"""The port's gate-backward kernel on the card, against its plain version.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports nothing of JAX, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: fp32 atol 1e-5 and bf16 5e-2, those of the JAX package's
backward-kernel tests (``tests/test_pallas.py:61-103``).  In bf16 every
input is drawn in (-1, 1), which keeps each output below 2 in magnitude:
there one bf16 ulp is at most 2^-7, and the kernel and the plain version
may round one ulp apart.
"""

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu_torch.models.blocks import ConvLSTMCell
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

_DTYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 5e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _inputs(hidden, dtype, seed):
    """z, c, dh, dc' at the odd shape (2, ., 9, 13) on the card."""
    rng = np.random.RandomState(seed)
    z = rng.randn(2, 4 * hidden, 9, 13)
    rest = [rng.randn(2, hidden, 9, 13) for _ in range(3)]
    if dtype == torch.bfloat16:
        rest = [np.clip(a, -1, 1) for a in rest]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype).cuda() for a in (z, *rest)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 8])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_backward_kernel_matches_plain(hidden, dtype):
    _card()
    tdt, atol = _DTYPES[dtype]
    z, c, dh, dcn = _inputs(hidden, tdt, seed=5)
    zt, ct = z.requires_grad_(), c.requires_grad_()
    before = (gates.launches, gates.backward_launches)
    h_next, c_next = gates.lstm_gates(zt, ct)
    torch.autograd.backward((h_next, c_next), (dh, dcn))
    torch.cuda.synchronize()
    assert (gates.launches, gates.backward_launches) == (before[0] + 1, before[1] + 1)
    dz_p, dc_p = gates.lstm_gates_backward_reference(zt.detach(), ct.detach(), dh, dcn)
    torch.testing.assert_close(zt.grad.float(), dz_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(ct.grad.float(), dc_p.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_cell_scan_under_checkpoint_matches_cpu():
    """A ConvLSTM cell scanned over 3 steps, each under checkpoint: the
    card's gradients (both kernels, twice the forward) equal the CPU's."""
    _card()
    disable_tf32()
    rng = np.random.RandomState(6)
    xs = rng.randn(3, 1, 32, 8, 12).astype(np.float32)
    cell = ConvLSTMCell(32, 16)
    grads = {}
    for dev in ("cpu", "cuda"):
        cell.zero_grad()
        cell.to(dev)
        x = torch.from_numpy(xs).to(dev).requires_grad_()
        h = torch.zeros(1, 16, 8, 12, device=dev)
        c = torch.zeros(1, 16, 8, 12, device=dev)
        total = 0.0
        for t in range(3):
            h, c = torch.utils.checkpoint.checkpoint(cell, x[t], (h, c), use_reentrant=False)
            total = total + (h ** 2).sum() + torch.sin(c).sum()
        before = (gates.launches, gates.backward_launches)
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (gates.launches - before[0], gates.backward_launches - before[1]) == (3, 3)
        grads[dev] = [g.cpu() for g in (cell.conv.weight.grad, cell.conv.bias.grad, x.grad)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
