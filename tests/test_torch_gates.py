"""ConvLSTM gate math of the PyTorch port against the JAX package.

The port's plain version (what ``lstm_gates`` runs on CPU tensors) is held
to the Pallas kernel (interpret mode on the CPU, as ``tests/test_pallas.py``
runs it) and to the XLA chain, at the bars of ``tests/test_pallas.py``:
fp32 atol 1e-6, bf16 atol 2e-2 (one bf16 ulp of the O(1) outputs), also
at the two inputs that take the CUDA kernel's scalar path: ``hidden=3``,
whose plane is no multiple of the 16-byte vector, and a contiguous view
one element into its storage.  The CUDA kernel itself runs only on the
card, against this plain version: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.ops.pallas.gates import fused_lstm_gates
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _xla_gates(z, c):
    i, f, o, g = jnp.split(z, 4, axis=-1)
    c_next = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    return jax.nn.sigmoid(o) * jnp.tanh(c_next), c_next


def _inputs(hidden, seed=0, hw=(9, 13)):
    """NHWC numpy inputs at the odd shape (2, *hw, hidden)."""
    rng = np.random.RandomState(seed)
    z = rng.randn(2, *hw, 4 * hidden).astype(np.float32)
    c = rng.randn(2, *hw, hidden).astype(np.float32)
    return z, c


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _at_storage_offset(t):
    """A contiguous copy of ``t`` one element into its storage."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("case", [16, 8, "hidden3", "storage_offset"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_plain_matches_pallas_kernel(case, dtype):
    """Hidden 16 and 8 at (2, 9, 13); ``hidden3`` at (2, 7, 5);
    ``storage_offset``: hidden 16 with z and c one element into their
    storage."""
    jdt, tdt, atol = _DTYPES[dtype]
    hidden, hw = {"hidden3": (3, (7, 5)), "storage_offset": (16, (9, 13))}.get(
        case, (case, (9, 13)))
    z, c = _inputs(hidden, hw=hw)
    h_j, c_j = fused_lstm_gates(jnp.asarray(z, jdt), jnp.asarray(c, jdt))
    zt, ct = _nchw(z, tdt), _nchw(c, tdt)
    if case == "storage_offset":
        zt, ct = _at_storage_offset(zt), _at_storage_offset(ct)
        assert zt.is_contiguous() and zt.storage_offset() == ct.storage_offset() == 1
    h_t, c_t = gates.lstm_gates(zt, ct)
    assert h_t.dtype == tdt and c_t.shape == (2, hidden, *hw)
    np.testing.assert_allclose(_nhwc(h_t), np.asarray(h_j, np.float32), atol=atol)
    np.testing.assert_allclose(_nhwc(c_t), np.asarray(c_j, np.float32), atol=atol)


@pytest.mark.parametrize("hidden", [16, 8])
def test_plain_matches_xla_chain(hidden):
    z, c = _inputs(hidden, seed=1)
    h_j, c_j = _xla_gates(jnp.asarray(z), jnp.asarray(c))
    h_t, c_t = gates.lstm_gates_reference(_nchw(z), _nchw(c))
    np.testing.assert_allclose(_nhwc(h_t), np.asarray(h_j), atol=1e-6)
    np.testing.assert_allclose(_nhwc(c_t), np.asarray(c_j), atol=1e-6)


def test_cpu_wrapper_does_not_count_launches():
    z, c = _inputs(8)
    before = gates.launches
    gates.lstm_gates(_nchw(z), _nchw(c))
    assert gates.launches == before


def test_graph_recorded_only_where_a_gradient_is_needed():
    """The wrapper goes through ``LSTMGates`` only in grad mode with an
    input that needs a gradient; otherwise it records no graph.  Both give
    the same values."""
    z, c = _inputs(8)
    zt, ct = _nchw(z), _nchw(c)
    h_plain, c_plain = gates.lstm_gates(zt, ct)
    assert h_plain.grad_fn is None and c_plain.grad_fn is None
    zg = zt.clone().requires_grad_()
    h_graph, c_graph = gates.lstm_gates(zg, ct)
    assert type(h_graph.grad_fn).__name__ == "LSTMGatesBackward"
    with torch.no_grad():
        assert gates.lstm_gates(zg, ct)[0].grad_fn is None
    torch.testing.assert_close(h_graph.detach(), h_plain, atol=0, rtol=0)
    torch.testing.assert_close(c_graph.detach(), c_plain, atol=0, rtol=0)


def test_non_cpu_tensors_never_take_the_plain_path():
    """Off the CPU the wrapper launches the kernel or raises: tensors on a
    device that is neither CPU nor CUDA, or split across devices, raise."""
    z = torch.empty(1, 32, 4, 4, device="meta")
    c = torch.empty(1, 8, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gates.lstm_gates(z, c)
    with pytest.raises(ValueError, match="CUDA"):
        gates.lstm_gates(z, torch.zeros(1, 8, 4, 4))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
