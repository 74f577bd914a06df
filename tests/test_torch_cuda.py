"""The port's CUDA kernels on the card, against their plain versions: the
ConvLSTM gate kernels (also through their registered custom ops) and the
fusion's reproject-and-vote (and its division against IEEE division).

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports nothing of JAX, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel is checked on its 16-byte path (hidden 16 and 8 at an odd
shape) and on its scalar path (``hidden=3``, whose plane of 105 elements
no 16-byte vector divides, and z and c one element into their storage).
Bars: the forward fp32 atol 1e-6 and bf16 2e-2, the backward fp32 1e-5 and
bf16 5e-2, those of the JAX package's kernel tests
(``tests/test_pallas.py:21-103``).  In bf16 every input but z is drawn in
(-1, 1), which keeps each output below 2 in magnitude: there one bf16 ulp
is at most 2^-7, and the kernel and the plain version may round one ulp
apart.
"""

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu_torch.models.blocks import ConvLSTMCell
from aa_rmvsnet_tpu_torch.ops import fusion, gates
from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

_DTYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 5e-2)}
_FORWARD_DTYPES = {"float32": (torch.float32, 1e-6), "bfloat16": (torch.bfloat16, 2e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _inputs(hidden, dtype, seed, hw=(9, 13)):
    """z, c, dh, dc' at the odd shape (2, ., *hw) on the card."""
    rng = np.random.RandomState(seed)
    z = rng.randn(2, 4 * hidden, *hw)
    rest = [rng.randn(2, hidden, *hw) for _ in range(3)]
    if dtype == torch.bfloat16:
        rest = [np.clip(a, -1, 1) for a in rest]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype).cuda() for a in (z, *rest)]


def _at_storage_offset(t):
    """A contiguous copy of ``t`` one element into its storage, so that its
    data pointer is off the 16-byte grid."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def _scalar_path_inputs(case, dtype, seed):
    """z, c, dh, dc' that take the kernels' scalar path."""
    if case == "hidden3":
        return _inputs(3, dtype, seed=seed, hw=(7, 5))
    z, c, dh, dcn = _inputs(16, dtype, seed=seed)
    z, c = _at_storage_offset(z), _at_storage_offset(c)
    assert z.is_contiguous() and z.data_ptr() % 16 != 0 and c.data_ptr() % 16 != 0
    return z, c, dh, dcn


def _forward_matches_plain(z, c, atol):
    before = gates.launches
    h_k, c_k = gates.lstm_gates(z, c)
    torch.cuda.synchronize()
    assert gates.launches == before + 1
    h_p, c_p = gates.lstm_gates_reference(z, c)
    assert h_k.dtype == c_k.dtype == c.dtype and h_k.shape == c.shape
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 8])
@pytest.mark.parametrize("dtype", sorted(_FORWARD_DTYPES))
def test_forward_kernel_matches_plain(hidden, dtype):
    _card()
    tdt, atol = _FORWARD_DTYPES[dtype]
    z, c, _, _ = _inputs(hidden, tdt, seed=2)
    _forward_matches_plain(z, c, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hidden3", "storage_offset"])
@pytest.mark.parametrize("dtype", sorted(_FORWARD_DTYPES))
def test_forward_kernel_scalar_path_matches_plain(case, dtype):
    """The forward's scalar path: ``hidden=3`` at (2, 3, 7, 5) and z and c
    as contiguous views one element into their storage."""
    _card()
    tdt, atol = _FORWARD_DTYPES[dtype]
    z, c, _, _ = _scalar_path_inputs(case, tdt, seed=3)
    _forward_matches_plain(z, c, atol)


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
@pytest.mark.parametrize("case", ["hidden3", "storage_offset"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_backward_kernel_scalar_path_matches_plain(case, dtype):
    """The kernel's scalar path: ``hidden=3`` at (2, 3, 7, 5), a plane of
    105 elements that no 16-byte vector divides, and z and c as contiguous
    views one element into their storage."""
    _card()
    tdt, atol = _DTYPES[dtype]
    z, c, dh, dcn = _scalar_path_inputs(case, tdt, seed=7 if case == "hidden3" else 8)
    before = gates.backward_launches
    dz, dc = gates.lstm_gates_backward(z, c, dh, dcn)
    torch.cuda.synchronize()
    assert gates.backward_launches == before + 1
    dz_p, dc_p = gates.lstm_gates_backward_reference(z, c, dh, dcn)
    torch.testing.assert_close(dz.float(), dz_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(dc.float(), dc_p.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(_FORWARD_DTYPES))
def test_gate_op_launches_the_kernel(dtype):
    """The registered custom ops (``torch.ops.aa_rmvsnet_torch.lstm_gates``
    and ``lstm_gates_backward``, what an exported or compiled program calls)
    on CUDA tensors launch the kernels once a call and match the plain
    versions at the kernels' bars."""
    _card()
    dtype, bar = _FORWARD_DTYPES[dtype]
    z, c, dh, dcn = _inputs(16, dtype, seed=7)
    before, before_bwd = gates.launches, gates.backward_launches
    out = torch.ops.aa_rmvsnet_torch.lstm_gates(z, c)
    grads = torch.ops.aa_rmvsnet_torch.lstm_gates_backward(z, c, dh, dcn)
    torch.cuda.synchronize()
    assert (gates.launches, gates.backward_launches) == (before + 1, before_bwd + 1)
    for got, want in zip(out, gates.lstm_gates_reference(z, c)):
        assert (got.float() - want.float()).abs().max().item() <= bar
    bwd_bar = _DTYPES[str(dtype).removeprefix("torch.")][1]
    for got, want in zip(grads, gates.lstm_gates_backward_reference(z, c, dh, dcn)):
        assert (got.float() - want.float()).abs().max().item() <= bwd_bar

@pytest.mark.cuda
def test_launch_counters_move_by_one_per_call():
    """Each wrapper call adds one to its own counter and none to the
    other's, on the 16-byte path and on the scalar one."""
    _card()
    for hidden, hw in ((16, (9, 13)), (3, (7, 5))):
        z, c, dh, dcn = _inputs(hidden, torch.float32, seed=9, hw=hw)
        for _ in range(3):
            before = (gates.launches, gates.backward_launches)
            gates.lstm_gates(z, c)
            assert (gates.launches, gates.backward_launches) == (before[0] + 1, before[1])
            gates.lstm_gates_backward(z, c, dh, dcn)
            assert (gates.launches, gates.backward_launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cell_scan_under_checkpoint_matches_cpu():
    """A ConvLSTM cell scanned over 3 steps, each under checkpoint: the
    card's gradients (both kernels, twice the forward) equal the CPU's.

    The weights are seeded, and cuDNN is off: its fp32 weight-gradient
    algorithm for this 3x3 conv differs from the CPU's by nearly the 1e-4
    bar on gradients of magnitude ~30 (one run, with unseeded weights, put
    one element of 27,648 past it), which is the library's rounding, not
    the gate kernels'.  Without cuDNN the conv is an im2col and an fp32
    GEMM (TF32 off), an order of magnitude inside the bar."""
    _card()
    disable_tf32()
    rng = np.random.RandomState(6)
    xs = rng.randn(3, 1, 32, 8, 12).astype(np.float32)
    torch.manual_seed(6)
    cell = ConvLSTMCell(32, 16)
    grads = {}
    for dev in ("cpu", "cuda"):
        cell.zero_grad()
        cell.to(dev)
        x = torch.from_numpy(xs).to(dev).requires_grad_()
        h = torch.zeros(1, 16, 8, 12, device=dev)
        c = torch.zeros(1, 16, 8, 12, device=dev)
        total = 0.0
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            for t in range(3):
                h, c = torch.utils.checkpoint.checkpoint(cell, x[t], (h, c),
                                                         use_reentrant=False)
                total = total + (h ** 2).sum() + torch.sin(c).sum()
            before = (gates.launches, gates.backward_launches)
            total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (gates.launches - before[0], gates.backward_launches - before[1]) == (3, 3)
        grads[dev] = [g.cpu() for g in (cell.conv.weight.grad, cell.conv.bias.grad, x.grad)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _fusion_plane():
    """An odd size, a source listed twice and one whose depths are zero, on
    noisy planes whose masks are mixed at every level."""
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_cameras

    h, w, views = 37, 53, 5
    cams = plane_cameras(h, w, views, 300.0, 2.0)
    rng = np.random.RandomState(9)
    depths = (500.0 + 1.5 * rng.randn(views, h, w)).astype(np.float32)
    depths[4] = 0.0
    ref, srcs = 2, [1, 3, 0, 1, 4]
    return depths, ref, srcs, np.stack([fusion.pair_matrices(*cams[ref], *cams[s]) for s in srcs])


@pytest.mark.cuda
@pytest.mark.parametrize("case, num_src, num_levels", [
    ("plane", 5, 9), ("plane", 5, 3),
    *[("edges", n, nl) for n in (1, fusion.MAX_SOURCES) for nl in (1, 9, 16)],
])
def test_fusion_kernel_matches_plain(case, num_src, num_levels):
    """``fuse_ref`` on the card equals its plain version on the card and on
    the CPU bit for bit (the kernel is built with -fmad=false): on noisy
    planes (``_fusion_plane``), and on inputs with 2 % each of 0, negative,
    NaN, +inf and -inf depths in every map, sources that project outside
    the image and reference intrinsics that change between sources
    (``utils/synthetic.py:fusion_edge_case``), with 1 and ``MAX_SOURCES``
    sources."""
    _card()
    from aa_rmvsnet_tpu_torch.utils.synthetic import fusion_edge_case

    depths, ref, srcs, mats = _fusion_plane() if case == "plane" else \
        fusion_edge_case(75, 101, num_src, seed=5)
    args = [torch.from_numpy(depths), ref, torch.tensor(srcs, dtype=torch.int32),
            torch.from_numpy(mats), num_levels]
    cpu = fusion.fuse_ref(*args)
    cuda = [a.cuda() if torch.is_tensor(a) else a for a in args]
    before = fusion.launches
    kernel = fusion.fuse_ref(*cuda)
    torch.cuda.synchronize()
    assert fusion.launches == before + 1
    plain = fusion.fuse_ref_reference(*cuda)
    share = (cpu[0] > 0).float().mean(dim=(1, 2))
    if case == "plane":
        assert bool(((share > 0.05) & (share < 0.999)).all()), share
    else:
        assert 0.05 < share[-1] < 0.999, share
    for k, p, c in zip(kernel, plain, cpu):
        assert k.dtype == c.dtype and torch.equal(k, p) and torch.equal(k.cpu(), c)


@pytest.mark.cuda
def test_fusion_kernel_past_2_24_pixels():
    """Past 2^24 pixels a row, float32 sample coordinates step by 2 and
    floor + 1 rounds to floor or floor + 2: the kernel still takes the taps
    the plain version takes, bit for bit (on the card; the CPU's plain
    version is the same arithmetic, held to it by the tests above)."""
    _card()
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_cameras

    h, w = 2, (1 << 24) + 96
    cams = plane_cameras(h, w, 3, 1000.0, 0.5)  # sources 1 px apart
    gen = torch.Generator(device="cuda").manual_seed(11)
    depths = (500.0 + 1.5 * torch.randn(3, h, w, device="cuda", generator=gen)).contiguous()
    srcs = [0, 2]
    mats = np.stack([fusion.pair_matrices(*cams[1], *cams[s]) for s in srcs])
    args = (depths, 1, torch.tensor(srcs, dtype=torch.int32, device="cuda"),
            torch.from_numpy(mats).cuda())
    kernel = fusion.fuse_ref(*args)
    plain = fusion.fuse_ref_reference(*args)
    assert bool((kernel[1][:, 1 << 24:] > 0).any())
    for k, p in zip(kernel, plain):
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_fusion_division_matches_ieee():
    """The fusion kernel's quotients (a divisor's reciprocal shared by the
    quotients, ``__ddiv_rn`` outside its fast range) equal IEEE division
    bit for bit, on random bit patterns, the fusion's magnitudes and the
    edges of the fast range."""
    _card()
    from aa_rmvsnet_tpu_torch.utils.synthetic import division_operands

    a, c = division_operands(1 << 20, seed=7)
    got = fusion.kernel_quotients(torch.from_numpy(a).cuda(), torch.from_numpy(c).cuda())
    with np.errstate(all="ignore"):
        want = a / c
    assert np.array_equal(got.cpu().numpy(), want, equal_nan=True)
