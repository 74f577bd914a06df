"""GroupNorm with its ReLU for inference (``ops/group_norm.py``), and the
rule by which ``parallel/spatial.py:group_norm_rows`` takes its kernel pair.

On the CPU: the plain version against ``nn.GroupNorm`` (+ ReLU), fp32 at
1e-5 and bf16 within one bf16 rounding (both round the same fp32 affine
once; the sums run in another order); the wrapper's refusals; the rule (a
CUDA tensor, no mesh, no autograd graph, no ``torch.compile`` or
``torch.export``), and that the remat training step never meets it; and
the blocks that pass ``relu=True`` equal to their former conv -> GN ->
ReLU, bit for bit.

The ``cuda`` cases hold the kernel pair to the plain version on the card
at the regularizer's and FeatNet's shapes, on its 16-byte and its scalar
path (fp32 within 1e-5 relative, bf16 within one ulp), and count its
launches.  The file imports nothing of JAX:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_group_norm.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from aa_rmvsnet_tpu_torch.models.blocks import (
    ConvGNReLU,
    DeconvGNReLU,
    DeformConvGNReLU,
    ResnetBlockGN,
)
from aa_rmvsnet_tpu_torch.ops import group_norm as group_norm_ops
from aa_rmvsnet_tpu_torch.parallel import spatial
from aa_rmvsnet_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)


def _affine(gn: nn.GroupNorm, seed: int) -> nn.GroupNorm:
    """``gn`` with a scale N(1, 0.1^2) and a shift N(0, 0.1^2), so that a
    dropped affine term shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        gn.weight.copy_(1 + 0.1 * torch.randn(gn.weight.shape, generator=g))
        gn.bias.copy_(0.1 * torch.randn(gn.bias.shape, generator=g))
    return gn


def _inputs(shape, groups, dtype, seed, device="cpu"):
    """``x`` of ``shape`` (mean 0.5, std 2: a mean that a one-pass variance
    would feel) and its GroupNorm in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    x = (0.5 + 2 * torch.randn(shape, generator=g)).to(dtype).to(device)
    gn = _affine(nn.GroupNorm(groups, shape[1], eps=1e-5), seed + 1).to(dtype).to(device)
    return x, gn


def _ulps_apart(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest distance between two bf16 tensors in bf16 units in the
    last place of the larger magnitude, magnitudes under 2^-12 of want's
    largest counted at that floor: there the fp32 affine's own rounding
    (~1e-7 of the terms ``x * a`` and ``b`` that cancel to a value near 0)
    is finer than a bf16 ulp of the value."""
    g, w = got.float(), want.float()
    floor = w.abs().max() * 2.0**-12
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()), floor)
    return ((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(6, 8), (7, 9)], ids=["row8", "row_odd"])
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_plain_matches_nn_group_norm(groups, batch, hw, dtype):
    x, gn = _inputs((batch, 16, *hw), groups, dtype, seed=groups * 10 + batch)
    for relu in (False, True):
        want = gn(x)
        want = torch.relu(want) if relu else want
        got = group_norm_ops.group_norm(x, groups, gn.weight, gn.bias, gn.eps, relu=relu)
        assert got.dtype == dtype and got.shape == x.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert _ulps_apart(got, want) <= 1
    assert group_norm_ops.group_norm_reference(x, groups, gn.weight, gn.bias, gn.eps).equal(
        group_norm_ops.group_norm(x, groups, gn.weight, gn.bias, gn.eps))


@pytest.mark.parametrize("case, error", [
    ("float16", TypeError),
    ("float64", TypeError),
    ("weight_float16", TypeError),
    ("non_contiguous", ValueError),
    ("groups_3_of_16", ValueError),
    ("weight_shape", ValueError),
])
def test_wrapper_refuses(case, error):
    x, gn = _inputs((2, 16, 6, 8), 2, torch.float32, seed=3)
    weight, bias, groups = gn.weight.detach(), gn.bias.detach(), 2
    if case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "weight_float16":
        weight, bias = weight.half(), bias.half()
    elif case == "non_contiguous":
        x = x.transpose(2, 3)
    elif case == "groups_3_of_16":
        groups = 3
    else:
        weight = weight[:8]
    with pytest.raises(error, match="group_norm"):
        group_norm_ops.group_norm(x, groups, weight, bias, 1e-5)


def _cuda_like():
    """A stand-in for a CUDA tensor: the rule reads ``is_cuda`` alone."""
    return SimpleNamespace(is_cuda=True)


def test_rule_takes_the_kernel_only_without_a_graph(monkeypatch):
    mesh = make_mesh(device="cpu")
    with torch.no_grad():
        assert spatial._takes_kernel(_cuda_like(), None)
        assert not spatial._takes_kernel(_cuda_like(), mesh)
        assert not spatial._takes_kernel(torch.zeros(1), None)
    with torch.inference_mode():
        assert spatial._takes_kernel(_cuda_like(), None)
    assert not spatial._takes_kernel(_cuda_like(), None)  # grad recorded
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.no_grad():
        assert not spatial._takes_kernel(_cuda_like(), None)


def test_rule_under_torch_compile():
    seen = []

    def probe(t):
        seen.append(spatial._takes_kernel(_cuda_like(), None))
        return t + 1

    with torch.no_grad():
        torch.compile(probe, backend="eager", fullgraph=False)(torch.zeros(2))
    assert seen == [False]


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_rows_is_gn_on_the_cpu(relu):
    x, gn = _inputs((2, 16, 6, 8), 2, torch.float32, seed=5)
    want = torch.relu(gn(x)) if relu else gn(x)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            assert spatial.group_norm_rows(x, gn, None, relu=relu).equal(want)


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_rows_with_a_mesh_is_unchanged(relu, monkeypatch):
    """On a mesh, the two-pass statistics over every rank's rows and the
    affine as before, bit for bit (one process, the all-reduce of its sums
    the identity)."""
    monkeypatch.setattr(spatial, "all_reduce_sum", lambda t, group: t)
    mesh = make_mesh(device="cpu")
    x, gn = _inputs((2, 16, 6, 8), 4, torch.bfloat16, seed=7)
    N, C, G = 2, 16, 4
    xf = x.float()
    x32 = xf.reshape(N, G, -1)
    mean = spatial.spatial_mean(x32, (2,), mesh)
    var = spatial.spatial_mean((x32 - mean[..., None]).square(), (2,), mesh)
    rstd = torch.rsqrt(var + gn.eps).repeat_interleave(C // G, dim=1)
    mean = mean.repeat_interleave(C // G, dim=1)
    a = rstd * gn.weight.float()
    b = gn.bias.float() - mean * a
    want = torch.addcmul(b[:, :, None, None], xf, a[:, :, None, None]).to(x.dtype)
    want = torch.relu(want) if relu else want
    assert spatial.group_norm_rows(x, gn, mesh, relu=relu).equal(want)


def test_remat_training_step_never_meets_the_rule(monkeypatch):
    """Every GroupNorm of a remat training forward and of its recompute
    runs with a graph recorded, so the rule refuses it on the card too;
    the same model's inference forward takes it everywhere."""
    from aa_rmvsnet_tpu_torch.models.network import SweepConfig
    from aa_rmvsnet_tpu_torch.pipeline.train import loss_fn
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample, seeded_model

    decided = []
    rule = spatial._takes_kernel
    monkeypatch.setattr(spatial, "_takes_kernel",
                        lambda x, mesh: decided.append(rule(_cuda_like(), mesh)) or False)
    sample = plane_train_sample(32, 40, 3, 4, seed=0, focal=90.0, baseline=6.0,
                                plane_depth=500.0, depth_min=480.0, depth_interval=10.0)
    batch = {k: torch.as_tensor(np.asarray(v))[None] for k, v in sample.items()
             if k != "name"}
    model = seeded_model(0)
    loss, _ = loss_fn(model, batch, SweepConfig(depth_block=2, remat=True))
    forward_calls = len(decided)
    loss.backward()
    # The backward recomputes each depth block's GroupNorms.
    assert forward_calls > 0 and len(decided) > forward_calls
    assert not any(decided)
    decided.clear()
    with torch.no_grad():
        loss_fn(model, batch, SweepConfig(depth_block=2))
    assert len(decided) == forward_calls and all(decided)


def _former(block, x):
    """The block's forward before the ReLU moved into ``group_norm_rows``."""
    if isinstance(block, DeconvGNReLU):
        return torch.relu(block.gn(block.conv(x)))
    return torch.relu(block[1](block[0](x)))


@pytest.mark.parametrize("make, in_channels", [
    (lambda: ConvGNReLU(8, 16), 8),
    (lambda: ConvGNReLU(16, 32, stride=2), 16),
    (lambda: DeconvGNReLU(16, 16), 16),
    (lambda: DeformConvGNReLU(16, 16), 16),
], ids=["conv", "conv_stride2", "deconv", "deform"])
def test_blocks_equal_conv_gn_relu(make, in_channels):
    torch.manual_seed(11)
    block = make()
    for module in block.modules():
        if isinstance(module, nn.GroupNorm):
            _affine(module, seed=12)
    x = torch.randn(2, in_channels, 8, 12)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            assert block(x).equal(_former(block, x))


def test_resnet_block_keeps_its_relu_after_the_add():
    torch.manual_seed(13)
    block = ResnetBlockGN(16, kernel=1)
    x = torch.randn(1, 16, 6, 8)
    inner, conv, gn = block.stem
    want = torch.relu(gn(conv(_former(inner, x))) + x)
    assert block(x).equal(want)


# --- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _at_storage_offset(t):
    """A contiguous copy of ``t`` one element into its storage, off the
    16-byte grid (the kernels' scalar path)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape, groups, case", [
    ((1, 16, 864, 1152), 2, "regularizer deconv_1"),
    ((1, 16, 432, 576), 2, "regularizer deconv_0"),
    ((5, 32, 864, 1152), 4, "FeatNet conv0"),
    ((5, 8, 216, 288), 1, "FeatNet conv2 1x1"),
    ((2, 12, 7, 9), 3, "odd plane"),
    ((2, 16, 9, 16), 2, "storage offset"),
])
def test_kernel_matches_plain(shape, groups, case, dtype):
    _card()
    x, gn = _inputs(shape, groups, dtype, seed=sum(shape), device="cuda")
    if case == "storage offset":
        x = _at_storage_offset(x)
    for relu in (False, True):
        before = group_norm_ops.launches
        with torch.no_grad():
            got = group_norm_ops.group_norm(x, groups, gn.weight, gn.bias, gn.eps, relu=relu)
        torch.cuda.synchronize()
        assert group_norm_ops.launches == before + 1
        want = group_norm_ops.group_norm_reference(x, groups, gn.weight, gn.bias, gn.eps,
                                                   relu=relu)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert _ulps_apart(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_group_norm_rows_takes_the_kernel_without_a_graph(layout):
    """The kernel pair where no graph is recorded, within one bf16 ulp of
    the plain version; aten's GroupNorm where one is, as before.  A
    channels-last input (as FeatNet's first convolution writes) goes
    through a contiguous copy."""
    _card()
    x, gn = _inputs((1, 16, 48, 64), 2, torch.bfloat16, seed=21, device="cuda")
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    before = group_norm_ops.launches
    with torch.no_grad():
        fused = spatial.group_norm_rows(x, gn, None, relu=True)
    assert group_norm_ops.launches == before + 1
    want = group_norm_ops.group_norm_reference(x.contiguous(), 2, gn.weight, gn.bias, gn.eps,
                                               relu=True)
    assert _ulps_apart(fused, want) <= 1
    x.requires_grad_()
    recorded = spatial.group_norm_rows(x, gn, None, relu=True)
    assert group_norm_ops.launches == before + 1 and recorded.grad_fn is not None
    assert recorded.equal(torch.relu(gn(x)))
