"""The sweep's unpacked warp with its squared residual (``ops/warp.py``),
and the rule by which ``models/network.py:_sweep_chunk`` sends the
unpacked cost block through it.

On the CPU: the plain version equal, bit for bit in bf16 and fp32, to the
composition it replaces (the 2x2 table of ``ops/patch_sample.py``, its
gather and blend, then ``(warped - ref) ** 2``), at coordinates inside,
on integers, straddling every border, wholly outside and negative; the
wrapper's refusals; the rule (CUDA features, no autograd graph, no mesh,
exact tables, the unpacked cost block without folded omega, fp32 or bf16,
not inside ``torch.compile`` or ``torch.export``), that the 2x2 tables
are skipped only where it holds, that the remat training step never meets
it, and ``sweep()``'s costs with the kernel's path forced equal to the
table path's, bit for bit.

The ``cuda`` cases hold the kernel to the plain version and to aten's
composition on the card at a block of a quarter-size Tanks and Temples
map (1x4x264x480, 32 channels, a far source's homography with samples
outside the image), on its 16-byte and its scalar path (bf16 bit for bit,
fp32 within one ulp), and count one launch per source view and depth
block of a sweep.  The file imports nothing of JAX:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_warp.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu_torch.models import network
from aa_rmvsnet_tpu_torch.models.network import SweepConfig, cast_model, extract_features, sweep
from aa_rmvsnet_tpu_torch.ops import warp
from aa_rmvsnet_tpu_torch.ops.homography import homography_terms, plane_sweep_xy
from aa_rmvsnet_tpu_torch.ops.patch_sample import build_patch_table, patch_bilinear_sample
from aa_rmvsnet_tpu_torch.parallel.mesh import make_mesh
from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

torch.set_num_threads(2)

B, H, W, C, DB = 2, 7, 11, 32, 3
COORD_CASES = ("inside", "integers", "borders", "outside", "negative", "near_integers")
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _features(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (3 * torch.randn(shape, generator=g)).to(dtype)


def _coords(case, seed, height=H, width=W, pixels=H * W):
    """``(B, DB, pixels)`` fp32 coordinates of one kind in a ``height x
    width`` map."""
    g = torch.Generator().manual_seed(seed)
    shape = (B, DB, pixels)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    if case == "inside":
        return uniform(0.0, width - 1.0), uniform(0.0, height - 1.0)
    if case == "integers":
        return (torch.randint(0, width, shape, generator=g).float(),
                torch.randint(0, height, shape, generator=g).float())
    if case == "borders":
        # Each sample straddles a border: before the first or past the last
        # column, row, or both (the corners).
        side = torch.randint(0, 4, shape, generator=g)
        x, y = uniform(0.0, width - 1.0), uniform(0.0, height - 1.0)
        x = torch.where(side == 0, uniform(-1.0, 0.0), x)
        x = torch.where(side == 1, uniform(width - 1.0, width), x)
        y = torch.where(side == 2, uniform(-1.0, 0.0), y)
        y = torch.where(side == 3, uniform(height - 1.0, height), y)
        corner = torch.rand(shape, generator=g) < 0.25
        x = torch.where(corner, uniform(width - 1.0, width), x)
        y = torch.where(corner, uniform(-1.0, 0.0), y)
        return x, y
    if case == "outside":
        # Wholly outside on one side or far away (points behind a camera
        # project to huge coordinates).
        far = torch.where(torch.rand(shape, generator=g) < 0.5, -1e6, 1e6)
        x = torch.where(torch.rand(shape, generator=g) < 0.5, uniform(width, width + 5.0), far)
        return x, uniform(-8.0, height + 8.0)
    if case == "negative":
        return uniform(-3.0, 0.0), uniform(-3.0, 0.0)
    # Within a few fp32 ulps of an integer: tent weights near 0 and 1.
    base_x = torch.randint(-1, width + 1, shape, generator=g).float()
    base_y = torch.randint(-1, height + 1, shape, generator=g).float()
    nudge = torch.randint(-3, 4, shape, generator=g).float() * 2.0**-20
    return base_x + nudge, base_y - nudge


def _composition(src, x, y, ref):
    """Today's unpacked path: the 2x2 table, its gather and blend, then the
    squared residual, in ``_build_cost_block``'s layout, returned as
    ``(B, Db, H, W, C)``."""
    b, height, width, c = ref.shape
    db = x.shape[1]
    warped = patch_bilinear_sample(build_patch_table(src), x.reshape(b, -1), y.reshape(b, -1),
                                   src.shape[1], src.shape[2], compute_dtype=src.dtype)
    warped = warped.view(b, db, height, width, c).permute(0, 1, 4, 2, 3)
    residual = (warped - ref.permute(0, 3, 1, 2)[:, None]) ** 2
    return residual.permute(0, 1, 3, 4, 2)


def _bits(t):
    return t.contiguous().view(_BITS[t.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", COORD_CASES)
def test_plain_equals_the_table_composition(case, dtype):
    for channels, seed in ((C, 1), (5, 2)):
        src = _features((B, H, W, channels), dtype, seed)
        ref = _features((B, H, W, channels), dtype, seed + 10)
        x, y = _coords(case, seed + 20)
        got = warp.warp_residual(src, x, y, ref)
        assert got.shape == (B, DB, H, W, channels) and got.dtype == dtype
        assert got.is_contiguous()
        assert torch.equal(_bits(got), _bits(_composition(src, x, y, ref)))


def test_plain_reads_a_source_of_another_size():
    """The source map may differ from the reference's size: its own
    rows and columns bound the samples, as the table's height and width
    do."""
    src = _features((B, 9, 6, C), torch.bfloat16, 3)
    ref = _features((B, H, W, C), torch.bfloat16, 4)
    x, y = _coords("borders", 5, height=9, width=6)
    assert torch.equal(_bits(warp.warp_residual(src, x, y, ref)),
                       _bits(_composition(src, x, y, ref)))


@pytest.mark.parametrize("case, error", [
    ("float16", TypeError),
    ("coords_float64", TypeError),
    ("ref_dtype", TypeError),
    ("non_contiguous", ValueError),
    ("pixels", ValueError),
    ("channels", ValueError),
])
def test_wrapper_refuses(case, error):
    src = _features((B, H, W, C), torch.float32, 6)
    ref = _features((B, H, W, C), torch.float32, 7)
    x, y = _coords("inside", 8)
    if case == "float16":
        src, ref = src.half(), ref.half()
    elif case == "coords_float64":
        x = x.double()
    elif case == "ref_dtype":
        ref = ref.bfloat16()
    elif case == "non_contiguous":
        src = src.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "pixels":
        x, y = x[..., 1:], y[..., 1:]
    else:
        ref = ref[..., :16].contiguous()
    with pytest.raises(error, match="warp_residual"):
        warp.warp_residual(src, x, y, ref)


# --- the rule ------------------------------------------------------------------

def _cuda_like():
    """A stand-in for CUDA features: the rule reads ``is_cuda`` alone."""
    return SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case, takes", [
    ("defaults_fp32", True),
    ("defaults_bf16", True),
    ("cpu", False),
    ("graph_recorded", False),
    ("mesh", False),
    ("int8_tables", False),
    ("fp8_tables", False),
    ("packed_rows", False),
    ("fold_omega", False),
    ("hybrid_omega", False),
    ("float16", False),
    ("compiling", False),
])
def test_rule_takes_the_kernel_only_where_it_holds(case, takes, monkeypatch):
    features = torch.zeros(1) if case == "cpu" else _cuda_like()
    settings = {
        "defaults_bf16": dict(feature_dtype=torch.bfloat16),
        "mesh": dict(mesh=make_mesh(device="cpu")),
        "int8_tables": dict(table_dtype=torch.int8),
        "fp8_tables": dict(table_dtype=torch.float8_e4m3fn),
        "packed_rows": dict(packed_rows=True),
        "fold_omega": dict(fold_omega=True),
        "hybrid_omega": dict(fold_omega="hybrid"),
        "float16": dict(feature_dtype=torch.float16),
    }.get(case, {})
    config = SweepConfig(**settings)
    if case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.set_grad_enabled(case == "graph_recorded"):
        assert network._takes_warp_kernel(features, config) is takes


def test_rule_under_torch_compile():
    seen = []

    def probe(t):
        seen.append(network._takes_warp_kernel(_cuda_like(), SweepConfig()))
        return t + 1

    with torch.no_grad():
        torch.compile(probe, backend="eager", fullgraph=False)(torch.zeros(2))
    assert seen == [False]


def _scene(views=4, num_depth=8):
    (sample,) = plane_scene(24, 32, views, num_depth, maps=1, seed=3, focal=40.0,
                            baseline=0.5, plane_depth=470.0, depth_min=425.0,
                            depth_interval=5.0)
    return [torch.from_numpy(np.asarray(sample[k]))[None]
            for k in ("imgs", "proj_matrices", "depth_values")]


def _sweep(dtype, takes, monkeypatch, **settings):
    """``sweep()`` of the toy scene with the rule's answer forced to
    ``takes``, and the 2x2 tables built and the kernel calls made."""
    imgs, projs, depths = _scene()
    calls = {"tables": 0, "warp": 0}
    build, kernel = network.build_patch_table_packed, network.warp_residual

    def counted_build(*args, **kwargs):
        calls["tables"] += 1
        return build(*args, **kwargs)

    def counted_warp(*args):
        calls["warp"] += 1
        return kernel(*args)

    monkeypatch.setattr(network, "_takes_warp_kernel", lambda features, config: takes)
    monkeypatch.setattr(network, "build_patch_table_packed", counted_build)
    monkeypatch.setattr(network, "warp_residual", counted_warp)
    model = cast_model(seeded_model(0), dtype)
    with torch.no_grad():
        features = extract_features(model, imgs, dtype)
        out = sweep(model, features, projs, depths,
                    SweepConfig(depth_block=4, feature_dtype=dtype, **settings))
    return out, calls


@pytest.mark.parametrize("takes", [True, False], ids=["kernel", "tables"])
def test_tables_are_skipped_only_where_the_kernel_takes_the_blocks(takes, monkeypatch):
    """3 source views, 8 hypotheses in blocks of 4: the kernel's path
    builds no table and calls the warp once per view and block; the
    table path builds one table a view and never calls it."""
    _, calls = _sweep(torch.bfloat16, takes, monkeypatch)
    assert calls == ({"tables": 0, "warp": 6} if takes else {"tables": 3, "warp": 0})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_sweep_costs_equal_the_table_path(dtype, monkeypatch):
    """On the CPU the rule refuses, so ``sweep()`` runs the table path;
    forced onto the kernel's path (the plain version here) it gives the
    same costs, depth and confidence to the bit."""
    want, _ = _sweep(dtype, False, monkeypatch)
    got, _ = _sweep(dtype, True, monkeypatch)
    for key in ("cost_volume", "depth", "photometric_confidence"):
        assert torch.equal(got[key], want[key]), key


def test_remat_training_step_never_meets_the_rule(monkeypatch):
    """A remat training forward records a graph, so the rule refuses it on
    the card too and the tables are built; the same model's inference
    forward takes it."""
    from aa_rmvsnet_tpu_torch.pipeline.train import loss_fn
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample

    decided = []
    rule = network._takes_warp_kernel
    monkeypatch.setattr(network, "_takes_warp_kernel",
                        lambda features, config: decided.append(rule(_cuda_like(), config))
                        or False)
    sample = plane_train_sample(32, 40, 3, 4, seed=0, focal=90.0, baseline=6.0,
                                plane_depth=500.0, depth_min=480.0, depth_interval=10.0)
    batch = {k: torch.as_tensor(np.asarray(v))[None] for k, v in sample.items()
             if k != "name"}
    model = seeded_model(0)
    loss, _ = loss_fn(model, batch, SweepConfig(depth_block=2, remat=True))
    loss.backward()
    assert decided == [False]
    decided.clear()
    with torch.no_grad():
        loss_fn(model, batch, SweepConfig(depth_block=2))
    assert decided == [True]


# --- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _tnt_block(dtype, channels=C, height=264, width=480):
    """A depth block of a quarter-size Tanks and Temples map on the card:
    features, the farthest source's coordinates for 4 hypotheses in bounded
    inverse depth (a camera 5 x 50 units from the reference at focal 291,
    so the border columns sample outside the image), and reference
    features."""
    focal, baseline = 1165.0 / 4, 50.0
    K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]])
    projs = []
    for shift in ([0.0], [0.0], [0.0]), ([-5 * baseline], [3.0], [0.0]):
        P = np.eye(4)
        P[:3, :4] = K @ np.hstack([np.eye(3), shift])
        projs.append(torch.tensor(P[None], dtype=torch.float32))
    inverse = np.linspace(1 / 500.0, 1 / 2000.0, 512)[200:204]
    depths = torch.tensor(1.0 / inverse, dtype=torch.float32)[None]
    rot_grid, trans = homography_terms(projs[1], projs[0], height, width)
    x, y = plane_sweep_xy(rot_grid, trans, depths)
    g = torch.Generator().manual_seed(channels)
    src = (2 * torch.randn(1, height, width, channels, generator=g)).to(dtype)
    ref = (2 * torch.randn(1, height, width, channels, generator=g)).to(dtype)
    return [t.cuda() for t in (src, x.contiguous(), y.contiguous(), ref)]


def _ulps_apart(got, want):
    """The largest distance between two fp32 tensors in units of the last
    place of the larger magnitude (1 for a zero against the least
    subnormal)."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-149)
    return ((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 23)).max().item()


def _at_storage_offset(t):
    """A contiguous copy of ``t`` one element into its storage, off the
    16-byte grid (the kernel's scalar path)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["vector", "odd_channels", "storage_offset"])
def test_kernel_matches_plain_at_a_tnt_block(case, dtype):
    _card()
    src, x, y, ref = _tnt_block(dtype, channels=5 if case == "odd_channels" else C)
    if case == "storage_offset":
        src, ref = _at_storage_offset(src), _at_storage_offset(ref)
    assert ((x < 0) | (x > src.shape[2] - 1)).any(), "the block samples outside the image"
    before = warp.launches
    with torch.no_grad():
        got = warp.warp_residual(src, x, y, ref)
    torch.cuda.synchronize()
    assert warp.launches == before + 1
    for want in (warp.warp_residual_reference(src, x, y, ref), _composition(src, x, y, ref)):
        if dtype == torch.bfloat16:
            assert torch.equal(_bits(got), _bits(want))
        else:
            assert _ulps_apart(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_sweep_launches_one_call_per_view_and_block(dtype):
    """3 source views and 8 hypotheses in blocks of 4: 6 launches without a
    graph, and omega's input of every view and block that of the table
    path (the rule forced off) bit for bit; none with a graph recorded."""
    _card()
    imgs, projs, depths = (t.cuda() for t in _scene())
    model = cast_model(seeded_model(0).cuda(), dtype)
    config = SweepConfig(depth_block=4, feature_dtype=dtype)
    residuals = []
    hook = model.omega.register_forward_pre_hook(lambda module, args: residuals.append(
        args[0].clone()))
    try:
        with torch.no_grad():
            features = extract_features(model, imgs, dtype)
            before = warp.launches
            sweep(model, features, projs, depths, config)
            torch.cuda.synchronize()
            assert warp.launches == before + 6
            rule = network._takes_warp_kernel
            network._takes_warp_kernel = lambda features, config: False
            try:
                sweep(model, features, projs, depths, config)
            finally:
                network._takes_warp_kernel = rule
        assert warp.launches == before + 6
        sweep(model, features, projs, depths, config)  # a graph is recorded
        assert warp.launches == before + 6
    finally:
        hook.remove()
    got, want = residuals[:6], residuals[6:12]
    for g, w in zip(got, want):
        assert g.stride() == w.stride() and torch.equal(_bits(g), _bits(w))
