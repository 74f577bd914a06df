"""The port's packed-row warp, fused residual, folded omega and bf16 sweep
against the JAX package, on the CPU.

Weights come from ``test_torch_models.jax_params`` through
``params_from_jax``.  The packed levers are exact where their host gate
passes, so in fp32 they are held to the JAX package's bars for its
numerically transparent levers (``tests/test_models.py:432-442``): cost
volume atol 5e-4, depth atol 1e-3 (a pixel may flip only on a near-tie,
as in ``test_torch_models.py``), confidence atol 1e-5.  The fused residual
is bit for bit the unfused one.  bf16 is held to a bar calibrated by the
JAX package's own bf16 error (:func:`test_bf16_forward_tracks_jax_bf16`).

    python -m pytest tests/test_torch_packed.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import network as network_j
from aa_rmvsnet_tpu.models.aggregation import omega_folded as omega_folded_j
from aa_rmvsnet_tpu.ops import homography as homography_j
from aa_rmvsnet_tpu.ops import patch_sample as patch_sample_j
from aa_rmvsnet_tpu.pipeline import infer as infer_j
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    SweepConfig,
    forward,
    params_from_jax,
    pick_packed_rows,
)
from aa_rmvsnet_tpu_torch.models.aggregation import omega_folded
from aa_rmvsnet_tpu_torch.models.network import cast_model
from aa_rmvsnet_tpu_torch.ops import homography
from aa_rmvsnet_tpu_torch.ops.homography import max_depth_step_displacement
from aa_rmvsnet_tpu_torch.ops.patch_sample import (
    build_patch_table,
    build_patch_table_packed,
    patch_bilinear_sample,
    patch_bilinear_sample_packed,
)
from aa_rmvsnet_tpu_torch.pipeline import infer
from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene

from test_models import _random_scene
from test_torch_models import jax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def model(params):
    net = AARMVSNetCore()
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.eval()


def _scene(baseline: float, H=32, W=40, V=3, D=32, seed=0, depth_interval=2.5):
    """(imgs, proj, depths) of a textured plane seen by cameras ``baseline``
    apart along x; batch 1."""
    (s,) = plane_scene(H, W, V, D, maps=1, seed=seed, focal=400.0, baseline=baseline,
                       plane_depth=500.0, depth_min=425.0, depth_interval=depth_interval)
    return s["imgs"][None], s["proj_matrices"][None], s["depth_values"][None]


def _taps6_scene():
    """``test_models.py:519-540``: ``_random_scene(seed=11)`` with its
    baselines widened until the 8-hypothesis span lies in (2, 4] px."""
    imgs, proj, depths = _random_scene(seed=11)
    H, W = imgs.shape[2:4]
    for mult in (15.0, 20.0, 25.0, 30.0, 40.0):
        p_try = proj.copy()
        p_try[:, 1:, :3, 3] *= mult
        if (not network_j.pick_packed_rows(p_try[0], depths[0], H, W, 8, taps=4)
                and network_j.pick_packed_rows(p_try[0], depths[0], H, W, 8, taps=6)):
            return imgs, p_try, depths
    pytest.fail("could not construct a (2, 4] px span scene")


def _run_jax(params, scene, **config):
    return network_j.forward(params, *map(jnp.asarray, scene), network_j.SweepConfig(**config))


def _run_port(model, scene, **config):
    with torch.no_grad():
        return forward(model, *map(torch.from_numpy, scene), SweepConfig(**config))


def _assert_forward_close(out_t, out_j):
    """Cost 5e-4, confidence 1e-5, and depth 1e-3 except on near-ties
    (the JAX cost volume's top two within 1e-4), at most 0.1 % of pixels."""
    vol_j = np.asarray(out_j["cost_volume"])
    np.testing.assert_allclose(out_t["cost_volume"].numpy(), vol_j, atol=5e-4)
    np.testing.assert_allclose(out_t["photometric_confidence"].numpy(),
                               np.asarray(out_j["photometric_confidence"]), atol=1e-5)
    top2 = np.sort(vol_j, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    off = np.abs(out_t["depth"].numpy() - np.asarray(out_j["depth"])) > 1e-3
    assert not np.any(off & ~near_tie), int(np.sum(off & ~near_tie))
    assert off.sum() <= 0.001 * off.size


# (a) ------------------------------------------------------------------------

@pytest.mark.parametrize("taps", [4, 6])
def test_build_patch_table_packed_matches_jax(taps):
    feat = np.random.RandomState(taps).randn(2, 5, 7, 3).astype(np.float32)
    table_t = build_patch_table_packed(torch.from_numpy(feat), taps).numpy()
    table_j = np.asarray(patch_sample_j.build_patch_table_packed(jnp.asarray(feat), taps=taps))
    assert table_t.shape == (2, 35, taps * taps * 3)
    np.testing.assert_array_equal(table_t, table_j)


# (b) ------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["samples", "ref"])
@pytest.mark.parametrize("taps", [4, 6])
def test_patch_bilinear_sample_packed_matches_jax(taps, fused):
    """Groups of K = 5 samples spanning up to ``taps - 2`` px, anchored
    inside the image, across its borders and wholly outside it."""
    rng = np.random.RandomState(10 + taps)
    B, H, W, C, G, K = 2, 9, 11, 4, 60, 5
    feat = rng.randn(B, H, W, C).astype(np.float32)
    span = taps - 2.0
    ax = rng.uniform(-span - 3, W + 2, (B, G, 1))
    ay = rng.uniform(-span - 3, H + 2, (B, G, 1))
    ax[:, :4], ay[:, :4] = -span - 2.5, -span - 2.5  # wholly outside
    ax[:, 4:8] = -0.5 * span  # straddling the left border
    x = (ax + rng.uniform(0, span, (B, G, K))).astype(np.float32)
    y = (ay + rng.uniform(0, span, (B, G, K))).astype(np.float32)
    ref = rng.randn(B, G, C).astype(np.float32) if fused else None

    table_t = build_patch_table_packed(torch.from_numpy(feat), taps)
    out_t = patch_bilinear_sample_packed(
        table_t, torch.from_numpy(x), torch.from_numpy(y), H, W, taps=taps,
        folded_out=True, ref=None if ref is None else torch.from_numpy(ref)).numpy()
    out_j = patch_sample_j.patch_bilinear_sample_packed(
        patch_sample_j.build_patch_table_packed(jnp.asarray(feat), taps=taps),
        jnp.asarray(x), jnp.asarray(y), H, W, taps=taps, folded_out=True,
        ref=None if ref is None else jnp.asarray(ref))
    assert out_t.shape == (B, G, K * C)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=1e-5)

    # Where the span holds, the packed row gives the 2x2 sampler's samples.
    two = patch_bilinear_sample(build_patch_table(torch.from_numpy(feat)),
                                torch.from_numpy(x).reshape(B, -1),
                                torch.from_numpy(y).reshape(B, -1), H, W).numpy()
    two = two.reshape(B, G, K, C)
    if fused:
        two = (two - ref[:, :, None]) ** 2
    np.testing.assert_allclose(out_t.reshape(B, G, K, C), two, atol=1e-5)
    if not fused:
        assert np.abs(two[:, :4]).max() == 0.0 and np.abs(two[:, 4:8]).max() > 0.0


def test_packed_sampler_refuses_quantized_levers():
    """The sampler refuses what it cannot do: the fused residual without
    the folded layout, a quantized residual without the fused one, an
    unknown residual dtype, and a quantized table without its scale and
    compute dtype (no lever runs the exact path in its place)."""
    table = build_patch_table_packed(torch.zeros(1, 4, 4, 2))
    x = torch.zeros(1, 16, 2)
    ref = torch.zeros(1, 16, 2)
    with pytest.raises(ValueError, match="folded_out"):
        patch_bilinear_sample_packed(table, x, x, 4, 4, ref=ref)
    with pytest.raises(ValueError, match="need ref"):
        patch_bilinear_sample_packed(table, x, x, 4, 4, folded_out=True,
                                     residual_dtype=torch.int8)
    with pytest.raises(ValueError, match="residual_dtype"):
        patch_bilinear_sample_packed(table, x, x, 4, 4, folded_out=True, ref=ref,
                                     residual_dtype=torch.float16)
    quantized = table.to(torch.int8)
    with pytest.raises(ValueError, match="scale and a compute_dtype"):
        patch_bilinear_sample_packed(quantized, x, x, 4, 4)


# (c) ------------------------------------------------------------------------

def _gate_case(name):
    imgs, proj, depths = _scene(baseline=2.0)
    proj, depths = proj[0].copy(), depths[0].copy()
    if name == "non_monotone_sweep":
        depths[[3, 4]] = depths[[4, 3]]
    elif name == "non_monotone_spacing":
        depths = np.cumsum(np.where(np.arange(32) % 2, 1.0, 3.0)).astype(np.float32) + 425
    elif name == "behind_a_camera":
        proj[2, 2, 3] = -500.0  # the second source sits in front of the plane
    elif name == "one_depth":
        depths = depths[:1]
    return proj, depths


@pytest.mark.parametrize("name", ["plane", "non_monotone_sweep", "non_monotone_spacing",
                                  "behind_a_camera", "one_depth"])
def test_span_bound_and_gate_match_jax(name):
    proj, depths = _gate_case(name)
    args = (proj[1:], proj[0], depths, 32, 40)
    bound = max_depth_step_displacement(*args)
    assert bound == homography_j.max_depth_step_displacement(*args)
    expect = {"plane": np.isfinite(bound) and bound > 0, "one_depth": bound == 0.0}
    assert expect.get(name, bound == float("inf"))
    for block in (4, 8, 16):
        for taps in (4, 6):
            assert pick_packed_rows(proj, depths, 32, 40, block, taps=taps) == \
                network_j.pick_packed_rows(proj, depths, 32, 40, block, taps=taps)


@pytest.mark.parametrize("name", ["plane", "behind_a_camera"])
@pytest.mark.parametrize("size", [(200, 100), (3, 20000)], ids=["two_runs", "row_a_run"])
def test_span_bound_in_runs_of_rows_matches_jax(name, size):
    """Maps of more than one run of rows (the last one short, or one row
    wider than a run) give the JAX package's whole-map bound to the bit."""
    proj, depths = _gate_case(name)
    args = (proj[1:], proj[0], depths, *size)
    assert size[0] * size[1] > homography._GATE_PIXELS
    assert max_depth_step_displacement(*args) == homography_j.max_depth_step_displacement(*args)


# (d) ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2, 8])
def test_omega_folded_matches_jax_and_module(params, model, groups, dtype):
    """fp32: atol 1e-4 to JAX's ``omega_folded`` and to the port's own
    ``InterViewAA`` on each volume (measured 3e-7).  bf16: two bf16 ulps
    of a weight in [0.5, 1), 2^-7, to JAX's bf16 ``omega_folded``
    (measured one ulp)."""
    N, H, W = 2, 12, 16
    x = (np.random.RandomState(groups).randn(N, H, W, groups * 32) ** 2).astype(np.float32)
    dtype_j = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    omega_j = jax.tree.map(lambda a: jnp.asarray(a, dtype_j), params["params"]["omega"])
    w_j = np.asarray(omega_folded_j(omega_j, jnp.asarray(x, dtype_j), groups), np.float32)
    with torch.no_grad():
        xt = torch.from_numpy(x).to(dtype)
        w_t = omega_folded(cast_model(model, dtype).omega, xt, groups)
        canonical = model.omega(torch.from_numpy(x).view(N, H, W, groups, 32)
                                .permute(0, 3, 4, 1, 2).reshape(N * groups, 32, H, W))
    assert w_t.shape == (N, H, W, groups) and w_t.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-4)
        np.testing.assert_allclose(
            w_t.numpy(), canonical.view(N, groups, H, W).permute(0, 2, 3, 1).numpy(), atol=1e-4)
    else:
        np.testing.assert_allclose(w_t.float().numpy(), w_j, atol=2.0 ** -7)


# (e) ------------------------------------------------------------------------

@pytest.mark.parametrize("taps", [4, 6])
@pytest.mark.parametrize("gather_pack", [1, 2])
@pytest.mark.parametrize("packed_rows", ["auto", True, False])
def test_resolve_packed_mode_matches_jax(packed_rows, gather_pack, taps):
    """On planes seen at baselines from 2 to 90 (8-hypothesis spans from
    0.15 to 6.9 px), one for each mode that (auto, 2, 6) can pick, and on
    a sweep of 40 depths (not a multiple of 16)."""
    cfg = dict(packed_rows=packed_rows, gather_pack=gather_pack, table_taps=taps)
    got = set()
    for baseline, D in ((2.0, 32), (15.0, 32), (23.5, 32), (40.0, 32), (90.0, 32), (2.0, 40)):
        imgs, proj, depths = _scene(baseline, D=D)
        sample = {"imgs": imgs[0], "proj_matrices": proj[0], "depth_values": depths[0]}
        mode = infer.resolve_packed_mode(sample, infer.InferConfig(out_root="", **cfg))
        assert mode == infer_j.resolve_packed_mode(sample, infer_j.InferConfig(out_root="", **cfg))
        got.add(mode)
    if packed_rows == "auto" and (gather_pack, taps) == (2, 6):
        assert got == {(True, 2, 4), (True, 2, 6), (True, 1, 4), (True, 1, 6), (False, 1, 4)}, got


# (f) ------------------------------------------------------------------------

_FORWARD_CASES = {
    "packed_fused": (lambda: _random_scene(seed=7),
                     dict(depth_block=4, packed_rows=True, fused_residual=True), 4, 4),
    "gather_pack_2": (lambda: _random_scene(seed=7),
                      dict(depth_block=2, packed_rows=True, gather_pack=2), 4, 4),
    "taps_6_gather_pack_2": (_taps6_scene, dict(depth_block=4, packed_rows=True, gather_pack=2,
                                                table_taps=6, fused_residual=True), 8, 6),
    "fold_omega": (lambda: _random_scene(seed=4), dict(depth_block=4, fold_omega=True), 0, 0),
    "fold_omega_hybrid": (lambda: _random_scene(seed=4),
                          dict(depth_block=4, fold_omega="hybrid"), 0, 0),
}


@pytest.mark.parametrize("case", list(_FORWARD_CASES))
def test_forward_matches_jax(params, model, case):
    make, config, gate_block, gate_taps = _FORWARD_CASES[case]
    scene = make()
    if gate_block:  # the packed levers are exact only where the gate passes
        assert pick_packed_rows(scene[1][0], scene[2][0], 32, 32, gate_block, taps=gate_taps)
    out_t = _run_port(model, scene, **config)
    assert out_t["cost_volume"].shape == (1, 32, 32, 32)
    _assert_forward_close(out_t, _run_jax(params, scene, **config))


# (g) ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gather_pack", [1, 2])
def test_fused_residual_equals_unfused(model, gather_pack, dtype):
    scene = _random_scene(seed=7)
    config = dict(depth_block=4 // gather_pack, packed_rows=True, gather_pack=gather_pack,
                  feature_dtype=dtype)
    unfused = _run_port(model, scene, **config)
    fused = _run_port(model, scene, **config, fused_residual=True)
    assert torch.equal(fused["cost_volume"], unfused["cost_volume"])
    assert torch.equal(fused["depth"], unfused["depth"])


@pytest.mark.parametrize("config,error", [
    (dict(gather_pack=2), "requires packed_rows"),
    (dict(fused_residual=True), "requires packed_rows"),
    (dict(packed_rows=True, gather_pack=3), "not divisible"),
])
def test_invalid_sweep_configs_raise(model, config, error):
    with pytest.raises(ValueError, match=error):
        _run_port(model, _random_scene(seed=9), depth_block=2, **config)


def test_bf16_sweep_refuses_gradients(model):
    """A bf16 sweep under autograd no longer refuses: it used to run on a
    copy of the model, which no gradient reached.  It now casts the
    parameters in the graph, so the gradients reach the caller's fp32
    parameters, in fp32, and the caller's model stays fp32; without a graph
    it still runs on ``cast_model``'s copy."""
    net = AARMVSNetCore()
    net.load_state_dict(model.state_dict())
    args = list(map(torch.from_numpy, _random_scene(seed=9, D=4)))
    out = forward(net, *args, SweepConfig(depth_block=4, feature_dtype=torch.bfloat16))
    assert out["cost_volume"].dtype == torch.float32
    out["cost_volume"].sum().backward()
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
    assert net.feature.conv2[0].weight.grad.abs().max() > 0
    with torch.no_grad():
        again = forward(net, *args, SweepConfig(depth_block=4, feature_dtype=torch.bfloat16))
    torch.testing.assert_close(again["cost_volume"], out["cost_volume"].detach(), atol=0,
                               rtol=0)


# (h) ------------------------------------------------------------------------

def test_bf16_forward_tracks_jax_bf16(params, model):
    """The port's bf16 forward (default inference levers: packed rows, fused
    residual; the gate kernel's plain version, fp32 math) against JAX's
    bf16 forward with ``pallas_gates=True`` (the Pallas gate kernel in
    interpret mode, fp32 math too), on a 32x40 plane, V=3, D=32.  The bar
    is twice the JAX package's own bf16 error against its fp32 forward on
    the same scene: on the cost volume's largest difference and on the
    share of depths more than one bin apart.  Measured: JAX bf16 vs fp32
    0.0486 and 10.2 % of pixels; the port's bf16 vs JAX bf16 0.0317 and
    7.8 %.  The caller's fp32 model is left in fp32."""
    scene = _scene(baseline=2.0, W=32)
    config = dict(depth_block=8, packed_rows=True, fused_residual=True)
    assert pick_packed_rows(scene[1][0], scene[2][0], 32, 32, 8)
    j32 = _run_jax(params, scene, **config)
    j16 = _run_jax(params, scene, **config, feature_dtype=jnp.bfloat16, pallas_gates=True)
    t16 = _run_port(model, scene, **config, feature_dtype=torch.bfloat16)
    assert next(model.parameters()).dtype == torch.float32
    assert t16["cost_volume"].dtype == torch.float32

    bin_w = float(scene[2][0, 1] - scene[2][0, 0])

    def distance(a, b):
        cost = np.abs(np.asarray(a["cost_volume"], np.float32)
                      - np.asarray(b["cost_volume"], np.float32)).max()
        off = np.mean(np.abs(np.asarray(a["depth"]) - np.asarray(b["depth"])) > bin_w + 1e-6)
        return cost, off

    ref_cost, ref_off = distance(j16, j32)
    cost, off = distance({k: v.numpy() for k, v in t16.items()}, j16)
    print(f"JAX bf16 vs fp32: {ref_cost:.4f}, {ref_off:.2%}; port bf16 vs JAX bf16: "
          f"{cost:.4f}, {off:.2%}")
    assert ref_cost > 0 and ref_off > 0  # the calibration is not vacuous
    assert cost <= 2 * ref_cost, (cost, ref_cost)
    assert off <= 2 * ref_off, (off, ref_off)
