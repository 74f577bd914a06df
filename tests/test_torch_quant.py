"""The port's quantized levers (fp8 / int8 warp tables, the int8 blend,
fp8 / int8 / dual residuals, omega's int8 rw0) against the JAX package's
on the CPU.

Weights come from ``test_torch_models.jax_params`` through
``params_from_jax``, so both packages run the same network.

- Tables and scales equal JAX's bit for bit.
- The samplers meet atol 1e-6 plus rtol 1e-6 in fp32, one fp32 ulp at
  their magnitude; the int8 blend is bit for bit.
- The int8 blend and the int8 rw0 convolution are exact at their integer
  bounds.
- Omega is held at the bars of ``test_torch_packed.py``.
- The whole forward with each lever meets two bars against JAX's same
  lever: >= 99 % of depths within one bin, and confidence atol 2e-4.
  Measured: >= 99.5 % and 4.7e-5.  An fp8 cast turns the ~1e-6 feature
  differences of two fp32 implementations into a whole fp8 step where a
  value sits on a rounding boundary.
- The fused residual equals the unfused one bit for bit.

The guardrails, refusals, the drop warning and the CLI are in
``test_torch_quant_pipeline.py``.

    python -m pytest tests/test_torch_quant.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import network as network_j
from aa_rmvsnet_tpu.models.aggregation import omega_folded as omega_folded_j
from aa_rmvsnet_tpu.ops import patch_sample as patch_sample_j
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    SweepConfig,
    forward,
    params_from_jax,
    pick_packed_rows,
)
from aa_rmvsnet_tpu_torch.models.aggregation import int8_conv, omega_folded
from aa_rmvsnet_tpu_torch.models.network import cast_model
from aa_rmvsnet_tpu_torch.ops.patch_sample import (
    build_patch_table_packed_quant,
    int8_blend,
    patch_bilinear_sample,
    patch_bilinear_sample_packed,
)

from test_models import _random_scene
from test_torch_models import jax_params

torch.set_num_threads(2)

F8 = (jnp.float8_e4m3fn, torch.float8_e4m3fn)
I8 = (jnp.int8, torch.int8)
DUAL = ("dual", "dual")
TABLES = {"fp8": F8, "int8": I8}
RESIDUALS = {"fp8": F8, "int8": I8, "dual": DUAL}
COMPUTE = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def model(params):
    net = AARMVSNetCore()
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.eval()


def _bits(a) -> np.ndarray:
    """The values of a JAX or torch array, fp8 and bf16 as their raw bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    if a.dtype == jnp.bfloat16:
        return np.asarray(a.view(jnp.uint16))
    return np.asarray(a.view(jnp.uint8) if a.dtype == jnp.float8_e4m3fn else a)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# (a) tables -----------------------------------------------------------------

@pytest.mark.parametrize("taps", [2, 4, 6])
@pytest.mark.parametrize("kind", list(TABLES))
def test_quantized_tables_match_jax_bit_for_bit(kind, taps):
    dtype_j, dtype_t = TABLES[kind]
    feat = (np.random.RandomState(taps).randn(2, 5, 7, 3) * 3).astype(np.float32)
    table_t, scale_t = build_patch_table_packed_quant(torch.from_numpy(feat), dtype_t, taps)
    table_j, scale_j = patch_sample_j.build_patch_table_packed_quant(
        jnp.asarray(feat), dtype_j, taps=taps)
    assert table_t.dtype == dtype_t and table_t.shape == (2, 35, taps * taps * 3)
    assert scale_t.shape == (2, 1, taps * taps * 3)
    np.testing.assert_array_equal(_bits(table_t), _bits(table_j))
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))


def test_fp8_table_amax_lands_on_448():
    """Each channel's amax, on one pixel, quantizes to exactly +-448 in
    both packages, over 4,096 channels whose amax spans 1e-6 to 1e6: torch
    saturates casts past 448 where JAX gives NaN from 464 up, so a scale
    that overshot would show here as NaN in JAX's table."""
    rng = np.random.RandomState(0)
    C = 4096
    amax = (10.0 ** rng.uniform(-6, 6, C)).astype(np.float32)
    feat = (rng.uniform(-1, 1, (1, 3, 4, C)) * amax).astype(np.float32)
    feat[0, 1, 2] = amax * np.where(rng.rand(C) < 0.5, -1, 1)  # the amax pixel
    table_t, _ = build_patch_table_packed_quant(torch.from_numpy(feat), F8[1], taps=2)
    table_j, _ = patch_sample_j.build_patch_table_packed_quant(jnp.asarray(feat), F8[0], taps=2)
    values_j = _np(table_j)
    assert not np.isnan(values_j).any()
    np.testing.assert_array_equal(_bits(table_t), _bits(table_j))
    at_amax = np.abs(table_t[0, 1 * 4 + 2, :C].float().numpy())  # tap (0, 0) of the pixel
    assert np.all(at_amax == 448.0) and np.abs(values_j).max() == 448.0


# (b) samplers ---------------------------------------------------------------

def _groups(taps, seed=3, B=2, H=9, W=11, C=4, G=60, K=5):
    """Features, K-sample groups spanning up to ``taps - 2`` px (inside the
    image, across its borders, outside it), reference features, and the
    sweep's shared residual scale for them at fp8's 448."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    span = taps - 2.0
    ax = rng.uniform(-span - 3, W + 2, (B, G, 1))
    ay = rng.uniform(-span - 3, H + 2, (B, G, 1))
    x = (ax + rng.uniform(0, span, (B, G, K))).astype(np.float32)
    y = (ay + rng.uniform(0, span, (B, G, K))).astype(np.float32)
    ref = rng.randn(B, G, C).astype(np.float32)
    a = np.maximum(np.abs(feat).max(axis=(0, 1, 2)), np.abs(ref).max(axis=(0, 1)))
    return feat, x, y, ref, (2 * a) ** 2


@pytest.mark.parametrize("kind", list(TABLES))
def test_patch_bilinear_sample_with_scale_matches_jax(kind):
    dtype_j, dtype_t = TABLES[kind]
    feat, x, y, _, _ = _groups(4)
    B, H, W = feat.shape[:3]
    table_t, scale_t = build_patch_table_packed_quant(torch.from_numpy(feat), dtype_t, 2)
    table_j, scale_j = patch_sample_j.build_patch_table_quant(jnp.asarray(feat), dtype_j)
    out_t = patch_bilinear_sample(table_t, torch.from_numpy(x).reshape(B, -1),
                                  torch.from_numpy(y).reshape(B, -1), H, W, scale=scale_t,
                                  compute_dtype=torch.float32)
    out_j = patch_sample_j.patch_bilinear_sample(
        table_j, jnp.asarray(x.reshape(B, -1)), jnp.asarray(y.reshape(B, -1)), H, W,
        scale=scale_j, compute_dtype=jnp.float32)
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="compute_dtype"):
        patch_bilinear_sample(table_t, torch.from_numpy(x).reshape(B, -1),
                              torch.from_numpy(y).reshape(B, -1), H, W)


def _packed_pair(kind, residual, compute, taps=4):
    dtype_j, dtype_t = TABLES[kind]
    cj, ct = COMPUTE[compute]
    feat, x, y, ref, span2 = _groups(taps)
    H, W = feat.shape[1:3]
    table_t, scale_t = build_patch_table_packed_quant(torch.from_numpy(feat), dtype_t, taps)
    table_j, scale_j = patch_sample_j.build_patch_table_packed_quant(
        jnp.asarray(feat), dtype_j, taps=taps)
    kw_t = dict(taps=taps, folded_out=True, scale=scale_t, compute_dtype=ct)
    kw_j = dict(taps=taps, folded_out=True, scale=scale_j, compute_dtype=cj)
    if residual != "samples":
        kw_t["ref"], kw_j["ref"] = torch.from_numpy(ref), jnp.asarray(ref)
    if residual in RESIDUALS:
        rd_j, rd_t = RESIDUALS[residual]
        inv = (1.0 / (span2 / (127.0 if residual == "int8" else 448.0))).astype(np.float32)
        kw_t.update(residual_inv_scale=torch.from_numpy(inv), residual_dtype=rd_t)
        kw_j.update(residual_inv_scale=jnp.asarray(inv), residual_dtype=rd_j)
    out_t = patch_bilinear_sample_packed(table_t, torch.from_numpy(x), torch.from_numpy(y),
                                         H, W, **kw_t)
    out_j = patch_sample_j.patch_bilinear_sample_packed(
        table_j, jnp.asarray(x), jnp.asarray(y), H, W, **kw_j)
    return out_t, out_j


@pytest.mark.parametrize("residual", ["samples", "residual", "fp8", "int8", "dual"])
@pytest.mark.parametrize("kind", list(TABLES))
def test_packed_sampler_quantized_matches_jax(kind, residual):
    """fp32 compute.  Samples and the unquantized residual: atol 1e-6 plus
    rtol 1e-6 (measured 1.9e-6 at values near 19, an fp32 ulp: the fp8
    path's product sums in another order); bit for bit from an int8 table.
    A quantized residual: bit for bit from an int8 table; from an fp8
    table each value within one quantization step of JAX's, and the
    values that differ (a 1e-6 move across a rounding boundary) under 1 %.
    The quantized values stay within [0, 448] (fp8) and [0, 127] (int8)."""
    out_t, out_j = _packed_pair(kind, residual, "fp32")
    pairs = list(zip(out_t, out_j)) if residual == "dual" else [(out_t, out_j)]
    assert isinstance(out_t, tuple) == (residual == "dual")
    for t, j in pairs:
        assert t.shape == (2, 60, 5 * 4) and _bits(t).dtype == _bits(j).dtype
        if kind == "int8":
            np.testing.assert_array_equal(_bits(t), _bits(j))
        elif residual in ("samples", "residual"):
            np.testing.assert_allclose(_np(t), _np(j), atol=1e-6, rtol=1e-6)
        else:
            vt, vj = _np(t), _np(j)
            step = np.where(vj > 0, 2.0 ** (np.floor(np.log2(np.maximum(vj, 2.0 ** -6))) - 3), 1.0)
            if t.dtype == torch.int8:
                step = np.ones_like(vj)
            assert np.all(np.abs(vt - vj) <= step), np.abs(vt - vj).max()
            assert np.mean(vt != vj) < 0.01
        if t.dtype == torch.float8_e4m3fn:
            assert 0.0 <= _np(t).min() and _np(t).max() <= 448.0
        if t.dtype == torch.int8:
            assert 0 <= t.min() and t.max() <= 127


@pytest.mark.parametrize("residual", ["samples", "dual"])
def test_packed_sampler_int8_blend_bf16_matches_jax(residual):
    """The production stack's sampler (int8 table, bf16 compute, dual
    residual at taps 6): bit for bit, since the int8 blend is exact."""
    out_t, out_j = _packed_pair("int8", residual, "bf16", taps=6)
    for t, j in (zip(out_t, out_j) if residual == "dual" else [(out_t, out_j)]):
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_blend_is_exact_at_its_bound(out_dtype):
    """36 taps of 127 against rows of +-127 sum to +-580,644, the bound, and
    random ones to everything below it: the result is the int64 sum,
    rounded once to ``out_dtype``.  The CPU's int8 ``bmm`` wraps around,
    which is why the blend does not use it."""
    rng = np.random.RandomState(0)
    N, K, T2, C = 64, 8, 36, 32
    w = rng.randint(0, 128, (N, K, T2)).astype(np.int64)
    rows = rng.randint(-127, 128, (N, T2, C)).astype(np.int64)
    w[0], rows[0] = 127, 127
    w[1], rows[1] = 127, -127
    exact = np.einsum("nkt,ntc->nkc", w, rows)
    assert exact.max() == 580_644 and exact.min() == -580_644
    out = int8_blend(torch.from_numpy(w).float(), torch.from_numpy(rows).to(torch.int8),
                     out_dtype)
    assert out.dtype == out_dtype
    assert torch.equal(out, torch.from_numpy(exact).to(out_dtype))
    wrapped = torch.bmm(torch.from_numpy(w[:2]).to(torch.int8),
                        torch.from_numpy(rows[:2]).to(torch.int8))
    assert wrapped.dtype == torch.int8


def test_int8_conv_is_exact_at_its_bound():
    """The grouped 3x3 convolution of omega's int8 rw0 on int8 input: an
    interior sum of 9 x 32 x 127 x 127 = 4,645,152 (the bound) and random
    ones, equal to the float64 (integer-exact) convolution rounded once to
    bf16."""
    rng = np.random.RandomState(1)
    G, N, H, W = 2, 1, 12, 10
    x = rng.randint(0, 128, (N, G * 32, H, W)).astype(np.float64)
    k = rng.randint(-127, 128, (G * 4, 32, 3, 3)).astype(np.float64)
    x[:, :32, 3:6, 3:6] = 127
    k[0] = 127
    exact = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(k), padding=1,
                                       groups=G)
    assert exact.max().item() == 4_645_152
    out = int8_conv(torch.from_numpy(x).to(torch.int8), torch.from_numpy(k), 1, G)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, exact.float().to(torch.bfloat16))


# (c) omega ------------------------------------------------------------------

def _residual_input(groups, seed=0, N=2, H=12, W=16):
    rng = np.random.RandomState(seed)
    raw = (rng.randn(N, H, W, groups * 32) ** 2).astype(np.float32)
    scale = (np.abs(rng.randn(32)) * 0.1 + 0.05).astype(np.float32)
    q = np.clip(np.round(raw / np.tile(scale, groups)), 0, 127).astype(np.int8)
    return raw, scale, q


@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("case", ["fp32", "bf16", "int8_fp32_model", "int8_bf16_model"])
def test_omega_folded_input_scale_matches_jax(params, model, case, groups):
    """``input_scale`` folded into rw0's kernel, against JAX's
    ``omega_folded`` on the same parameters in the same dtype: fp32 atol
    1e-4, bf16 two bf16 ulps of a weight in [0.5, 1), 2^-7
    (``test_torch_packed.py``'s bars).  On int8 input both run omega's
    int8 rw0 and then bf16 (held at the bf16 bar), also for fp32
    parameters."""
    raw, scale, q = _residual_input(groups)
    dtype = torch.bfloat16 if case.endswith("bf16") or case.endswith("bf16_model") \
        else torch.float32
    dtype_j = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    omega_j = jax.tree.map(lambda a: jnp.asarray(a, dtype_j), params["params"]["omega"])
    x = q if case.startswith("int8") else raw / np.tile(scale, groups)
    w_j = omega_folded_j(omega_j, jnp.asarray(x, jnp.int8 if case.startswith("int8") else dtype_j),
                         groups, input_scale=jnp.asarray(scale))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        xt = xt if case.startswith("int8") else xt.to(dtype)
        w_t = omega_folded(cast_model(model, dtype).omega, xt, groups, torch.from_numpy(scale))
    out_dtype = torch.bfloat16 if case.startswith("int8") else dtype
    assert w_t.shape == (2, 12, 16, groups) and w_t.dtype == out_dtype
    assert np.asarray(w_j).dtype == jnp.dtype(
        jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32)
    atol = 1e-4 if out_dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(w_t.float().numpy(), np.asarray(w_j, np.float32), atol=atol)


def test_omega_input_scale_folds_exactly(model):
    """``omega_folded(o, q, G, s)`` equals ``omega_folded(o, q * tile(s),
    G)`` in fp32 (atol 1e-6): the scale only moves into the kernel."""
    raw, scale, _ = _residual_input(4, seed=5)
    q = raw / np.tile(scale, 4)
    with torch.no_grad():
        a = omega_folded(model.omega, torch.from_numpy(q * np.tile(scale, 4)), 4)
        b = omega_folded(model.omega, torch.from_numpy(q), 4, torch.from_numpy(scale))
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


def test_int8_omega_computes_in_bf16_in_an_fp32_sweep(model, monkeypatch):
    """An fp32 sweep with an int8 residual runs omega after rw0 in bf16
    (each of its GroupNorms sees bf16), as the JAX package does, and the
    variance then promotes to fp32; with an fp8 residual omega stays fp32."""
    from aa_rmvsnet_tpu_torch.models import aggregation

    seen = []
    group_norm = aggregation._group_norm_folded

    def spy(x, gn, groups, mesh=None):
        seen.append(x.dtype)
        return group_norm(x, gn, groups, mesh)

    monkeypatch.setattr(aggregation, "_group_norm_folded", spy)
    scene = [torch.from_numpy(a) for a in _random_scene(seed=9, D=8)]
    with torch.no_grad():
        out = forward(model, *scene, SweepConfig(depth_block=4, packed_rows=True,
                                                 residual_dtype=torch.int8))
        assert seen and set(seen) == {torch.bfloat16}
        assert out["cost_volume"].dtype == torch.float32
        seen.clear()
        forward(model, *scene, SweepConfig(depth_block=4, packed_rows=True,
                                           residual_dtype=torch.float8_e4m3fn))
    assert seen and set(seen) == {torch.float32}
    assert next(model.parameters()).dtype == torch.float32


# (d) the whole forward ------------------------------------------------------

_LEVERS = {
    "fp8_tables_unpacked": dict(table_dtype=F8),
    "int8_tables_packed": dict(packed_rows=True, table_dtype=I8),
    "fp8_residual": dict(packed_rows=True, table_dtype=F8, residual_dtype=F8),
    "int8_residual": dict(packed_rows=True, table_dtype=F8, residual_dtype=I8),
    "dual_residual": dict(packed_rows=True, table_dtype=F8, residual_dtype=DUAL),
    "fp8_residual_fold_omega": dict(fold_omega=True, residual_dtype=F8),
}


def _split(config: dict) -> tuple[dict, dict]:
    """A lever's settings for JAX and for the port."""
    pick = lambda i: {k: v[i] if isinstance(v, tuple) else v for k, v in config.items()}
    return pick(0), pick(1)


@pytest.mark.parametrize("lever", list(_LEVERS))
def test_forward_lever_matches_jax(params, model, lever):
    scene = _random_scene(seed=7)
    assert pick_packed_rows(scene[1][0], scene[2][0], 32, 32, 4)
    cfg_j, cfg_t = _split(dict(depth_block=4, **_LEVERS[lever]))
    out_j = network_j.forward(params, *map(jnp.asarray, scene), network_j.SweepConfig(**cfg_j))
    with torch.no_grad():
        out_t = forward(model, *map(torch.from_numpy, scene), SweepConfig(**cfg_t))
    bin_w = float(scene[2][0, 1] - scene[2][0, 0])
    within = np.abs(out_t["depth"].numpy() - np.asarray(out_j["depth"])) <= bin_w + 1e-6
    conf = np.abs(out_t["photometric_confidence"].numpy()
                  - np.asarray(out_j["photometric_confidence"])).max()
    print(f"{lever}: {within.mean():.4%} of depths within one bin of JAX's, confidence "
          f"{conf:.2e}")
    assert within.mean() >= 0.99, within.mean()
    assert conf <= 2e-4, conf


@pytest.mark.parametrize("pack,residual", [(1, None), (1, "fp8"), (2, "fp8"), (2, "dual"),
                                           (2, "int8")])
def test_fused_residual_equals_unfused_with_each_residual_dtype(model, pack, residual):
    scene = _random_scene(seed=7)
    config = dict(depth_block=4 // pack, packed_rows=True, gather_pack=pack,
                  residual_dtype=None if residual is None else RESIDUALS[residual][1])
    with torch.no_grad():
        unfused = forward(model, *map(torch.from_numpy, scene), SweepConfig(**config))
        fused = forward(model, *map(torch.from_numpy, scene),
                        SweepConfig(**config, fused_residual=True))
    assert torch.equal(fused["cost_volume"], unfused["cost_volume"])
    assert torch.equal(fused["depth"], unfused["depth"])
