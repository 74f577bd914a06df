"""The int8 omega chain (``AA_RMVSNET_OMEGA_INT8=chain``: omega's stems and
rw2 on int8 activations too, whenever its input is int8) against the JAX
package's on the CPU.

The network is ``test_torch_models.jax_params(seed=3)`` with its three
omega GroupNorm affines drawn from a seed (weight 1 + 0.5 N(0, 1), bias 0.3
N(0, 1)): at JAX's init they are 1 and 0, and every channel's static
bound would be 8.  Omega's parameters are cast to bf16, as in JAX's own
chain test (``tests/test_models.py:604-635``), whose inputs these are: G=8
volumes of ``(2, 24, 32)`` squared normals quantized with a per-channel
scale.

- Each int8 stage (rw0, stem0, stem1, rw2) takes the same integer kernel
  as JAX's, bit for bit, and the same int8 activations, except where a
  GroupNorm statistic, summed in another order, moves one across a
  rounding boundary: >= 99.9 % of them equal and none off by more than 1
  (measured: all equal with bf16 parameters, 1 and 3 of 49,152 with
  fp32 ones).  On the port's activations its integer sum (a float64
  convolution, exact for these integers) equals JAX's int32 convolution
  of the same operands, and the port's bf16 result is that sum rounded
  once.
- The sigmoid weights within 2^-7 of JAX's with bf16 parameters, two bf16
  ulps of a weight in [0.5, 1), the bar of the base int8 path
  (``test_torch_quant.py``), and within 2^-6 with fp32 ones, whose
  activations are not all JAX's.  Measured: 2^-8 and 2^-7, 74 % bit for
  bit.
- Chain against base within JAX's own bars: mean < 0.03, max < 0.25.
- A non-int8 input ignores the switch; the chain on two spatial ranks
  (gloo subprocesses, the slab's rw0 halo and GroupNorm all-reduces) keeps
  its int8 stages equal to the whole map's except where a GroupNorm
  statistic, summed in another order, moves an activation across a
  rounding boundary: >= 99.9 % of each stage's activations equal, none off
  by more than 1, the weights within 2^-6.
- The JAX package's claim for the chain (``tests/test_models.py:609-612``):
  the dual residual's guardrail still holds with it on, >= 90 % of pixels
  and >= 99 % of the confident ones within one bin of the exact packed
  path, on ``test_torch_quant_pipeline.py``'s scene and
  ``matching_model(sharpness=1000)`` weights (the port alone: JAX's
  guardrail needs its absent checkpoint).
- One ``run_inference`` map with the dual residual, fp8 tables and the
  chain against JAX's: ``test_torch_quant.py``'s bars for a lever against
  JAX's same lever, >= 99 % of depths within one bin and confidence atol
  2e-4; both packages are seen to run the chain (their int8 convolutions
  counted).

JAX reads the switch while it traces, and ``jax.jit`` caches a trace by
function: the JAX calls here run eagerly or after ``jax.clear_caches()``.

    python -m pytest tests/test_torch_omega_chain.py -q
"""

import json
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.core.pfm import read_pfm
from aa_rmvsnet_tpu.data.eval_dataset import EvalDataset as EvalDatasetJ
from aa_rmvsnet_tpu.models.aggregation import omega_folded as omega_folded_j
from aa_rmvsnet_tpu.pipeline.infer import InferConfig as InferConfigJ
from aa_rmvsnet_tpu.pipeline.infer import run_inference as run_inference_j
from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, aggregation, params_from_jax
from aa_rmvsnet_tpu_torch.models.aggregation import omega_folded
from aa_rmvsnet_tpu_torch.models.network import cast_model
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

from scenefix import make_plane_scene
from test_torch_models import jax_params
from test_torch_quant_pipeline import GUARD_BIN, GUARD_D, GUARD_V, guard  # noqa: F401
from test_torch_parallel import _free_port, _start_ranks

torch.set_num_threads(2)

SWITCH = "AA_RMVSNET_OMEGA_INT8"
G = 8
H, W, V, D = 32, 40, 3, 8  # the run_inference map
WEIGHT_BARS = {"bf16": 2.0 ** -7, "fp32": 2.0 ** -6}

# One rank of two under make_mesh(spatial=2): omega_folded with the chain
# on its slab of the input's rows, its int8 stages' inputs recorded.
WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    os.environ["AA_RMVSNET_OMEGA_INT8"] = "chain"
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, aggregation
    from aa_rmvsnet_tpu_torch.models.network import cast_model
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh, spatial_rows

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    mesh = make_mesh(spatial=2, device="cpu")
    model = AARMVSNetCore()
    model.load_state_dict(torch.load(a["weights"], weights_only=True))
    data = np.load(a["inputs"])
    row0, rows = spatial_rows(mesh, data["x"].shape[1])
    stages, conv = [], aggregation.int8_conv

    def spy(x, *args):
        stages.append(x.clone())
        return conv(x, *args)

    aggregation.int8_conv = spy
    with torch.no_grad():
        w = aggregation.omega_folded(cast_model(model, torch.bfloat16).omega,
                                     torch.from_numpy(data["x"][:, row0:row0 + rows]),
                                     a["groups"], torch.from_numpy(data["scale"]), mesh=mesh)
    torch.save({"w": w, "stages": stages}, a["out"])
    torch.distributed.destroy_process_group()
""")


def _omega_tree():
    tree = jax_params(seed=3)
    rng = np.random.RandomState(7)
    omega = tree["params"]["omega"]
    for gn in (omega["rw0"]["gn"], omega["rw1"]["stem0"]["gn"], omega["rw1"]["gn"]):
        gn["scale"] = (1.0 + 0.5 * rng.randn(*gn["scale"].shape)).astype(np.float32)
        gn["bias"] = (0.3 * rng.randn(*gn["bias"].shape)).astype(np.float32)
    return tree


def _inputs():
    """``tests/test_models.py:620-630``'s int8 residual and its scale."""
    rng = np.random.RandomState(0)
    raw = (rng.randn(2, 24, 32, G * 32) ** 2).astype(np.float32)
    scale = (np.abs(rng.randn(32)) * 0.1 + 0.05).astype(np.float32)
    xq = np.clip(np.round(raw / np.tile(scale, G)), 0, 127).astype(np.int8)
    return xq, scale


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The spatial ranks, started first; the model and the inputs."""
    root = tmp_path_factory.mktemp("chain")
    tree = _omega_tree()
    model = AARMVSNetCore()
    model.load_state_dict(params_from_jax(tree))
    xq, scale = _inputs()
    torch.save(model.state_dict(), root / "weights.pt")
    np.savez(root / "inputs.npz", x=xq, scale=scale)
    port, argvs, outs = _free_port(), [], []
    for rank in range(2):
        out = str(root / f"rank{rank}.pt")
        args = dict(port=port, rank=rank, groups=G, weights=str(root / "weights.pt"),
                    inputs=str(root / "inputs.npz"), out=out)
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    wait = _start_ranks(argvs)

    def ranks():
        wait()
        return [torch.load(out, weights_only=False) for out in outs]

    return root, tree, model, xq, scale, ranks


class _Stages:
    """Records each int8 convolution: JAX's ``conv_general_dilated`` with
    an int32 result (its int8 input, block-diagonal kernel and int32
    sum), the port's ``int8_conv`` (its int8 input, grouped kernel and
    bf16 result)."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        conv_j, conv_t = jax.lax.conv_general_dilated, aggregation.int8_conv

        def spy_j(lhs, rhs, *args, **kwargs):
            out = conv_j(lhs, rhs, *args, **kwargs)
            if kwargs.get("preferred_element_type") == jnp.int32:
                # The stage's operands, and its convolution of others.
                self.jax.append((np.asarray(lhs), np.asarray(rhs),
                                 lambda x, rhs=rhs, a=args, k=kwargs: np.asarray(
                                     conv_j(jnp.asarray(x), rhs, *a, **k))))
            return out

        def spy_t(x, weight, padding, groups):
            out = conv_t(x, weight, padding, groups)
            self.port.append((x.clone(), weight.clone(), out, padding, groups))
            return out

        monkeypatch.setattr(jax.lax, "conv_general_dilated", spy_j)
        monkeypatch.setattr(aggregation, "int8_conv", spy_t)


def _block_diag(weight: np.ndarray, groups: int) -> np.ndarray:
    """The port's grouped ``(G*cout, cin, kh, kw)`` kernel as JAX's dense
    block-diagonal ``(kh, kw, G*cin, G*cout)`` one."""
    cout, cin = weight.shape[0] // groups, weight.shape[1]
    out = np.zeros(weight.shape[2:] + (groups * cin, groups * cout), np.float32)
    for g in range(groups):
        out[:, :, g * cin:(g + 1) * cin, g * cout:(g + 1) * cout] = \
            weight[g * cout:(g + 1) * cout].transpose(2, 3, 1, 0)
    return out


def _run_both(tree, model, xq, scale, dtype_j, dtype_t):
    omega_j = jax.tree.map(lambda a: jnp.asarray(a, dtype_j), tree["params"]["omega"])
    w_j = omega_folded_j(omega_j, jnp.asarray(xq), G, input_scale=jnp.asarray(scale))
    with torch.no_grad():
        w_t = omega_folded(cast_model(model, dtype_t).omega, torch.from_numpy(xq), G,
                           torch.from_numpy(scale))
    return np.asarray(w_j, np.float32), w_t


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_chain_stages_and_weights_match_jax(setup, monkeypatch, dtype):
    """Omega's parameters in bf16 (JAX's chain test) or fp32 (an fp32 sweep
    with an int8 residual): the chain computes in bf16 either way."""
    _, tree, model, xq, scale, _ = setup
    dtype_j, dtype_t = {"bf16": (jnp.bfloat16, torch.bfloat16),
                        "fp32": (jnp.float32, torch.float32)}[dtype]
    monkeypatch.setenv(SWITCH, "chain")
    stages = _Stages(monkeypatch)
    w_j, w_t = _run_both(tree, model, xq, scale, dtype_j, dtype_t)
    assert len(stages.jax) == len(stages.port) == 4  # rw0, stem0, stem1, rw2
    for i, ((x_j, k_j, conv_j), (x_t, k_t, out_t, padding, groups)) in enumerate(
            zip(stages.jax, stages.port)):
        assert x_t.dtype == torch.int8 and x_j.dtype == np.int8
        x_t = x_t.permute(0, 2, 3, 1).numpy()
        diff = np.abs(x_t.astype(np.int32) - x_j)
        print(f"stage {i}: {(diff > 0).sum()} of {diff.size} activations off JAX's")
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, f"stage {i} input"
        assert np.array_equal(_block_diag(k_t.numpy(), groups), k_j.astype(np.float32)), \
            f"stage {i} kernel"
        exact = torch.nn.functional.conv2d(torch.from_numpy(x_t).permute(0, 3, 1, 2).double(),
                                           k_t.double(), padding=padding, groups=groups)
        sum_j = conv_j(x_t)
        assert sum_j.dtype == np.int32
        assert np.array_equal(exact.permute(0, 2, 3, 1).numpy(), sum_j.astype(np.float64)), \
            f"stage {i} integer sum"
        assert torch.equal(out_t, exact.float().to(torch.bfloat16)), f"stage {i} rounding"
    assert w_t.shape == (2, 24, 32, G) and w_t.dtype == torch.bfloat16
    err = np.abs(w_t.float().numpy() - w_j)
    print(f"chain ({dtype} parameters) against JAX's: max {err.max():.3g}, "
          f"{(err == 0).mean():.2%} bit for bit")
    assert err.max() <= WEIGHT_BARS[dtype], err.max()


def test_chain_against_base_within_jax_bars(setup, monkeypatch):
    """``tests/test_models.py:632-635``: chain against the base int8 path,
    mean < 0.03, max < 0.25, in the port as in JAX."""
    _, tree, model, xq, scale, _ = setup
    base_j, base_t = _run_both(tree, model, xq, scale, jnp.bfloat16, torch.bfloat16)
    monkeypatch.setenv(SWITCH, "chain")
    chain_j, chain_t = _run_both(tree, model, xq, scale, jnp.bfloat16, torch.bfloat16)
    for name, d in (("JAX", np.abs(chain_j - base_j)),
                    ("port", np.abs(chain_t.float().numpy() - base_t.float().numpy()))):
        print(f"{name}: chain against base mean {d.mean():.4g}, max {d.max():.4g}")
        assert 0 < d.mean() < 0.03, (name, d.mean())
        assert d.max() < 0.25, (name, d.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_switch_leaves_non_int8_inputs_alone(setup, monkeypatch, dtype):
    _, _, model, xq, scale, _ = setup
    x = torch.from_numpy(xq.astype(np.float32)).to(dtype)
    omega = cast_model(model, dtype).omega
    with torch.no_grad():
        base = omega_folded(omega, x, G, torch.from_numpy(scale))
        monkeypatch.setenv(SWITCH, "chain")
        chain = omega_folded(omega, x, G, torch.from_numpy(scale))
    assert chain.dtype == dtype and torch.equal(chain, base)


def test_chain_on_a_spatial_mesh(setup, monkeypatch):
    """Two gloo ranks, a slab of 12 rows each, against the whole map."""
    _, _, model, xq, scale, ranks = setup
    monkeypatch.setenv(SWITCH, "chain")
    stages = _Stages(monkeypatch)
    with torch.no_grad():
        whole = omega_folded(cast_model(model, torch.bfloat16).omega, torch.from_numpy(xq), G,
                             torch.from_numpy(scale))
    got = ranks()
    w = torch.cat([r["w"] for r in got], dim=1)
    assert w.shape == whole.shape and w.dtype == torch.bfloat16
    for i, (x_whole, *_) in enumerate(stages.port):
        if i == 0:  # rw0 reads the slab with its halo: compare the slabs' own rows
            x_split = torch.cat([r["stages"][0][..., 1:-1, :] for r in got], dim=-2)
        else:
            x_split = torch.cat([r["stages"][i] for r in got], dim=-2)
        diff = (x_split.int() - x_whole.int()).abs()
        print(f"stage {i}: {(diff == 0).float().mean().item():.5%} of activations equal")
        assert diff.max().item() <= 1, i
        assert (diff == 0).float().mean().item() >= 0.999, i
    err = (w.float() - whole.float()).abs().max().item()
    print(f"weights: max {err:.3g}")
    assert err <= 2.0 ** -6


def test_guardrail_dual_residual_with_the_chain(guard, monkeypatch):
    _, _, run, base_depth, confident = guard
    monkeypatch.setenv(SWITCH, "chain")
    counted = []
    conv = aggregation.int8_conv
    monkeypatch.setattr(aggregation, "int8_conv", lambda *a: counted.append(1) or conv(*a))
    depth, _ = run(packed_rows=True, table_dtype=torch.float8_e4m3fn, residual_dtype="dual")
    # rw0, stem0, stem1 and rw2 for each source view and depth block of 4.
    assert len(counted) == 4 * (GUARD_V - 1) * (GUARD_D // 4)
    within = np.abs(depth - base_depth) <= GUARD_BIN + 1e-6
    print(f"dual residual with the chain: {within.mean():.4%} within one bin, "
          f"{within[confident].mean():.4%} of the {confident.mean():.2%} confident pixels")
    assert within.mean() >= 0.90, within.mean()
    assert within[confident].mean() >= 0.99, within[confident].mean()


def _count_int8_convs(monkeypatch) -> list:
    """Counts the int8 convolutions each package traces or runs."""
    counts = [0, 0]
    conv_j, conv_t = jax.lax.conv_general_dilated, aggregation.int8_conv

    def spy_j(lhs, rhs, *args, **kwargs):
        counts[0] += kwargs.get("preferred_element_type") == jnp.int32
        return conv_j(lhs, rhs, *args, **kwargs)

    def spy_t(*args):
        counts[1] += 1
        return conv_t(*args)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy_j)
    monkeypatch.setattr(aggregation, "int8_conv", spy_t)
    return counts


def test_run_inference_dual_residual_chain_tracks_jax(setup, monkeypatch, tmp_path):
    """One 32x40 map (V=3, D=8, depth block 4, fp32, packed rows, fp8
    tables, the dual residual) with the chain, in both packages."""
    _, tree, model, _, _, _ = setup
    make_plane_scene(str(tmp_path), H=H, W=W, num_views=V, focal=200.0)
    monkeypatch.setenv(SWITCH, "chain")
    jax.clear_caches()
    counts = _count_int8_convs(monkeypatch)
    run_inference_j(tree, [EvalDatasetJ(str(tmp_path), ["scan1"], nviews=V, ndepths=D,
                                        max_h=H, max_w=W)[0]],
                    InferConfigJ(out_root=str(tmp_path / "jax"), depth_block=4,
                                 feature_dtype=np.float32, num_workers=0, packed_rows=True,
                                 table_dtype=jnp.float8_e4m3fn, residual_dtype="dual"),
                    progress=False)
    sample = EvalDataset(str(tmp_path), ["scan1"], nviews=V, ndepths=D, max_h=H, max_w=W)[0]
    stats = run_inference(model, [sample], InferConfig(
        out_root=str(tmp_path / "port"), depth_block=4, feature_dtype=torch.float32,
        num_workers=0, packed_rows=True, table_dtype=torch.float8_e4m3fn,
        residual_dtype="dual", device="cpu"), progress=False)
    jax.clear_caches()
    # JAX traces omega once per trace (4 int8 convolutions); the port runs
    # them for each of the 2 source views and each of the 2 depth blocks.
    assert counts[0] >= 4 and counts[0] % 4 == 0, counts
    assert counts[1] == 4 * (V - 1) * (D // 4), counts
    assert stats["modes"] == [(True, 1, 4)]
    maps = {}
    for side in ("jax", "port"):
        maps[side] = [read_pfm(str(tmp_path / side / "scan1" / family / "00000000.pfm"))[0]
                      for family in ("depth_est_0", "confidence_0")]
    bin_w = float(sample["depth_values"][1] - sample["depth_values"][0])
    within = np.abs(maps["port"][0] - maps["jax"][0]) <= bin_w + 1e-6
    conf = np.abs(maps["port"][1] - maps["jax"][1]).max()
    print(f"dual residual + chain: {within.mean():.4%} of depths within one bin of JAX's, "
          f"confidence {conf:.2e}")
    assert within.mean() >= 0.99, within.mean()
    assert conf <= 2e-4, conf
