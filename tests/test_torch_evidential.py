"""The PyTorch port's evidential (NIG) head against the JAX package, on the
CPU, in fp32.

Weights: the JAX ``init_evidential(PRNGKey(0))`` with its BatchNorm affine
parameters and statistics randomised (as ``tests/test_evidential.py``
randomises the reference module's), and the shipped trained head
``checkpoints/evidential_head`` (orbax, restored here; the port reads no
orbax), crossed to the port through ``evidential_params_from_jax``.

Bars: the head's outputs at ``tests/test_evidential.py:63-68``'s (gamma
2e-3; nu, alpha and beta 1e-3; ``prob_combine`` 1e-4; measured ~1e-7 of
each output's size).  The modules run at atol 1e-5: each output of a
3x3x3 convolution over up to 160 channels sums 4,320 products of O(1), so
fp32 rounding in two summation orders leaves ~1e-6.  ``mish`` runs at
rtol 1e-6 (a few ulps: the port's ``F.mish`` rounds once where JAX's
``x * tanh(softplus(x))`` rounds three times).  The interpolation
matrix is the JAX package's bit for bit.  ``run_inference`` and ``cli
eval`` with a head write the four PFM families of JAX ``run_inference`` on
the exact fp32 path: depth and confidence at PR 1's bars (depth 1e-3,
confidence 1e-5), gamma at 2e-3, aleatoric and epistemic at 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.core.pfm import read_pfm
from aa_rmvsnet_tpu.data.eval_dataset import EvalDataset as EvalDatasetJ
from aa_rmvsnet_tpu.models import evidential as ev_j
from aa_rmvsnet_tpu.models.convert import _evidential_rules, convert_evidential_state_dict
from aa_rmvsnet_tpu.ops.resize import _interp_matrix
from aa_rmvsnet_tpu.ops.resize import resize_trilinear_align_corners as resize_j
from aa_rmvsnet_tpu.pipeline.infer import InferConfig as InferConfigJ
from aa_rmvsnet_tpu.pipeline.infer import run_inference as run_inference_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    evidential_apply,
    evidential_params_from_jax,
    load_evidential_checkpoint,
    params_from_jax,
)
from aa_rmvsnet_tpu_torch.models import evidential as ev_t
from aa_rmvsnet_tpu_torch.ops.resize import interp_matrix, resize_trilinear_align_corners
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

from scenefix import make_plane_scene
from test_torch_models import jax_params

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_HEAD = os.path.join(REPO_ROOT, "checkpoints", "evidential_head")
HEAD_BARS = {"gamma": 2e-3, "nu": 1e-3, "alpha": 1e-3, "beta": 1e-3, "prob_combine": 1e-4}
# The trained head's scene family (scripts/train_evidential_head.py).
H, W, V, D = 32, 32, 3, 32
FAMILIES = ["depth_est_0", "confidence_0", "aleatoric_0", "epistemic_0"]


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_bn(variables, seed=0):
    """BN scale ~ N(1, 0.1), bias ~ N(0, 0.1), mean ~ N(0, 0.1), var ~ U(0.5,
    1.5), so that the statistics' conversion is exercised."""
    rng = np.random.RandomState(seed)

    def visit(params, stats):
        for name, node in params.items():
            if not isinstance(node, dict):
                continue
            if "scale" in node:
                shape = node["scale"].shape
                node["scale"] = rng.normal(1.0, 0.1, shape).astype(np.float32)
                node["bias"] = rng.normal(0.0, 0.1, shape).astype(np.float32)
                stats[name]["mean"] = rng.normal(0.0, 0.1, shape).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            elif name in stats:
                visit(node, stats[name])

    visit(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def random_variables():
    return _randomize_bn(_numpy(jax.jit(ev_j.init_evidential)(jax.random.PRNGKey(0))))


@pytest.fixture(scope="module")
def trained_variables():
    import orbax.checkpoint as ocp

    return _numpy(ocp.StandardCheckpointer().restore(TRAINED_HEAD))


def _port_head(variables) -> EvidentialHead:
    head = EvidentialHead()
    head.load_state_dict(evidential_params_from_jax(variables), strict=True)
    return head.eval()


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# --------------------------------------------------------------------------- resize


@pytest.mark.parametrize("sizes", [(512, 32), (48, 32), (32, 32), (1, 5), (5, 1), (16, 8)])
def test_interp_matrix_is_jax_bit_for_bit(sizes):
    np.testing.assert_array_equal(interp_matrix(*sizes), _interp_matrix(*sizes))


@pytest.mark.parametrize("out", [(4, 4, 4), (1, 3, 5), (7, 16, 1), (12, 8, 8)])
def test_trilinear_resize_matches_jax(out):
    """NCDHW against JAX's NDHWC, size-1 axes included (JAX maps the single
    output to input index 0, as ``align_corners=True`` does)."""
    x = np.random.RandomState(0).randn(2, 12, 8, 8, 3).astype(np.float32)
    want = np.asarray(resize_j(jnp.asarray(x), *out))
    got = resize_trilinear_align_corners(_ncdhw(x), *out)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, atol=1e-6)


# --------------------------------------------------------------------------- modules


def _sub(variables, *path):
    params, stats = variables["params"], variables["batch_stats"]
    for part in path:
        params, stats = params[part], stats[part]
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("name", ["mish", "convbn", "deconv", "hourglass", "hourglass_up"])
def test_module_matches_jax(random_variables, name):
    rng = np.random.RandomState(1)
    head = _port_head(random_variables)
    v = random_variables
    x = rng.randn(1, 8, 8, 8, 32).astype(np.float32)
    if name == "mish":
        x = 4 * x
        want = np.asarray(ev_j.mish(jnp.asarray(x)))
        got = ev_t.mish(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    if name == "convbn":
        want = ev_j.ConvBN3d(32).apply(_sub(v, "dres1_0"), x)
        module, args = head.dres1[0], (x,)
    elif name == "deconv":
        x = rng.randn(1, 4, 4, 4, 128).astype(np.float32)
        want = ev_j.Deconv3dBN(64).apply(_sub(v, "dres2", "conv5"), x)
        module, args = head.dres2.conv5, (x,)
    elif name == "hourglass":
        want = ev_j.HourGlass(32).apply(_sub(v, "dres2"), x)
        module, args = head.dres2, (x,)
    else:
        feat4 = rng.randn(1, 4, 4, 4, 32).astype(np.float32)
        feat5 = rng.randn(1, 2, 2, 2, 32).astype(np.float32)
        want = ev_j.HourGlassUp(32).apply(_sub(v, "combine1"), x, feat4, feat5)
        module, args = head.combine1, (x, feat4, feat5)
    with torch.no_grad():
        got = module(*(_ncdhw(a) for a in args))
    want = np.asarray(want)
    assert got.shape == _ncdhw(want).shape
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, atol=1e-5)


@pytest.mark.parametrize("name", ["moe_nig", "uncertainty_decompositions"])
def test_nig_functions_match_jax(name):
    rng = np.random.RandomState(2)
    u = [rng.uniform(400, 600, (2, 5, 6)).astype(np.float32) for _ in range(2)]
    la = [rng.uniform(0.1, 3.0, (2, 5, 6)).astype(np.float32) for _ in range(2)]
    a = [rng.uniform(1.1, 4.0, (2, 5, 6)).astype(np.float32) for _ in range(2)]
    b = [rng.uniform(0.1, 3.0, (2, 5, 6)).astype(np.float32) for _ in range(2)]
    if name == "moe_nig":
        args = (u[0], la[0], a[0], b[0], u[1], la[1], a[1], b[1])
        want = ev_j.moe_nig(*(jnp.asarray(t) for t in args))
        got = ev_t.moe_nig(*(torch.from_numpy(t) for t in args))
    else:
        want = ev_j.uncertainty_decompositions(*(jnp.asarray(t) for t in (la[0], a[0], b[0])))
        got = ev_t.uncertainty_decompositions(*(torch.from_numpy(t) for t in (la[0], a[0], b[0])))
        assert got.keys() == want.keys()
        want, got = [want[k] for k in sorted(want)], [got[k] for k in sorted(want)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# --------------------------------------------------------------------------- the head


@pytest.mark.parametrize("case", ["random", "trained", "depth48"])
def test_head_matches_jax(random_variables, trained_variables, case):
    """``evidential_apply`` against ``make_evidential_apply`` on one cost
    volume: random weights at D=32, 16x16; the trained head at D=32, 32x32;
    random weights at D=48, where the depth values are resampled onto the
    32-hypothesis grid."""
    variables = trained_variables if case == "trained" else random_variables
    d, h, w = {"random": (32, 16, 16), "trained": (32, 32, 32), "depth48": (48, 16, 16)}[case]
    rng = np.random.RandomState(3)
    cost = (3.0 * rng.randn(1, d, h, w)).astype(np.float32)
    dvals = np.linspace(425.0, 425.0 + 2.75 * (d - 1), d, dtype=np.float32)[None]
    want = ev_j.make_evidential_apply(variables)(jnp.asarray(cost), jnp.asarray(dvals))
    with torch.no_grad():
        got = evidential_apply(_port_head(variables), torch.from_numpy(cost),
                               torch.from_numpy(dvals))
    assert got.keys() == want.keys()
    for key, bar in HEAD_BARS.items():
        shape = (1, 32, h, w) if key == "prob_combine" else (1, h, w)
        assert got[key].shape == shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=bar,
                                   err_msg=key)
    assert got["nu"].min() > 0 and got["alpha"].min() > 1


# --------------------------------------------------------------------------- weight bridge


@pytest.mark.parametrize("start", ["port", "jax"])
def test_weight_bridge_round_trip_is_exact(random_variables, start):
    """port ``state_dict`` -> JAX ``convert_evidential_state_dict`` ->
    ``evidential_params_from_jax`` gives the same tensors, and the JAX tree
    comes back from its round trip the same, bit for bit."""
    if start == "port":
        state = EvidentialHead(generator=torch.Generator().manual_seed(5)).state_dict()
        back = evidential_params_from_jax(
            convert_evidential_state_dict({k: v.numpy() for k, v in state.items()}))
        assert back.keys() == state.keys()
        for k, v in state.items():
            assert back[k].dtype == v.dtype, k
            torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    else:
        back = convert_evidential_state_dict(
            {k: v.numpy() for k, v in evidential_params_from_jax(random_variables).items()})
        flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(random_variables)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("layout", ["whole_model", "head_only"])
def test_reference_checkpoint_loads_strict(random_variables, tmp_path, layout):
    """The head's keys are the reference torch names of
    ``_evidential_rules``, 185 tensors and 4,311,328 values besides the BN
    counters; a ``.ckpt`` with ``module.`` and ``evidential.`` prefixes
    among the core's tensors, or the head's bare state dict, loads with
    ``strict=True``."""
    head = EvidentialHead()
    expected = set()
    for prefix, _, kind in _evidential_rules():
        leaves = ("weight",) if kind != "bn" else (
            "weight", "bias", "running_mean", "running_var", "num_batches_tracked")
        expected |= {f"{prefix}.{leaf}" for leaf in leaves}
    assert set(head.state_dict()) == expected
    counted = {k: v for k, v in head.state_dict().items() if "num_batches" not in k}
    assert len(counted) == 185 and sum(v.numel() for v in counted.values()) == 4_311_328

    state = evidential_params_from_jax(random_variables)
    if layout == "whole_model":
        core = AARMVSNetCore().state_dict()
        payload = {"epoch": 0, "optimizer": {}, "model": {
            **{"module." + k: v for k, v in core.items()},
            **{"module.evidential." + k: v for k, v in state.items()}}}
    else:
        payload = state
    path = tmp_path / "head.ckpt"
    torch.save(payload, path)
    loaded = load_evidential_checkpoint(EvidentialHead(), path)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)


# --------------------------------------------------------------------------- run_inference, cli


@pytest.fixture(scope="module")
def scene_outputs(tmp_path_factory, trained_variables):
    """The trained head's scene family (32x32, V=3, D=32, a textureless
    band) through JAX ``run_inference`` for both depth sources, the port's
    ``run_inference`` with ``depth_source="wta"`` and the port's ``cli eval``
    with a whole-model ``.ckpt`` (core and head) and no ``--depth_source``,
    all on the exact fp32 path with the same core and head weights."""
    root = tmp_path_factory.mktemp("evidential_scene")
    make_plane_scene(str(root), H=H, W=W, num_views=V, focal=2000.0, plane_depth=470.0,
                     dmin=425.0, dint=2.75, textureless_rows=(0.4, 0.6))
    listfile = root / "list.txt"
    listfile.write_text("scan1\n")
    params = jax_params(seed=1, size=H)
    core_state = params_from_jax(params)
    head_state = evidential_params_from_jax(trained_variables)
    ckpt = root / "model.ckpt"
    torch.save({"model": {**{"module." + k: v for k, v in core_state.items()},
                          **{"module.evidential." + k: v for k, v in head_state.items()}}},
               ckpt)
    exact = dict(depth_block=8, num_workers=0)
    ds_kwargs = dict(nviews=V, ndepths=D, interval_scale=1.0, max_h=H, max_w=W)

    outs = {}
    for source in ("wta", "evidential"):
        outs[("jax", source)] = root / f"jax_{source}"
        stats = run_inference_j(params, EvalDatasetJ(str(root), str(listfile), **ds_kwargs),
                                InferConfigJ(out_root=str(outs[("jax", source)]),
                                             feature_dtype=jnp.float32, packed_rows=False,
                                             fused_residual=False, depth_source=source,
                                             evidential_params=trained_variables, **exact),
                                progress=False)
        assert stats["count"] == V

    core = AARMVSNetCore()
    core.load_state_dict(core_state, strict=True)
    head = EvidentialHead()
    head.load_state_dict(head_state, strict=True)
    outs[("port", "wta")] = root / "port_wta"
    stats = run_inference(core, EvalDataset(str(root), str(listfile), **ds_kwargs),
                          InferConfig(out_root=str(outs[("port", "wta")]),
                                      feature_dtype=torch.float32, packed_rows=False,
                                      fused_residual=False, device="cpu", evidential=head,
                                      depth_source="wta", **exact),
                          progress=False)
    assert stats["count"] == V and len(stats["head_seconds"]) == V
    assert stats["modes"] == [(False, 1, 4)] * V

    outs[("port", "evidential")] = root / "port_cli"
    cli.main(["eval", "--device", "cpu", "--testpath", str(root), "--testlist", str(listfile),
              "--outdir", str(outs[("port", "evidential")]), "--loadckpt", str(ckpt),
              "--evidential_ckpt", str(ckpt), "--preset", "dtu_eval_smoke",
              "--view_num", str(V), "--numdepth", str(D), "--max_h", str(H),
              "--max_w", str(W), "--depth_block", "8", "--interval_scale", "1.0",
              "--fp32", "--packed_rows", "0"])
    return outs


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("source", ["wta", "evidential"])
def test_inference_with_head_matches_jax(scene_outputs, source, family):
    bar = {"depth_est_0": 2e-3 if source == "evidential" else 1e-3, "confidence_0": 1e-5,
           "aleatoric_0": 1e-3, "epistemic_0": 1e-3}[family]
    for view in range(V):
        name = f"scan1/{family}/{view:08d}.pfm"
        got, _ = read_pfm(str(scene_outputs[("port", source)] / name))
        want, _ = read_pfm(str(scene_outputs[("jax", source)] / name))
        assert got.shape == (H, W) and got.dtype == np.float32
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=bar, err_msg=name)


@pytest.mark.parametrize("flags,message", [
    (["--depth_source", "evidential"], "--depth_source evidential requires --evidential_ckpt"),
    # checkpoints/ holds an orbax directory but is none itself.
    (["--evidential_ckpt", os.path.dirname(TRAINED_HEAD)],
     "--evidential_ckpt .*neither a torch .ckpt nor an orbax checkpoint directory"),
])
def test_cli_refuses(tmp_path, flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["eval", "--device", "cpu", "--testpath", str(tmp_path), "--testlist", "x",
                  "--loadckpt", "x", *flags])


def test_evidential_depth_needs_a_head(tmp_path):
    with pytest.raises(ValueError, match="requires an evidential head"):
        run_inference(AARMVSNetCore(), [], InferConfig(out_root=str(tmp_path), device="cpu",
                                                       depth_source="evidential"))
