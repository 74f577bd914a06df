"""The port's view axis (``models/network.py:sweep`` under
``make_mesh(view=k)``, ``parallel/mesh.py:view_merge``, training under a
``(data, view)`` mesh) on the CPU, against the JAX package on its virtual
8-device mesh.

Ranks are gloo subprocesses (``python -c``; the port alone, no JAX) on a
free port with a hard timeout.  View rank ``v`` of 2 sweeps source views
``2v+1, 2v+2`` of V=5.  Bars are the JAX package's own for its view mesh
(``tests/test_train.py:TestViewAxisSharding``): the cost volume 1e-4, the
depth 1e-3, the loss rtol 1e-5, each gradient within max(5e-3 max|g|,
1e-6); a factor-2 error in the gradient rule (the view sum applied to the
regularizer, or not applied to FeatNet and omega) is orders of magnitude
past that bar.  The evidential head's updated BatchNorm statistics are
held within 1e-5 of max(max|s|, 1e-3), with flax's variance taken in two
passes as in ``tests/test_torch_parallel.py``.
"""

import json
import math
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import evidential as ev_j
from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.models.network import forward as forward_j
from aa_rmvsnet_tpu.parallel.mesh import make_mesh as make_mesh_j
from aa_rmvsnet_tpu.parallel.mesh import replicated, shard_train_batch
from aa_rmvsnet_tpu.pipeline.train import TrainConfig as TrainConfigJ
from aa_rmvsnet_tpu.pipeline.train import evidential_loss_fn as evidential_loss_fn_j
from aa_rmvsnet_tpu.pipeline.train import loss_fn as loss_fn_j
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    evidential_params_from_jax,
    params_from_jax,
)
from aa_rmvsnet_tpu_torch.models.network import SweepConfig, forward, view_shard
from aa_rmvsnet_tpu_torch.parallel import Mesh
from aa_rmvsnet_tpu_torch.pipeline import train as train_module
from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig, evidential_loss_fn, loss_fn

from test_torch_evidential import _randomize_bn
from test_torch_models import jax_params
from test_torch_parallel import _free_port, _numpy, _start_ranks
from test_train import _batch

torch.set_num_threads(2)

H = W = 16
D, BLOCK, MAXDISP, TOTAL_STEPS = 8, 2, 8, 100_000

# One rank: for each batch, the forward under make_mesh(**mesh) on its data
# rows and without a mesh (mode "forward"), or one train_step from the
# given weights (mode "step"; the batch named "evidential" with the head);
# results to a torch.save file.
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
    from aa_rmvsnet_tpu_torch.models.network import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig, make_optimizer, train_step, trainable_parameters)

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", a["world"], a["rank"], backend="gloo")
    mesh = make_mesh(**a["mesh"], device="cpu")
    weights = torch.load(a["weights"], weights_only=True)
    d, n = mesh.coord("data"), mesh.shape["data"]
    out = {"coords": (d, mesh.coord("view"))}
    for name, path in a["batches"].items():
        data = np.load(path)
        rows = slice(d * len(data["imgs"]) // n, (d + 1) * len(data["imgs"]) // n)
        batch = {k: torch.from_numpy(np.ascontiguousarray(data[k][rows])) for k in data.files}
        model = AARMVSNetCore()
        model.load_state_dict(weights["core"])
        if a["mode"] == "forward":
            inputs = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            with torch.no_grad():
                out[name] = forward(model, *inputs, SweepConfig(depth_block=a["block"], mesh=mesh))
                out[name + "_alone"] = forward(model, *inputs, SweepConfig(depth_block=a["block"]))
            continue
        head = None
        if name == "evidential":
            head = EvidentialHead(a["maxdisp"])
            head.load_state_dict(weights["head"])
        config = TrainConfig(depth_block=a["block"], device="cpu", mesh=mesh,
                             evidential=head is not None, maxdisp=a["maxdisp"],
                             total_steps=a["total_steps"])
        optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config,
                                              a["total_steps"])
        metrics, _ = train_step(model, optimizer, scheduler, batch, config, head)
        res = {"metrics": {k: float(v) for k, v in metrics.items()},
               "grads": {k: p.grad for k, p in model.named_parameters()},
               "state": model.state_dict()}
        if head is not None:
            res["grads"].update({"evidential." + k: p.grad for k, p in head.named_parameters()})
            res["state"].update({"evidential." + k: v for k, v in head.state_dict().items()})
        out[name] = res
    torch.save(out, a["out"])
    torch.distributed.destroy_process_group()
""")


def _start(workdir, mode: str, mesh: dict, weights: dict, batches: dict):
    """WORKER on ``prod(mesh)`` gloo ranks, started at once so that the
    JAX reference is computed while they run; the returned function waits
    for them and loads each rank's results."""
    world = int(np.prod(list(mesh.values())))
    torch.save(weights, workdir / "weights.pt")
    for name, batch in batches.items():
        np.savez(workdir / f"{name}.npz", **{k: np.asarray(v) for k, v in batch.items()})
    port, argvs, outs = _free_port(), [], []
    for rank in range(world):
        out = str(workdir / f"rank{rank}.pt")
        args = dict(mode=mode, port=port, world=world, rank=rank, mesh=mesh, block=BLOCK,
                    maxdisp=MAXDISP, total_steps=TOTAL_STEPS, out=out,
                    weights=str(workdir / "weights.pt"),
                    batches={k: str(workdir / f"{k}.npz") for k in batches})
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    wait = _start_ranks(argvs)

    def results() -> list:
        wait()
        return [torch.load(out, weights_only=False) for out in outs]

    return results


def _jax_view_forward(tree, batch):
    mesh = make_mesh_j(data=2, view=2, devices=jax.devices()[:4])
    return forward_j(jax.device_put(tree, replicated(mesh)),
                     *(shard_train_batch(mesh, batch)[k]
                       for k in ("imgs", "proj_matrices", "depth_values")),
                     SweepConfigJ(depth_block=BLOCK, mesh=mesh))


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """Two view ranks' forwards of a V=5 and a V=4 batch, each also without
    a mesh, and JAX's (data=2, view=2) forward of the V=5 batch."""
    tree = jax_params(seed=2, size=H)
    batches = {f"v{v}": _batch(B=2, V=v, H=H, W=W, D=D, seed=7) for v in (5, 4)}
    results = _start(tmp_path_factory.mktemp("forward"), "forward", {"view": 2},
                     {"core": params_from_jax(tree)}, batches)
    want = jax.tree.map(np.asarray, _jax_view_forward(tree, batches["v5"]))
    return results(), want


def test_forward_matches_jax_view_mesh(forwards):
    """Two view ranks against JAX's (data=2, view=2) forward at V=5: the
    cost volume 1e-4, the depth 1e-3; both ranks return the same result."""
    ranks, want = forwards
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1)]
    got = [r["v5"] for r in ranks]
    for key in ("depth", "photometric_confidence", "cost_volume"):
        assert torch.equal(got[0][key], got[1][key]), key
    np.testing.assert_allclose(got[0]["cost_volume"].numpy(), want["cost_volume"], atol=1e-4)
    np.testing.assert_allclose(got[0]["depth"].numpy(), want["depth"], atol=1e-3)


def test_indivisible_view_count_runs_unsharded(forwards):
    """V=4 (3 source views over 2 view ranks): the sweep runs unsharded on
    each rank without a word, equal bit for bit to the rank's forward
    without a mesh (JAX's ``test_view_axis_skipped_when_indivisible``)."""
    ranks, _ = forwards
    for r in ranks:
        for key in ("depth", "photometric_confidence", "cost_volume"):
            assert torch.equal(r["v4"][key], r["v4_alone"][key]), key


#: The one gradient that is exactly 0: the softmax over depth, which both
#: losses read, ignores a shift of every cost by the output conv's bias.
ZERO_GRAD = "cost_regularization.conv_0.bias"


def _assert_grads(got: dict, want: dict, move: dict, zero_bound: float, what: str) -> None:
    """JAX's view-mesh bar, max(5e-3 max|g|, 1e-6), or ten times the port's
    own move under 1e-7 weight noise where that is larger.  The exactly
    zero gradient holds only rounding on both sides, each held to zero
    within the pairwise-summation bound of its sum of the loss's cost
    gradients, ``log2(n) u sum|dL/dc|`` (``zero_bound``)."""
    for name, w in want.items():
        if name == ZERO_GRAD:
            assert abs(float(got[name])) <= zero_bound and abs(float(w)) <= zero_bound, \
                (what, name, float(got[name]), float(w), zero_bound)
            continue
        bar = max(5e-3 * np.abs(w).max(), 1e-6, 10 * move[name])
        np.testing.assert_allclose(np.asarray(got[name]), w, atol=bar, err_msg=f"{what} {name}")


def _rank_agreement(ranks: list, case: str) -> None:
    for r in ranks[1:]:
        for key in ("grads", "state"):
            for name, t in ranks[0][case][key].items():
                assert torch.equal(t, r[case][key][name]), f"{case} {key} {name}"


def _port_reference(weights: dict, batch: dict, evidential: bool) -> tuple[dict, float]:
    """One process at the global batch: per tensor the largest change of the
    port's gradient when every weight is scaled by 1 + 1e-7 N(0, 1), and
    the rounding bound of the exactly zero gradient, ``ceil(log2 n) u
    sum|dL/dc|`` over the ``n`` elements ``c`` of the cost volume (``u =
    2^-24``)."""
    gen = torch.Generator().manual_seed(11)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    config = TrainConfig(depth_block=BLOCK, device="cpu", evidential=evidential,
                         maxdisp=MAXDISP)
    volumes = []

    def keep(cost_volume):  # the cost volume, kept for its gradient
        cost_volume.retain_grad()
        volumes.append(cost_volume)
        return torch.softmax(cost_volume, dim=1)

    grads = []
    for nudge in (False, True):
        core = AARMVSNetCore()
        core.load_state_dict(weights["core"])
        modules = [("", core)]
        if evidential:
            head = EvidentialHead(MAXDISP)
            head.load_state_dict(weights["head"])
            modules.append(("evidential.", head))
        if nudge:
            with torch.no_grad():
                for _, m in modules:
                    for p in m.parameters():
                        p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
        for _, m in modules:
            m.train()
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(train_module, "probability_volume", keep)
            if evidential:
                loss, _ = evidential_loss_fn(core, head, tensors, config,
                                             config.sweep(remat=True))
            else:
                loss, _ = loss_fn(core, tensors, config.sweep(remat=True))
        loss.backward()
        grads.append({prefix + n: p.grad for prefix, m in modules
                      for n, p in m.named_parameters()})
    move = {n: (grads[1][n] - g).abs().max().item() for n, g in grads[0].items()}
    volume = volumes[0]
    n = volume.numel()
    return move, math.ceil(math.log2(n)) * 2.0 ** -24 * volume.grad.abs().sum().item()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Four ranks, (data=2, view=2), one train_step of the core and one of
    the core with the evidential head (half of data rank 1's pixels
    masked), against JAX's single-device steps at batch 2."""
    core_tree = jax_params(seed=1, size=H)
    init = jax.jit(ev_j.init_evidential, static_argnums=(1, 2, 3))
    head_vars = _randomize_bn(_numpy(init(jax.random.PRNGKey(1), H, W, MAXDISP)), seed=3)
    core_batch = _batch(B=2, V=5, H=H, W=W, D=D, seed=3)
    ev_batch = {k: np.array(v) for k, v in _batch(B=2, V=5, H=H, W=W, D=D, seed=5).items()}
    ev_batch["mask"][1, : H // 2] = 0.0
    weights = {"core": params_from_jax(core_tree),
               "head": evidential_params_from_jax(head_vars)}
    results = _start(tmp_path_factory.mktemp("step"), "step", {"data": 2, "view": 2}, weights,
                     {"core": core_batch, "evidential": ev_batch})

    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn_j(p, b, TrainConfigJ(depth_block=BLOCK).sweep())[0]))(
        core_tree, core_batch)
    core = {"loss": float(loss_j),
            "grads": {k: v.numpy() for k, v in params_from_jax(_numpy(grads_j)).items()},
            **dict(zip(("move", "zero_bound"), _port_reference(weights, core_batch, False)))}

    import flax.linen.normalization as normalization

    # flax's one-pass E[x^2] - E[x]^2 variance moves this loss past its bar
    # (tests/test_torch_parallel.py); two passes, as the port takes it.
    fast = normalization._compute_stats
    config_j = TrainConfigJ(depth_block=BLOCK, evidential=True, maxdisp=MAXDISP,
                            total_steps=TOTAL_STEPS)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(normalization, "_compute_stats",
                      lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))
        trainable = {"core": core_tree, "head": head_vars["params"]}
        (loss_j, (stats_j, _)), grads_j = jax.jit(jax.value_and_grad(
            lambda t, s, b: evidential_loss_fn_j(t, s, b, config_j, config_j.sweep()),
            has_aux=True))(trainable, head_vars["batch_stats"], ev_batch)
    head_j = evidential_params_from_jax(_numpy({"params": grads_j["head"],
                                                "batch_stats": stats_j}))
    grads = {k: v.numpy() for k, v in params_from_jax(_numpy(grads_j["core"])).items()}
    grads.update({"evidential." + k: v.numpy() for k, v in head_j.items()
                  if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))})
    evidential = {"loss": float(loss_j), "grads": grads,
                  "stats": {"evidential." + k: v.numpy() for k, v in head_j.items()
                            if k.endswith(("running_mean", "running_var"))},
                  **dict(zip(("move", "zero_bound"), _port_reference(weights, ev_batch, True)))}
    return results(), {"core": core, "evidential": evidential}


@pytest.mark.parametrize("case", ["core", "evidential"])
def test_data_view_step_matches_jax_global_batch(steps, case):
    """(data=2, view=2), four ranks at batch 1 per data rank, against JAX's
    single-device step at batch 2: all four ranks equal bit for bit, the
    loss rtol 1e-5, every gradient at JAX's view-mesh bar (or the port's
    own move under weight noise, see :func:`_assert_grads`); with the head,
    its BatchNorm statistics within 1e-5 of their size (summed over the
    data group only: the view ranks hold replicas of their rows)."""
    ranks, want = steps
    want = want[case]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _rank_agreement(ranks, case)
    got = ranks[0][case]
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-5)
    _assert_grads(got["grads"], want["grads"], want["move"], want["zero_bound"], "gradient")
    for name, w in want.get("stats", {}).items():
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got["state"][name].numpy() / scale, w / scale, atol=1e-5,
                                   err_msg=name)


def _fake_mesh(**sizes) -> Mesh:
    """A mesh of the given axis sizes seen from rank 0, without a process
    group: the refusals below raise before any collective."""
    shape = {"data": 1, "view": 1, "spatial": 1, "depth": 1, **sizes}
    world = int(np.prod(list(shape.values())))
    return Mesh(0, world, None, torch.device("cpu"), tuple(shape.values()))


def test_view_shard_layout_and_refusals():
    """View rank v takes the v-th run of consecutive source views; the view
    mesh refuses gather_pack and residual_dtype with JAX's messages, and
    training refuses view with spatial (JAX's ``_check_train_mesh``)."""
    mesh = _fake_mesh(view=2)
    assert list(view_shard(mesh, 5)) == [1, 2]
    assert view_shard(mesh, 4) is None and view_shard(None, 5) is None
    assert list(view_shard(_fake_mesh(data=2, view=4), 9)) == [1, 2]
    model_inputs = (torch.zeros(1, 5, H, W, 3), torch.eye(4).expand(1, 5, 4, 4),
                    torch.linspace(400, 600, D)[None])
    model = AARMVSNetCore()
    with pytest.raises(ValueError, match="gather_pack > 1 is not supported on a view-sharded"):
        forward(model, *model_inputs, SweepConfig(depth_block=2, packed_rows=True,
                                                  gather_pack=2, mesh=mesh))
    with pytest.raises(ValueError, match="residual_dtype is not supported on a view-sharded"):
        forward(model, *model_inputs, SweepConfig(depth_block=2, packed_rows=True,
                                                  residual_dtype=torch.float8_e4m3fn,
                                                  mesh=mesh))
    with pytest.raises(ValueError, match="view > 1 AND spatial > 1"):
        TrainConfig(mesh=_fake_mesh(view=2, spatial=2))
