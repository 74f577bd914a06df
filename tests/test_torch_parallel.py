"""The port's data-parallel training (``parallel/mesh.py``, ``run_training``
and ``cli train`` under a mesh) on the CPU: two gloo ranks at batch 1 each
against the JAX package's single-device step at batch 2.

Each rank is a subprocess (``python -c``; the port alone, no JAX) on a free
port with a hard timeout, so that a hang fails its test.  Rank ``k`` holds
row ``k`` of the global batch, as ``form_global_batch`` lays the rows out in
the JAX package.  Bars are the fp32 training bars: the core's loss rtol
1e-5 and each gradient within 2e-4 of max(max|g|, 1e-3)
(``tests/test_torch_train.py``); the evidential step's loss rtol 1e-5,
gradients at that bar or 10 times the port's own move under 1e-7 weight
noise where that is larger, and every updated BatchNorm statistic within
1e-5 of max(max|s|, 1e-3) (``tests/test_torch_evidential_train.py``, whose
docstring gives the reason: flax's E[x^2] - E[x]^2 variance).  Updated
weights: Adam's first step moves a weight by ~1e-3 (the rate) times the
sign of its gradient, so where a gradient is inside its bar of 0 its sign,
and the weight's move, are rounding: the weights are held at 1e-6 where
|g| exceeds twice the gradient bar, and within twice the rate elsewhere.
The two ranks' weights and statistics after the step are equal bit for
bit.  The evidential case masks half of rank 1's pixels, so the ranks'
valid counts differ and a mean of the ranks' own losses would be wrong.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

from aa_rmvsnet_tpu.data.dtu import DTUTrainDataset as DTUTrainDatasetJ
from aa_rmvsnet_tpu.models import evidential as ev_j
from aa_rmvsnet_tpu.pipeline.train import TrainConfig as TrainConfigJ
from aa_rmvsnet_tpu.pipeline.train import evidential_loss_fn as evidential_loss_fn_j
from aa_rmvsnet_tpu.pipeline.train import loss_fn as loss_fn_j
from aa_rmvsnet_tpu.pipeline.train import make_optimizer as make_optimizer_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.data.dtu import DTUTrainDataset
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    evidential_params_from_jax,
    params_from_jax,
)
from aa_rmvsnet_tpu_torch.parallel import make_mesh
from aa_rmvsnet_tpu_torch.pipeline.checkpoint import checkpoint_path, latest_step
from aa_rmvsnet_tpu_torch.pipeline.train import (
    TrainConfig,
    evidential_loss_fn,
    loss_fn,
    shard_dataset,
)

from test_torch_evidential import _randomize_bn
from test_torch_models import jax_params
from test_train import _batch
import test_pipeline

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16
MAXDISP = 8
LR, TOTAL_STEPS = 1e-3, 100_000
TIMEOUT_S = 240

# One rank of a two-rank run: a train_step (mode "step") or run_training
# (mode "train") under a gloo mesh, its results written with torch.save.
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig, make_optimizer, run_training, train_step, trainable_parameters)

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", a["world"], a["rank"], backend="gloo")
    mesh = make_mesh(device="cpu")
    weights = torch.load(a["weights"], weights_only=True)
    model = AARMVSNetCore()
    model.load_state_dict(weights["core"])
    head = None
    if a["evidential"]:
        head = EvidentialHead(a["maxdisp"])
        head.load_state_dict(weights["head"])
    if a["rank"] and a.get("perturb"):  # rank 0's weights must win
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    config = TrainConfig(depth_block=2, device="cpu", mesh=mesh, evidential=a["evidential"],
                         maxdisp=a["maxdisp"], total_steps=a["total_steps"],
                         **a.get("config", {}))
    data = np.load(a["batch"])
    if a["mode"] == "step":
        rows = slice(a["rank"], a["rank"] + 1)
        batch = {k: torch.from_numpy(np.ascontiguousarray(data[k][rows])) for k in data.files}
        model.train()
        optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config,
                                              a["total_steps"])
        metrics, _ = train_step(model, optimizer, scheduler, batch, config, head)
        out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "grads": {n: p.grad for n, p in model.named_parameters()},
               "state": model.state_dict()}
        if head is not None:
            out["head_grads"] = {n: p.grad for n, p in head.named_parameters()}
            out["head_state"] = head.state_dict()
    else:
        samples = [{k: data[k][i] for k in data.files} for i in range(data["imgs"].shape[0])]
        stats = run_training(model, samples, config, head=head)
        out = {"stats": stats, "state": model.state_dict()}
    torch.save(out, a["out"])
    torch.distributed.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO_ROOT}


def _start_ranks(argvs: list[list[str]], timeout: float = TIMEOUT_S):
    """Start one process per argv; the returned function waits for all
    under one deadline (killing every one on a hang), checks that each
    exited 0 and returns their standard outputs.  Work done between the
    two overlaps with the ranks'."""
    procs = [subprocess.Popen(argv, cwd=REPO_ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]

    def wait() -> list[str]:
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        return [out for out, _ in outs]

    return wait


def _run_ranks(argvs: list[list[str]], timeout: float = TIMEOUT_S) -> list[str]:
    """Start one process per argv and wait for them (:func:`_start_ranks`)."""
    return _start_ranks(argvs, timeout)()


def _two_ranks(tmp_path, mode: str, weights: dict, batch: dict, evidential: bool = False,
               **extra) -> list[dict]:
    """Run WORKER on two gloo ranks; returns each rank's results."""
    torch.save(weights, tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", **{k: np.asarray(v) for k, v in batch.items()})
    port = _free_port()
    argvs, outs = [], []
    for rank in range(2):
        out = str(tmp_path / f"rank{rank}.pt")
        args = dict(mode=mode, port=port, world=2, rank=rank, evidential=evidential,
                    maxdisp=MAXDISP, total_steps=TOTAL_STEPS, out=out,
                    weights=str(tmp_path / "weights.pt"), batch=str(tmp_path / "batch.npz"),
                    **extra)
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    _run_ranks(argvs)
    return [torch.load(out, weights_only=False) for out in outs]


def _updated(params, grads, config=TrainConfigJ(total_steps=TOTAL_STEPS)):
    """JAX's parameters after one optax step with ``grads``."""
    tx = make_optimizer_j(config)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_grads(got: dict, want: dict, floor: float | dict = 2e-4, what: str = "") -> None:
    """Each tensor within ``floor`` (by name, or one for all) of
    max(max|want|, 1e-3)."""
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        bar = floor[name] if isinstance(floor, dict) else floor
        np.testing.assert_allclose(np.asarray(got[name]) / scale, w / scale, atol=bar,
                                   err_msg=f"{what} {name}")


def _assert_weights(got: dict, want: dict, grads: dict, bars: dict) -> None:
    """Updated weights: 1e-6 where |g| exceeds twice its bar, twice the
    rate elsewhere (the sign of a gradient inside its bar is rounding)."""
    for name, w in want.items():
        g = grads[name]
        settled = np.abs(g) > 2 * bars[name] * max(np.abs(g).max(), 1e-3)
        err = np.abs(np.asarray(got[name]) - w)
        assert err[settled].max(initial=0) <= 1e-6, name
        assert err.max() <= 2 * LR, name


def _rank_agreement(results: list[dict], keys=("state",)) -> None:
    for key in keys:
        for name, t in results[0][key].items():
            assert torch.equal(t, results[1][key][name]), f"{key} {name}"


# --------------------------------------------------------------------------- the step


def test_two_ranks_equal_jax_global_batch_step(tmp_path):
    tree = jax_params(seed=1, size=H)
    batch = _batch(B=2, seed=3)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn_j(p, b, TrainConfigJ(depth_block=2).sweep())[0]))(tree, batch)
    want_grads = {k: v.numpy() for k, v in params_from_jax(_numpy(grads_j)).items()}
    want_state = {k: v.numpy() for k, v in
                  params_from_jax(_numpy(_updated(tree, grads_j))).items()}

    results = _two_ranks(tmp_path, "step", {"core": params_from_jax(tree)}, batch)
    _rank_agreement(results)
    for r in results:
        np.testing.assert_allclose(r["metrics"]["loss"], float(loss_j), rtol=1e-5)
    # Each rank holds the averaged gradient of the global batch.
    grads = {k: v.numpy() for k, v in results[0]["grads"].items()}
    _assert_grads(grads, want_grads, what="gradient")
    _assert_grads({k: v.numpy() for k, v in results[1]["grads"].items()}, want_grads,
                  what="rank 1 gradient")
    _assert_weights({k: v.numpy() for k, v in results[0]["state"].items()}, want_state,
                    want_grads, {k: 2e-4 for k in want_grads})


def _nudged_move(core: AARMVSNetCore, head: EvidentialHead, batch: dict, config) -> dict:
    """Per tensor, the port's own move, over max(max|g|, 1e-3), when every
    weight is scaled by 1 + 1e-7 N(0, 1): one process, the global batch."""
    gen = torch.Generator().manual_seed(11)
    grads = []
    for nudge in (False, True):
        c, h = AARMVSNetCore(), EvidentialHead(MAXDISP)
        c.load_state_dict(core.state_dict())
        h.load_state_dict(head.state_dict())
        if nudge:
            with torch.no_grad():
                for p in list(c.parameters()) + list(h.parameters()):
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
        c.train(), h.train()
        loss, _ = evidential_loss_fn(c, h, batch, config, config.sweep(remat=True))
        loss.backward()
        grads.append({**{n: p.grad for n, p in c.named_parameters()},
                      **{"evidential." + n: p.grad for n, p in h.named_parameters()}})
    return {n: (grads[1][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-3)
            for n, g in grads[0].items()}


def test_two_ranks_equal_jax_global_batch_evidential_step(tmp_path, monkeypatch):
    """The core and the evidential head: loss, gradients, updated weights
    and the head's BatchNorm statistics, with half of rank 1's pixels
    masked.  JAX's BatchNorm takes its variance in two passes here, as the
    port does (``test_whole_path_matches_jax[two_pass]``): flax's one-pass
    E[x^2] - E[x]^2 moved this loss by 1.2e-5 of itself, past the bar."""
    import flax.linen.normalization as normalization

    fast = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))
    core_tree = jax_params(seed=1, size=H)
    init = jax.jit(ev_j.init_evidential, static_argnums=(1, 2, 3))
    head_vars = _randomize_bn(_numpy(init(jax.random.PRNGKey(1), H, W, MAXDISP)), seed=3)
    batch = {k: np.array(v) for k, v in _batch(B=2, D=8, seed=5).items()}
    batch["mask"][1, : H // 2] = 0.0
    assert batch["mask"][0].sum() != batch["mask"][1].sum()

    config_j = TrainConfigJ(depth_block=2, evidential=True, maxdisp=MAXDISP,
                            total_steps=TOTAL_STEPS)
    trainable = {"core": core_tree, "head": head_vars["params"]}
    (loss_j, (stats_j, _)), grads_j = jax.jit(jax.value_and_grad(
        lambda t, s, b: evidential_loss_fn_j(t, s, b, config_j, config_j.sweep()),
        has_aux=True))(trainable, head_vars["batch_stats"], batch)
    updated_j = _updated(trainable, grads_j, config_j)
    want_grads = {k: v.numpy() for k, v in params_from_jax(_numpy(grads_j["core"])).items()}
    want_grads.update({"evidential." + k: v.numpy() for k, v in evidential_params_from_jax(
        _numpy({"params": grads_j["head"], "batch_stats": stats_j})).items()
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))})
    want_stats = {k: v.numpy() for k, v in evidential_params_from_jax(
        _numpy({"params": updated_j["head"], "batch_stats": stats_j})).items()}
    want_state = {k: v.numpy() for k, v in
                  params_from_jax(_numpy(updated_j["core"])).items()}
    want_state.update({"evidential." + k: v for k, v in want_stats.items()
                       if not k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked"))})

    core, head = AARMVSNetCore(), EvidentialHead(MAXDISP)
    core.load_state_dict(params_from_jax(core_tree), strict=True)
    head.load_state_dict(evidential_params_from_jax(head_vars), strict=True)
    results = _two_ranks(tmp_path, "step", {"core": core.state_dict(),
                                            "head": head.state_dict()},
                         batch, evidential=True)
    _rank_agreement(results, ("state", "head_state"))
    for r in results:
        np.testing.assert_allclose(r["metrics"]["loss"], float(loss_j), rtol=1e-5)

    config = TrainConfig(depth_block=2, evidential=True, maxdisp=MAXDISP, device="cpu")
    move = _nudged_move(core, head, {k: torch.from_numpy(v) for k, v in batch.items()},
                        config)
    bars = {n: max(2e-4, 10 * m) for n, m in move.items()}
    r = results[0]
    grads = {k: v.numpy() for k, v in r["grads"].items()}
    grads.update({"evidential." + k: v.numpy() for k, v in r["head_grads"].items()})
    _assert_grads(grads, want_grads, bars, "gradient")
    state = {k: v.numpy() for k, v in r["state"].items()}
    state.update({"evidential." + k: v.numpy() for k, v in r["head_state"].items()})
    _assert_weights(state, want_state, want_grads, bars)
    for name, buf in r["head_state"].items():
        if name.endswith(("running_mean", "running_var")):
            w = want_stats[name]
            scale = max(np.abs(w).max(), 1e-3)
            np.testing.assert_allclose(buf.numpy() / scale, w / scale, atol=1e-5,
                                       err_msg=name)


# --------------------------------------------------------------------------- the loop


def _samples(n: int, seed: int) -> dict:
    return {k: np.array(v) for k, v in _batch(B=n, seed=seed).items()}


def test_rank_zero_checkpoints_and_both_ranks_resume(tmp_path):
    """``run_training`` on two ranks from different weights (rank 1's
    perturbed): rank 0's are broadcast, only rank 0 writes, both ranks end
    equal to the checkpoint; a resumed run restores it on both ranks and
    takes the next step, whose weights equal a run of two steps."""
    core = AARMVSNetCore(generator=torch.Generator().manual_seed(2))
    logdir = str(tmp_path / "logs")
    batch = _samples(4, seed=7)
    first = _two_ranks(tmp_path, "train", {"core": core.state_dict()}, batch, perturb=True,
                       config={"logdir": logdir, "max_steps": 1, "epochs": 2,
                               "num_workers": 0})
    _rank_agreement(first)
    assert [r["stats"]["step"] for r in first] == [1, 1]
    assert os.listdir(logdir) == [os.path.basename(checkpoint_path(logdir, 1))]
    saved = torch.load(checkpoint_path(logdir, 1), weights_only=True)["model"]
    for name, t in first[0]["state"].items():
        assert torch.equal(saved[name], t), name
    assert first[0]["stats"]["losses"] == first[1]["stats"]["losses"]

    resumed = _two_ranks(tmp_path, "train", {"core": AARMVSNetCore().state_dict()}, batch,
                         config={"logdir": logdir, "max_steps": 1, "epochs": 2,
                                 "num_workers": 0, "resume": True})
    _rank_agreement(resumed)
    assert [(r["stats"]["start_step"], r["stats"]["step"]) for r in resumed] == [(1, 2)] * 2
    assert latest_step(logdir) == 2

    (tmp_path / "again").mkdir()
    both = _two_ranks(tmp_path / "again", "train", {"core": core.state_dict()}, batch,
                      config={"max_steps": 2, "epochs": 2, "num_workers": 0})
    for name, t in both[0]["state"].items():
        torch.testing.assert_close(resumed[0]["state"][name], t, atol=0, rtol=0, msg=name)
    assert resumed[0]["stats"]["losses"] == both[0]["stats"]["losses"][1:]


def test_dtu_dataset_shard_matches_jax(tmp_path):
    root = str(tmp_path)
    listfile = test_pipeline.TestDTUTrainDataset._make_dtu(None, root)
    kwargs = dict(nviews=3, ndepths=8, image_scale=0.25)
    full, full_j = DTUTrainDataset(root, listfile, **kwargs), \
        DTUTrainDatasetJ(root, listfile, **kwargs)
    for num in (2, 3, 5):
        shards = [full.shard(k, num) for k in range(num)]
        assert [s.metas for s in shards] == [full_j.shard(k, num).metas for k in range(num)]
        assert sorted(m for s in shards for m in s.metas) == sorted(full.metas)
        assert shard_dataset(full, 1, num).metas == shards[1].metas
    assert shard_dataset(full, 0, 1) is full
    listed = list(range(7))
    assert [shard_dataset(listed, 2, 3)[i] for i in range(2)] == [2, 5]
    np.testing.assert_array_equal(full.shard(1, 2)[0]["imgs"], full[1]["imgs"])


def test_cli_train_two_processes(tmp_path):
    """``cli train --coordinator localhost:PORT --num_processes 2
    --process_id k --device cpu`` on the synthetic DTU tree: rank 0 prints
    the mesh and the global-batch losses and writes the checkpoint, whose
    core loads."""
    root = str(tmp_path / "dtu")
    os.makedirs(root)
    listfile = test_pipeline.TestDTUTrainDataset._make_dtu(None, root)
    logdir = str(tmp_path / "logs")
    port = _free_port()
    argvs = [[sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "train", "--device", "cpu",
              "--numdepth", "8", "--view_num", "3", "--depth_block", "4",
              "--num_workers", "0", "--summary_freq", "1", "--trainpath", root,
              "--trainlist", listfile, "--logdir", logdir, "--max_steps", "2",
              "--no_tensorboard", "--coordinator", f"localhost:{port}",
              "--num_processes", "2", "--process_id", str(k)] for k in range(2)]
    out0, out1 = _run_ranks(argvs)
    assert "mesh: {'data': 2, 'view': 1, 'spatial': 1, 'depth': 1} over 2 processes " \
           "(gloo), global batch 2" in out0
    assert "step 2: loss=" in out0 and "train done: steps 0 -> 2" in out0
    assert "loss=" not in out1 and "train done" not in out1
    assert os.listdir(logdir) == [os.path.basename(checkpoint_path(logdir, 2))]
    model = AARMVSNetCore()
    model.load_state_dict(torch.load(checkpoint_path(logdir, 2), weights_only=True)["model"])


# --------------------------------------------------------------------------- refusals


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match=r"--spatial 2 needs as many processes, one a rank "
                                         r"\(--num_processes 1\)"):
        cli.main(["train", "--trainpath", str(tmp_path), "--trainlist", "x", "--device", "cpu",
                  "--spatial", "2"])
    with pytest.raises(SystemExit, match=r"global batch 3 \(= 1 x 3 processes\) must be "
                                         r"divisible by the data mesh axis \(2 = 2 devices "
                                         r"/ spatial 1\)"):
        cli.check_global_batch(1, 3, 2, 2)
    cli.check_global_batch(2, 3, 3, 3)  # the port's own case: data axis = processes
    sizes = {"view": "1x2x1x1", "spatial": "1x1x2x1", "depth": "1x1x1x2"}
    for axis, shape in sizes.items():  # over one process: JAX's mesh-size refusal
        with pytest.raises(ValueError, match=r"1 devices not divisible by "
                                             r"view\*spatial\*depth=2"):
            make_mesh(**{axis: 2}, device="cpu")
        with pytest.raises(ValueError, match=f"mesh {shape} != 1 devices"):
            make_mesh(data=1, **{axis: 2}, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1x1x1 != 1 devices"):
        make_mesh(data=2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group, mesh.device.type) == (0, 1, None, "cpu")
    for argv, message in ((["--num_processes", "0"], "--num_processes 0: must be at least 1"),
                          (["--num_processes", "2", "--process_id", "2"],
                           r"--process_id 2: must be in \[0, --num_processes 2\)")):
        with pytest.raises(SystemExit, match=message):
            cli.main(["train", "--trainpath", str(tmp_path), "--trainlist", "x", *argv])


def test_world_of_one_keeps_its_collectives(monkeypatch):
    """In a process group of one rank every axis spans the world, so every
    axis group is the world's, and a data-parallel step still runs its
    all-reduce through the backend (one, over the data group; the view
    axis of one runs none)."""
    from aa_rmvsnet_tpu_torch.parallel import mesh as mesh_module
    from aa_rmvsnet_tpu_torch.pipeline.train import average_gradients

    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "view": 1, "spatial": 1, "depth": 1}
        assert mesh.group is dist.group.WORLD
        assert (mesh.data_group, mesh.view_group, mesh.depth_group) == (dist.group.WORLD,) * 3
        groups = []
        all_reduce = dist.all_reduce
        monkeypatch.setattr(mesh_module.dist, "all_reduce",
                            lambda t, group=None: groups.append(group) or all_reduce(t, group=group))
        params = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))]
        params[0].grad = torch.full((3,), 2.0)
        average_gradients(params, mesh)
        assert groups == [dist.group.WORLD]
        assert torch.equal(params[0].grad, torch.full((3,), 2.0))
        assert torch.equal(params[1].grad, torch.zeros(2, 2))
        local = mesh_module.local_mesh(device="cpu")
        assert (local.group, local.data_group, local.view_group, local.depth_group) == \
            (None,) * 4
    finally:
        dist.destroy_process_group()
