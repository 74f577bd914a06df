"""Evidential training on the spatial mesh axis (``TrainConfig(evidential=
True, mesh=make_mesh(spatial=2))``, ``cli train --evidential --spatial
2``) on two gloo CPU ranks, against the JAX package's
``make_evidential_train_step`` and ``make_evidential_eval_step``
(``aa_rmvsnet_tpu/pipeline/train.py:173-262``) on its ``(data=1,
spatial=2)`` mesh of two CPU devices and on one device.

Each rank sweeps its 16 rows of a 32x40 batch (V=3, D=8, depth block 4,
remat) and runs the head (maxdisp 8) on its rows of the cost volume
against its rows of the labels, its BatchNorm statistics summed over both
ranks; it backpropagates its share of the loss, and the spatial sum of
the gradients gives the whole map's.  Weights: the core from
``jax_params``, the head from ``utils/synthetic.py:seeded_head`` (the JAX
init, its BatchNorm randomised), crossed to JAX by its converter.  flax takes its
BatchNorm variance in two passes here, as torch does (the one-pass form
cancels on the head's first volumes, ``test_torch_evidential_train.py``).

Bars, ``tests/test_torch_evidential_train.py``'s (lines 10-19): the loss
rtol 1e-5; each core and head gradient within max(2e-4, 10 x the port's
own move on one process when every weight is scaled by 1 + 1e-7 noise) of
max(max|g|, 1e-3), the exactly zero one within its rounding bound; every
updated BatchNorm statistic within 1e-5 of max(max|s|, 1e-3).  After the
step both ranks' parameters and buffers are equal bit for bit, and each
rank's images are its rows.  ``eval_step`` against JAX's evidential eval step: loss
and gamma's error rtol 1e-5, the threshold rates within one pixel.  Two
processes of ``cli train --evidential --spatial 2`` take one step on the
synthetic DTU tree and write one checkpoint with the head and its
statistics, which loads.

The ranks and the CLI's processes are ``python -c`` / ``python -m``
subprocesses (the port alone) on free ports with a deadline, started before
the JAX references compile.
"""

import json
import math
import sys
import textwrap

import flax.linen.normalization as normalization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aa_rmvsnet_tpu.models.convert import convert_evidential_state_dict
from aa_rmvsnet_tpu.parallel.mesh import make_mesh as make_mesh_j
from aa_rmvsnet_tpu.parallel.mesh import replicated, shard_train_batch
from aa_rmvsnet_tpu.pipeline.train import TrainConfig as TrainConfigJ
from aa_rmvsnet_tpu.pipeline.train import make_evidential_eval_step, make_evidential_train_step
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    evidential_params_from_jax,
    load_evidential_checkpoint,
    load_reference_checkpoint,
    params_from_jax,
)
from aa_rmvsnet_tpu_torch.pipeline import train as train_module
from aa_rmvsnet_tpu_torch.pipeline.checkpoint import HEAD_PREFIX, checkpoint_path
from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig, evidential_loss_fn
from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head

import test_pipeline
from test_torch_evidential_train import _nudge
from test_torch_models import jax_params
from test_torch_spatial_pipeline import _popen
from test_torch_parallel import TIMEOUT_S, _free_port, _start_ranks
from test_torch_view_parallel import ZERO_GRAD
from test_train import _batch

torch.set_num_threads(1)

H, W, V, D, BLOCK, MAXDISP = 32, 40, 3, 8, 4, 8

# One rank of two under make_mesh(spatial=2): eval_step on the eval batch,
# the loss on the slab's rows of imgs with the whole map's labels (refused),
# then one evidential train_step; results to a torch.save file.
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig, batch_rows, eval_step, evidential_loss_fn, make_optimizer, train_step,
        trainable_parameters)

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    mesh = make_mesh(spatial=2, device="cpu")
    weights = torch.load(a["weights"], weights_only=True)
    model, head = AARMVSNetCore(), EvidentialHead(a["maxdisp"])
    model.load_state_dict(weights["core"])
    head.load_state_dict(weights["head"])
    config = TrainConfig(depth_block=a["block"], device="cpu", mesh=mesh, evidential=True,
                         maxdisp=a["maxdisp"], total_steps=100)
    batches = {}
    for name in ("train", "eval"):
        data = np.load(a[name])
        batches[name] = {k: torch.from_numpy(data[k]) for k in data.files}
    out = {"eval": {k: float(v) for k, v in eval_step(
        model, batch_rows(batches["eval"], mesh), config, head).items()}}
    whole_labels = dict(batch_rows(batches["eval"], mesh), depth=batches["eval"]["depth"],
                        mask=batches["eval"]["mask"])
    try:
        with torch.no_grad():
            evidential_loss_fn(model, head, whole_labels, config, config.sweep(remat=False))
    except ValueError as exc:
        out["refusal"] = str(exc)
    optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config, 100)
    metrics, images = train_step(model, optimizer, scheduler, batch_rows(batches["train"], mesh),
                                 config, head)
    out.update(metrics={k: float(v) for k, v in metrics.items()},
               images={k: tuple(v.shape) for k, v in images.items()},
               grads={k: p.grad for k, p in model.named_parameters()},
               state=model.state_dict())
    out["grads"].update({"evidential." + k: p.grad for k, p in head.named_parameters()})
    out["state"].update({"evidential." + k: v for k, v in head.state_dict().items()})
    torch.save(out, a["out"])
    torch.distributed.destroy_process_group()
""")


def _grads_tx() -> optax.GradientTransformation:
    """An optimizer that moves nothing and keeps the step's gradients as
    its state, so that ``make_evidential_train_step`` returns them."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (jax.tree.map(jnp.zeros_like, updates), updates))


def _jax_step(state, batch, mesh=None) -> dict:
    """JAX's evidential train step: loss, gradients and updated statistics
    on the port's names."""
    config = TrainConfigJ(depth_block=BLOCK, evidential=True, maxdisp=MAXDISP, mesh=mesh)
    tx = _grads_tx()
    trainable = {"core": state["core"], "head": state["head"]}
    if mesh is not None:
        state = jax.device_put(state, replicated(mesh))
        batch = shard_train_batch(mesh, batch)
    new_state, grads, metrics, _ = make_evidential_train_step(config, tx)(
        state, tx.init(trainable), batch)
    grads = jax.tree.map(np.asarray, grads)
    out = {k: v.numpy() for k, v in params_from_jax(grads["core"]).items()}
    head = evidential_params_from_jax({"params": grads["head"],
                                       "batch_stats": jax.tree.map(np.asarray,
                                                                   new_state["batch_stats"])})
    out.update({HEAD_PREFIX + k: v.numpy() for k, v in head.items()})
    return {"loss": float(metrics["loss"]), "tensors": out}


def _port_moves(weights: dict, batch: dict) -> tuple[dict, float]:
    """Per gradient tensor, how far the port's gradient on one process
    moves when every weight is scaled by 1 + 1e-7 N(0, 1); and the rounding
    bound of the exactly zero gradient, ``ceil(log2 n) u sum|dL/dc|`` over
    the ``n`` elements ``c`` of the cost volume (``u = 2^-24``)."""
    config = TrainConfig(depth_block=BLOCK, device="cpu", evidential=True, maxdisp=MAXDISP)
    grads, volumes = [], []

    def keep(cost_volume):  # the cost volume, kept for its gradient
        cost_volume.retain_grad()
        volumes.append(cost_volume)
        return torch.softmax(cost_volume, dim=1)

    for nudge in (False, True):
        core, head = AARMVSNetCore(), EvidentialHead(MAXDISP)
        core.load_state_dict(weights["core"])
        head.load_state_dict(weights["head"])
        if nudge:
            _nudge(core, head)
        core.train(), head.train()
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(train_module, "probability_volume", keep)
            loss, _ = evidential_loss_fn(core, head,
                                         {k: torch.tensor(v) for k, v in batch.items()},
                                         config, config.sweep(remat=True))
        loss.backward()
        grads.append({**{k: p.grad for k, p in core.named_parameters()},
                      **{HEAD_PREFIX + k: p.grad for k, p in head.named_parameters()}})
    volume = volumes[0]
    bound = math.ceil(math.log2(volume.numel())) * 2.0 ** -24 * volume.grad.abs().sum().item()
    return {k: (grads[1][k] - g).abs().max().item() for k, g in grads[0].items()}, bound


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_evidential")
    core_tree = jax_params(seed=1, size=H)
    head = seeded_head(3, MAXDISP).state_dict()
    head_vars = convert_evidential_state_dict({k: v.numpy() for k, v in head.items()})
    weights = {"core": params_from_jax(core_tree), "head": head}
    torch.save(weights, root / "weights.pt")
    batches = {name: {k: np.asarray(v) for k, v in _batch(V=V, H=H, W=W, D=D,
                                                           seed=seed).items()}
               for name, seed in (("train", 5), ("eval", 6))}
    for name, batch in batches.items():
        np.savez(root / f"{name}.npz", **batch)
    port, argvs, outs = _free_port(), [], []
    for rank in range(2):
        out = str(root / f"rank{rank}.pt")
        args = dict(port=port, rank=rank, weights=str(root / "weights.pt"),
                    train=str(root / "train.npz"), eval=str(root / "eval.npz"), out=out,
                    block=BLOCK, maxdisp=MAXDISP)
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    wait = _start_ranks(argvs)

    dtu = root / "dtu"
    dtu.mkdir()
    listfile = test_pipeline.TestDTUTrainDataset._make_dtu(None, str(dtu))
    cli_port = _free_port()
    trainers = [_popen([sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "train", "--device",
                        "cpu", "--numdepth", "8", "--view_num", "3", "--depth_block", "4",
                        "--num_workers", "0", "--summary_freq", "1", "--trainpath", str(dtu),
                        "--trainlist", listfile, "--logdir", str(root / "logs"),
                        "--max_steps", "1", "--no_tensorboard", "--evidential", "--maxdisp",
                        str(MAXDISP), "--coordinator", f"localhost:{cli_port}",
                        "--num_processes", "2", "--process_id", str(k), "--spatial", "2"])
                for k in range(2)]
    try:
        state = {"core": core_tree, "head": head_vars["params"],
                 "batch_stats": head_vars["batch_stats"]}
        with pytest.MonkeyPatch.context() as patch:
            fast = normalization._compute_stats
            patch.setattr(normalization, "_compute_stats",
                          lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))
            mesh_j = make_mesh_j(data=1, spatial=2, devices=jax.devices()[:2])
            want = {"mesh": _jax_step(state, batches["train"], mesh_j),
                    "one": _jax_step(state, batches["train"])}
            eval_j = make_evidential_eval_step(TrainConfigJ(depth_block=BLOCK, evidential=True,
                                                            maxdisp=MAXDISP))(
                state, batches["eval"])
        want["eval"] = {k: float(v) for k, v in eval_j.items()}
        want["moves"], want["zero_bound"] = _port_moves(weights, batches["train"])
        cli = [(*p.communicate(timeout=TIMEOUT_S), p.returncode) for p in trainers]
        wait()
    finally:
        for p in trainers:
            p.kill()
    ranks = [torch.load(out, weights_only=False) for out in outs]
    return root, ranks, want, cli


@pytest.mark.parametrize("against", ["mesh", "one"])
def test_train_step_matches_jax(runs, against):
    """The ranks' loss, core and head gradients and updated BatchNorm
    statistics against JAX's step on its spatial mesh and on one device.
    The output conv's bias has an exactly zero gradient (softmax's shift
    invariance): rounding on both sides, each held to zero within the
    pairwise-summation bound of its sum (``test_torch_view_parallel.py``)."""
    _, ranks, want, _ = runs
    ref, moves = want[against], want["moves"]
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"], ref["loss"], rtol=1e-5)
    got = ranks[0]
    for name, move in moves.items():
        w = ref["tensors"][name]
        if name == ZERO_GRAD:
            bound = want["zero_bound"]
            assert abs(float(got["grads"][name])) <= bound and abs(float(w)) <= bound, \
                (name, float(got["grads"][name]), float(w), bound)
            continue
        scale = max(np.abs(w).max(), 1e-3)
        err = np.abs(got["grads"][name].numpy() - w).max() / scale
        bar = max(2e-4, 10 * move / scale)
        assert err <= bar, f"{name}: error {err:.3e}, bar {bar:.3e}"
    stats = [k for k in ref["tensors"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 10
    for name in stats:
        w = ref["tensors"][name]
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got["state"][name].numpy() / scale, w / scale, atol=1e-5,
                                   err_msg=name)


def test_ranks_equal_after_the_step(runs):
    """Both ranks' parameters, gradients and buffers bit for bit; the
    head's images are each rank's rows."""
    _, ranks, _, _ = runs
    for key in ("state", "grads"):
        for name, t in ranks[0][key].items():
            assert torch.equal(t, ranks[1][key][name]), (key, name)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["images"]["depth_est"] == ranks[0]["images"]["alea_1"] == (1, H // 2, W)


def test_eval_step_matches_jax(runs):
    """``eval_step`` on the mesh against JAX's evidential eval step, and the
    loss on the whole map's labels with the slab's volume refused by
    name."""
    _, ranks, want, _ = runs
    for r in ranks:
        got = r["eval"]
        assert got.keys() == want["eval"].keys()
        for key in ("loss", "abs_depth_error"):
            np.testing.assert_allclose(got[key], want["eval"][key], rtol=1e-5, err_msg=key)
        for tau in (2, 4, 8, 16, 32):
            key = f"thres{tau}mm_error"
            np.testing.assert_allclose(got[key], want["eval"][key], atol=1.0 / (H * W),
                                       err_msg=key)
        assert "on a spatial mesh the labels are the slab's rows" in r["refusal"]


def test_cli_train_evidential_spatial(runs):
    """Two processes of ``cli train --evidential --spatial 2``: rank 0
    prints and writes one checkpoint holding the head and its statistics,
    which both loaders take."""
    root, _, _, cli = runs
    (out0, err0, rc0), (out1, err1, rc1) = cli
    assert rc0 == 0 and rc1 == 0, (err0[-3000:], err1[-3000:])
    assert "mesh: {'data': 1, 'view': 1, 'spatial': 2, 'depth': 1} over 2 processes " \
           "(gloo), global batch 2" in out0
    assert "epoch 0 step 1: " in out0 and " loss=" in out0
    assert "train done: steps 0 -> 1" in out0
    assert "loss=" not in out1
    path = checkpoint_path(str(root / "logs"), 1)
    keys = torch.load(path, weights_only=True)["model"].keys()
    head = EvidentialHead(MAXDISP)
    assert {k.removeprefix(HEAD_PREFIX) for k in keys if k.startswith(HEAD_PREFIX)} \
        == head.state_dict().keys()
    load_reference_checkpoint(AARMVSNetCore(), path)
    loaded = load_evidential_checkpoint(head, path)
    assert all(torch.isfinite(v).all() for v in loaded.state_dict().values()
               if v.is_floating_point())
    assert int(loaded.state_dict()[next(k for k in loaded.state_dict()
                                        if k.endswith("num_batches_tracked"))]) == 1
