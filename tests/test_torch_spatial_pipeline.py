"""The port's spatial mesh axis end to end on the CPU, against the JAX
package on its virtual CPU devices: ``run_inference`` and a core training
step under ``make_mesh(spatial=2)`` on two gloo ranks, against the JAX
package's same calls on its ``(data=1, spatial=2)`` mesh of two devices
(``tests/test_pipeline.py:TestInferenceSpatialSharding``,
``tests/test_train.py:TestMultiChip``); ``cli eval --spatial 2`` and ``cli
train --spatial 2``; the refusals.

Inference uses the JAX test's scene and geometry (a 32x40 plane, V=3, D=8,
depth block 4) with weights from one init through ``params_from_jax``; with
a seeded evidential head it is held to the port's serial run at the head's
CPU bars.
fp32: depth atol 1e-3, a pixel excused only where JAX's two best costs lie
within 1e-4 (``tests/test_torch_fanout.py:assert_depth_at_fp32_bars``),
confidence atol 1e-4.  bf16 with packed rows (the ``cli eval`` default
path): the bars of ``tests/test_torch_packed.py``, twice the JAX package's
own bf16 error against its fp32 result, on the confidence's largest error
and on the share of depths more than one bin apart.  Training (one step,
B=2 at 16x16, V=3, D=4, depth block 2, remat): the loss rtol 1e-5 and each
gradient within 2e-4 of max(max|g|, 1e-3), ``tests/test_train.py``'s bars
for its spatial mesh.

The ranks are ``python -c`` subprocesses (the port alone) on a free port
with a deadline, started with the CLI commands before the JAX references
compile, so that all run at once.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.core.pfm import read_pfm
from aa_rmvsnet_tpu.data.eval_dataset import EvalDataset as EvalDatasetJ
from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.parallel.mesh import make_mesh as make_mesh_j
from aa_rmvsnet_tpu.parallel.mesh import replicated, shard_train_batch
from aa_rmvsnet_tpu.pipeline.infer import InferConfig as InferConfigJ
from aa_rmvsnet_tpu.pipeline.infer import run_inference as run_inference_j
from aa_rmvsnet_tpu.pipeline.train import loss_fn as loss_fn_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, params_from_jax
from aa_rmvsnet_tpu_torch.parallel import Mesh, spatial_rows
from aa_rmvsnet_tpu_torch.pipeline.checkpoint import checkpoint_path
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig
from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head

import test_pipeline
from scenefix import make_plane_scene
from test_torch_fanout import assert_depth_at_fp32_bars, jax_cost_volumes
from test_torch_models import jax_params
from test_torch_parallel import REPO_ROOT, TIMEOUT_S, _env, _free_port, _start_ranks
from test_train import _batch

H, W, V, D = 32, 40, 3, 8
TRAIN_HW, TRAIN_D, TRAIN_BLOCK = 16, 4, 2

# One rank of two under make_mesh(spatial=2): run_inference in fp32, in
# bf16 with packed rows and in fp32 with an evidential head, then one core
# train_step on its rows of the batch (stats, loss and gradients to a
# torch.save file).
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig, batch_rows, make_optimizer, train_step)

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    mesh = make_mesh(spatial=2, device="cpu")
    weights = torch.load(a["weights"], weights_only=True)
    model = AARMVSNetCore()
    model.load_state_dict(weights["infer"])
    ds = EvalDataset(a["root"], ["scan1"], nviews=a["V"], ndepths=a["D"], max_h=a["H"],
                     max_w=a["W"])
    stats = {}
    for name, dtype, packed in (("fp32", torch.float32, "auto"),
                                ("bf16", torch.bfloat16, True)):
        stats[name] = run_inference(model, ds, InferConfig(
            out_root=a["out_root"] + "_" + name, depth_block=4, feature_dtype=dtype,
            num_workers=0, packed_rows=packed, device="cpu", mesh=mesh), progress=False)
    head = EvidentialHead()
    head.load_state_dict(weights["head"])
    stats["evidential"] = run_inference(model, ds, InferConfig(
        out_root=a["out_root"] + "_evidential", depth_block=4, feature_dtype=torch.float32,
        num_workers=0, device="cpu", mesh=mesh, evidential=head, depth_source="evidential"),
        progress=False)
    model = AARMVSNetCore()
    model.load_state_dict(weights["train"])
    data = np.load(a["batch"])
    batch = batch_rows({k: torch.from_numpy(data[k]) for k in data.files}, mesh)
    config = TrainConfig(depth_block=a["block"], device="cpu", mesh=mesh, total_steps=100)
    optimizer, scheduler = make_optimizer(list(model.parameters()), config, 100)
    metrics, images = train_step(model, optimizer, scheduler, batch, config)
    torch.save({"stats": stats, "loss": float(metrics["loss"]),
                "rows": tuple(images["depth_est"].shape),
                "grads": {k: p.grad for k, p in model.named_parameters()}}, a["out"])
    torch.distributed.destroy_process_group()
""")


def _maps(out_root: str, ref: int):
    return [read_pfm(os.path.join(out_root, "scan1", family, f"{ref:08d}.pfm"))[0]
            for family in ("depth_est_0", "confidence_0")]


def _popen(argv, **kwargs):
    return subprocess.Popen(argv, cwd=REPO_ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kwargs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two ranks, ``cli eval --spatial 2`` and the two processes
    of ``cli train --spatial 2``, all started first; then the JAX package's
    spatial inference in fp32 and bf16, its cost volumes and its gradient
    on the spatial mesh; then the port's results."""
    root = tmp_path_factory.mktemp("spatial")
    make_plane_scene(str(root), H=H, W=W, num_views=V, focal=200.0)
    (root / "list.txt").write_text("scan1\n")
    tree = jax_params(seed=1)
    tree_train = jax_params(seed=2, size=TRAIN_HW)
    batch = {k: np.asarray(v) for k, v in _batch(B=2, V=V, H=TRAIN_HW, W=TRAIN_HW, D=TRAIN_D,
                                                    seed=5).items()}
    head = seeded_head(3)
    torch.save({"infer": params_from_jax(tree), "train": params_from_jax(tree_train),
                "head": head.state_dict()}, root / "weights.pt")
    torch.save({"model": params_from_jax(tree)}, root / "model.ckpt")
    np.savez(root / "batch.npz", **batch)
    port, argvs, outs = _free_port(), [], []
    for rank in range(2):
        out = str(root / f"rank{rank}.pt")
        args = dict(port=port, rank=rank, root=str(root), out_root=str(root / "port"),
                    weights=str(root / "weights.pt"), batch=str(root / "batch.npz"), out=out,
                    block=TRAIN_BLOCK, H=H, W=W, V=V, D=D)
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    wait = _start_ranks(argvs)

    evaluate = _popen([sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "eval", "--testpath",
                       str(root), "--testlist", str(root / "list.txt"), "--loadckpt",
                       str(root / "model.ckpt"), "--view_num", str(V), "--numdepth", str(D),
                       "--max_h", str(H), "--max_w", str(W), "--interval_scale", "1",
                       "--depth_block", "4", "--fp32", "--device", "cpu", "--outdir",
                       str(root / "cli"), "--spatial", "2"])
    dtu = root / "dtu"
    os.makedirs(dtu)
    listfile = test_pipeline.TestDTUTrainDataset._make_dtu(None, str(dtu))
    train_port = _free_port()
    trainers = [_popen([sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "train", "--device",
                        "cpu", "--numdepth", "8", "--view_num", "3", "--depth_block", "4",
                        "--num_workers", "0", "--summary_freq", "1", "--trainpath", str(dtu),
                        "--trainlist", listfile, "--logdir", str(root / "logs"),
                        "--max_steps", "1", "--no_tensorboard", "--coordinator",
                        f"localhost:{train_port}", "--num_processes", "2", "--process_id",
                        str(k), "--spatial", "2"]) for k in range(2)]
    try:
        mesh_j = make_mesh_j(data=1, spatial=2, devices=jax.devices()[:2])
        dataset_j = EvalDatasetJ(str(root), ["scan1"], nviews=V, ndepths=D, max_h=H, max_w=W)
        # bf16 with the Pallas gate kernel (interpret mode): fp32 gate math,
        # as the port's (tests/test_torch_packed.py).
        for name, dtype, packed in (("fp32", np.float32, "auto"), ("bf16", jnp.bfloat16, True)):
            run_inference_j(tree, dataset_j, InferConfigJ(
                out_root=str(root / f"jax_{name}"), depth_block=4, feature_dtype=dtype,
                num_workers=0, packed_rows=packed, pallas_gates=name == "bf16", mesh=mesh_j),
                progress=False)
        volumes_j = jax_cost_volumes(tree, dataset_j)
        step = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn_j(p, b, SweepConfigJ(depth_block=TRAIN_BLOCK, remat=True))[0]))
        loss_j, grads_j = step(jax.device_put(tree_train, replicated(mesh_j)),
                               shard_train_batch(mesh_j, batch))
        commands = {"eval": evaluate, **{f"train{k}": p for k, p in enumerate(trainers)}}
        done = {name: (*p.communicate(timeout=TIMEOUT_S), p.returncode)
                for name, p in commands.items()}
        # The port's serial run with the head, at the ranks' one thread.
        model = AARMVSNetCore()
        model.load_state_dict(params_from_jax(tree))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            run_inference(model, EvalDataset(str(root), ["scan1"], nviews=V, ndepths=D,
                                             max_h=H, max_w=W),
                          InferConfig(out_root=str(root / "serial_evidential"), depth_block=4,
                                      feature_dtype=torch.float32, num_workers=0,
                                      device="cpu", evidential=head,
                                      depth_source="evidential"), progress=False)
        finally:
            torch.set_num_threads(threads)
        wait()
    finally:
        for p in (evaluate, *trainers):
            p.kill()
    ranks = [torch.load(out, weights_only=False) for out in outs]
    want = {"loss": float(loss_j), "grads": params_from_jax(jax.tree.map(np.asarray, grads_j))}
    return root, ranks, volumes_j, want, done


def test_inference_fp32_matches_jax_spatial_mesh(runs):
    root, ranks, volumes_j, _, _ = runs
    stats = ranks[0]["stats"]["fp32"]
    assert stats == ranks[1]["stats"]["fp32"]
    assert stats["count"] == V and [len(s) for s in stats["map_seconds"]] == [V, V]
    for ref in range(V):
        depth, conf = _maps(str(root / "port_fp32"), ref)
        depth_j, conf_j = _maps(str(root / "jax_fp32"), ref)
        assert_depth_at_fp32_bars(depth, depth_j, volumes_j[ref])
        np.testing.assert_allclose(conf, conf_j, atol=1e-4)


def test_inference_bf16_packed_tracks_jax_bf16(runs):
    """bf16 with packed rows on the spatial mesh against JAX's: within
    twice JAX's own bf16 error against its fp32 run."""
    root, ranks, _, _, _ = runs
    assert all(m[0] for per_rank in ranks[0]["stats"]["bf16"]["modes"] for m in per_rank)
    bin_w = 2.5  # make_plane_scene's depth interval at interval_scale 1

    def distance(a: str, b: str):
        conf, off = 0.0, []
        for ref in range(V):
            (da, ca), (db, cb) = _maps(str(root / a), ref), _maps(str(root / b), ref)
            conf = max(conf, float(np.abs(ca - cb).max()))
            off.append(np.abs(da - db) > bin_w + 1e-6)
        return conf, float(np.mean(off))

    ref_conf, ref_off = distance("jax_bf16", "jax_fp32")
    conf, off = distance("port_bf16", "jax_bf16")
    print(f"JAX bf16 vs fp32: confidence {ref_conf:.4g}, {ref_off:.2%} of depths off a bin; "
          f"port bf16 vs JAX bf16: {conf:.4g}, {off:.2%}")
    assert ref_conf > 0  # the calibration is not vacuous
    assert conf <= 2 * ref_conf, (conf, ref_conf)
    assert off <= 2 * ref_off, (off, ref_off)


def test_inference_evidential_head_on_spatial_mesh(runs):
    """With an evidential head each spatial rank runs it on its rows of the
    cost volume and spatial rank 0 gathers its four maps: the maps written
    against the port's serial run at the head's bars (gamma, the depth
    here, 2e-3; aleatoric and epistemic 1e-3; confidence 1e-4)."""
    root, ranks, _, _, _ = runs
    stats = ranks[0]["stats"]["evidential"]
    assert stats["count"] == V and [len(s) for s in stats["head_seconds"]] == [V, V]
    bars = {"depth_est_0": 2e-3, "confidence_0": 1e-4, "aleatoric_0": 1e-3,
            "epistemic_0": 1e-3}
    for ref in range(V):
        for family, bar in bars.items():
            name = os.path.join("scan1", family, f"{ref:08d}.pfm")
            got = read_pfm(str(root / "port_evidential" / name))[0]
            want = read_pfm(str(root / "serial_evidential" / name))[0]
            np.testing.assert_allclose(got, want, atol=bar, err_msg=name)


def test_training_step_matches_jax_spatial_mesh(runs):
    _, ranks, _, want, _ = runs
    assert ranks[0]["rows"] == ranks[1]["rows"] == (2, TRAIN_HW // 2, TRAIN_HW)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
    for name, w in want["grads"].items():
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name]), name
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(ranks[0]["grads"][name].numpy() / scale, w / scale,
                                   atol=2e-4, err_msg=name)


def test_cli_eval_and_train_spatial(runs):
    """``cli eval --spatial 2 --fp32`` writes the fp32 maps at the fp32 bars
    against JAX; ``cli train --spatial 2`` steps on the (data=1, spatial=2)
    mesh, rank 0 printing and writing the checkpoint."""
    root, _, volumes_j, _, done = runs
    out, err, rc = done["eval"]
    assert rc == 0, err[-3000:]
    assert out.splitlines()[0] == ("eval: 2 ranks (--spatial 2) on torch.distributed, "
                                   "backend gloo, ranks on the CPU")
    for ref in range(V):
        depth, conf = _maps(str(root / "cli"), ref)
        depth_j, conf_j = _maps(str(root / "jax_fp32"), ref)
        assert_depth_at_fp32_bars(depth, depth_j, volumes_j[ref])
        np.testing.assert_allclose(conf, conf_j, atol=1e-4)
    (out0, err0, rc0), (out1, err1, rc1) = done["train0"], done["train1"]
    assert rc0 == 0 and rc1 == 0, (err0[-3000:], err1[-3000:])
    assert "mesh: {'data': 1, 'view': 1, 'spatial': 2, 'depth': 1} over 2 processes " \
           "(gloo), global batch 2" in out0
    assert "step 1: loss=" in out0 and "train done: steps 0 -> 1" in out0
    assert "loss=" not in out1
    model = AARMVSNetCore()
    model.load_state_dict(torch.load(checkpoint_path(str(root / "logs"), 1),
                                     weights_only=True)["model"])


def _fake_mesh(sizes) -> Mesh:
    """A mesh of these axis sizes as rank 0 sees it, with no process group:
    enough for the checks that run before any collective."""
    return Mesh(0, int(np.prod(sizes)), None, torch.device("cpu"), tuple(sizes))


def test_spatial_refusals(tmp_path):
    with pytest.raises(SystemExit, match="--depth_stages is exclusive with --fanout/--spatial"):
        cli.main(["eval", "--testpath", str(tmp_path), "--testlist", "x", "--loadckpt", "x",
                  "--spatial", "2", "--depth_stages", "2"])
    train = ["train", "--trainpath", str(tmp_path), "--trainlist", "x", "--device", "cpu",
             "--coordinator", "localhost:1", "--process_id", "0"]
    with pytest.raises(SystemExit, match=r"global batch 5 \(= 1 x 5 processes\) must be "
                                         r"divisible by the data mesh axis \(2 = 5 devices "
                                         r"/ spatial 2\)"):
        cli.main([*train, "--num_processes", "5", "--spatial", "2", "--batch_size", "1"])
    mesh = _fake_mesh((1, 1, 2, 1))
    assert spatial_rows(mesh, 40) == (0, 20)
    for height in (30, 36):  # slabs of 15 and 18 rows
        with pytest.raises(ValueError, match=f"a height of {height} rows does not split over "
                                             "a spatial axis of 2 into slabs of a multiple "
                                             "of 4 rows"):
            spatial_rows(mesh, height)
    with pytest.raises(ValueError, match="training with view > 1 AND spatial > 1"):
        TrainConfig(mesh=_fake_mesh((1, 2, 2, 1)))
