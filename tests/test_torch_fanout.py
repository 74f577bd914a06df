"""The port's eval fan-out (``run_inference`` under ``make_mesh(data=2)``)
on the CPU: two gloo ranks against the port's serial run and against the
JAX package's ``run_inference`` on a ``data=2`` mesh of its virtual CPU
devices (``tests/test_pipeline.py:TestInferenceFanout``).

Three samples over two ranks: rank 0 takes samples 0 and 2, rank 1 sample
1 (JAX's batches of two plus a ragged tail padded with a repeat give the
same maps).  The ranks' PFMs must equal the serial run's byte for byte
(the serial run at the ranks' one thread: the CPU's kernels pick their
algorithm by the thread count).  Against JAX the exact fp32 path
(``packed_rows=False``) is held at the fp32 bars of
``tests/test_torch_models.py``: depth atol 1e-3, a pixel excused only on a
near-tie (the two best costs of JAX's cost volume within 1e-4) and on at
most 0.1 % of pixels, confidence atol 1e-5.  One pixel of map 0 is such a
near-tie: its two best costs lie 3e-8 apart in JAX.  The stats are
gathered over the ranks.
"""

import json
import os
import sys
import textwrap

import jax
import numpy as np
import torch

from aa_rmvsnet_tpu.core.pfm import read_pfm
from aa_rmvsnet_tpu.data.eval_dataset import EvalDataset as EvalDatasetJ
from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.models.network import forward as forward_j
from aa_rmvsnet_tpu.parallel.mesh import make_mesh as make_mesh_j
from aa_rmvsnet_tpu.pipeline.infer import InferConfig as InferConfigJ
from aa_rmvsnet_tpu.pipeline.infer import run_inference as run_inference_j
from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, params_from_jax
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

from scenefix import make_plane_scene
from test_torch_models import jax_params
from test_torch_parallel import _free_port, _start_ranks

torch.set_num_threads(2)

H, W, V, D = 32, 40, 3, 8
SETTINGS = dict(depth_block=4, feature_dtype="float32", packed_rows=False,
                fused_residual=False, num_workers=0)

# One rank of two: run_inference under make_mesh(data=2); its stats to JSON.
WORKER = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    model = AARMVSNetCore()
    model.load_state_dict(torch.load(a["weights"], weights_only=True))
    ds = EvalDataset(a["root"], ["scan1"], nviews=a["V"], ndepths=a["D"], max_h=a["H"],
                     max_w=a["W"])
    settings = dict(a["settings"], feature_dtype=getattr(torch, a["settings"]["feature_dtype"]))
    stats = run_inference(model, ds, InferConfig(out_root=a["out_root"], device="cpu",
                                                 mesh=make_mesh(data=2, device="cpu"),
                                                 **settings), progress=False)
    with open(a["stats"], "w") as f:
        json.dump(stats, f)
    torch.distributed.destroy_process_group()
""")


def _maps(out_root: str, ref: int):
    return [read_pfm(os.path.join(out_root, "scan1", family, f"{ref:08d}.pfm"))[0]
            for family in ("depth_est_0", "confidence_0")]


def jax_cost_volumes(tree, dataset) -> list[np.ndarray]:
    """JAX's fp32 ``(D, H, W)`` cost volume of each of ``dataset``'s maps
    (the exact sweep, one map at a time)."""
    config = SweepConfigJ(depth_block=4, collect_volume=True)
    run = jax.jit(lambda p, i, pr, d: forward_j(p, i, pr, d, config)["cost_volume"])
    return [np.asarray(run(tree, *(np.asarray(s[k])[None] for k in
                                   ("imgs", "proj_matrices", "depth_values"))))[0]
            for s in dataset]


def assert_depth_at_fp32_bars(depth: np.ndarray, depth_j: np.ndarray, volume_j: np.ndarray):
    """Depth within 1e-3 of JAX's but on near-ties, where JAX's two best
    costs lie within 1e-4, and those on at most 0.1 % of pixels."""
    top2 = np.sort(volume_j, axis=0)[-2:]
    near_tie = (top2[1] - top2[0]) < 1e-4
    off = np.abs(depth - depth_j) > 1e-3
    assert not np.any(off & ~near_tie), int(np.sum(off & ~near_tie))
    assert off.sum() <= 0.001 * off.size, int(off.sum())


def test_two_ranks_write_the_serial_runs_maps(tmp_path):
    root = str(tmp_path / "scene")
    make_plane_scene(root, H=H, W=W, num_views=V, focal=200.0)
    tree = jax_params(seed=1)
    torch.save(params_from_jax(tree), tmp_path / "weights.pt")
    fan = str(tmp_path / "fanout")
    port, argvs = _free_port(), []
    for rank in range(2):
        args = dict(port=port, rank=rank, root=root, out_root=fan, settings=SETTINGS,
                    weights=str(tmp_path / "weights.pt"), stats=str(tmp_path / f"{rank}.json"),
                    H=H, W=W, V=V, D=D)
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
    wait = _start_ranks(argvs)

    # While the ranks run: JAX on a data=2 mesh, and the port's serial run.
    jax_out = str(tmp_path / "jax")
    dataset_j = EvalDatasetJ(root, ["scan1"], nviews=V, ndepths=D, max_h=H, max_w=W)
    stats_j = run_inference_j(tree, dataset_j,
                              InferConfigJ(out_root=jax_out, depth_block=4,
                                           feature_dtype=np.float32, num_workers=0,
                                           packed_rows=False, fused_residual=False,
                                           mesh=make_mesh_j(data=2, devices=jax.devices()[:2])),
                              progress=False)
    assert stats_j["count"] == V
    volumes_j = jax_cost_volumes(tree, dataset_j)
    model = AARMVSNetCore()
    model.load_state_dict(params_from_jax(tree))
    serial = str(tmp_path / "serial")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' count: the CPU's kernels pick by it
    try:
        run_inference(model, EvalDataset(root, ["scan1"], nviews=V, ndepths=D, max_h=H,
                                         max_w=W),
                      InferConfig(out_root=serial, device="cpu",
                                  **dict(SETTINGS, feature_dtype=torch.float32)),
                      progress=False)
    finally:
        torch.set_num_threads(threads)
    wait()

    stats = [json.load(open(tmp_path / f"{rank}.json")) for rank in range(2)]
    assert stats[0] == stats[1]
    assert stats[0]["count"] == V and [len(s) for s in stats[0]["map_seconds"]] == [2, 1]
    assert stats[0]["total_s"] == max(sum(s) for s in stats[0]["map_seconds"])
    assert stats[0]["modes"] == [[[False, 1, 4]] * 2, [[False, 1, 4]]]
    for ref in range(V):
        for family in ("depth_est_0", "confidence_0"):
            name = os.path.join("scan1", family, f"{ref:08d}.pfm")
            with open(os.path.join(fan, name), "rb") as a, \
                    open(os.path.join(serial, name), "rb") as b:
                assert a.read() == b.read(), name
        (depth, conf), (depth_j, conf_j) = _maps(fan, ref), _maps(jax_out, ref)
        assert_depth_at_fp32_bars(depth, depth_j, volumes_j[ref])
        np.testing.assert_allclose(conf, conf_j, atol=1e-5)
