"""The port's depth-block pipeline (``parallel/depth_pipeline.py``) on the
CPU: two gloo stages against the port's single sweep and against the JAX
package's ``pipeline_forward`` on its virtual CPU mesh, and the
pipeline's refusals.

P=2 stages, M=3 maps (more maps than stages, so the pipeline fills and
drains) with per-map depth ranges that differ (JAX's
``tests/test_depth_pipeline.py:_map_stack``), D=8, depth block 2.  Against
the single sweep: depth bit for bit, confidence atol 1e-5 (the logsumexp's
reassociation over the chunks).  Against JAX, the fp32 bars of
``tests/test_torch_packed.py`` (depth atol 1e-3, a pixel flipping only on
a near-tie, confidence atol 1e-5) for the exact and the packed sweep, and
those of ``tests/test_torch_quant.py`` for fp8 tables (>= 99 % of depths
within one bin, confidence atol 2e-4).  Ranks are subprocesses with a hard
timeout, as in ``tests/test_torch_parallel.py``.
"""

import json
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.parallel.depth_pipeline import pipeline_forward as pipeline_forward_j
from aa_rmvsnet_tpu.parallel.mesh import make_mesh as make_mesh_j
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead, params_from_jax
from aa_rmvsnet_tpu_torch.models.network import SweepConfig
from aa_rmvsnet_tpu_torch.parallel import Mesh, sweep_depth_pipelined
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

from test_depth_pipeline import _map_stack
from test_torch_models import jax_params
from test_torch_parallel import _free_port, _start_ranks

torch.set_num_threads(2)

M, D, BLOCK = 3, 8, 2
CONFIGS = {"exact": {}, "packed": {"packed_rows": True},
           "fp8_tables": {"table_dtype": "float8_e4m3fn"}}

# One stage of two: pipeline_forward under make_mesh(depth=2) for each
# configuration, and the port's single sweep of each map; torch.save file.
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore
    from aa_rmvsnet_tpu_torch.models.network import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh, pipeline_forward

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    mesh = make_mesh(depth=2, device="cpu")
    model = AARMVSNetCore()
    model.load_state_dict(torch.load(a["weights"], weights_only=True))
    data = np.load(a["maps"])
    imgs, proj, depths = (torch.from_numpy(data[k]) for k in ("imgs", "proj", "depths"))
    out = {"stage": mesh.coord("depth")}
    with torch.no_grad():
        for name, levers in a["configs"].items():
            if "table_dtype" in levers:
                levers = {**levers, "table_dtype": getattr(torch, levers["table_dtype"])}
            config = SweepConfig(depth_block=a["block"], collect_volume=False, **levers)
            piped = pipeline_forward(model, imgs, proj, depths, mesh, config)
            single = [forward(model, imgs[m], proj[m], depths[m], config)
                      for m in range(len(imgs))]
            out[name] = {"piped": piped, "single": single}
    torch.save(out, a["out"])
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Both stages' results for every configuration, and JAX's
    ``pipeline_forward`` of the same maps on a (depth=2) mesh."""
    work = tmp_path_factory.mktemp("pipeline")
    imgs, proj, depths = (np.asarray(x) for x in _map_stack(M=M, D=D, seed=3))
    tree = jax_params(seed=2, size=16)
    torch.save(params_from_jax(tree), work / "weights.pt")
    np.savez(work / "maps.npz", imgs=imgs, proj=proj, depths=depths)
    port, argvs, outs = _free_port(), [], []
    for rank in range(2):
        out = str(work / f"stage{rank}.pt")
        args = dict(port=port, rank=rank, out=out, block=BLOCK, configs=CONFIGS,
                    weights=str(work / "weights.pt"), maps=str(work / "maps.npz"))
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    wait = _start_ranks(argvs)
    mesh = make_mesh_j(depth=2, devices=jax.devices()[:2])
    want = {}
    for name, levers in CONFIGS.items():
        if "table_dtype" in levers:
            levers = {"table_dtype": jnp.float8_e4m3fn}
        config = SweepConfigJ(depth_block=BLOCK, collect_volume=False, **levers)
        run = jax.jit(lambda p, i, pr, d: pipeline_forward_j(p, i, pr, d, mesh, config))
        want[name] = jax.tree.map(np.asarray, run(tree, imgs, proj, depths))
    wait()
    return [torch.load(out, weights_only=False) for out in outs], want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_matches_single_sweep(stages, name):
    """Each map's depth equal bit for bit to the port's single sweep of it,
    the confidence within 1e-5; both stages return the whole result."""
    ranks, _ = stages
    assert [r["stage"] for r in ranks] == [0, 1]
    for key in ("depth", "photometric_confidence"):
        assert torch.equal(ranks[0][name]["piped"][key], ranks[1][name]["piped"][key]), key
    piped, single = ranks[0][name]["piped"], ranks[0][name]["single"]
    assert piped["depth"].shape == (M, 1, 16, 16)
    for m in range(M):
        assert torch.equal(piped["depth"][m], single[m]["depth"]), m
        np.testing.assert_allclose(piped["photometric_confidence"][m].numpy(),
                                   single[m]["photometric_confidence"].numpy(), atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_matches_jax_pipeline_forward(stages, name):
    ranks, want = stages
    got, want = ranks[0][name]["piped"], want[name]
    depth, conf = got["depth"].numpy(), got["photometric_confidence"].numpy()
    if name == "fp8_tables":
        interval = np.abs(np.diff(_map_stack(M=M, D=D, seed=3)[2][0, 0])).max()
        assert np.mean(np.abs(depth - want["depth"]) <= interval + 1e-3) >= 0.99
        np.testing.assert_allclose(conf, want["photometric_confidence"], atol=2e-4)
    else:
        np.testing.assert_allclose(depth, want["depth"], atol=1e-3)
        np.testing.assert_allclose(conf, want["photometric_confidence"], atol=1e-5)


def _depth_mesh(**sizes) -> Mesh:
    """A mesh of the given axis sizes seen from rank 0, without a process
    group: the refusals below raise before any collective."""
    shape = {"data": 1, "view": 1, "spatial": 1, "depth": 2, **sizes}
    world = int(np.prod(list(shape.values())))
    return Mesh(0, world, None, torch.device("cpu"), tuple(shape.values()))


def test_refusals(tmp_path):
    """JAX's messages: collect_volume and a depth count the stages do not
    divide in the pipelined sweep, its single-mesh levers, a depth axis
    with a data axis, and an evidential head on a depth mesh."""
    mesh, model = _depth_mesh(), AARMVSNetCore()
    feats = torch.zeros(1, 3, 1, 16, 16, 32)
    proj = torch.eye(4).expand(1, 1, 3, 4, 4)
    depths = torch.linspace(400, 600, D).expand(1, 1, D)
    with pytest.raises(ValueError, match="collect_volume is not supported by the depth pipeline"):
        sweep_depth_pipelined(model, feats, proj, depths, mesh, SweepConfig(collect_volume=True))
    with pytest.raises(ValueError, match="D=7 not divisible by depth axis 2"):
        sweep_depth_pipelined(model, feats, proj, depths[..., :7], mesh,
                              SweepConfig(depth_block=2, collect_volume=False))
    for levers in ({"packed_rows": True, "gather_pack": 2},
                   {"packed_rows": True, "residual_dtype": torch.float8_e4m3fn}):
        with pytest.raises(ValueError, match="gather_pack / residual_dtype are not supported "
                                             "in the depth-pipelined sweep"):
            sweep_depth_pipelined(model, feats, proj, depths, mesh,
                                  SweepConfig(collect_volume=False, **levers))
    out = str(tmp_path)
    with pytest.raises(ValueError, match="depth-pipelined inference uses the depth axis "
                                         "exclusively"):
        run_inference(model, [], InferConfig(out_root=out, mesh=_depth_mesh(data=2)))
    with pytest.raises(ValueError, match="depth-pipelined inference uses the depth axis "
                                         "exclusively"):
        run_inference(model, [], InferConfig(out_root=out, mesh=_depth_mesh(view=2)))
    with pytest.raises(ValueError, match="the depth-block pipeline cannot collect the cost "
                                         "volume"):
        run_inference(model, [], InferConfig(out_root=out, mesh=mesh,
                                             evidential=EvidentialHead(8)))
