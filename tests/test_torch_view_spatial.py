"""A mesh with view and spatial axes both above 1 at inference
(``make_mesh(view=2, spatial=2)``) on four gloo CPU ranks, against the
JAX package's ``forward`` on its ``(data=1, view=2, spatial=2)`` mesh of
four of the eight CPU devices (``tests/test_train.py:292-314`` and
``:362-382``).

Rank ``(v, s)`` sweeps the source views of view rank ``v`` on the rows of
spatial rank ``s``: the source features are gathered over the spatial
group, the partial view mean merged over the view group.  Bars are the JAX
package's own for this mesh: the cost volume 1e-4, the depth 1e-3, against
JAX's mesh and against one device.  The two view ranks of a slab return
the same slab bit for bit.  At V=4 the 3 source views do not split over 2
view ranks: the view axis is skipped, and each slab is the spatial
split's alone.

``run_inference`` on the mesh computes on the view ranks as replicas, as
the JAX package replicates over its view axis in inference: its PFMs are
those of ``make_mesh(spatial=2)`` (two more ranks, started at the same
time) bit for bit.  ``make_mesh`` warns as JAX's does, and training on the
mesh raises JAX's ``ValueError``.

    python -m pytest tests/test_torch_view_spatial.py -q
"""

import json
import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.core.pfm import read_pfm
from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.models.network import forward as forward_j
from aa_rmvsnet_tpu.parallel.mesh import make_mesh as make_mesh_j
from aa_rmvsnet_tpu.parallel.mesh import replicated, shard_train_batch
from aa_rmvsnet_tpu_torch.models import params_from_jax

from scenefix import make_plane_scene
from test_torch_models import jax_params
from test_torch_parallel import _free_port, _start_ranks
from test_train import _batch

H = W = 16
D, BLOCK = 4, 2
SCENE_H, SCENE_W, SCENE_V, SCENE_D = 32, 40, 3, 8

# One rank: under make_mesh(**mesh) the warnings it gives, the forward of
# each batch on its rows with no grad, the training refusal, then
# run_inference on the plane scene; results to a torch.save file.
WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch
    torch.set_num_threads(1)
    from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore
    from aa_rmvsnet_tpu_torch.models.network import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh, spatial_rows
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig

    a = json.loads(sys.argv[1])
    initialize_distributed(f"localhost:{a['port']}", a["world"], a["rank"], backend="gloo")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = make_mesh(**a["mesh"], device="cpu")
    model = AARMVSNetCore()
    model.load_state_dict(torch.load(a["weights"], weights_only=True))
    out = {"coords": (mesh.coord("view"), mesh.coord("spatial")),
           "warnings": [str(w.message) for w in caught]}
    for name, path in a["batches"].items():
        data = np.load(path)
        row0, rows = spatial_rows(mesh, data["imgs"].shape[2])
        with torch.no_grad():
            out[name] = forward(model, torch.from_numpy(data["imgs"][:, :, row0:row0 + rows]),
                                torch.from_numpy(data["proj_matrices"]),
                                torch.from_numpy(data["depth_values"]),
                                SweepConfig(depth_block=a["block"], mesh=mesh))
    refusals = []
    for evidential in (False, True):
        try:
            TrainConfig(mesh=mesh, evidential=evidential, device="cpu")
        except ValueError as exc:
            refusals.append(str(exc))
    out["refusals"] = refusals
    ds = EvalDataset(a["root"], ["scan1"], nviews=a["V"], ndepths=a["D"], max_h=a["H"],
                     max_w=a["W"])
    out["stats"] = run_inference(model, ds, InferConfig(
        out_root=a["out_root"], depth_block=4, feature_dtype=torch.float32, num_workers=0,
        packed_rows=False, device="cpu", mesh=mesh), progress=False)
    torch.save(out, a["out"])
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four ranks of make_mesh(view=2, spatial=2) and two of
    make_mesh(spatial=2), all started at once; then JAX's forwards."""
    root = tmp_path_factory.mktemp("view_spatial")
    make_plane_scene(str(root), H=SCENE_H, W=SCENE_W, num_views=SCENE_V, focal=200.0)
    tree = jax_params(seed=4, size=H)
    torch.save(params_from_jax(tree), root / "weights.pt")
    batches = {"v5": _batch(B=1, V=5, H=H, W=W, D=D, seed=7),
               "v4": _batch(B=1, V=4, H=H, W=W, D=D, seed=8)}
    for name, batch in batches.items():
        np.savez(root / f"{name}.npz", **{k: np.asarray(v) for k, v in batch.items()})
    waits = {}
    for label, mesh, names in (("view_spatial", {"view": 2, "spatial": 2}, list(batches)),
                               ("spatial", {"spatial": 2}, [])):
        world, port, argvs, outs = int(np.prod(list(mesh.values()))), _free_port(), [], []
        for rank in range(world):
            out = str(root / f"{label}{rank}.pt")
            args = dict(port=port, world=world, rank=rank, mesh=mesh, block=BLOCK,
                        weights=str(root / "weights.pt"), out=out, root=str(root),
                        out_root=str(root / label), H=SCENE_H, W=SCENE_W, V=SCENE_V,
                        D=SCENE_D, batches={k: str(root / f"{k}.npz") for k in names})
            argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
            outs.append(out)
        waits[label] = (_start_ranks(argvs), outs)

    with pytest.warns(UserWarning, match="view.*spatial"):
        mesh_j = make_mesh_j(data=1, view=2, spatial=2, devices=jax.devices()[:4])
    run_j = jax.jit(forward_j, static_argnums=4)  # a quarter of the eager time
    want = {}
    for name, batch in batches.items():
        inputs = [batch[k] for k in ("imgs", "proj_matrices", "depth_values")]
        one = run_j(tree, *inputs, SweepConfigJ(depth_block=BLOCK))
        sharded = run_j(jax.device_put(tree, replicated(mesh_j)),
                        *(shard_train_batch(mesh_j, batch)[k]
                          for k in ("imgs", "proj_matrices", "depth_values")),
                        SweepConfigJ(depth_block=BLOCK, mesh=mesh_j))
        want[name] = {"one": jax.tree.map(np.asarray, one),
                      "mesh": jax.tree.map(np.asarray, sharded)}
    ranks = {}
    for label, (wait, outs) in waits.items():
        wait()
        ranks[label] = [torch.load(out, weights_only=False) for out in outs]
    return root, ranks, want


def _whole(ranks: list, name: str, view: int) -> dict:
    """View rank ``view``'s outputs, its two slabs joined on the rows."""
    slabs = [r[name] for r in ranks if r["coords"][0] == view]
    return {k: torch.cat([s[k] for s in slabs], dim=-2).numpy() for k in slabs[0]}


def _assert_forward(ranks: list, want: dict, name: str) -> None:
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for s in range(2):
        for key in ("depth", "photometric_confidence", "cost_volume"):
            assert torch.equal(ranks[s][name][key], ranks[2 + s][name][key]), (name, s, key)
    got = _whole(ranks, name, 0)
    assert got["cost_volume"].shape == (1, D, H, W)
    for against in ("mesh", "one"):
        np.testing.assert_allclose(got["cost_volume"], want[name][against]["cost_volume"],
                                   atol=1e-4, err_msg=f"{name} against JAX's {against}")
        np.testing.assert_allclose(got["depth"], want[name][against]["depth"], atol=1e-3,
                                   err_msg=f"{name} against JAX's {against}")


def test_forward_matches_jax_view_spatial_mesh(runs):
    """V=5: each view rank sweeps 2 of the 4 source views on its slab."""
    _, ranks, want = runs
    _assert_forward(ranks["view_spatial"], want, "v5")


def test_view_axis_skipped_when_indivisible(runs):
    """V=4: 3 source views over 2 view ranks, so every rank sweeps all of
    them on its slab (JAX's ``test_view_axis_skipped_when_indivisible``)."""
    _, ranks, want = runs
    _assert_forward(ranks["view_spatial"], want, "v4")


def test_run_inference_equals_the_spatial_split(runs):
    """``run_inference`` on make_mesh(view=2, spatial=2): the view ranks
    are replicas, spatial rank 0 of view rank 0 writes, and its PFMs equal
    make_mesh(spatial=2)'s bit for bit."""
    root, ranks, _ = runs
    stats = [r["stats"] for r in ranks["view_spatial"]]
    assert stats[0]["count"] == SCENE_V
    assert [len(s) for s in stats[0]["map_seconds"]] == [SCENE_V] * 4
    assert all(m == (False, 1, 4) for per_rank in stats[0]["modes"] for m in per_rank)
    for ref in range(SCENE_V):
        for family in ("depth_est_0", "confidence_0"):
            name = os.path.join("scan1", family, f"{ref:08d}.pfm")
            got = read_pfm(str(root / "view_spatial" / name))[0]
            want = read_pfm(str(root / "spatial" / name))[0]
            assert got.shape == (SCENE_H, SCENE_W)
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_mesh_warns_and_training_refuses(runs):
    """``make_mesh`` warns as JAX's does on every rank; ``TrainConfig`` on
    the mesh raises JAX's ``ValueError``, for the core and for the head."""
    _, ranks, _ = runs
    for r in ranks["view_spatial"]:
        assert any("view > 1 combined with spatial > 1" in w for w in r["warnings"])
        assert len(r["refusals"]) == 2
        assert all("training with view > 1 AND spatial > 1" in e for e in r["refusals"])
    for r in ranks["spatial"]:
        assert r["warnings"] == [] and r["refusals"] == []
