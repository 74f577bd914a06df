"""``cli eval --fanout 2`` and ``cli eval --depth_stages 2`` of the port,
``--device cpu`` (two gloo ranks that the command starts itself), against
the port's serial ``cli eval`` and the JAX CLI's same flags on its virtual
CPU devices (``tests/test_cli.py:test_eval_cli_spatial_and_depth_stage_meshes``).

The scene and flags are the JAX test's: a 32x40 plane scene, V=3, D=8,
``--fp32 --depth_block 4`` and the CLI's default packed rows and fused
residual, from a ``.ckpt`` of seeded weights.  The fan-out writes the
serial run's PFMs byte for byte and the pipeline its depth bit for bit
(its confidence within 1e-5, the logsumexp's reassociation).  Against the
JAX CLI: depth atol 1e-3, a pixel excused only on a near-tie of JAX's cost
volume (``tests/test_torch_fanout.py:assert_depth_at_fp32_bars``),
confidence atol 1e-5.  A rank that fails fails the command.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu import cli as cli_j
from aa_rmvsnet_tpu.data.eval_dataset import EvalDataset as EvalDatasetJ
from aa_rmvsnet_tpu_torch.core.pfm import read_pfm
from aa_rmvsnet_tpu_torch.models import EvidentialHead, params_from_jax

from scenefix import make_plane_scene
from test_torch_fanout import assert_depth_at_fp32_bars, jax_cost_volumes
from test_torch_models import jax_params
from test_torch_parallel import REPO_ROOT, TIMEOUT_S, _env

V = 3


def _maps(out_root: str, ref: int):
    return [read_pfm(os.path.join(out_root, "scan1", family, f"{ref:08d}.pfm"))[0]
            for family in ("depth_est_0", "confidence_0")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI runs (serial, fan-out, pipeline, and a pipeline with an
    evidential head, which every rank refuses) as subprocesses, and the JAX
    CLI's fan-out and pipeline while they run."""
    root = tmp_path_factory.mktemp("cli")
    make_plane_scene(str(root), H=32, W=40, num_views=V, focal=200.0)
    (root / "list.txt").write_text("scan1\n")
    tree = jax_params(seed=1)
    torch.save({"model": params_from_jax(tree)}, root / "model.ckpt")
    torch.save(EvidentialHead(8).state_dict(), root / "head.ckpt")
    common = ["eval", "--testpath", str(root), "--testlist", str(root / "list.txt"),
              "--preset", "dtu_eval_smoke", "--loadckpt", str(root / "model.ckpt"),
              "--numdepth", "8", "--max_h", "32", "--max_w", "40", "--fp32",
              "--depth_block", "4"]
    port = {"serial": [], "fanout": ["--fanout", "2"], "piped": ["--depth_stages", "2"],
            "refused": ["--depth_stages", "2", "--evidential_ckpt", str(root / "head.ckpt")]}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", *common, "--device", "cpu",
         "--outdir", str(root / name), *flags], cwd=REPO_ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, flags in port.items()}
    try:
        for name, flags in (("jax_fanout", ["--fanout", "2"]),
                            ("jax_piped", ["--depth_stages", "2"])):
            cli_j.main([*common, "--outdir", str(root / name), *flags])
        volumes_j = jax_cost_volumes(tree, EvalDatasetJ(
            str(root), ["scan1"], nviews=V, ndepths=8, interval_scale=1.06, max_h=32, max_w=40))
        done = {name: (p.communicate(timeout=TIMEOUT_S), p.returncode)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    return root, done, volumes_j


def test_fanout_and_pipeline_match_the_serial_run(runs):
    root, done, _ = runs
    for name in ("serial", "fanout", "piped"):
        (_, err), code = done[name]
        assert code == 0, err[-3000:]
    (out, _), _ = done["fanout"]
    assert out.splitlines()[0] == ("eval: 2 ranks (--fanout 2) on torch.distributed, backend "
                                   "gloo, ranks on the CPU")
    assert "eval done: 3 maps" in out
    for ref in range(V):
        for family in ("depth_est_0", "confidence_0"):
            name = os.path.join("scan1", family, f"{ref:08d}.pfm")
            with open(root / "fanout" / name, "rb") as a, open(root / "serial" / name, "rb") as b:
                assert a.read() == b.read(), name
        (depth, conf), (depth_p, conf_p) = _maps(root / "serial", ref), _maps(root / "piped", ref)
        np.testing.assert_array_equal(depth_p, depth)
        np.testing.assert_allclose(conf_p, conf, atol=1e-5)


@pytest.mark.parametrize("name", ["fanout", "piped"])
def test_matches_the_jax_cli(runs, name):
    root, _, volumes_j = runs
    for ref in range(V):
        (depth, conf), (depth_j, conf_j) = _maps(root / name, ref), \
            _maps(root / f"jax_{name}", ref)
        assert_depth_at_fp32_bars(depth, depth_j, volumes_j[ref])
        np.testing.assert_allclose(conf, conf_j, atol=1e-5)


def test_a_failed_rank_fails_the_command(runs):
    """Every rank of ``--depth_stages 2 --evidential_ckpt`` raises JAX's
    refusal; the command exits non-zero with it."""
    _, done, _ = runs
    (_, err), code = done["refused"]
    assert code != 0
    assert "eval: a rank failed" in err
    assert "the depth-block pipeline cannot collect the cost volume" in err
