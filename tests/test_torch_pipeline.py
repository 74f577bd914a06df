"""The PyTorch port's inference entry points against the JAX package.

``python -m aa_rmvsnet_tpu_torch.cli eval --device cpu`` on a JPEG plane
scene must write the PFMs that the JAX package's ``run_inference`` writes
on the exact fp32 path (same seeded weights, crossed through a reference
``.ckpt``): depth equal, confidence atol 1e-5.  The JAX package's fusion
must accept the port's output tree, and the port must import nothing of
JAX or of the JAX package.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.core.pfm import read_pfm
from aa_rmvsnet_tpu.core.ply import read_ply
from aa_rmvsnet_tpu.data.eval_dataset import EvalDataset as EvalDatasetJ
from aa_rmvsnet_tpu.pipeline.fuse import FuseConfig, fuse_scan
from aa_rmvsnet_tpu.pipeline.infer import InferConfig as InferConfigJ
from aa_rmvsnet_tpu.pipeline.infer import run_inference as run_inference_j
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, params_from_jax
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

from scenefix import make_plane_scene
from test_torch_models import jax_params

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, V, D = 64, 80, 3, 48


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO_ROOT}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """The plane scene, run through the port's CLI and through JAX."""
    root = tmp_path_factory.mktemp("scene")
    make_plane_scene(str(root), H=H, W=W, num_views=V)
    listfile = root / "list.txt"
    listfile.write_text("scan1\n")
    params = jax_params(seed=1)
    ckpt = root / "model.ckpt"
    torch.save({"model": params_from_jax(params)}, ckpt)

    out_t = root / "out_torch"
    cmd = [
        sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "eval",
        "--device", "cpu", "--testpath", str(root), "--testlist", str(listfile),
        "--outdir", str(out_t), "--loadckpt", str(ckpt),
        "--preset", "dtu_eval_smoke", "--view_num", str(V), "--numdepth", str(D),
        "--max_h", str(H), "--max_w", str(W), "--depth_block", "4",
        "--interval_scale", "1.0",
    ]
    run = subprocess.run(cmd, cwd=REPO_ROOT, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]

    out_j = root / "out_jax"
    ds = EvalDatasetJ(str(root), str(listfile), nviews=V, ndepths=D,
                      interval_scale=1.0, max_h=H, max_w=W)
    stats = run_inference_j(params, ds, InferConfigJ(
        out_root=str(out_j), depth_block=4, feature_dtype=jnp.float32,
        packed_rows=False, fused_residual=False, num_workers=0,
    ), progress=False)
    assert stats["count"] == V
    return root, out_t, out_j


@pytest.mark.parametrize("view", range(V))
def test_cli_eval_matches_jax_run_inference(outputs, view):
    _, out_t, out_j = outputs
    name = f"scan1/{{}}/{view:08d}.pfm"
    depth_t, _ = read_pfm(str(out_t / name.format("depth_est_0")))
    depth_j, _ = read_pfm(str(out_j / name.format("depth_est_0")))
    conf_t, _ = read_pfm(str(out_t / name.format("confidence_0")))
    conf_j, _ = read_pfm(str(out_j / name.format("confidence_0")))
    assert depth_t.shape == (H, W) and depth_t.dtype == np.float32
    np.testing.assert_array_equal(depth_t, depth_j)
    np.testing.assert_allclose(conf_t, conf_j, atol=1e-5)
    assert np.all((conf_t > 0) & (conf_t <= 1.0 + 1e-6))


def test_fusion_accepts_port_output(outputs):
    """The JAX package's ``fuse_scan`` reads the port's PFM tree as it is
    and writes a non-empty PLY.  The weights are random, so the depth maps
    need not agree across views: the thresholds are opened wide, and what
    is tested is the file layout, shapes and cameras, not depth quality."""
    root, out_t, _ = outputs
    ply = str(root / "port.ply")
    loose = FuseConfig(photo_threshold=0.0, dist_base=1e-3, rel_diff_base=1e-3,
                       num_workers=2)
    n = fuse_scan(str(root / "scan1"), str(out_t / "scan1"), ply, loose)
    xyz, rgb = read_ply(ply)
    assert n > 0 and xyz.shape == (n, 3) and rgb.shape == (n, 3)
    assert np.isfinite(xyz).all()


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(AARMVSNetCore(), [], InferConfig(out_root=str(tmp_path)))


def test_unported_flag_is_refused(tmp_path):
    from aa_rmvsnet_tpu_torch import cli

    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["eval", "--testpath", str(tmp_path), "--testlist", "x",
                  "--loadckpt", "x", "--packed_rows", "1"])


def test_port_imports_no_jax():
    """Every module of the port, and ``chip_smoke.py``, import nothing of
    JAX, flax, orbax or the JAX package (compared by first dotted
    component: ``aa_rmvsnet_tpu_torch`` starts with ``aa_rmvsnet_tpu``)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import aa_rmvsnet_tpu_torch as pkg
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(info.name)
        importlib.import_module("chip_smoke")
        bad = sorted(
            name for name in sys.modules
            if name.split(".")[0] == "aa_rmvsnet_tpu"
            or name.split(".")[0].startswith(("jax", "flax", "orbax"))
        )
        training = [
            "models.losses", "utils.metrics", "utils.logging", "data.dtu",
            "pipeline.checkpoint", "pipeline.train",
        ]
        print("MISSING", [m for m in training
                          if "aa_rmvsnet_tpu_torch." + m not in sys.modules])
        print("BAD", bad)
        print("N", sum(n.startswith("aa_rmvsnet_tpu_torch.") for n in sys.modules))
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "MISSING []" in run.stdout, run.stdout
    assert "BAD []" in run.stdout, run.stdout
    assert int(run.stdout.split("N ")[1]) >= 37
