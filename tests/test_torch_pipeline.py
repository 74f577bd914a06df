"""The PyTorch port's inference entry points against the JAX package.

``python -m aa_rmvsnet_tpu_torch.cli eval --device cpu --fp32 --packed_rows
0`` on a JPEG plane scene must write the PFMs that the JAX package's
``run_inference`` writes on the exact fp32 path (same seeded weights,
crossed through a reference ``.ckpt``): depth equal, confidence atol 1e-5.
With no precision or packing flags (bf16, packed rows where the gate
passes, fused residual) the port's PFMs must track the JAX package's
``run_inference`` defaults within twice the JAX package's own bf16 error.
The JAX package's fusion must accept the port's output tree, and the port
must import nothing of JAX or of the JAX package.
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
from aa_rmvsnet_tpu.pipeline.infer import resolve_packed_mode as resolve_packed_mode_j
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
    """The plane scene, run through the port's CLI and through JAX, on the
    exact fp32 path and with the CLI's defaults."""
    root = tmp_path_factory.mktemp("scene")
    make_plane_scene(str(root), H=H, W=W, num_views=V)
    listfile = root / "list.txt"
    listfile.write_text("scan1\n")
    params = jax_params(seed=1)
    ckpt = root / "model.ckpt"
    torch.save({"model": params_from_jax(params)}, ckpt)
    ds = EvalDatasetJ(str(root), str(listfile), nviews=V, ndepths=D,
                      interval_scale=1.0, max_h=H, max_w=W)

    def port_cli(out, *flags):
        cmd = [
            sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "eval",
            "--device", "cpu", "--testpath", str(root), "--testlist", str(listfile),
            "--outdir", str(out), "--loadckpt", str(ckpt),
            "--preset", "dtu_eval_smoke", "--view_num", str(V), "--numdepth", str(D),
            "--max_h", str(H), "--max_w", str(W), "--depth_block", "4",
            "--interval_scale", "1.0", *flags,
        ]
        run = subprocess.run(cmd, cwd=REPO_ROOT, env=_env(), capture_output=True,
                             text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-3000:]
        return run.stdout

    def jax_run(out, **config):
        stats = run_inference_j(params, ds, InferConfigJ(
            out_root=str(out), depth_block=4, num_workers=0, **config), progress=False)
        assert stats["count"] == V

    out_t = root / "out_torch"
    port_cli(out_t, "--fp32", "--packed_rows", "0")
    out_j = root / "out_jax"
    jax_run(out_j, feature_dtype=jnp.float32, packed_rows=False, fused_residual=False)

    # The defaults: bf16, packed rows where the gate passes, fused residual.
    mode = resolve_packed_mode_j(ds[0], InferConfigJ(out_root="", depth_block=4))
    assert mode == (True, 1, 4)  # the scene takes the packed path
    stdout = port_cli(root / "out_torch_default")
    assert stdout.count(f"packed mode {mode}") == V, stdout
    jax_run(root / "out_jax_default")
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


def test_cli_eval_defaults_track_jax_defaults(outputs):
    """The port's ``cli eval`` defaults against JAX ``run_inference``'s
    (bf16, packed rows, fused residual; JAX runs its gate chain in XLA
    bf16), with the bar of ``test_torch_packed.py::test_bf16_forward_tracks_jax_bf16``:
    twice the JAX package's own distance from its fp32 maps, on the share
    of depths more than one bin apart and on the confidence.  Measured: JAX
    bf16 vs fp32 25.3 % and 0.0010 (random weights leave the costs flat and
    the confidence low), the port's bf16 vs JAX bf16 21.7 % and 0.0008."""
    root, _, out_j = outputs
    bin_w = 2.5  # the scene's depth interval at interval_scale 1.0

    def maps(out):
        depth = np.stack([read_pfm(str(out / f"scan1/depth_est_0/{v:08d}.pfm"))[0]
                          for v in range(V)])
        conf = np.stack([read_pfm(str(out / f"scan1/confidence_0/{v:08d}.pfm"))[0]
                         for v in range(V)])
        return depth, conf

    def distance(a, b):
        return (np.mean(np.abs(a[0] - b[0]) > bin_w + 1e-6), np.abs(a[1] - b[1]).max())

    port16, jax16 = maps(root / "out_torch_default"), maps(root / "out_jax_default")
    ref_off, ref_conf = distance(jax16, maps(out_j))
    off, conf = distance(port16, jax16)
    print(f"JAX bf16 vs fp32: {ref_off:.2%}, {ref_conf:.4f}; port bf16 vs JAX bf16: "
          f"{off:.2%}, {conf:.4f}")
    assert ref_conf > 0
    assert off <= 2 * ref_off, (off, ref_off)
    assert conf <= 2 * ref_conf, (conf, ref_conf)


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
    """``--spatial`` is ported (``tests/test_torch_spatial_pipeline.py``); a
    use of it that cannot work is refused by name before any rank starts."""
    from aa_rmvsnet_tpu_torch import cli

    argv = ["eval", "--testpath", str(tmp_path), "--testlist", "x", "--loadckpt", "x"]
    with pytest.raises(SystemExit, match="--spatial 0: must be at least 1"):
        cli.main([*argv, "--spatial", "0"])
    with pytest.raises(SystemExit, match="--depth_stages is exclusive with --fanout/--spatial"):
        cli.main([*argv, "--spatial", "2", "--depth_stages", "2"])


@pytest.mark.parametrize("flag,value", [("--fold_omega", "hybird"), ("--packed_rows", "2"),
                                        ("--table_taps", "5")])
def test_eval_lever_flags_are_strict(tmp_path, flag, value, capsys):
    """A typo in a lever fails in the parser instead of picking a path."""
    from aa_rmvsnet_tpu_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["eval", "--testpath", str(tmp_path), "--testlist", "x",
                  "--loadckpt", "x", flag, value])
    assert exc.value.code == 2 and flag in capsys.readouterr().err


def test_port_imports_no_jax(tmp_path):
    """Every module of the port, and ``chip_smoke.py``, import nothing of
    JAX, flax, orbax or the JAX package (compared by first dotted
    component: ``aa_rmvsnet_tpu_torch`` starts with ``aa_rmvsnet_tpu``),
    and the port's fusion, run on the CPU, never loads the JAX package's
    C++ core (``native/libfusion_core.so``)."""
    make_plane_scene(str(tmp_path), H=32, W=40, num_views=3)
    from scenefix import write_prediction

    for v in range(3):
        write_prediction(str(tmp_path / "out"), v, np.full((32, 40), 500.0, np.float32),
                         np.full((32, 40), 0.9, np.float32))
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import aa_rmvsnet_tpu_torch as pkg
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(info.name)
        importlib.import_module("chip_smoke")
        from aa_rmvsnet_tpu_torch.pipeline.fuse import FuseConfig, fuse_scan
        n = fuse_scan({str(tmp_path / "scan1")!r}, {str(tmp_path / "out")!r},
                      {str(tmp_path / "fused.ply")!r},
                      FuseConfig(num_workers=2, device="cpu"))
        print("FUSED", n)
        with open("/proc/self/maps") as f:
            print("NATIVE", "libfusion_core" in f.read())
        bad = sorted(
            name for name in sys.modules
            if name.split(".")[0] == "aa_rmvsnet_tpu"
            or name.split(".")[0].startswith(("jax", "flax", "orbax"))
        )
        wanted = [
            "models.losses", "utils.metrics", "utils.logging", "data.dtu",
            "pipeline.checkpoint", "pipeline.train", "pipeline.fuse", "ops.fusion",
            "ops.image", "core.ply", "utils.quality", "models.convert", "utils.export",
            "utils.analysis", "utils.visualize", "data.validate", "tools.bench",
        ]
        print("MISSING", [m for m in wanted
                          if "aa_rmvsnet_tpu_torch." + m not in sys.modules])
        print("BAD", bad)
        print("N", sum(n.startswith("aa_rmvsnet_tpu_torch.") for n in sys.modules))
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "MISSING []" in run.stdout, run.stdout
    assert "BAD []" in run.stdout, run.stdout
    assert int(run.stdout.split("FUSED ")[1].split()[0]) > 0, run.stdout
    assert "NATIVE False" in run.stdout, run.stdout
    assert int(run.stdout.split("N ")[1]) >= 42
