"""The port's host tools against the JAX package's, on the same inputs:
``cli analyze`` (``utils/analysis.py``), ``cli viz`` (``utils/visualize.py``),
``cli eval --dry_check`` (``data/validate.py``) and ``--save_png``
(``save_depth_png``), the small leftovers (``read_pf``, ``std_prob``,
``interval_threshold_error_rate``, ``MeterDict.count``,
``find_dataset_def``), the CLI surface against the JAX CLI's, and
``tools/bench.py``'s measurement on a tiny scene.

Bars: the analytics report at rtol 1e-6 (both run numpy, scipy and
scikit-learn on the same arrays); everything else equal.
"""

import argparse
import json
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu import cli as cli_j
from aa_rmvsnet_tpu.core.pfm import read_pf as read_pf_j
from aa_rmvsnet_tpu.data import find_dataset_def as find_dataset_def_j
from aa_rmvsnet_tpu.models.convert import convert_state_dict
from aa_rmvsnet_tpu.pipeline.infer import save_outputs as save_outputs_j
from aa_rmvsnet_tpu.utils import metrics as metrics_j
from aa_rmvsnet_tpu.utils.visualize import model_graph_dot as model_graph_dot_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.core.pfm import read_pf, read_pfm
from aa_rmvsnet_tpu_torch.data import find_dataset_def
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore
from aa_rmvsnet_tpu_torch.pipeline.infer import save_outputs
from aa_rmvsnet_tpu_torch.utils import metrics

from scenefix import make_plane_scene

torch.set_num_threads(2)


def _image(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


# --------------------------------------------------------------------------- analyze


def _write_dumps(logdir):
    """Three training dumps in JAX's layout: two with the head's maps, one
    without."""
    rng = np.random.RandomState(0)
    out = os.path.join(logdir, "results", "train")
    os.makedirs(out)
    for step, head in ((10, True), (20, True), (30, False)):
        gt = rng.uniform(400, 600, (24, 32)).astype(np.float32)
        unc = rng.uniform(0.1, 3.0, (24, 32)).astype(np.float32)
        arrays = {"depth_est": gt + rng.randn(24, 32).astype(np.float32) * unc,
                  "depth_gt": gt, "mask": (rng.rand(24, 32) > 0.2).astype(np.float32),
                  "ref_img": rng.rand(24, 32, 3).astype(np.float32) * 255}
        if head:
            arrays.update(alea_1=unc * 0.6, epis_1=unc * 0.4)
        np.savez_compressed(os.path.join(out, f"{step}.npz"), **arrays)


def _assert_reports_close(got, want, path="report"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            _assert_reports_close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_reports_close(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)


def test_analyze_report_matches_jax(tmp_path):
    logdir = str(tmp_path / "log")
    _write_dumps(logdir)
    cli_j.cmd_analyze(SimpleNamespace(logdir=logdir, mode="train", out=str(tmp_path / "jax"),
                                      error_threshold=2.0))
    cli.main(["analyze", "--logdir", logdir, "--out", str(tmp_path / "port")])
    with open(tmp_path / "jax" / "report.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "report.json") as f:
        got = json.load(f)
    assert set(want) == {"10", "20", "30"} and "ause" in want["10"]
    _assert_reports_close(got, want)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_analyze_without_dumps_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="no dumps under"):
        cli.main(["analyze", "--logdir", str(tmp_path)])


# --------------------------------------------------------------------------- viz


@pytest.mark.parametrize("source", ["fresh", "ckpt", "orbax"])
def test_viz_graph_matches_jax(tmp_path, source):
    """The DOT graph of the same weights: a fresh core (JAX graphs its own
    fresh init; the tree's names and sizes are the same), a torch
    ``.ckpt``, and an orbax directory (JAX's ``convert`` of that file)."""
    state = AARMVSNetCore(generator=torch.Generator().manual_seed(0)).state_dict()
    want = model_graph_dot_j(convert_state_dict({k: v.numpy() for k, v in state.items()}))
    argv = ["viz", "--out", str(tmp_path / "viz")]
    if source != "fresh":
        torch.save({"model": state}, tmp_path / "core.ckpt")
        path = str(tmp_path / "core.ckpt")
        if source == "orbax":
            cli_j.cmd_convert(SimpleNamespace(ckpt=path, out=str(tmp_path / "orbax"),
                                              evidential=False))
            path = str(tmp_path / "orbax")
        argv += ["--loadckpt", path]
    cli.main(argv)
    assert (tmp_path / "viz" / "model_graph.dot").read_text() == want
    assert '"params" [label="params\\n187,203 params"]' in want
    summary = (tmp_path / "viz" / "model_summary.txt").read_text()
    assert "AARMVSNetCore: 187,203 parameters" in summary
    assert "EvidentialHead(maxdisp=32): 4,306,912 parameters" in summary


# --------------------------------------------------------------------------- dry check


def _dry_check_tree(tmp_path, case):
    """The trees of ``tests/test_cli.py::TestDryCheck``: good, broken (a cam
    file missing, an image unreadable), and broken under the padded preset
    (an image missing, no depth_end)."""
    make_plane_scene(tmp_path, H=32, W=32, num_views=3)
    (tmp_path / "list.txt").write_text("scan1\n")
    if case != "good":
        os.remove(tmp_path / "scan1/cams/00000002_cam.txt")
        (tmp_path / "scan1/images/00000001.jpg").write_bytes(b"not a jpeg")
    if case == "padded":
        (tmp_path / "scan1/images/00000001.jpg").unlink()
    preset = "tnt_intermediate" if case == "padded" else "dtu_eval_smoke"
    return ["eval", "--dry_check", "--testpath", str(tmp_path), "--testlist",
            str(tmp_path / "list.txt"), "--preset", preset]


@pytest.mark.parametrize("case", ["good", "broken", "padded"])
def test_dry_check_matches_jax(tmp_path, capsys, case):
    """The same verdict, exit and summary as JAX's ``--dry_check``, without
    ``--loadckpt``."""
    argv = _dry_check_tree(tmp_path, case)
    outs = []
    for main in (cli_j.main, cli.main):
        if case == "good":
            main(argv)
        else:
            with pytest.raises(SystemExit) as exc:
                main(argv)
            assert exc.value.code == 1
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert ("dataset check OK" in outs[1]) == (case == "good")


def test_eval_without_loadckpt_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--loadckpt is required"):
        cli.main(["eval", "--testpath", str(tmp_path), "--testlist", "x"])


# --------------------------------------------------------------------------- previews


def test_save_outputs_previews_match_jax(tmp_path):
    """Every family's preview, as JAX's ``save_outputs`` writes it: the same
    files, the same pixels (a NaN and an inf among the values)."""
    rng = np.random.RandomState(0)
    depth = rng.uniform(400, 600, (12, 16)).astype(np.float32)
    depth[0, 0], depth[1, 1] = np.nan, np.inf
    conf = rng.rand(12, 16).astype(np.float32)
    unc = {"aleatoric_0": rng.rand(12, 16).astype(np.float32),
           "epistemic_0": np.full((12, 16), 0.5, np.float32)}
    save_outputs_j(str(tmp_path / "jax"), 3, depth, conf, unc, save_png=True)
    save_outputs(str(tmp_path / "port"), 3, depth, conf, unc, save_png=True)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    got = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                 for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert got == files and len([f for f in files if f.endswith(".png")]) == 4
    for name in files:
        if name.endswith(".png"):
            np.testing.assert_array_equal(_image(tmp_path / "port" / name),
                                          _image(tmp_path / "jax" / name), err_msg=name)


def test_cli_eval_save_png(tmp_path, capsys):
    """``cli eval --save_png`` on the CPU writes a preview beside each PFM,
    JAX's ``save_depth_png`` of that PFM; ``--pallas_gates`` is accepted."""
    from aa_rmvsnet_tpu.utils.visualize import save_depth_png as save_depth_png_j

    make_plane_scene(tmp_path, H=32, W=32, num_views=3)
    (tmp_path / "list.txt").write_text("scan1\n")
    torch.save({"model": AARMVSNetCore(generator=torch.Generator().manual_seed(0))
                .state_dict()}, tmp_path / "core.ckpt")
    out = tmp_path / "out"
    cli.main(["eval", "--device", "cpu", "--testpath", str(tmp_path), "--testlist",
              str(tmp_path / "list.txt"), "--preset", "dtu_eval_smoke", "--numdepth", "8", "--max_h", "32", "--max_w", "32",
              "--fp32", "--packed_rows", "0", "--loadckpt", str(tmp_path / "core.ckpt"),
              "--outdir", str(out), "--save_png", "--pallas_gates"])
    assert "eval done: 3 maps" in capsys.readouterr().out
    for family, png_family, mode in (("depth_est_0", "depth_png_0", "depth"),
                                     ("confidence_0", "confidence_png_0", "relative")):
        for view in range(3):
            pfm, _ = read_pfm(out / "scan1" / family / f"{view:08d}.pfm")
            save_depth_png_j(str(tmp_path / "want.png"), pfm, mode=mode)
            np.testing.assert_array_equal(
                _image(out / "scan1" / png_family / f"{view:08d}.png"),
                _image(tmp_path / "want.png"))


# --------------------------------------------------------------------------- leftovers


@pytest.mark.parametrize("header", [b"Typ=Pic98::TPlane<float>\nLines=3\nColumns=4\n",
                                    b"NotAPF", b"Typ=Pic98::TPlane<float>\nLines=3\n"],
                         ids=["plane", "other", "no_columns"])
def test_read_pf_matches_jax(tmp_path, header):
    path = tmp_path / "img.PF"
    path.write_bytes(header + np.arange(12, dtype="<f4").tobytes())
    got, want = read_pf(path), read_pf_j(path)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_metric_leftovers_match_jax():
    rng = np.random.RandomState(0)
    prob = rng.rand(2, 8, 6, 5).astype(np.float32)
    np.testing.assert_allclose(metrics.std_prob(torch.from_numpy(prob)).numpy(),
                               np.asarray(metrics_j.std_prob(jnp.asarray(prob))), rtol=1e-6)
    est, gt = (rng.uniform(400, 600, (2, 6, 5)).astype(np.float32) for _ in range(2))
    mask = (rng.rand(2, 6, 5) > 0.3).astype(np.float32)
    interval = np.array([2.5, 40.0], np.float32)
    for k in (1.0, 3.0):
        got = metrics.interval_threshold_error_rate(*map(torch.from_numpy, (est, gt, mask,
                                                                          interval)), k)
        want = metrics_j.interval_threshold_error_rate(*map(jnp.asarray, (est, gt, mask,
                                                                          interval)), k)
        assert float(got) == float(want)
    meter, meter_j = metrics.MeterDict(), metrics_j.MeterDict()
    for m in (meter, meter_j):
        m.update({"loss": 1.0})
        m.update({"loss": 3.0})
    assert meter.count == meter_j.count == 2 and meter.mean() == meter_j.mean()


@pytest.mark.parametrize("name", ["dtu", "dtu_yao", "eval", "data_eval_transform",
                                  "data_eval_transform_padding"])
def test_find_dataset_def_matches_jax(name):
    got, want = find_dataset_def(name), find_dataset_def_j(name)
    unwrap = lambda f: (getattr(f, "func", f).__name__, getattr(f, "keywords", {}))  # noqa: E731
    assert unwrap(got) == unwrap(want)
    assert getattr(got, "func", got).__module__.startswith("aa_rmvsnet_tpu_torch.")


def test_find_dataset_def_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown dataset 'nope'"):
        find_dataset_def("nope")


@pytest.mark.parametrize("package", ["sklearn", "cv2"])
def test_missing_host_package_is_refused_by_name(tmp_path, monkeypatch, package):
    """A missing optional package fails the command that needs it with its
    name (``cli analyze``: scikit-learn; ``--dry_check``: cv2), and the
    previews without matplotlib fail naming it."""
    from aa_rmvsnet_tpu_torch.utils.optional import MissingPackage
    from aa_rmvsnet_tpu_torch.utils.visualize import save_depth_png

    if package == "cv2":
        argv = _dry_check_tree(tmp_path, "good")
    else:
        _write_dumps(str(tmp_path / "log"))
        argv = ["analyze", "--logdir", str(tmp_path / "log")]
    for module in (package, "sklearn.metrics") if package == "sklearn" else (package,):
        monkeypatch.setitem(sys.modules, module, None)  # an earlier import is cached
    with pytest.raises(SystemExit, match=f"{argv[0]}: .*needs the {package} package"):
        cli.main(argv)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(MissingPackage, match="needs the matplotlib package"):
        save_depth_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))


# --------------------------------------------------------------------------- CLI surface


def _parser_options(module):
    """{subcommand: {option string}} of a CLI module's parser."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd")
    for name in ("eval", "fuse", "train", "convert", "analyze", "quality", "viz"):
        getattr(module, f"_add_{name}")(sub)
    return {name: {s for action in p._actions for s in action.option_strings}
            for name, p in sub.choices.items()}


#: The JAX CLI's multi-device flags (ROADMAP item 14), all ported.
MULTI_DEVICE = {"eval": ("--fanout", "--spatial", "--depth_stages", "--pipeline_maps"),
                "train": ("--coordinator", "--num_processes", "--process_id", "--spatial",
                          "--single_device")}
#: The ported multi-process flags of ``train``: a use that cannot work, and
#: its refusal by name; ``--single_device`` is taken, and the run goes on
#: to read the missing list.
PORTED_TRAIN = {"--coordinator": ("localhost", SystemExit, "--coordinator 'localhost': must"),
                "--num_processes": ("2", SystemExit, "--num_processes 2 needs --coordinator"),
                "--process_id": ("1", SystemExit, "--process_id 1: must be in"),
                "--single_device": (None, FileNotFoundError, "x"),
                "--spatial": ("2", SystemExit, "--spatial 2 needs as many processes")}
#: The ported multi-rank flags of ``eval``: a use that cannot work (its
#: arguments), and its refusal by name.
PORTED_EVAL = {"--fanout": (["0"], "--fanout 0: must be at least 1"),
               "--spatial": (["0"], "--spatial 0: must be at least 1"),
               "--depth_stages": (["2", "--fanout", "2"],
                                  "--depth_stages is exclusive with --fanout/--spatial"),
               "--pipeline_maps": (["0"], "--pipeline_maps 0: must be at least 1")}


def test_cli_takes_every_jax_subcommand_and_flag():
    want, got = _parser_options(cli_j), _parser_options(cli)
    assert set(got) == set(want)
    for name, options in want.items():
        assert options <= got[name], (name, sorted(options - got[name]))


@pytest.mark.parametrize("command,flag", [(c, f) for c, flags in MULTI_DEVICE.items()
                                          for f in flags])
def test_multi_device_flags_are_refused_by_name(tmp_path, command, flag):
    error = SystemExit
    if command == "eval":
        argv = ["eval", "--testpath", str(tmp_path), "--testlist", "x", "--loadckpt", "x"]
        values, message = PORTED_EVAL[flag]
    else:
        argv = ["train", "--trainpath", str(tmp_path), "--trainlist", "x", "--device", "cpu"]
        value, error, message = PORTED_TRAIN[flag]
        values = [value] if value else []
    with pytest.raises(error, match=message):
        cli.main([*argv, flag, *values])


# --------------------------------------------------------------------------- bench


def test_bench_measures_both_configurations_on_a_tiny_scene():
    """``tools/bench.py``'s measurement and checks at 32x40, V=3, D=16 on the
    CPU (the tool itself refuses to run without a card)."""
    from aa_rmvsnet_tpu_torch.tools import bench
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    samples = bench.scene(2, height=32, width=40, views=3, num_depth=16)
    model = seeded_model(0)
    for name, (_, mode) in bench.CONFIGS.items():
        result = bench.measure(model, samples, name, warmup=1, device="cpu")
        assert result["mode"] == list(mode) and len(result["map_seconds"]) == 2
        assert result["maps_per_s"] == 1.0 / result["map_seconds"][1]
        assert result["peak_gib"] is None


def test_bench_needs_a_card():
    from aa_rmvsnet_tpu_torch.tools import bench

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert bench.main([]) == 1
