"""The port's training data path and ``cli train`` on a synthetic DTU tree.

The tree is the one ``tests/test_pipeline.py:TestDTUTrainDataset`` builds
(3 views x 7 lights of random PNGs, 64x80 after image_scale 0.25).  The
port's ``DTUTrainDataset`` must give the JAX package's samples array for
array; ``cli train --device cpu`` must write checkpoints, resume from the
highest one, and leave a checkpoint that ``cli eval --loadckpt`` reads.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.data.dtu import DTUTrainDataset as DTUTrainDatasetJ
from aa_rmvsnet_tpu.data.loader import batched as batched_j
from aa_rmvsnet_tpu.data.loader import resilient_samples as resilient_samples_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.core.pfm import read_pfm
from aa_rmvsnet_tpu_torch.data.dtu import DTUTrainDataset
from aa_rmvsnet_tpu_torch.data.loader import batched, resilient_samples
from aa_rmvsnet_tpu_torch.pipeline.checkpoint import checkpoint_path, latest_step

from scenefix import make_plane_scene
import test_pipeline

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    listfile = test_pipeline.TestDTUTrainDataset._make_dtu(None, str(root))
    return str(root), listfile


@pytest.mark.parametrize("inverse_depth", [False, True], ids=["linear", "inverse"])
def test_dtu_dataset_matches_jax(dtu_tree, inverse_depth):
    root, listfile = dtu_tree
    kwargs = dict(nviews=3, ndepths=8, image_scale=0.25, inverse_depth=inverse_depth)
    ds_t = DTUTrainDataset(root, listfile, **kwargs)
    ds_j = DTUTrainDatasetJ(root, listfile, **kwargs)
    assert ds_t.metas == ds_j.metas and len(ds_t) == 42
    for idx in (0, 1, 17, 41):
        got, want = ds_t[idx], ds_j[idx]
        assert got.keys() == want.keys()
        for key in want:
            if isinstance(want[key], str):
                assert got[key] == want[key]
            else:
                assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_batched_resilient_stream_matches_jax():
    """A flaky dataset through ``resilient_samples`` + ``batched``: the same
    substitutions, the same batches, the same skip count."""

    class Flaky:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            if i in (0, 3):
                raise OSError(f"bad sample {i}")
            return {"x": np.full((2,), i, np.float32), "name": f"s{i}"}

    out = []
    for resilient, batch_fn in ((resilient_samples, batched),
                                (resilient_samples_j, batched_j)):
        skips = []
        stream = resilient(Flaky(), num_workers=2, on_skip=skips.append)
        out.append(([b["x"].tolist() for b in batch_fn(stream, 2, drop_last=True)],
                    len(skips)))
    assert out[0] == out[1]
    assert len(out[0][0]) == 3 and out[0][1] == 2


def _train(args, timeout=600):
    cmd = [sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "train", "--device", "cpu",
           "--numdepth", "8", "--view_num", "3", "--depth_block", "4",
           "--num_workers", "0", "--summary_freq", "1", *args]
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO_ROOT}
    run = subprocess.run(cmd, cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


def test_cli_train_saves_resumes_and_feeds_eval(dtu_tree, tmp_path):
    root, listfile = dtu_tree
    logdir = str(tmp_path / "logs")
    common = ["--trainpath", root, "--trainlist", listfile, "--logdir", logdir]

    out = _train(common + ["--max_steps", "2"])
    assert "step 2: loss=" in out
    assert latest_step(logdir) == 2
    assert os.path.exists(os.path.join(logdir, "results", "train", "2.npz"))  # TrainLogger

    out = _train(common + ["--max_steps", "1", "--resume", "--no_tensorboard"])
    assert "resumed from step 2" in out and "step 3: loss=" in out
    assert latest_step(logdir) == 3
    payload = torch.load(checkpoint_path(logdir, 3), weights_only=True)
    assert payload["step"] == 3 and {"model", "optimizer", "scheduler"} <= payload.keys()

    scene = tmp_path / "scene"
    make_plane_scene(str(scene), H=32, W=40, num_views=3)
    (scene / "list.txt").write_text("scan1\n")
    outdir = tmp_path / "out"
    cli.main(["eval", "--device", "cpu", "--testpath", str(scene),
              "--testlist", str(scene / "list.txt"), "--outdir", str(outdir),
              "--loadckpt", checkpoint_path(logdir, 3), "--preset", "dtu_eval_smoke",
              "--view_num", "3", "--numdepth", "8", "--max_h", "32", "--max_w", "40",
              "--depth_block", "4"])
    depth, _ = read_pfm(str(outdir / "scan1" / "depth_est_0" / "00000000.pfm"))
    assert depth.shape == (32, 40) and np.isfinite(depth).all()


@pytest.mark.parametrize("flag", ["--evidential", "--spatial", "--single_device"])
def test_cli_train_refuses_unported_flags(flag, tmp_path):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["train", "--trainpath", str(tmp_path), "--trainlist", "x", flag])


def test_cli_train_cuda_without_a_card_raises(dtu_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    root, listfile = dtu_tree
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--trainpath", root, "--trainlist", listfile,
                  "--logdir", str(tmp_path), "--no_tensorboard", "--numdepth", "8",
                  "--view_num", "3", "--num_workers", "0"])
