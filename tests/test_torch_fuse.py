"""The port's depth-map fusion and quality metrics against the JAX package.

The reproject-and-vote (``ops/fusion.py``: on the CPU the plain version of
the CUDA kernel) against the JAX package's C++ core
(``pipeline/native.py:fuse_pair_native``) accumulated over the same
sources; ``fuse_scan`` and ``fuse_scan_padded`` against JAX's, in point
count, vertex order, xyz (rtol 1e-6) and colours (within 1), and against
JAX's numpy/cv2.remap path within 1 % of points, JAX's own bar between its
two paths (``tests/test_pipeline.py:638``); view blocks, the cv2 image
operations, the PLY writer, the quality metrics and the two CLI
subcommands.  The scenes are 64x80 planes from ``tests/scenefix.py`` whose
predicted depths are the plane plus noise of 1.5 at depth 500, where level
i passes a relative depth error under 0.38 i: the masks of every level
are mixed.
"""

import contextlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu import cli as cli_j
from aa_rmvsnet_tpu.core.ply import read_ply as read_ply_j
from aa_rmvsnet_tpu.core.ply import write_ply as write_ply_j
from aa_rmvsnet_tpu.pipeline import fuse as fuse_j
from aa_rmvsnet_tpu.pipeline import native as native_j
from aa_rmvsnet_tpu.utils.quality import accuracy_completeness as accuracy_completeness_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.core.ply import read_ply, write_ply
from aa_rmvsnet_tpu_torch.ops import fusion
from aa_rmvsnet_tpu_torch.ops.image import pyr_down, resize_linear
from aa_rmvsnet_tpu_torch.pipeline import fuse
from aa_rmvsnet_tpu_torch.utils.quality import accuracy_completeness

from scenefix import make_plane_scene, write_prediction

torch.set_num_threads(2)

H, W, VIEWS, PLANE, NOISE = 64, 80, 5, 500.0, 1.5


def _native():
    if not native_j.available():
        pytest.skip("no C++ toolchain for the JAX package's native fusion core")


def _noisy(root, seed=0, padded=False):
    """A plane scene with noisy predictions: full-resolution maps, or the
    padded pipeline's half-resolution maps with 2 pad rows top and bottom."""
    scene, gt, K, Es = make_plane_scene(str(root), H=H, W=W, num_views=VIEWS)
    out_dir = os.path.join(str(root), "out", "scan1")
    rng = np.random.RandomState(seed)
    h, w = (H // 2, W // 2) if padded else (H, W)
    for v in range(VIEWS):
        depth = (PLANE + NOISE * rng.randn(h, w)).astype(np.float32)
        conf = rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)
        if padded:
            depth, conf = np.pad(depth, ((2, 2), (0, 0))), np.pad(conf, ((2, 2), (0, 0)))
        write_prediction(out_dir, v, depth, conf)
    return scene, out_dir, K, Es


def _same_cloud(path_t, path_j):
    xt, ct = read_ply(path_t)
    xj, cj = read_ply_j(path_j)
    assert xt.shape == xj.shape and len(xt) > 0
    np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-6 * np.abs(xj).max())
    assert np.abs(ct.astype(int) - cj.astype(int)).max() <= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_fuse_ref_matches_native_core(tmp_path, seed):
    """Level counts, loose counts and reprojected sums of one reference view
    against the C++ core accumulated over its four sources: counts equal on
    >= 99.99 % of pixels, each other pixel within 1e-9 of a threshold (none
    is, since the two give the same bits), sums at rtol 1e-6."""
    _native()
    _, _, K, Es = make_plane_scene(str(tmp_path), H=H, W=W, num_views=VIEWS)
    rng = np.random.RandomState(seed)
    depths = (PLANE + NOISE * rng.randn(VIEWS, H, W)).astype(np.float32)
    ref, srcs = 2, [1, 3, 0, 4]
    levels = np.zeros((9, H, W), np.int32)
    loose = np.zeros((H, W), np.int32)
    sums = np.zeros((H, W), np.float32)
    for s in srcs:
        native_j.fuse_pair_native(depths[ref], K, Es[ref], depths[s], K, Es[s],
                                  levels, loose, sums)
    mats = torch.from_numpy(np.stack([fusion.pair_matrices(K, Es[ref], K, Es[s])
                                      for s in srcs]))
    index = torch.tensor(srcs, dtype=torch.int32)
    got = fusion.fuse_ref(torch.from_numpy(depths), ref, index, mats)
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.float32]
    counts, loose_t, sums_t = (t.numpy() for t in got)

    # Mixed masks: every level passes somewhere and fails somewhere.
    share = (counts > 0).mean(axis=(1, 2))
    assert np.all((share > 0.05) & (share < 0.999)), share
    differ = (counts != levels).any(axis=0) | (loose_t != loose)
    assert differ.mean() <= 1e-4, differ.mean()
    if differ.any():
        near = np.zeros((H, W), bool)
        for s, m in zip(srcs, mats.tolist()):
            dist, rel, *_ = fusion.pair_terms(torch.from_numpy(depths[ref]),
                                              torch.from_numpy(depths[s]), m)
            for dt, rt in fusion.level_thresholds(9, 4.0, 1300.0):
                near |= ((dist - dt).abs() < 1e-9).numpy() | ((rel - rt).abs() < 1e-9).numpy()
        assert near[differ].all()
    np.testing.assert_allclose(sums_t, sums, rtol=1e-6)
    np.testing.assert_array_equal(sums_t, sums)


def test_pair_functions_match_jax_numpy_path(tmp_path):
    """``graduated_consistency`` and ``reproject_with_depth`` (the C++
    core's arithmetic) against JAX's numpy/cv2.remap ones, at the bar of
    ``tests/test_pipeline.py:test_native_matches_numpy_path``."""
    _, gt, K, Es = make_plane_scene(str(tmp_path), H=48, W=64, num_views=2)
    rng = np.random.RandomState(0)
    ref_depth = gt + rng.randn(*gt.shape).astype(np.float32) * 0.5
    src_depth = gt + rng.randn(*gt.shape).astype(np.float32) * 0.5
    args = (ref_depth, K.astype(np.float64), Es[0].astype(np.float64),
            src_depth, K.astype(np.float64), Es[1].astype(np.float64))
    masks_t, reproj_t = fuse.graduated_consistency(*args, fuse.FuseConfig())
    masks_j, reproj_j = fuse_j.graduated_consistency(*args, fuse_j.FuseConfig())
    assert (np.stack(masks_t) == np.stack(masks_j)).mean() > 0.999
    both = masks_t[-1] & masks_j[-1]
    np.testing.assert_allclose(reproj_t[both], reproj_j[both], rtol=1e-4)
    for a, b in zip(fuse.reproject_with_depth(*args), fuse_j.reproject_with_depth(*args)):
        assert a.dtype == np.float32 and a.shape == b.shape
        # Pixel coordinates at x = 0 come out as +-1e-15: an absolute 1e-5 px there.
        np.testing.assert_allclose(a[both], b[both], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.35, 0.2], ids=["dtu", "tnt"])
def test_fuse_scan_matches_jax(tmp_path, threshold):
    _native()
    scene, out_dir, _, _ = _noisy(tmp_path)
    path_t, path_j, path_n = (str(tmp_path / f"{k}.ply") for k in "tjn")
    n_t = fuse.fuse_scan(scene, out_dir, path_t, fuse.FuseConfig(
        photo_threshold=threshold, num_workers=2, device="cpu"))
    n_j = fuse_j.fuse_scan(scene, out_dir, path_j, fuse_j.FuseConfig(
        photo_threshold=threshold, num_workers=2))
    n_n = fuse_j.fuse_scan(scene, out_dir, path_n, fuse_j.FuseConfig(
        photo_threshold=threshold, num_workers=2, use_native=False))
    assert n_t == n_j
    _same_cloud(path_t, path_j)
    assert abs(n_t - n_n) <= 0.01 * max(n_t, n_n)


def _native_pairs(depth_ref, K_ref, E_ref, depth_src, K_src, E_src, config):
    """JAX's ``graduated_consistency`` computed by its C++ core: for one pair
    the level counts are the masks."""
    levels = np.zeros((config.num_levels,) + depth_ref.shape, np.int32)
    loose = np.zeros(depth_ref.shape, np.int32)
    reproj = np.zeros(depth_ref.shape, np.float32)
    native_j.fuse_pair_native(depth_ref, K_ref, E_ref, depth_src, K_src, E_src, levels, loose,
                              reproj, config.dist_base, config.rel_diff_base)
    return [m.astype(bool) for m in levels], reproj


def test_fuse_scan_padded_matches_jax(tmp_path, monkeypatch):
    """The padded variant against JAX's, which fuses on its numpy/cv2.remap
    path only: within 1 % of its points; and equal (count, order, xyz,
    colours) to JAX's variant made to fuse with its C++ core."""
    _native()
    scene, out_dir, _, _ = _noisy(tmp_path, seed=3, padded=True)
    path_t, path_j, path_n = (str(tmp_path / f"{k}.ply") for k in "tjn")
    n_t = fuse.fuse_scan_padded(scene, out_dir, path_t, fuse.FuseConfig(
        photo_threshold=0.3, num_workers=2, device="cpu"))
    n_n = fuse_j.fuse_scan_padded(scene, out_dir, path_n, num_workers=2)
    assert abs(n_t - n_n) <= 0.01 * max(n_t, n_n), (n_t, n_n)
    monkeypatch.setattr(fuse_j, "graduated_consistency", _native_pairs)
    n_j = fuse_j.fuse_scan_padded(scene, out_dir, path_j, num_workers=2)
    assert n_t == n_j > 0
    _same_cloud(path_t, path_j)


@pytest.mark.parametrize("padded", [False, True], ids=["dtu", "tnt_padded"])
def test_view_blocks_merge_to_the_single_cloud(tmp_path, padded):
    scene, out_dir, _, _ = _noisy(tmp_path, padded=padded)
    run = fuse.fuse_scan_padded if padded else fuse.fuse_scan
    config = fuse.FuseConfig(photo_threshold=0.3 if padded else 0.35, num_workers=2,
                             device="cpu")
    single = str(tmp_path / "single.ply")
    n = run(scene, out_dir, single, config)
    blocks = [str(tmp_path / f"part.block{b}of3.ply") for b in range(3)]
    for b, path in enumerate(blocks):
        run(scene, out_dir, path, config, view_block=(b, 3))
    assert fuse.merge_ply_blocks(blocks, str(tmp_path / "merged.ply")) == n
    with open(single, "rb") as a, open(tmp_path / "merged.ply", "rb") as b:
        assert a.read() == b.read()


def test_empty_view_block_writes_an_empty_cloud(tmp_path):
    """A block whose reference views have no depth maps fuses zero points
    and still writes its PLY; the whole scan with no maps raises."""
    scene, _, _, _ = make_plane_scene(str(tmp_path), H=H, W=W, num_views=4)
    empty = str(tmp_path / "none")
    config = fuse.FuseConfig(num_workers=2, device="cpu")
    path = str(tmp_path / "b.ply")
    assert fuse.fuse_scan(scene, empty, path, config, view_block=(1, 2)) == 0
    assert read_ply(path)[0].shape == (0, 3)
    with pytest.raises(RuntimeError, match="no fused points"):
        fuse.fuse_scan(scene, empty, path, config)


def test_use_native_false_and_cuda_without_a_card_are_refused(tmp_path):
    scene, out_dir, _, _ = _noisy(tmp_path)
    path = str(tmp_path / "x.ply")
    with pytest.raises(NotImplementedError, match="no numpy/cv2.remap fusion path"):
        fuse.fuse_scan(scene, out_dir, path, fuse.FuseConfig(use_native=False, device="cpu"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuse.fuse_scan(scene, out_dir, path, fuse.FuseConfig(num_workers=2))


def test_save_masks_and_display(tmp_path, monkeypatch):
    """``save_masks`` writes the PNGs JAX's writes; ``display`` shows the
    same panes JAX's shows (cv2's window calls recorded)."""
    _native()
    scene, out_dir, _, _ = _noisy(tmp_path)
    shown = {}
    for name, module, kwargs in (("t", fuse, dict(device="cpu")), ("j", fuse_j, {})):
        frames = shown.setdefault(name, [])
        monkeypatch.setattr(cv2, "imshow", lambda title, img, f=frames: f.append((title, img)))
        monkeypatch.setattr(cv2, "waitKey", lambda *a: -1)
        monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
        module.fuse_scan(scene, out_dir, str(tmp_path / f"{name}.ply"),
                         module.FuseConfig(num_workers=2, **kwargs), save_masks=True,
                         display=True)
        os.rename(os.path.join(out_dir, "mask"), os.path.join(out_dir, f"mask_{name}"))
    assert [t for t, _ in shown["t"]] == [t for t, _ in shown["j"]] and len(shown["t"]) == VIEWS
    for (_, a), (_, b) in zip(shown["t"], shown["j"]):
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1
    names = sorted(os.listdir(os.path.join(out_dir, "mask_j")))
    assert names == sorted(os.listdir(os.path.join(out_dir, "mask_t"))) and len(names) == 3 * VIEWS
    for n in names:
        np.testing.assert_array_equal(cv2.imread(os.path.join(out_dir, "mask_t", n)),
                                      cv2.imread(os.path.join(out_dir, "mask_j", n)))


@pytest.mark.parametrize("src,dst", [((1200, 1600), (864, 1152)), ((64, 80), (64, 80)),
                                     ((64, 80), (32, 40)), ((37, 53), (50, 71)),
                                     ((1080, 1920), (1056, 1877))])
def test_resize_linear_matches_cv2(src, dst):
    img = np.random.RandomState(0).rand(*src, 3).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]))
    got = resize_linear(torch.from_numpy(img), dst[1], dst[0]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(64, 80), (37, 53), (7, 9)])
def test_pyr_down_matches_cv2(shape):
    img = np.random.RandomState(1).randint(0, 256, (*shape, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pyr_down(torch.from_numpy(img)).numpy(), cv2.pyrDown(img))
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(pyr_down(torch.from_numpy(f)).numpy(), cv2.pyrDown(f),
                               atol=1e-5, rtol=0)


def test_write_ply_byte_for_byte(tmp_path):
    rng = np.random.RandomState(2)
    xyz = rng.randn(1000, 3).astype(np.float32) * 100
    rgb = rng.randint(0, 256, (1000, 3)).astype(np.uint8)
    write_ply(str(tmp_path / "t.ply"), xyz, rgb)
    write_ply_j(str(tmp_path / "j.ply"), xyz, rgb)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got = read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(got[0], xyz)
    np.testing.assert_array_equal(got[1], rgb)
    with pytest.raises(ValueError, match="matching"):
        write_ply(str(tmp_path / "bad.ply"), xyz, rgb[:10])


@pytest.mark.parametrize("downsample", [0.0, 0.5])
def test_accuracy_completeness_matches_jax(downsample):
    rng = np.random.RandomState(3)
    gt = rng.rand(3000, 3) * 50
    pred = (gt[:2000] + rng.randn(2000, 3) * 0.3).astype(np.float32)
    got = accuracy_completeness(pred, gt, max_dist=2.0, downsample=downsample)
    want = accuracy_completeness_j(pred, gt, max_dist=2.0, downsample=downsample)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def _fuse_cli(main, scene_root, outdir, *flags):
    main(["fuse", "--testpath", str(scene_root), "--testlist", str(scene_root / "list.txt"),
          "--outdir", str(outdir), "--num_workers", "2", *flags])


@pytest.mark.parametrize("dataset", ["dtu", "tnt", "tnt_padded"])
def test_cli_fuse_matches_jax(tmp_path, monkeypatch, dataset):
    """``cli fuse --device cpu`` against the JAX ``cli fuse`` on a plane
    scene whose predictions sit on the plane, by scan and by view block
    with ``--merge_blocks``: the same PLY names and clouds (the padded
    variant against JAX's made to fuse with its C++ core)."""
    _native()
    padded = dataset == "tnt_padded"
    root = tmp_path / "scene"
    make_plane_scene(str(root), H=H, W=W, num_views=4)
    (root / "list.txt").write_text("scan1\n")
    h, w = (H // 2, W // 2) if padded else (H, W)
    depth = np.full((h, w), PLANE, np.float32)
    conf = np.full((h, w), 0.9, np.float32)
    if padded:
        depth, conf = np.pad(depth, ((2, 2), (0, 0))), np.pad(conf, ((2, 2), (0, 0)))
        monkeypatch.setattr(fuse_j, "graduated_consistency", _native_pairs)
    outs = {k: tmp_path / k for k in ("t", "j", "tb", "jb")}
    for out in outs.values():
        for v in range(4):
            write_prediction(str(out / "scan1"), v, depth, conf)
    name = "mvsnet_001_l3.ply" if dataset == "dtu" else "scan1.ply"
    flags = ["--test_dataset", dataset]
    _fuse_cli(cli.main, root, outs["t"], *flags, "--device", "cpu")
    _fuse_cli(cli_j.main, root, outs["j"], *flags)
    for b in range(2):
        _fuse_cli(cli.main, root, outs["tb"], *flags, "--device", "cpu", "--view_block",
                  str(b), "--num_view_blocks", "2")
        _fuse_cli(cli_j.main, root, outs["jb"], *flags, "--view_block", str(b),
                  "--num_view_blocks", "2")
    _fuse_cli(cli.main, root, outs["tb"], *flags, "--num_view_blocks", "2", "--merge_blocks")
    _fuse_cli(cli_j.main, root, outs["jb"], *flags, "--num_view_blocks", "2",
              "--merge_blocks")
    _same_cloud(str(outs["t"] / name), str(outs["j"] / name))
    _same_cloud(str(outs["tb"] / name), str(outs["jb"] / name))
    assert (outs["tb"] / name).read_bytes() == (outs["t"] / name).read_bytes()


def test_cli_quality_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    gt = (rng.rand(2000, 3) * 20).astype(np.float32)
    pred = (gt + rng.randn(2000, 3).astype(np.float32) * 0.2).astype(np.float32)
    colors = np.zeros((2000, 3), np.uint8)
    write_ply(str(tmp_path / "pred.ply"), pred, colors)
    write_ply(str(tmp_path / "gt.ply"), gt, colors)
    printed = []
    for main in (cli.main, cli_j.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["quality", "--ply", str(tmp_path / "pred.ply"), "--gt",
                  str(tmp_path / "gt.ply"), "--downsample", "0.1"])
        printed.append(json.loads(buf.getvalue()))
    assert printed[0].keys() == printed[1].keys()
    for k, v in printed[1].items():
        assert printed[0][k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
