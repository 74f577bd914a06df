"""``tnt_intermediate_1920.defaults`` on the CPU at a toy size: the port
held to the frozen reference at bounded inverse depth, 7 views from both
ends of the pair list and padded rows; the scene maker held to the port's
padded eval loader; and the cell's check against a map off its mode and
against its control.

The toy keeps every width and the configuration's 7 views, depth block 4,
padding and hypothesis family, and cuts the frames to 32x64 (40x64 with
the padded rows, which the loader's crop keeps at this size), the
hypotheses to 32 and the focal length to 40 px.  Cameras 40 units apart
pass the 4x4 packed gate; 80 apart fail it, as the cell's cameras do at
full size."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import manifest as manifests
from benchmark import scene_tnt
from benchmark.run import run_cell

from .toy import EXACT

CELL = "tnt_intermediate_1920.defaults"
TOY = dict(frame=[32, 64], height=40, width=64, num_depth=32)
PACKED_FP32 = {"infer": {"feature_dtype": "float32"}, "mode": [True, 1, 4]}


def work(baseline: float = 80.0) -> dict:
    w = manifests.cell(manifests.load(), CELL)
    w["config_data"].update(TOY)
    w["traffic_params"].update(focal=40.0, baseline=baseline)
    return w


@pytest.mark.parametrize("variant, baseline", [(EXACT, 80.0), (PACKED_FP32, 40.0)],
                         ids=["exact", "packed"])
def test_tnt_reference_equals_the_port_in_fp32(variant, baseline):
    """The bars of the DTU cells' test (``test_bench_reference.py``)."""
    _, numbers = run_cell(CELL, 2**31 + 1234, 0.0, False, "cpu", variant=variant,
                          work=work(baseline))
    assert numbers["depth_gap_max"] <= 1e-5
    assert numbers["conf_err_max"] <= 1e-5


def test_the_hypothesis_index_of_a_depth():
    from benchmark.drivers.tnt_eval import hypothesis_index

    depths = torch.tensor([500.0, 520.0, 545.0, 580.0])
    got = hypothesis_index(torch.tensor([[500.0, 545.0, 580.0], [509.0, 511.0, 700.0]]), depths)
    assert got.tolist() == [[0, 2, 3], [0, 1, 3]]


def _write_scene(root, frames, cameras, ref, sources, depth_min, depth_end, num_depth):
    """A scene directory as ``EvalDataset`` reads it: PNG data under the
    ``.jpg`` names (``cv2.imread`` reads by content: lossless), cam files
    with ``depth_end``, and a pair list of the reference alone."""
    import cv2

    for sub in ("images", "cams"):
        os.makedirs(os.path.join(root, sub))
    for cam, frame in frames.items():
        bgr = cv2.cvtColor(frame.astype(np.uint8), cv2.COLOR_RGB2BGR)
        cv2.imencode(".png", bgr)[1].tofile(os.path.join(root, "images", f"{cam:08d}.jpg"))
        K, E = cameras[cam]
        rows = ["extrinsic", *(" ".join(repr(float(v)) for v in r) for r in E), "",
                "intrinsic", *(" ".join(repr(float(v)) for v in r) for r in K), "",
                f"{depth_min!r} 1.0 {num_depth} {depth_end!r}"]
        with open(os.path.join(root, "cams", f"{cam:08d}_cam.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "pair.txt"), "w") as f:
        f.write(f"1\n{ref}\n{len(sources)} " + " ".join(f"{s} 1.0" for s in sources) + "\n")


@pytest.mark.parametrize("frame_h", [32, 48], ids=["rows_kept", "rows_cropped"])
def test_the_scene_maker_is_the_padded_loader(tmp_path, frame_h):
    """At 32 rows the padded frame is 40 rows and the loader keeps its zero
    rows; at 48 it crops 8 from each end, as 1080-row frames lose 16."""
    from aa_rmvsnet_tpu_torch.data.eval_dataset import EvalDataset

    geometry = dict(work()["config_data"], frame=[frame_h, 64])
    traffic = work()["traffic_params"]
    ref, neighbours = 5, 5
    sources = scene_tnt.pair_list(ref, neighbours)
    focal, baseline = traffic["focal"], traffic["baseline"]
    cameras = {c: scene_tnt.camera(focal, frame_h, 64, (c - ref) * baseline)
               for c in [ref] + sources}
    gen = torch.Generator().manual_seed(3)
    texture = scene_tnt.textures(1, frame_h, 64 + 2 * 60, 2.0, gen, "cpu")[0]
    frames = scene_tnt.frames(texture, {c: 60 + (c - ref) * 5.5 for c in cameras}, 64)
    frames = {c: np.round(f).astype(np.float32) for c, f in frames.items()}
    scan = tmp_path / "scan"
    _write_scene(str(scan), frames, cameras, ref, sources, 500.0, 2000.0, 32)

    want = EvalDataset(str(tmp_path), ["scan"], nviews=7, ndepths=32, max_h=40, max_w=64,
                       pad_vertical=True)[0]
    got = scene_tnt.sample(frames, cameras, ref, sources, 500.0, 2000.0, geometry)
    for key in ("imgs", "proj_matrices", "depth_values"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["imgs"].shape == (7, 40, 64, 3)
    # The view order: the reference, the list's first three, its last three.
    positions = -got["proj_matrices"][:, 0, 3] / (focal * baseline)
    np.testing.assert_allclose(positions, [0, -1, 1, -2, 4, -5, 5], atol=1e-6)
    # The padded rows: cy (``P[1, 2]`` of ``K [I | t]`` with ``t`` along x)
    # moved down by 4, then up by the crop; where the crop keeps them, each
    # view's 4 rows at either end are one value a channel (the zeros,
    # standardized).
    start_h = (frame_h + 8 - 40) // 2
    assert got["proj_matrices"][0, 1, 2] == frame_h / 2 + 4 - start_h
    if start_h == 0:
        for rows in (got["imgs"][:, :4], got["imgs"][:, -4:]):
            assert (rows == rows[:, :1, :1]).all()
    np.testing.assert_array_equal(
        got["depth_values"],
        (1.0 / np.linspace(1 / 500.0, 1 / 2000.0, 32, endpoint=False)).astype(np.float32))


def test_a_map_off_its_mode_fails():
    """The cell's maps take the unpacked warp (their gate fails); cameras
    that pass the gate put the map on the packed warp, and it counts as
    failed."""
    result, _ = run_cell(CELL, 8, 0.0, False, "cpu", work=work())
    assert result["failed"] == 0, result
    result, _ = run_cell(CELL, 8, 0.0, False, "cpu", work=work(baseline=40.0))
    assert result["failed"] > 0
    assert result["correct"] is False


@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_tnt_control_is_not_correct(seed):
    program, _ = run_cell(CELL, seed, 0.0, False, "cpu", variant=EXACT, work=work())
    assert program["correct"] is True, program["checks"]
    control, _ = run_cell(CELL, seed, 0.0, False, "cpu", variant=work()["control"],
                          work=work())
    assert control["failed"] == 0
    assert control["correct"] is False, control["checks"]


def test_the_gate_calls_reach_the_summary():
    """One ``pick_packed_rows`` call a map under the defaults."""
    from benchmark.drivers import tnt_eval

    cell = tnt_eval.Cell(work(), 4, "cpu")
    cell.setup(0.0)
    assert cell.step(0) and cell.step(1)
    summary = cell.work_done(2)
    assert summary["gate_calls"] == [1, 1]
    assert manifests.reader("infer.gate_calls_per_map")(summary) == 1.0
