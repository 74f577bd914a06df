"""``dtu_eval.production`` on the CPU at a toy size: a map counts as failed
unless it ran in its reference camera's mode, and the cell's control is
not correct, where the program's levers at the toy size are.

The toy is ``toy.py``'s eval geometry (32x40, 3 views, 32 hypotheses,
focal 40 px) with the cameras 700 units apart, where the levers pick one
mode for the middle reference and another for the two at the ends, as on
the cell's line of 5 cameras at full size: (True, 2, 6) in the middle
after 2 gate calls, (True, 1, 6) at the ends after 4."""

from __future__ import annotations

import pytest

from benchmark.run import run_cell

from .toy import work as toy_work

CELL = "dtu_eval.production"
MODES = [[True, 1, 6], [True, 2, 6], [True, 1, 6]]


def work(modes=MODES) -> dict:
    w = toy_work(CELL)
    w["traffic_params"].update(baseline=700.0)
    w["config_data"]["num_depth"] = 32
    w["mode_by_camera"] = modes
    return w


def test_each_map_runs_in_its_cameras_mode():
    """The scenes take the cameras in turn; each map is held to its own
    camera's mode, and the gate's calls reach the summary."""
    from benchmark.drivers import eval_levers

    cell = eval_levers.Cell(work(), 7, "cpu")
    cell.setup(0.0)
    cameras = [cell.mode_of(s) for s in cell.samples]
    assert cameras == [tuple(MODES[i % 3]) for i in range(len(cell.samples))]
    assert all(cell.step(i) for i in range(len(cell.samples)))
    calls = {(True, 1, 6): 4, (True, 2, 6): 2}
    assert cell.work_done(len(cell.samples))["gate_calls"] == [calls[m] for m in cameras]


def test_a_map_off_its_cameras_mode_fails():
    result, _ = run_cell(CELL, 7, 2.0, False, "cpu", work=work())
    assert result["failed"] == 0 and result["correct"] is True, result
    swapped = work(modes=[MODES[1], MODES[0], MODES[1]])
    result, _ = run_cell(CELL, 7, 2.0, False, "cpu", work=swapped)
    assert result["failed"] == result["attempted"]
    assert result["correct"] is False


def test_one_mode_for_every_map_fails_the_middle_camera():
    """Every map held to the ends' mode, as ``eval``'s one-mode check would
    hold them: the middle camera's maps fail."""
    from benchmark.drivers import eval_levers

    cell = eval_levers.Cell(work(), 7, "cpu", variant={"mode": MODES[0]})
    cell.setup(0.0)
    assert [cell.step(i) for i in range(3)] == [True, False, True]


@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_production_control_is_not_correct(seed):
    program, _ = run_cell(CELL, seed, 0.0, False, "cpu", work=work())
    assert program["correct"] is True, program["checks"]
    control, _ = run_cell(CELL, seed, 0.0, False, "cpu", variant=work()["control"],
                          work=work())
    assert control["failed"] == 0
    assert control["correct"] is False, control["checks"]
