"""Each cell's control comes out not correct under the cell's own limits,
and the program, computed as the reference computes, comes out correct.

At toy sizes the bf16 path's rounding is not the card's at full size, so
the eval cells' program runs here on its exact fp32 path; the control is
what every run of the cell is held against on the card: the reference,
computed in the precision below the configuration's, in the program's
place (fp8 operands for the bf16 core, TF32 for fp32).  TF32 exists only
on the card, so the training cells' control runs there (``cuda`` marker:
``python -m pytest benchmark/tests -m cuda`` on the card)."""

from __future__ import annotations

import pytest
import torch

from benchmark.run import run_cell

from .toy import EXACT, work



@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs a CUDA card; this control runs on the card")
    return "cuda"


@pytest.mark.parametrize("cell", ["dtu_eval.defaults", "dtu_eval.evidential"])
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_eval_control_is_not_correct(cell, seed):
    program, _ = run_cell(cell, seed, 0.0, False, "cpu", variant=EXACT, work=work(cell))
    assert program["correct"] is True, program["checks"]
    control, _ = run_cell(cell, seed, 0.0, False, "cpu", variant=work(cell)["control"],
                          work=work(cell))
    assert control["correct"] is False, control["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dtu_train.fp32", "dtu_train.evidential"])
def test_training_control_is_not_correct(cell, card):
    """At the cell's own size (three steps and their replay: seconds)."""
    program, _ = run_cell(cell, 21, 0.0, False, card)
    assert program["correct"] is True, program["checks"]
    control, _ = run_cell(cell, 21, 0.0, False, card, variant={"reference": "tf32"})
    assert control["correct"] is False, control["checks"]
