"""The check catches a broken timed path: the rest of a run driven on the
CPU at toy sizes, with the program broken underneath, reads ``correct``
false under the cell's own limits; once for each fault the cell can have
on one card (no cell exchanges anything between cards)."""

from __future__ import annotations

import pytest
import torch

from benchmark.run import run_cell

from .toy import EXACT, work



@pytest.mark.parametrize("cell", ["dtu_eval.defaults", "dtu_eval.evidential"])
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from aa_rmvsnet_tpu_torch.pipeline import infer

    save = infer.save_outputs

    def altered(out_dir, ref_view, depth, confidence, *rest):
        depth = depth.copy()
        depth[: depth.shape[0] // 4] += 8.0  # eight hypotheses off on a quarter of the rows
        return save(out_dir, ref_view, depth, confidence, *rest)

    result, _ = run_cell(cell, 3, 0.0, False, "cpu", variant=EXACT, work=work(cell))
    assert result["correct"] is True, result["checks"]
    monkeypatch.setattr(infer, "save_outputs", altered)
    result, _ = run_cell(cell, 3, 0.0, False, "cpu", variant=EXACT, work=work(cell))
    assert result["correct"] is False


def _no_group_norm_affine(monkeypatch):
    """Every GroupNorm of the core normalises and drops its scale and shift."""
    monkeypatch.setattr(torch.nn.GroupNorm, "forward", lambda self, x: torch.nn.functional
                        .group_norm(x, self.num_groups, None, None, self.eps))


def _no_conv_bias(monkeypatch):
    """Every convolution of the core's blocks (FeatNet, the deformable
    branches, the ConvLSTM cells) drops its bias."""
    from aa_rmvsnet_tpu_torch.models import blocks

    conv2d_rows = blocks.conv2d_rows

    def unbiased(conv, x, mesh, **kwargs):
        kwargs["bias"] = torch.zeros_like(conv.bias)
        return conv2d_rows(conv, x, mesh, **kwargs)

    monkeypatch.setattr(blocks, "conv2d_rows", unbiased)


@pytest.mark.parametrize("fault", [_no_group_norm_affine, _no_conv_bias],
                         ids=["group_norm_affine", "conv_bias"])
@pytest.mark.parametrize("cell", ["dtu_eval.defaults", "dtu_eval.evidential"])
def test_an_affine_term_dropped(cell, fault, monkeypatch):
    """The seeded weights give every scale, shift and bias a value of its
    own, so a path that drops one reads otherwise than the reference."""
    fault(monkeypatch)
    result, _ = run_cell(cell, 5, 0.0, False, "cpu", variant=EXACT, work=work(cell))
    assert result["correct"] is False


def test_a_map_off_its_packed_mode_fails():
    """The cell's maps run on the packed warp; one that falls back to the
    exact path counts as failed, and the run is not correct."""
    result, _ = run_cell("dtu_eval.defaults", 8, 0.0, False, "cpu",
                         variant={"infer": {"packed_rows": False, "fused_residual": False}},
                         work=work("dtu_eval.defaults"))
    assert result["failed"] > 0
    assert result["correct"] is False


@pytest.mark.parametrize("cell", ["dtu_train.fp32", "dtu_train.evidential"])
def test_a_window_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    """Set-up's three steps are sound; from the window's first step on,
    Adam's step does nothing (as a captured step replayed on stale buffers
    might).  The window's last step catches it."""
    from benchmark.drivers import train

    setup = train.Cell.setup

    def sound_setup(self, seconds):
        setup(self, seconds)
        monkeypatch.setattr(self.optimizer, "step", lambda closure=None: None)

    monkeypatch.setattr(train.Cell, "setup", sound_setup)
    result, broken = run_cell(cell, 9, 0.0, False, "cpu", work=work(cell))
    assert broken["loss1_rel"] <= work(cell)["limits"]["loss1_rel"]
    assert broken["last_change_gap_median"] == pytest.approx(1.0)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", ["dtu_train.fp32", "dtu_train.evidential"])
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    limit = work(cell)["limits"]["change_gap"]
    _, sound = run_cell(cell, 4, 0.0, False, "cpu", work=work(cell))
    assert sound["change_gap"] <= limit
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result, broken = run_cell(cell, 4, 0.0, False, "cpu", work=work(cell))
    assert result["correct"] is False
    assert broken["change_gap"] == pytest.approx(1.0)


#: The number each cell's half-batch fault trips on the card (PERF.md §2);
#: the worst-leaf numbers of the sound run swing more at toy sizes.
HALF_BATCH = {"dtu_train.fp32": "grad_gap", "dtu_train.evidential": "loss1_rel"}


@pytest.mark.parametrize("cell", sorted(HALF_BATCH))
def test_half_the_batch_left_out(cell, monkeypatch):
    """The loss's mean over the upper half of the rows alone."""
    from aa_rmvsnet_tpu_torch.pipeline import train

    number = HALF_BATCH[cell]
    limit = work(cell)["limits"][number]
    _, sound = run_cell(cell, 6, 0.0, False, "cpu", work=work(cell))
    assert sound[number] <= limit
    name = "loss_emvsnet" if cell.endswith("evidential") else "depth_classification_loss"
    loss = getattr(train, name)
    mask_at = 5 if name == "loss_emvsnet" else 2

    def half(*args, **kwargs):
        args = list(args)
        mask = args[mask_at].clone()
        mask[:, mask.shape[1] // 2:] = 0.0
        args[mask_at] = mask
        return loss(*args, **kwargs)

    monkeypatch.setattr(train, name, half)
    result, broken = run_cell(cell, 6, 0.0, False, "cpu", work=work(cell))
    assert result["correct"] is False
    assert broken[number] > limit
