"""The frozen reference against the port on the CPU at toy sizes, and the
FLOP count against a count of the operations the port runs.

The port's fp32 paths compute what the reference computes, so these hold
them to fp32's rounding: on the eval path the reference's best cost at
every pixel's depth and the confidence to 1e-5; in training the losses,
the first gradient by leaf and the head's BatchNorm statistics.  The
cell's own bf16 path is held by the check's limits on the card."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.run import run_cell

from .toy import EXACT, TOY, work

PACKED_FP32 = {"infer": {"feature_dtype": "float32"}}


@pytest.mark.parametrize("variant", [EXACT, PACKED_FP32], ids=["exact", "packed"])
def test_eval_reference_equals_the_port_in_fp32(variant):
    _, numbers = run_cell("dtu_eval.defaults", 1234567890123, 0.0, False, "cpu",
                          variant=variant, work=work("dtu_eval.defaults"))
    assert numbers["depth_gap_max"] <= 1e-5
    assert numbers["conf_err_max"] <= 1e-5


def test_evidential_eval_reference_equals_the_port_in_fp32():
    _, numbers = run_cell("dtu_eval.evidential", 77, 0.0, False, "cpu", variant=EXACT,
                          work=work("dtu_eval.evidential"))
    assert numbers["conf_err_max"] <= 1e-5
    assert numbers["gamma_err_max"] <= 2e-3  # depths ~430-440 mm: 5e-6 relative
    assert numbers["aleatoric_rel_max"] <= 1e-4
    assert numbers["epistemic_rel_max"] <= 1e-4


@pytest.mark.parametrize("cell", ["dtu_train.fp32", "dtu_train.evidential"])
def test_training_reference_equals_the_port(cell):
    """The first loss to fp32's rounding.  Some leaves' gradients are small
    sums of large terms of both signs (a bias before a GroupNorm), whose
    fp32 rounding alone moves them by up to ~1 % of the median leaf (the
    reference in fp32 against itself in fp64 reads the same); Adam's first
    steps then move each weight by about the learning rate times the sign
    of its gradient, so a few weights whose gradient is near 0 step the
    other way, and the later losses and the change follow."""
    _, numbers = run_cell(cell, 99, 0.0, False, "cpu", work=work(cell))
    assert numbers["loss1_rel"] <= (1e-6 if cell.endswith("fp32") else 1e-4)
    assert numbers["loss_rel"] <= 1e-3
    assert numbers["grad_gap"] <= 0.05
    assert numbers["change_gap"] <= 0.3
    if cell.endswith("evidential"):
        assert numbers["stats_gap"] <= 1e-2


def _port_flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_flop_count_matches_the_ports_operations():
    from aa_rmvsnet_tpu_torch.models.evidential import EvidentialHead, evidential_apply
    from aa_rmvsnet_tpu_torch.models.network import AARMVSNetCore, SweepConfig, forward

    H, W, V, D, M = TOY["height"], TOY["width"], TOY["views"], TOY["num_depth"], TOY["maxdisp"]
    imgs = torch.randn(1, V, H, W, 3)
    proj = torch.eye(4).repeat(1, V, 1, 1)
    depths = torch.linspace(400, 500, D)[None]
    core = AARMVSNetCore()
    with torch.no_grad():
        counted = _port_flops(lambda: forward(core, imgs, proj, depths,
                                              SweepConfig(depth_block=8, collect_volume=False)))
        assert counted == pytest.approx(flops.core_forward(H, W, V, D), rel=1e-9)
        head = EvidentialHead(M).eval()
        counted = _port_flops(lambda: evidential_apply(head, torch.randn(1, D, H, W), depths))
        assert counted == pytest.approx(flops.head_forward(H, W, D, M), rel=1e-9)
