"""Depth maps of Tanks and Temples at full resolution: ``cli eval``'s path,
``run_inference``, one map a step, on the padded loader's samples
(``benchmark/scene_tnt.py``: 7 views with sources from both ends of the
pair list, bounded inverse-depth hypotheses).

``eval_levers``' cell on these scenes: set-up makes the weights and the
window's scenes from the seed, loads the weights into the core, casts it
once to the sweep's precision as ``run_inference`` would, and warms every
shape of the window with one ``run_inference`` call on the first scene
with the sweep cut to four depth blocks.  A map counts as failed unless it
ran in the workload file's ``mode`` and, on the card, launched the
ConvLSTM gate kernel once per cell and hypothesis.

The check is ``eval``'s on the winner's index: the hypotheses are spaced
in inverse depth, so each depth the program wrote is taken to the index
of its hypothesis, and the reference's regularized costs are read there.
"""

from __future__ import annotations

import os
import random
import shutil

import torch

from .. import compare, pfm, scene_tnt
from . import eval_levers


def hypothesis_index(depth: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """The index of the hypothesis nearest each depth of ``depth`` (``(H,
    W)``) among the increasing ``depth_values`` (``(D,)``)."""
    upper = torch.searchsorted(depth_values, depth.contiguous()).clamp(1, len(depth_values) - 1)
    lower = upper - 1
    nearer_lower = (depth - depth_values[lower]).abs() <= (depth_values[upper] - depth).abs()
    return torch.where(nearer_lower, lower, upper)


class Cell(eval_levers.Cell):
    #: The fewest seconds a map is assumed to take (~19 s on an H100).
    min_map_s = 15.0

    def make_samples(self, count: int) -> list[dict]:
        return scene_tnt.scenes(count, self.seed, self.geo, self.work["traffic_params"],
                                self.device)

    def check(self, count: int) -> dict:
        """The numbers of one window map drawn from the seed.  The control
        (``variant["reference"]``) puts the reference, computed in a lower
        precision, in the program's place."""
        index = random.Random(self.seed).randrange(count) % len(self.samples)
        sample = self.samples[index]
        got = None
        if not self.variant.get("reference"):
            folder = os.path.join(self.out_root, sample["scan"])
            name = f"{sample['ref_view']:08d}.pfm"
            got = {k: torch.from_numpy(pfm.read(os.path.join(folder, fam, name)).copy())
                   .to(self.device)
                   for k, fam in (("depth", "depth_est_0"), ("confidence", "confidence_0"))}
        shutil.rmtree(self.out_root, ignore_errors=True)
        self.model = self.config = None
        self.samples = [sample]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want, volume = self.reference_maps(sample)
        if got is None:
            got, _ = self.reference_maps(sample, lower=True)
        depths = torch.from_numpy(sample["depth_values"]).to(self.device)
        got["depth"] = hypothesis_index(got["depth"], depths).float()
        indices = torch.arange(len(depths), dtype=torch.float32, device=self.device)
        return compare.eval_numbers(got, want, volume, indices)
