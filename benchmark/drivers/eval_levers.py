"""Depth maps under ``cli eval``'s production stack of levers
(``--int8_tables --dual_residual --gather_pack 2 --table_taps 6``, the
workload file's ``infer``): ``eval``'s cell and check on
``dtu_eval.defaults``' scenes, with each map's packed mode checked
against its reference camera's.

On the benchmark's line of cameras the levers do not pick one mode: the
super-packed 6x6 rows pass the gate for the inner references, and the
references at the ends fall back to one block's 4x4 rows (the gate's
window spans a factor of 2 in parallax, and so does the line).  The two
modes differ in their gate calls (2 and 3 a map), their sweep and their
memory, so the window's scenes take the reference cameras in turn
(:func:`scenes_in_turn`): every five maps of a window hold the line's two
end and three inner references.  Set-up warms one map of each mode.
The workload file names the mode of each reference camera by its place
on the line (``mode_by_camera``); a map counts as failed unless it ran in
its camera's mode and, on the card, launched the ConvLSTM gate kernel
once per cell and hypothesis.  A variant's ``mode`` sets one mode for
every map.

Each map's ``gate_calls`` (the ``pick_packed_rows`` calls of
``run_inference``'s gate) go to the trace summary; a program whose stats
do not count them leaves them out.
"""

from __future__ import annotations

import dataclasses
import math
import shutil
import tempfile

import numpy as np
import torch
from torch.profiler import record_function

from .. import scene, weights
from . import DTYPES, options
from . import eval as base


def scenes_in_turn(n: int, seed: int, geometry: dict, traffic: dict, device) -> list[dict]:
    """``benchmark/scene.py``'s eval scenes (the same cameras, planes and
    textures, drawn from the seed) with scene ``i`` seen from reference
    camera ``i mod V`` and its sources nearest first."""
    H, W, V = geometry["height"], geometry["width"], geometry["views"]
    dmin, step = float(geometry["depth_min"]), float(geometry["depth_interval"])
    focal, baseline = float(traffic["focal"]), float(traffic["baseline"])
    low, high = (float(v) for v in traffic["plane_depth"])
    gen = torch.Generator(device=device).manual_seed(seed)
    depths = low + (high - low) * torch.rand(n, generator=gen, device=device,
                                             dtype=torch.float64).cpu().numpy()
    tex_w = W + int(math.ceil((V - 1) * baseline * focal / low)) + 2
    hyps = (dmin + step * np.arange(geometry["num_depth"])).astype(np.float32)
    cols = torch.arange(W, device=device, dtype=torch.float64)
    out = []
    for i in range(n):
        z, ref = float(depths[i]), i % V
        tex = scene.textures(1, H, tex_w, float(traffic["texture_sigma"]), gen, device)[0]
        order = [ref] + scene.sources(ref, V)
        imgs = []
        for k in order:
            pos = cols + k * baseline * focal / z
            x0 = torch.floor(pos)
            frac = (pos - x0).float()
            x0 = x0.long()
            img = tex[:, :, x0] * (1.0 - frac) + tex[:, :, x0 + 1] * frac  # (3, H, W)
            mean = img.mean(dim=(1, 2), keepdim=True)
            std = img.var(dim=(1, 2), keepdim=True, unbiased=False).sqrt()
            imgs.append(((img - mean) / std).permute(1, 2, 0))
        out.append({
            "imgs": torch.stack(imgs).cpu().numpy(),
            "proj_matrices": np.stack([scene.projection(focal, H, W, k * baseline)
                                       for k in order]),
            "depth_values": hyps, "scan": f"scene{i}", "ref_view": i,
        })
    return out


class Cell(base.Cell):
    #: The fewest seconds a map is assumed to take (see ``eval.MIN_MAP_S``).
    min_map_s = base.MIN_MAP_S

    def __init__(self, work: dict, seed: int, device: str, variant: dict | None = None):
        super().__init__(dict(work, mode=work.get("mode", ())), seed, device, variant)

    def make_samples(self, count: int) -> list[dict]:
        return scenes_in_turn(count, self.seed, self.geo, self.work["traffic_params"],
                              self.device)

    def setup(self, seconds: float) -> None:
        """``eval``'s set-up without a head, on :meth:`make_samples`'
        scenes, warming one map of each mode the window holds."""
        from aa_rmvsnet_tpu_torch.models.network import AARMVSNetCore, cast_model
        from aa_rmvsnet_tpu_torch.ops import gates
        from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

        self.run_inference, self.gates = run_inference, gates
        geo, dev = self.geo, self.device
        self.core_w = weights.core_weights(self.seed, dev)
        core = AARMVSNetCore().to(dev)
        core.load_state_dict(self.core_w)
        self.out_root = tempfile.mkdtemp(prefix="bench-maps-")
        settings = dict(depth_block=geo["depth_block"],
                        feature_dtype=DTYPES[geo["precision"]["core"]],
                        packed_rows=geo["packed_rows"], fused_residual=geo["fused_residual"])
        settings.update(options(dict(self.work.get("infer", {}),
                                     **self.variant.get("infer", {}))))
        self.config = InferConfig(out_root=self.out_root, num_workers=0, device=str(dev),
                                  **settings)
        self.model = cast_model(core.eval(), self.config.feature_dtype)
        self.samples = self.make_samples(max(4, math.ceil(seconds / self.min_map_s)))

        first = {}  # mode -> the first scene the window runs in it
        for sample in self.samples:
            first.setdefault(self.mode_of(sample), sample)
        warm_root = tempfile.mkdtemp(prefix="bench-warm-")
        try:
            with torch.inference_mode():
                for sample in first.values():
                    cut = sample["depth_values"][:4 * geo["depth_block"]]
                    run_inference(self.model, [dict(sample, scan="warmup", depth_values=cut)],
                                  dataclasses.replace(self.config, out_root=warm_root),
                                  progress=False)
        finally:
            shutil.rmtree(warm_root, ignore_errors=True)
        self.gate_seconds: list[float] = []
        self.gate_calls: list[int] = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def mode_of(self, sample: dict) -> tuple:
        """The mode ``sample``'s map must run in: the cell's one mode, or
        that of its reference camera (camera ``k`` sits at ``x = k *
        baseline``, so its projection's ``[0, 3]`` is ``-focal * k *
        baseline``)."""
        if self.mode:
            return self.mode
        t = self.work["traffic_params"]
        camera = round(-float(sample["proj_matrices"][0][0, 3]) / (t["focal"] * t["baseline"]))
        return tuple(self.work["mode_by_camera"][camera])

    def step(self, i: int) -> bool:
        sample = self.samples[i % len(self.samples)]
        launches = self.gates.launches
        with record_function("bench.map"):
            stats = self.run_inference(self.model, [sample], self.config, progress=False)
        self.gate_seconds += stats["gate_seconds"]
        self.gate_calls += stats.get("gate_calls", [])
        # The gate kernel exists on the card alone (CPU calls are not counted).
        want = base.GATE_CELLS * self.geo["num_depth"] if self.device.type == "cuda" else 0
        return (stats["count"] == 1 and not stats["failures"]
                and [tuple(m) for m in stats["modes"]] == [self.mode_of(sample)]
                and self.gates.launches - launches == want)

    def work_done(self, count: int) -> dict:
        work = super().work_done(count)
        if self.gate_calls:
            work["gate_calls"] = self.gate_calls
        return work
