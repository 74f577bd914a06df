"""Depth maps: ``cli eval``'s path, ``run_inference``, one map per call.

Set-up makes the weights on the device from the seed and the window's
scenes from the seed, loads the weights into the port's core (and head),
casts the core once to the sweep's precision as ``run_inference`` would,
and warms every shape of the window: one ``run_inference`` call on the
first scene with the sweep cut to four depth blocks (every kernel shape of
a full map but fewer of them) and, with the head, the head on a volume of
the real ``(D, H, W)``.  A map of the window is one ``run_inference`` call
on one scene held in memory: the packed gate, the sweep, the head, the
copies to the host and the PFM writes.  A map counts as failed unless it
ran in the cell's packed mode (the workload file's ``mode``) and, on the
card, launched the ConvLSTM gate kernel once per cell and hypothesis.

The check draws one map of the window from the seed, reads the PFMs the
program wrote for it, frees the program, and runs the reference on the
same inputs and weights.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import shutil
import tempfile

import torch
from torch.profiler import record_function

from .. import compare, flops, pfm, scene, weights
from ..reference import aa_rmvsnet, evidential
from . import DTYPES, options

#: The fewest seconds a map is assumed to take (a map of ``dtu_eval`` takes
#: ~9.7 s on an H100): the window's scenes are made for ``seconds /
#: MIN_MAP_S`` maps (at least 4) and reused past that.
MIN_MAP_S = 9.0
#: The ConvLSTM cells of the regularizer: gate kernel launches per hypothesis.
GATE_CELLS = 5


class Cell:
    unit = "map"

    def __init__(self, work: dict, seed: int, device: str, variant: dict | None = None):
        self.work, self.seed, self.device = work, seed, torch.device(device)
        self.geo = work["config_data"]
        self.variant = variant or {}
        self.head_on = bool(work.get("head"))
        self.mode = tuple(self.variant.get("mode", work["mode"]))

    def setup(self, seconds: float) -> None:
        from aa_rmvsnet_tpu_torch.models.evidential import EvidentialHead, evidential_apply
        from aa_rmvsnet_tpu_torch.models.network import AARMVSNetCore, cast_model
        from aa_rmvsnet_tpu_torch.ops import gates
        from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference

        self.run_inference, self.gates = run_inference, gates
        geo, dev = self.geo, self.device
        self.core_w = weights.core_weights(self.seed, dev)
        core = AARMVSNetCore().to(dev)
        core.load_state_dict(self.core_w)
        head = None
        if self.head_on:
            self.head_w = weights.head_weights(self.seed, dev)
            head = EvidentialHead(geo["maxdisp"]).to(dev)
            head.load_state_dict(self.head_w)
        self.out_root = tempfile.mkdtemp(prefix="bench-maps-")
        chosen = dict(self.work.get("infer", {}), **self.variant.get("infer", {}))
        settings = dict(depth_block=geo["depth_block"],
                        feature_dtype=DTYPES[geo["precision"]["core"]],
                        packed_rows=geo["packed_rows"], fused_residual=geo["fused_residual"])
        settings.update(options(chosen))
        self.config = InferConfig(
            out_root=self.out_root, num_workers=0, device=str(dev), evidential=head,
            depth_source="evidential" if head is not None else "wta", **settings)
        self.model = cast_model(core.eval(), self.config.feature_dtype)
        count = max(4, math.ceil(seconds / MIN_MAP_S))
        self.samples = scene.scenes(count, self.seed, geo, self.work["traffic_params"], dev)

        warm = dict(self.samples[0], scan="warmup",
                    depth_values=self.samples[0]["depth_values"][:4 * geo["depth_block"]])
        warm_root = tempfile.mkdtemp(prefix="bench-warm-")
        try:
            with torch.inference_mode():
                run_inference(self.model, [warm],
                              dataclasses.replace(self.config, out_root=warm_root),
                              progress=False)
                if head is not None:
                    gen = torch.Generator(device=dev).manual_seed(self.seed)
                    volume = torch.randn(1, geo["num_depth"], geo["height"], geo["width"],
                                         generator=gen, device=dev)
                    depths = torch.from_numpy(self.samples[0]["depth_values"])[None].to(dev)
                    evidential_apply(head, volume, depths)
                    del volume
        finally:
            shutil.rmtree(warm_root, ignore_errors=True)
        self.gate_seconds: list[float] = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(self, i: int) -> bool:
        launches = self.gates.launches
        with record_function("bench.map"):
            stats = self.run_inference(self.model, [self.samples[i % len(self.samples)]],
                                       self.config, progress=False)
        self.gate_seconds += stats["gate_seconds"]
        # The gate kernel exists on the card alone (CPU calls are not counted).
        want = GATE_CELLS * self.geo["num_depth"] if self.device.type == "cuda" else 0
        return (stats["count"] == 1 and not stats["failures"]
                and [tuple(m) for m in stats["modes"]] == [self.mode]
                and self.gates.launches - launches == want)

    def work_done(self, count: int) -> dict:
        """The window's counts for the trace summary: maps, depth steps, the
        model FLOPs by precision and the bytes the gate calls need."""
        g = self.geo
        H, W, V, D = g["height"], g["width"], g["views"], g["num_depth"]
        dtype = self.config.feature_dtype  # the sweep's, as the cell runs it
        core_dtype = next(k for k, v in DTYPES.items() if v == dtype)
        work = {"maps": count, "depth_steps": count * D, "gate_seconds": self.gate_seconds,
                "flops": {core_dtype: count * flops.core_forward(H, W, V, D)}}
        if self.head_on:
            work["flops"]["float32"] = work["flops"].get("float32", 0.0) + \
                count * flops.head_forward(H, W, D, g["maxdisp"])
        # Each ConvLSTM gate call reads z (4 hidden planes) and c, and writes
        # h' and c': 7 planes of its cell's hidden size at its resolution.
        size = torch.finfo(dtype).bits // 8
        planes = H * W * (16 + 16 // 4 + 16 // 16 + 16 // 4 + 8)
        work["gate_bytes"] = count * D * planes * size * 7
        return work

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
            families = {"confidence": "confidence_0"}
            families.update({"gamma": "depth_est_0", "aleatoric": "aleatoric_0",
                             "epistemic": "epistemic_0"} if self.head_on
                            else {"depth": "depth_est_0"})
            got = {k: torch.from_numpy(pfm.read(os.path.join(folder, fam, name)).copy())
                   .to(self.device) for k, fam in families.items()}
        shutil.rmtree(self.out_root, ignore_errors=True)
        self.model = self.config = None
        self.samples = [sample]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want, volume = self.reference_maps(sample)
        if got is None:
            got, _ = self.reference_maps(sample, lower=True)
        depths = torch.from_numpy(sample["depth_values"]).to(self.device)
        return compare.eval_numbers(got, want, volume, depths)

    def reference_maps(self, sample: dict, lower: bool = False) -> tuple[dict, torch.Tensor]:
        """The reference's maps of ``sample`` and, where the depth map is the
        winner-take-all one, its ``(D, H, W)`` regularized costs.  ``lower``:
        the core in fp8 (operands rounded, float32 sums) and the head with
        TF32, the steps below the precisions the configuration states."""
        dev = self.device
        p = aa_rmvsnet.Weights(self.core_w)
        if lower:
            p.cast = aa_rmvsnet.fp8_e4m3
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = lower
        imgs = torch.from_numpy(sample["imgs"])[None].to(dev)
        proj = torch.from_numpy(sample["proj_matrices"])[None].to(dev)
        dvals = torch.from_numpy(sample["depth_values"])[None].to(dev)
        try:
            with torch.no_grad():
                volume = aa_rmvsnet.cost_volume(p, imgs, proj, dvals, self.geo["depth_block"])
                depth, conf = aa_rmvsnet.depth_and_confidence(volume, dvals)
                maps = {"depth": depth[0], "confidence": conf[0]}
                if not self.head_on:
                    return maps, volume[0]
                prob = torch.softmax(volume, dim=1)
                del volume
                nig = evidential.head(self.head_w, prob, dvals, self.geo["maxdisp"])
                del prob
                maps["gamma"] = nig["gamma"][0]
                maps.update({k: v[0] for k, v in evidential.uncertainty(nig).items()})
                return maps, None
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
