"""Training steps: ``cli train``'s step, ``train_step``, fed as
``run_training`` feeds it.

Set-up makes the weights on the device from the seed and the run's
batches from the seed (each a distinct scene), builds the port's model
(and head), Adam and the cosine schedule as ``run_training`` builds them,
and drives that one object through its first three steps with the
window's own call on batches 0-2: they warm every shape of the window,
and they are what the check compares.  The window then keeps stepping the
same object on batches 3, 4, ...; a step is ``batch_to_device``,
``train_step``, the synchronise and the loss read back, as in
``run_training``'s loop.  Before each window step the benchmark copies
the parameters, Adam's moments and the head's running statistics into
buffers made in set-up (three multi-tensor copies), so that after the
window it holds the state the last step started from.

The check replays the first three steps in the reference, from the same
weights on the same batches, with its own Adam; and the window's last
step from the state it started from, on its batch: a fault that only
starts after warm-up (a captured graph replayed on stale inputs, a step
that stops updating) shows there.  That step starts from the program's
state, which the reference cannot make itself; the first three steps
check the start from the seed.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, flops, scene, weights
from ..reference import aa_rmvsnet, evidential
from . import DTYPES, options

#: Steps compared with the reference; made in set-up.
FIRST_STEPS = 3
#: The fewest seconds a step is assumed to take (a ``dtu_train`` step takes
#: 0.73-1.53 s on an H100); batches beyond are reused.
MIN_STEP_S = 0.7
BUFFERS = ("running_mean", "running_var")


def _is_buffer(name: str) -> bool:
    return name.endswith(BUFFERS) or name.endswith("num_batches_tracked")


class Cell:
    unit = "step"

    def __init__(self, work: dict, seed: int, device: str, variant: dict | None = None):
        self.work, self.seed, self.device = work, seed, torch.device(device)
        self.geo = work["config_data"]
        self.variant = variant or {}
        self.head_on = bool(work.get("head"))

    def setup(self, seconds: float) -> None:
        from aa_rmvsnet_tpu_torch.models.evidential import EvidentialHead
        from aa_rmvsnet_tpu_torch.models.network import AARMVSNetCore
        from aa_rmvsnet_tpu_torch.pipeline.train import (
            TrainConfig, batch_to_device, make_optimizer, train_step, trainable_parameters)
        from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

        self.batch_to_device, self.train_step = batch_to_device, train_step
        g, dev = self.geo, self.device
        if g["batch_size"] != 1 or not g["remat"] or g["precision"]["tf32"]:
            raise ValueError("the train driver runs batch 1 with remat (train_step always "
                             "remats) and TF32 off")
        self.config = TrainConfig(
            learning_rate=g["learning_rate"], lr_min=g["lr_min"], total_steps=g["total_steps"],
            depth_block=g["depth_block"], batch_size=g["batch_size"], device=str(dev),
            feature_dtype=DTYPES[g["precision"]["core"]],
            evidential=self.head_on, maxdisp=g["maxdisp"],
            evidential_weight_reg=g["evidential_weight_reg"],
            **options(self.work.get("train", {})))
        disable_tf32()
        self.core_w = weights.core_weights(self.seed, dev)
        self.model = AARMVSNetCore().to(dev)
        self.model.load_state_dict(self.core_w)
        self.head = None
        self.head_w = {}
        if self.head_on:
            self.head_w = weights.head_weights(self.seed, dev)
            self.head = EvidentialHead(g["maxdisp"]).to(dev)
            self.head.load_state_dict(self.head_w)
        params = trainable_parameters(self.model, self.head)
        self.optimizer, self.scheduler = make_optimizer(params, self.config, g["total_steps"])
        count = FIRST_STEPS + max(16, math.ceil(seconds / MIN_STEP_S))
        samples = scene.scenes(count, self.seed, g, self.work["traffic_params"], dev, train=True)
        self.batches = [{k: np.asarray(v)[None] for k, v in s.items()} for s in samples]
        self.losses: list[float] = []
        for t in range(FIRST_STEPS):
            if not self._step(t):
                raise RuntimeError(f"training step {t} of set-up gave a loss that is not finite")
            if t == 0:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                state = self.optimizer.state
                self.first_grad = {k: (state[p]["exp_avg"].detach() if "exp_avg" in state[p]
                                       else torch.zeros_like(p)) / (1.0 - beta1)
                                   for k, p in self._named()}
        self.after = {k: p.detach().clone() for k, p in self._named()}
        self.stats_after = {f"head.{k}": v.detach().clone()
                            for k, v in (self.head.state_dict().items() if self.head else [])
                            if k.endswith(BUFFERS)}
        self.first_losses = list(self.losses)
        self.live = self._state()
        self.before = [[t.detach().clone() for t in ts] for ts in self.live]
        self.last = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _named(self):
        yield from self.model.named_parameters()
        if self.head is not None:
            yield from ((f"head.{k}", p) for k, p in self.head.named_parameters())

    def _state(self) -> list:
        """The tensors a step changes, as three lists: the parameters (with
        the head's running statistics), Adam's first and second moments
        (zeros where a parameter has none, as one that never had a
        gradient)."""
        named = list(self._named())
        stats = [v for k, v in (self.head.state_dict().items() if self.head else [])
                 if k.endswith(BUFFERS)]
        state = self.optimizer.state
        moments = [[state[p][key] if key in state[p] else torch.zeros_like(p)
                    for _, p in named] for key in ("exp_avg", "exp_avg_sq")]
        return [[p for _, p in named] + stats] + moments

    def step(self, i: int) -> bool:
        """The window's step ``i``, on batch ``FIRST_STEPS + i`` (cycling
        past the last), after the copy of the state it starts from."""
        with torch.no_grad():
            for dst, src in zip(self.before, self.live):
                torch._foreach_copy_(dst, src)
        index = FIRST_STEPS + i % (len(self.batches) - FIRST_STEPS)
        self.last = (FIRST_STEPS + i, index)
        return self._step(index)

    def _step(self, index: int) -> bool:
        host = self.batches[index]
        if self.variant.get("half_batch"):
            # A fault: the lower half of the map's rows left out of the loss.
            mask = host["mask"].copy()
            mask[:, mask.shape[1] // 2:] = 0.0
            host = dict(host, mask=mask)
        with record_function("bench.step"):
            batch = self.batch_to_device(host, self.device)
            metrics, _ = self.train_step(self.model, self.optimizer, self.scheduler, batch,
                                         self.config, self.head)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            loss = float(metrics["loss"])
        self.losses.append(loss)
        return math.isfinite(loss)

    def work_done(self, count: int) -> dict:
        g = self.geo
        H, W, V, D = g["height"], g["width"], g["views"], g["num_depth"]
        dtype = self.config.feature_dtype  # the sweep's; the head stays fp32
        core = next(k for k, v in DTYPES.items() if v == dtype)
        step_flops = {core: 3.0 * flops.core_forward(H, W, V, D)}
        if self.head_on:
            step_flops["float32"] = step_flops.get("float32", 0.0) + \
                3.0 * flops.head_forward(H, W, D, g["maxdisp"])
        # Gate calls a step: the forward, remat's recompute, the backward
        # (reads z, c, dh, dc' and writes dz, dc: 7 + 5 planes).
        planes = H * W * (16 + 16 // 4 + 16 // 16 + 16 // 4 + 8)
        gate_bytes = D * planes * (torch.finfo(dtype).bits // 8) * (2 * 7 + 12)
        return {"steps": count, "flops": {k: count * f for k, f in step_flops.items()},
                "gate_bytes": count * gate_bytes}

    def check(self, count: int) -> dict:
        """The first three steps against the reference's.  The control
        (``variant["reference"]``) puts the reference, run with TF32, in the
        program's place."""
        got = {"losses": self.first_losses, "grad": self.first_grad,
               "change": {k: self.after[k] - self._initial(k) for k in self.after},
               "stats_change": {k: v - self._initial(k) for k, v in self.stats_after.items()}}
        keys = [k for k, _ in self._named()] + [
            f"head.{k}" for k in (self.head.state_dict() if self.head else {})
            if k.endswith(BUFFERS)]
        start = {"params": dict(zip(keys, self.before[0])),
                 "exp_avg": dict(zip(keys, self.before[1])),
                 "exp_avg_sq": dict(zip(keys, self.before[2]))}
        got_last = {"loss": self.losses[-1],
                    "change": {k: a.detach() - b for k, a, b in
                               zip(keys, self.live[0], self.before[0])}}
        t, index = self.last
        self.model = self.head = self.optimizer = self.scheduler = self.live = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        args = (self.core_w, self.head_w, self.batches[:FIRST_STEPS], self.geo, self.device,
                self.head_on)
        last = (start, t, self.batches[index], self.geo, self.device, self.head_on)
        if self.variant.get("reference"):
            got, got_last = replay(*args, tf32=True), replay_step(*last, tf32=True)
        numbers = compare.train_numbers(got, replay(*args))
        numbers.update(compare.last_step_numbers(got_last, replay_step(*last)))
        return numbers

    def _initial(self, key: str) -> torch.Tensor:
        return self.head_w[key[5:]] if key.startswith("head.") else self.core_w[key]


def replay(core_w: dict, head_w: dict, batches: list, geo: dict, device, head_on: bool,
           tf32: bool = False) -> dict:
    """The reference's first steps: plain autograd through the whole sweep,
    Adam (betas 0.9, 0.999, eps 1e-8) at ``learning_rate`` times the cosine
    factor of the step.  Returns the losses, the first gradient, each
    parameter's change and each BatchNorm statistic's change."""
    params = {k: v.clone() for k, v in core_w.items()}
    params.update({f"head.{k}": v.clone() for k, v in head_w.items()})
    leaves = [k for k in params if not _is_buffer(k)]
    m = {k: torch.zeros_like(params[k]) for k in leaves}
    v = {k: torch.zeros_like(params[k]) for k in leaves}
    losses, first = [], None
    with _tf32(tf32):
        for t, batch in enumerate(batches):
            loss, grads = _step(params, m, v, t, batch, geo, device, head_on)
            losses.append(loss)
            first = grads if first is None else first
    initial = {k: v for k, v in core_w.items()}
    initial.update({f"head.{k}": v for k, v in head_w.items()})
    return {"losses": losses, "grad": first,
            "change": {k: params[k] - initial[k] for k in leaves},
            "stats_change": {k: params[k] - initial[k] for k in params
                             if k.endswith(BUFFERS)}}


def replay_step(start: dict, t: int, batch: dict, geo: dict, device, head_on: bool,
                tf32: bool = False) -> dict:
    """The reference's step ``t`` (0-based) from ``start`` (the program's
    ``params`` with the head's running statistics, ``exp_avg`` and
    ``exp_avg_sq`` by key).  Returns its loss, its gradient and each
    parameter's change."""
    params = {k: p.clone() for k, p in start["params"].items()}
    leaves = [k for k in params if not _is_buffer(k)]
    m = {k: start["exp_avg"][k].clone() for k in leaves}
    v = {k: start["exp_avg_sq"][k].clone() for k in leaves}
    with _tf32(tf32):
        loss, grads = _step(params, m, v, t, batch, geo, device, head_on)
    return {"loss": loss, "grad": grads,
            "change": {k: params[k] - start["params"][k] for k in params}}


@contextlib.contextmanager
def _tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _step(params: dict, m: dict, v: dict, t: int, batch: dict, geo: dict, device,
          head_on: bool) -> tuple[float, dict]:
    """One reference step ``t`` on ``batch``, in place on ``params`` (the
    head's running statistics included), ``m`` and ``v``.  Returns the loss
    and the gradient by leaf."""
    leaves = list(m)
    x = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in batch.items()}
    live = {k: params[k].detach().requires_grad_(True) for k in leaves}
    p = {**params, **live}
    volume = aa_rmvsnet.cost_volume(p, x["imgs"], x["proj_matrices"], x["depth_values"],
                                    geo["depth_block"])
    if head_on:
        hp = {k[5:]: val for k, val in p.items() if k.startswith("head.")}
        stats: dict = {}
        nig = evidential.head(hp, torch.softmax(volume, dim=1), x["depth_values"],
                              geo["maxdisp"], train=True, stats=stats)
        loss = evidential.evidential_loss(nig, x["depth"], x["mask"],
                                          geo["evidential_weight_reg"])
        params.update({f"head.{k}": s for k, s in stats.items()})
    else:
        loss = aa_rmvsnet.classification_loss(volume, x["depth"], x["mask"], x["depth_values"])
    grads = torch.autograd.grad(loss, [live[k] for k in leaves])
    alpha = geo["lr_min"] / geo["learning_rate"]
    lr = geo["learning_rate"] * aa_rmvsnet.cosine_factor(t, geo["total_steps"], alpha)
    with torch.no_grad():
        for k, g in zip(leaves, grads):
            m[k] = 0.9 * m[k] + 0.1 * g
            v[k] = 0.999 * v[k] + 0.001 * g * g
            mhat = m[k] / (1.0 - 0.9 ** (t + 1))
            vhat = v[k] / (1.0 - 0.999 ** (t + 1))
            params[k] = params[k] - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return float(loss.detach()), {k: g.detach() for k, g in zip(leaves, grads)}
