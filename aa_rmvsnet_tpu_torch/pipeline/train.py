"""Training driver: Adam with cosine annealing, BPTT through the depth sweep
with one recompute per depth block, per-epoch checkpoints and validation
(port of ``aa_rmvsnet_tpu/pipeline/train.py`` and of the loop of the JAX
CLI's ``cmd_train``, for one device).

Reference trainer semantics (train.py:179-285): Adam at 1e-3, cosine
annealing to 2e-6 over the run, the masked cross-entropy of
``models/losses.py``, a validation pass after every epoch with the
2/4/8/16/32 mm threshold metrics.  A training step runs the sweep with
``remat=True``: on CUDA each of the 5 ConvLSTM cells launches the gate
kernel twice per hypothesis (forward and recompute) and the gate-backward
kernel once, 2 x 5 x D and 5 x D launches per step.

With ``TrainConfig(evidential=True)`` and an :class:`EvidentialHead`, a step
is the fork's production loop (reference train.py:120-121, 234-237; JAX
``pipeline/train.py:152-262``): the core's probability volume feeds the head
in train mode (BatchNorm on batch statistics, running statistics updated as
flax's), ``loss_emvsnet`` on its NIG output, and one Adam over the core and
the head together; the gradient reaches the core through the probability
volume and BPTT through the sweep, so the gate launches per step are the
same.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from ..data.loader import batched, resilient_samples
from ..models.evidential import EvidentialHead, loss_emvsnet, uncertainty_decompositions
from ..models.losses import depth_classification_loss
from ..models.network import AARMVSNetCore, SweepConfig, forward, probability_volume
from ..utils.device import disable_tf32, resolve_device
from ..utils.metrics import MeterDict, abs_depth_error, threshold_error_rate
from .checkpoint import restore_latest, save_state

THRESHOLDS_MM = (2.0, 4.0, 8.0, 16.0, 32.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimiser, sweep and loop settings.

    ``total_steps`` is the cosine schedule's length; None means epochs x
    steps per epoch.  ``logdir`` None writes no checkpoint.  ``max_steps``
    stops a run early (after a checkpoint).  ``evidential`` trains an
    evidential head with the core (``maxdisp`` hypotheses, ``loss_emvsnet``
    with ``evidential_weight_reg``).  The JAX package's ``feature_dtype``
    (bf16), ``fold_omega`` and ``mesh`` are refused: not ported yet.
    """

    learning_rate: float = 1e-3
    lr_min: float = 2e-6
    total_steps: int | None = None
    depth_block: int = 16
    grad_clip: float | None = None
    epochs: int = 10
    batch_size: int = 1
    num_workers: int = 8
    summary_freq: int = 20
    max_steps: int | None = None
    logdir: str | None = None
    resume: bool = False
    seed: int = 0
    device: str = "cuda"
    feature_dtype: Any = torch.float32
    fold_omega: Any = False
    mesh: Any = None
    evidential: bool = False
    maxdisp: int = 32
    evidential_weight_reg: float = 0.1

    def __post_init__(self):
        refused = [
            name for name, value, default in (
                ("feature_dtype", self.feature_dtype, torch.float32),
                ("fold_omega", self.fold_omega, False),
                ("mesh", self.mesh, None),
            ) if value != default
        ]
        if refused:
            raise NotImplementedError(
                f"TrainConfig {', '.join(refused)}: not ported yet to "
                "aa_rmvsnet_tpu_torch"
            )

    def sweep(self, remat: bool = True) -> SweepConfig:
        return SweepConfig(depth_block=self.depth_block, remat=remat,
                           collect_volume=True)


def cosine_decay(step: int, total_steps: int, alpha: float) -> float:
    """``optax.cosine_decay_schedule``'s factor in closed form:
    ``alpha + (1 - alpha) * (1 + cos(pi * t / T)) / 2`` with t capped at T."""
    t = min(step, total_steps)
    return alpha + (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps))


def make_optimizer(params, config: TrainConfig, total_steps: int):
    """Adam (eps 1e-8 outside the square root, as optax's) and a cosine
    schedule from ``learning_rate`` to ``lr_min`` over ``total_steps``,
    through ``LambdaLR`` with the closed form (the recursive
    ``CosineAnnealingLR`` drifts from it).  Returns
    ``(optimizer, scheduler)``; step the scheduler after each optimizer
    step, so update t uses the rate of step t, as optax does."""
    optimizer = torch.optim.Adam(params, lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    alpha = config.lr_min / config.learning_rate
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda t: cosine_decay(t, total_steps, alpha))
    return optimizer, scheduler


def clip_by_global_norm(params, max_norm: float) -> None:
    """Scale the gradients by ``max_norm / norm`` where their global norm
    is at least ``max_norm`` (``optax.clip_by_global_norm``), in place."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def batch_to_device(batch: dict, device) -> dict:
    """The numeric array fields of a ``batched`` batch (all but ``name``)
    as tensors on ``device``."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items() if isinstance(v, np.ndarray) and v.dtype.kind in "fiub"
    }


def loss_fn(model: AARMVSNetCore, batch: dict, sweep_config: SweepConfig):
    out = forward(model, batch["imgs"], batch["proj_matrices"],
                  batch["depth_values"], sweep_config)
    return depth_classification_loss(
        probability_volume(out["cost_volume"]), batch["depth"], batch["mask"],
        batch["depth_values"],
    )


def evidential_loss_fn(model: AARMVSNetCore, head: EvidentialHead, batch: dict,
                       config: TrainConfig, sweep_config: SweepConfig):
    """The core's probability volume through ``head`` (in the mode the
    caller set), then ``loss_emvsnet``.  Returns ``(loss, head outputs)``."""
    out = forward(model, batch["imgs"], batch["proj_matrices"],
                  batch["depth_values"], sweep_config)
    ev = head(probability_volume(out.pop("cost_volume")), batch["depth_values"])
    loss = loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"],
                        batch["depth"], batch["mask"], config.evidential_weight_reg)
    return loss, ev


def _evidential_summaries(ev: dict, batch: dict) -> tuple[dict, dict]:
    """Metrics and images of an evidential step (JAX
    ``_evidential_summaries``): the head's mean nu, alpha and beta, gamma's
    error, and both uncertainty decompositions."""
    gamma, depth, mask = ev["gamma"].detach(), batch["depth"], batch["mask"]
    nu, alpha, beta = ev["nu"].detach(), ev["alpha"].detach(), ev["beta"].detach()
    metrics = {
        "loss_components/nu": nu.mean(),
        "loss_components/alpha": alpha.mean(),
        "loss_components/beta": beta.mean(),
        "abs_depth_error": abs_depth_error(gamma, depth, mask),
    }
    decomp = uncertainty_decompositions(nu, alpha, beta)
    images = {
        "depth_est": gamma * mask,
        "error_map": torch.abs(gamma - depth) * mask,
        "alea_1": decomp["aleatoric_1"],
        "epis_1": decomp["epistemic_1"],
        "alea_2": decomp["aleatoric_2"],
        "epis_2": decomp["epistemic_2"],
    }
    return metrics, images


def trainable_parameters(model, head=None) -> list:
    """The core's parameters, then the head's: the one Adam's list."""
    return list(model.parameters()) + ([] if head is None else list(head.parameters()))


def train_step(model, optimizer, scheduler, batch: dict, config: TrainConfig,
               head: EvidentialHead | None = None):
    """One update: zero grads, forward with remat, loss, backward (which
    recomputes each depth block), Adam and scheduler steps, under the
    profiler ranges ``train.forward``, ``train.backward`` and
    ``train.optimizer``.  With ``head`` (``config.evidential``) both modules
    run in train mode and the loss is ``loss_emvsnet`` on the head's output.
    Returns ``(metrics, images)`` of detached tensors."""
    model.train()
    if head is not None:
        head.train()
    optimizer.zero_grad(set_to_none=True)
    with record_function("train.forward"):
        if head is None:
            loss, wta_depth = loss_fn(model, batch, config.sweep(remat=True))
        else:
            loss, ev = evidential_loss_fn(model, head, batch, config, config.sweep(remat=True))
    with record_function("train.backward"):
        loss.backward()
    with record_function("train.optimizer"):
        if config.grad_clip is not None:
            clip_by_global_norm(trainable_parameters(model, head), config.grad_clip)
        optimizer.step()
        scheduler.step()
    if head is not None:
        metrics, images = _evidential_summaries(ev, batch)
        metrics["loss"] = loss.detach()
        return metrics, images
    depth, mask = batch["depth"], batch["mask"]
    metrics = {"loss": loss.detach(),
               "abs_depth_error": abs_depth_error(wta_depth, depth, mask)}
    images = {"depth_est": wta_depth * mask,
              "error_map": torch.abs(wta_depth - depth) * mask}
    return metrics, images


@torch.no_grad()
def eval_step(model, batch: dict, config: TrainConfig,
              head: EvidentialHead | None = None) -> dict:
    """Loss and depth metrics without remat or gradients.  With ``head``
    (JAX ``make_evidential_eval_step``) the head runs in eval mode, the loss
    is ``loss_emvsnet`` and the metrics are of gamma; ``train_step`` puts
    both modules back in train mode."""
    model.eval()
    if head is None:
        loss, depth_est = loss_fn(model, batch, config.sweep(remat=False))
    else:
        head.eval()
        loss, ev = evidential_loss_fn(model, head, batch, config, config.sweep(remat=False))
        depth_est = ev["gamma"]
    depth, mask = batch["depth"], batch["mask"]
    metrics = {"loss": loss, "abs_depth_error": abs_depth_error(depth_est, depth, mask)}
    for tau in THRESHOLDS_MM:
        metrics[f"thres{int(tau)}mm_error"] = threshold_error_rate(depth_est, depth, mask, tau)
    return metrics


def _summarize(logger, mode: str, images: dict, batch: dict, step: int) -> None:
    """TensorBoard images and an ``.npz`` dump of the batch's first sample
    (reference train.py:236-239)."""
    arrays = {k: v[0].float().cpu().numpy() for k, v in images.items()}
    arrays["depth_gt"] = batch["depth"][0]
    arrays["mask"] = batch["mask"][0]
    arrays["ref_img"] = batch["imgs"][0, 0]
    logger.images(mode, arrays, step)
    logger.dump(mode, arrays, step)


def run_training(
    model: AARMVSNetCore,
    dataset,
    config: TrainConfig,
    val_dataset=None,
    logger=None,
    head: EvidentialHead | None = None,
) -> dict:
    """Train ``model`` on ``dataset`` (``len`` and ``__getitem__`` giving
    the ``DTUTrainDataset`` sample dict) for ``config.epochs`` epochs; with
    ``config.evidential``, ``model`` and the evidential ``head`` together
    (one without the other raises).

    Moves the model and the head to ``config.device`` (raising without a
    card for ``cuda``) and turns TF32 off.  Each epoch visits the dataset in a
    permutation drawn from ``(seed, epoch)``, in batches of
    ``batch_size`` (the last partial batch dropped); a failed load is
    replaced by the last good sample.  With ``logdir``, a checkpoint is
    written after every epoch and at ``max_steps``; with ``resume`` the
    run restarts from the highest saved step, at the batch where that run
    stopped.  After every epoch ``val_dataset``, if given, is evaluated.

    Returns ``{start_step, step, losses, step_seconds, val}``: per-step
    losses and seconds (host clock around the step, ending in a device
    synchronise), and the last validation means.
    """
    if config.evidential != (head is not None):
        raise ValueError("run_training: config.evidential needs an evidential head, and a "
                         "head needs config.evidential")
    if head is not None and head.maxdisp != config.maxdisp:
        raise ValueError(f"run_training: the head has maxdisp {head.maxdisp}, the config "
                         f"{config.maxdisp}")
    if len(dataset) < config.batch_size:
        raise ValueError(f"run_training: {len(dataset)} sample(s) make no batch of "
                         f"{config.batch_size}")
    device = resolve_device(config.device)
    disable_tf32()
    model.to(device)
    if head is not None:
        head.to(device)
    steps_per_epoch = max(len(dataset) // config.batch_size, 1)
    total_steps = config.total_steps or config.epochs * steps_per_epoch
    optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config, total_steps)

    start_step = 0
    if config.resume and config.logdir:
        restored = restore_latest(config.logdir, model, optimizer, scheduler, head=head)
        if restored is not None:
            start_step = restored
            print(f"resumed from step {start_step}", flush=True)

    def on_skip(exc):
        print(f"SKIP (train load failure): {exc}", flush=True)

    def save(step):
        if config.logdir:
            save_state(config.logdir, step, model, optimizer, scheduler, head=head)

    step = start_step
    losses: list[float] = []
    step_seconds: list[float] = []
    val_means: dict = {}
    meter = MeterDict()
    for epoch in range(start_step // steps_per_epoch, config.epochs):
        done = step - epoch * steps_per_epoch  # batches of this epoch already taken
        order = np.random.RandomState([config.seed, epoch]).permutation(len(dataset))
        order = order[done * config.batch_size:]
        samples = resilient_samples(dataset, order, num_workers=config.num_workers,
                                    on_skip=on_skip)
        for host_batch in itertools.islice(
            batched(samples, config.batch_size, drop_last=True), steps_per_epoch - done
        ):
            t0 = time.perf_counter()
            batch = batch_to_device(host_batch, device)
            metrics, images = train_step(model, optimizer, scheduler, batch, config, head)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            meter.update(metrics)
            step += 1
            if step % config.summary_freq == 0:
                means = meter.mean()
                print(f"epoch {epoch} step {step}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in means.items()), flush=True)
                if logger is not None:
                    logger.scalars("train", means, step)
                    _summarize(logger, "train", images, host_batch, step)
                meter = MeterDict()
            if config.max_steps and step - start_step >= config.max_steps:
                save(step)
                return {"start_step": start_step, "step": step, "losses": losses,
                        "step_seconds": step_seconds, "val": val_means}
        save(step)

        if val_dataset is not None and len(val_dataset) >= config.batch_size:
            vmeter = MeterDict()
            for vbatch in batched(
                resilient_samples(val_dataset, num_workers=config.num_workers,
                                  on_skip=on_skip),
                config.batch_size, drop_last=True,
            ):
                vmeter.update(eval_step(model, batch_to_device(vbatch, device), config, head))
            val_means = vmeter.mean()
            print(f"epoch {epoch} fulltest: "
                  + " ".join(f"{k}={v:.4f}" for k, v in val_means.items()), flush=True)
            if logger is not None:
                logger.scalars("fulltest", val_means, step)
    return {"start_step": start_step, "step": step, "losses": losses,
            "step_seconds": step_seconds, "val": val_means}
