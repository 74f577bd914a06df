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

``TrainConfig(feature_dtype=torch.bfloat16)`` runs the sweep in bf16 on the
fp32 parameters cast in the autograd graph (``models/network.py:
cast_in_graph``): Adam keeps fp32 master weights and moments, and the gate
kernels run their bf16 instantiations.  ``fold_omega`` (``"hybrid"`` or
``True``) takes the folded omega path of the JAX package's same lever.

``TrainConfig(mesh=make_mesh(...))`` (``parallel/mesh.py``) trains across
processes with the JAX package's global-batch semantics.  On the data
axis: ``batch_size`` is per data rank, every data rank takes ``(len //
data) // batch_size`` steps an epoch from its shard
(``dataset.shard(data_rank, data)``) in its own order, rank 0's weights are
broadcast before the first step, the gradients averaged over the data
group before the clip, the evidential loss divides by the global valid
count and the head's BatchNorm takes the global batch's statistics, so
each step is one step on the concatenated global batch; metrics are
global-batch means, and only rank 0 writes checkpoints and logs.  On the
view axis (the JAX package's ``(data, view)`` training mesh) the view
ranks of one data rank hold the same rows and split the sweep's source
views (``models/network.py:view_shard``): FeatNet's and omega's gradients
are each view rank's share and are summed over the view group, while the
regularizer's and the head's, computed whole on every view rank, are
averaged over it (the same value, made bit for bit the same on every
rank); the data group's collectives then run as above.  On the spatial
axis (the JAX package's ``(data, spatial)`` training mesh) the spatial
ranks of one data rank hold the same samples and each takes its slab of
rows of ``imgs``, ``depth`` and ``mask`` (:func:`batch_rows`): the sweep
runs on the slabs (``parallel/spatial.py``), the loss's valid counts and
the metrics' masked sums are summed over the spatial group, each rank's
loss is its rows' share of the batch's, and every gradient, each rank's
share, is summed over the spatial group before the data group's average.
With the evidential head on a spatial mesh each rank runs the head on its
slab of the cost volume (``EvidentialHead.forward(..., mesh)``, as GSPMD
keeps the JAX package's head row-sharded): its BatchNorm statistics are
summed over the spatial and data groups, so that they, and the running
statistics, are the global batch's on every rank, and ``loss_emvsnet`` is
the rank's rows' share over the global valid count, whose gradients the
same spatial sum adds up.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any

import numpy as np
import torch

from ..data.loader import batched, resilient_samples
from ..models.evidential import (
    EvidentialHead,
    batch_statistics_over,
    loss_emvsnet,
    uncertainty_decompositions,
)
from ..models.losses import depth_classification_loss
from ..models.network import (
    AARMVSNetCore,
    SweepConfig,
    forward,
    probability_volume,
    spatial_mesh,
    view_shard,
)
from ..parallel.mesh import (
    Mesh,
    all_reduce_mean,
    all_reduce_sum_,
    shard_dataset,
    spatial_rows,
)
from ..parallel.spatial import gather_rows, spatial_mean
from ..utils.device import disable_tf32, resolve_device
from ..utils.metrics import MeterDict, abs_depth_error, threshold_error_rate
from ..utils.spans import span
from .checkpoint import restore_latest, save_state

THRESHOLDS_MM = (2.0, 4.0, 8.0, 16.0, 32.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimiser, sweep and loop settings.

    ``total_steps`` is the cosine schedule's length; None means epochs x
    steps per epoch.  ``logdir`` None writes no checkpoint.  ``max_steps``
    stops a run early (after a checkpoint).  ``evidential`` trains an
    evidential head with the core (``maxdisp`` hypotheses, ``loss_emvsnet``
    with ``evidential_weight_reg``).  ``feature_dtype`` (``torch.float32``
    or ``torch.bfloat16``) and ``fold_omega`` (``False``, ``"hybrid"``,
    ``True``) go to the sweep, as the JAX package's do.  ``mesh``, a
    :class:`..parallel.mesh.Mesh` with data and view or spatial axes,
    trains across its ranks on its device (``device`` is then not read);
    ``batch_size`` is per data rank.  A mesh with view and spatial axes
    above 1 is refused, as the JAX package refuses it.
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
        if self.feature_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"TrainConfig feature_dtype is torch.float32 or torch.bfloat16, "
                             f"not {self.feature_dtype}")
        if not any(self.fold_omega is v for v in (False, True)) and self.fold_omega != "hybrid":
            raise ValueError(f"TrainConfig fold_omega is False, True or 'hybrid', "
                             f"not {self.fold_omega!r}")
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"TrainConfig mesh is a parallel.mesh.Mesh (make_mesh) or None, "
                            f"not {type(self.mesh).__name__}")
        check_train_mesh(self.mesh)

    def sweep(self, remat: bool = True) -> SweepConfig:
        return SweepConfig(depth_block=self.depth_block, remat=remat, collect_volume=True,
                           feature_dtype=self.feature_dtype, fold_omega=self.fold_omega,
                           mesh=self.mesh)


def check_train_mesh(mesh) -> None:
    """The JAX package's refusal of a training mesh with view and spatial
    axes above 1, whose gradients its XLA partitioner double-counts by the
    view size (``aa_rmvsnet_tpu/pipeline/train.py:_check_train_mesh``)."""
    if mesh is not None and mesh.shape["view"] > 1 and mesh.shape["spatial"] > 1:
        raise ValueError(
            "training with view > 1 AND spatial > 1 produces wrong gradients "
            "(XLA SPMD double-counts the view psum across the spatial axis); "
            "use (data, view) or (data, spatial) for training"
        )


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


def batch_rows(batch: dict, mesh) -> dict:
    """This rank's slab of rows of ``imgs`` ``(B, V, H, W, 3)``, ``depth``
    and ``mask`` ``(B, H, W)`` on a spatial mesh
    (:func:`..parallel.mesh.spatial_rows`), the JAX package's row sharding
    of the training batch (the core's labels and the evidential head's
    alike); ``batch`` itself otherwise."""
    if spatial_mesh(mesh) is None:
        return batch
    row0, rows = spatial_rows(mesh, batch["imgs"].shape[2])
    return dict(batch, imgs=batch["imgs"][:, :, row0:row0 + rows],
                **{key: batch[key][:, row0:row0 + rows] for key in ("depth", "mask")})


def _rows_group(config: TrainConfig):
    """The spatial group where the batch's rows are split over it, else
    None."""
    mesh = spatial_mesh(config.mesh)
    return None if mesh is None else mesh.spatial_group


def loss_fn(model: AARMVSNetCore, batch: dict, sweep_config: SweepConfig, group=None):
    """The core's loss and WTA depth; under a spatial mesh ``batch`` holds
    this rank's rows (:func:`batch_rows`), ``group`` is the spatial group and
    the loss is the rank's share."""
    out = forward(model, batch["imgs"], batch["proj_matrices"],
                  batch["depth_values"], sweep_config)
    return depth_classification_loss(
        probability_volume(out["cost_volume"]), batch["depth"], batch["mask"],
        batch["depth_values"], group=group,
    )


def _group(config: TrainConfig):
    """The data group: the ranks whose rows make up the global batch (view
    ranks hold replicas of their data rank's rows)."""
    return None if config.mesh is None else config.mesh.data_group


def evidential_loss_fn(model: AARMVSNetCore, head: EvidentialHead, batch: dict,
                       config: TrainConfig, sweep_config: SweepConfig):
    """The core's probability volume through ``head`` (in the mode the
    caller set), then ``loss_emvsnet``.  Returns ``(loss, head outputs)``.
    Under a mesh the head's train-mode statistics and the loss's valid
    count are the global batch's.  On a spatial mesh ``batch`` holds this
    rank's rows (:func:`batch_rows`): the head runs on the slab of the
    cost volume, its outputs are the slab's, and the loss is the rank's
    share."""
    out = forward(model, batch["imgs"], batch["proj_matrices"],
                  batch["depth_values"], sweep_config)
    volume = out.pop("cost_volume")
    if volume.shape[2:] != batch["depth"].shape[1:]:
        raise ValueError(f"evidential_loss_fn: a {tuple(volume.shape[2:])} volume against "
                         f"{tuple(batch['depth'].shape[1:])} labels; on a spatial mesh the "
                         "labels are the slab's rows (batch_rows)")
    with batch_statistics_over(head, _pixel_groups(config)):
        ev = head(probability_volume(volume), batch["depth_values"], spatial_mesh(config.mesh))
    del volume
    loss = loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"],
                        batch["depth"], batch["mask"], config.evidential_weight_reg,
                        group=_group(config), rows_group=_rows_group(config))
    return loss, ev


def _pixel_groups(config: TrainConfig) -> tuple:
    """The groups over whose ranks the global batch's pixels are split: the
    spatial group (rows), then the data group (samples)."""
    return (_rows_group(config), _group(config))


def _loss_metric(loss: torch.Tensor, config: TrainConfig) -> torch.Tensor:
    """The batch's loss from this rank's: the spatial ranks' shares summed."""
    loss = loss.detach().clone()
    all_reduce_sum_([loss], _rows_group(config))
    return loss


def _mean_over_ranks(metrics: dict, keys, config: TrainConfig) -> None:
    """Replace the plain batch means ``keys`` of ``metrics`` by their mean
    over the data ranks (the global batch's mean: every data rank holds as
    many samples), in one all-reduce."""
    if _group(config) is None:
        return
    values = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_mean([values], _group(config))
    metrics.update(zip(keys, values))


def _evidential_summaries(ev: dict, batch: dict, config: TrainConfig) -> tuple[dict, dict]:
    """Metrics and images of an evidential step (JAX
    ``_evidential_summaries``): the head's mean nu, alpha and beta and
    gamma's error, over the whole map on a spatial mesh, and both
    uncertainty decompositions (this rank's rows)."""
    gamma, depth, mask = ev["gamma"].detach(), batch["depth"], batch["mask"]
    nu, alpha, beta = ev["nu"].detach(), ev["alpha"].detach(), ev["beta"].detach()
    rows = spatial_mesh(config.mesh)
    metrics = {
        "loss_components/nu": spatial_mean(nu, (0, 1, 2), rows),
        "loss_components/alpha": spatial_mean(alpha, (0, 1, 2), rows),
        "loss_components/beta": spatial_mean(beta, (0, 1, 2), rows),
        "abs_depth_error": abs_depth_error(gamma, depth, mask, group=_pixel_groups(config)),
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


def average_gradients(params, mesh: Mesh, view_partial=()) -> None:
    """The global batch's gradient of every parameter, in place (a
    parameter without one counts as zeros), the same on every rank.  Over
    the spatial group every gradient, of which each spatial rank holds its
    rows' share, is summed.  Over the view group the gradients of
    ``view_partial``, of which each view rank holds its source views'
    share, are summed, and the others, which every view rank computes
    whole, averaged (on the card their backward is not bit for bit
    deterministic, so the view ranks' copies would drift apart); then every
    gradient is averaged over the data group.  One all-reduce per group."""
    views = mesh.shape["view"] > 1
    rows = mesh.shape["spatial"] > 1
    if mesh.data_group is None and not views and not rows:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if rows:
        all_reduce_sum_(grads, mesh.spatial_group)
    if views:
        all_reduce_sum_(grads, mesh.view_group)
        partial = {id(p) for p in view_partial}
        for p in params:
            if id(p) not in partial:
                p.grad.div_(mesh.shape["view"])
    all_reduce_mean(grads, mesh.data_group)


def train_step(model, optimizer, scheduler, batch: dict, config: TrainConfig,
               head: EvidentialHead | None = None):
    """One update: zero grads, forward with remat, loss, backward (which
    recomputes each depth block), Adam and scheduler steps, under the
    profiler ranges ``train.forward``, ``train.backward`` and
    ``train.optimizer``.  With ``head`` (``config.evidential``) both modules
    run in train mode and the loss is ``loss_emvsnet`` on the head's output.
    Under ``config.mesh`` the gradients are those of the global batch
    before the clip (:func:`average_gradients`), and the metrics are the
    global batch's; on a spatial mesh ``batch`` holds this rank's rows
    (:func:`batch_rows`), and so do the images.
    Returns ``(metrics, images)`` of detached tensors."""
    model.train()
    if head is not None:
        head.train()
    optimizer.zero_grad(set_to_none=True)
    with span("train.forward"):
        if head is None:
            loss, wta_depth = loss_fn(model, batch, config.sweep(remat=True),
                                      _rows_group(config))
        else:
            loss, ev = evidential_loss_fn(model, head, batch, config, config.sweep(remat=True))
    with span("train.backward"):
        loss.backward()
    params = trainable_parameters(model, head)
    if config.mesh is not None:
        partial = ()
        if view_shard(config.mesh, batch["imgs"].shape[1]) is not None:
            partial = list(model.feature.parameters()) + list(model.omega.parameters())
        average_gradients(params, config.mesh, partial)
    with span("train.optimizer"):
        if config.grad_clip is not None:
            clip_by_global_norm(params, config.grad_clip)
        optimizer.step()
        scheduler.step()
    if head is not None and config.mesh is not None and config.mesh.shape["view"] > 1:
        # The view ranks' BatchNorm statistics come from the same volume,
        # but the card's 3D convolutions are not bit for bit deterministic,
        # so the replicas' running statistics are averaged to stay equal.
        # The spatial ranks' are sums over the ranks, equal already.
        all_reduce_mean([b for b in head.buffers() if b.is_floating_point()],
                        config.mesh.view_group)
    if head is not None:
        metrics, images = _evidential_summaries(ev, batch, config)
        metrics["loss"] = _loss_metric(loss, config)
        _mean_over_ranks(metrics, ["loss", "loss_components/nu", "loss_components/alpha",
                                   "loss_components/beta"], config)
        return metrics, images
    depth, mask = batch["depth"], batch["mask"]
    metrics = {"loss": _loss_metric(loss, config),
               "abs_depth_error": abs_depth_error(wta_depth, depth, mask,
                                                  group=_pixel_groups(config))}
    _mean_over_ranks(metrics, ["loss"], config)
    images = {"depth_est": wta_depth * mask,
              "error_map": torch.abs(wta_depth - depth) * mask}
    return metrics, images


@torch.no_grad()
def eval_step(model, batch: dict, config: TrainConfig,
              head: EvidentialHead | None = None) -> dict:
    """Loss and depth metrics without remat or gradients.  With ``head``
    (JAX ``make_evidential_eval_step``) the head runs in eval mode, the loss
    is ``loss_emvsnet`` and the metrics are of gamma; ``train_step`` puts
    both modules back in train mode.  Under ``config.mesh`` every metric is
    the global batch's."""
    model.eval()
    if head is None:
        loss, depth_est = loss_fn(model, batch, config.sweep(remat=False), _rows_group(config))
    else:
        head.eval()
        loss, ev = evidential_loss_fn(model, head, batch, config, config.sweep(remat=False))
        depth_est = ev["gamma"]
    loss, group = _loss_metric(loss, config), _pixel_groups(config)
    depth, mask = batch["depth"], batch["mask"]
    metrics = {"loss": loss,
               "abs_depth_error": abs_depth_error(depth_est, depth, mask, group=group)}
    _mean_over_ranks(metrics, ["loss"], config)
    for tau in THRESHOLDS_MM:
        metrics[f"thres{int(tau)}mm_error"] = threshold_error_rate(depth_est, depth, mask, tau,
                                                                   group=group)
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


def broadcast_from_main(modules, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers into every rank's ``modules``, in
    place, so that all ranks start from the same weights."""
    if mesh.group is None:
        return
    for module in modules:
        for tensor in module.state_dict().values():
            torch.distributed.broadcast(tensor, src=0, group=mesh.group)


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
    card for ``cuda``), or to the mesh's device, and turns TF32 off.  Each
    epoch visits the dataset in a permutation drawn from ``(seed, epoch)``,
    in batches of ``batch_size`` (the last partial batch dropped); a failed
    load is replaced by the last good sample, so no step is skipped.  With
    ``logdir``, a checkpoint is written after every epoch and at
    ``max_steps``; with ``resume`` the run restarts from the highest saved
    step, at the batch where that run stopped.  After every epoch
    ``val_dataset``, if given, is evaluated.

    Under ``config.mesh`` every rank of the mesh calls this with the whole
    dataset and takes its data rank's shard (:func:`shard_dataset`) in a
    permutation drawn from ``(seed, epoch, data_rank)`` (``(seed, epoch)``
    with one data rank), ``(len(dataset) // data) // batch_size`` steps an
    epoch, from rank 0's weights (broadcast after any resume, which every
    rank reads); only rank 0 writes checkpoints (the others wait at a
    barrier), prints and calls ``logger``.  On a spatial mesh each rank
    steps on its rows of every batch (:func:`batch_rows`), and the summary
    images are gathered whole for rank 0.

    Returns ``{start_step, step, losses, step_seconds, val}``: per-step
    losses (the global batch's) and seconds (host clock around the step,
    ending in a device synchronise), and the last validation means.
    """
    if config.evidential != (head is not None):
        raise ValueError("run_training: config.evidential needs an evidential head, and a "
                         "head needs config.evidential")
    if head is not None and head.maxdisp != config.maxdisp:
        raise ValueError(f"run_training: the head has maxdisp {head.maxdisp}, the config "
                         f"{config.maxdisp}")
    mesh = config.mesh
    data_rank, data_size = (0, 1) if mesh is None else (mesh.coord("data"), mesh.shape["data"])
    if len(dataset) // data_size < config.batch_size:
        raise ValueError(f"run_training: {len(dataset)} sample(s) over {data_size} rank(s) "
                         f"make no batch of {config.batch_size}")
    device = resolve_device(config.device) if mesh is None else mesh.device
    disable_tf32()
    model.to(device)
    if head is not None:
        head.to(device)
    is_main = mesh is None or mesh.is_main
    steps_per_epoch = max((len(dataset) // data_size) // config.batch_size, 1)
    val_steps = 0 if val_dataset is None else (len(val_dataset) // data_size) // config.batch_size
    dataset = shard_dataset(dataset, data_rank, data_size)
    if val_dataset is not None:
        val_dataset = shard_dataset(val_dataset, data_rank, data_size)
    total_steps = config.total_steps or config.epochs * steps_per_epoch
    params = trainable_parameters(model, head)
    optimizer, scheduler = make_optimizer(params, config, total_steps)
    group = _group(config)

    start_step = 0
    if config.resume and config.logdir:
        restored = restore_latest(config.logdir, model, optimizer, scheduler, head=head)
        if restored is not None:
            start_step = restored
            if is_main:
                print(f"resumed from step {start_step}", flush=True)
    if mesh is not None:
        broadcast_from_main([model] + ([] if head is None else [head]), mesh)

    def on_skip(exc):
        where = f", rank {mesh.rank}" if mesh is not None and mesh.world_size > 1 else ""
        print(f"SKIP (train load failure{where}): {exc}", flush=True)

    def save(step):
        if config.logdir and is_main:
            save_state(config.logdir, step, model, optimizer, scheduler, head=head)
        if mesh is not None and mesh.group is not None:
            torch.distributed.barrier(group=mesh.group)

    def result():
        return {"start_step": start_step, "step": step, "losses": losses,
                "step_seconds": step_seconds, "val": val_means}

    step = start_step
    losses: list[float] = []
    step_seconds: list[float] = []
    val_means: dict = {}
    meter = MeterDict()
    for epoch in range(start_step // steps_per_epoch, config.epochs):
        done = step - epoch * steps_per_epoch  # batches of this epoch already taken
        seed = [config.seed, epoch] if data_size == 1 else [config.seed, epoch, data_rank]
        order = np.random.RandomState(seed).permutation(len(dataset))
        order = order[done * config.batch_size:]
        samples = resilient_samples(dataset, order, num_workers=config.num_workers,
                                    on_skip=on_skip)
        for host_batch in itertools.islice(
            batched(samples, config.batch_size, drop_last=True), steps_per_epoch - done
        ):
            t0 = time.perf_counter()
            batch = batch_rows(batch_to_device(host_batch, device), mesh)
            metrics, images = train_step(model, optimizer, scheduler, batch, config, head)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            meter.update(metrics)
            step += 1
            if step % config.summary_freq == 0:
                means = meter.mean(group)
                if _rows_group(config) is not None:  # the first sample, whole
                    images = {k: gather_rows(v[:1], mesh, dim=1) for k, v in images.items()}
                if is_main:
                    print(f"epoch {epoch} step {step}: "
                          + " ".join(f"{k}={v:.4f}" for k, v in means.items()), flush=True)
                    if logger is not None:
                        logger.scalars("train", means, step)
                        _summarize(logger, "train", images, host_batch, step)
                meter = MeterDict()
            if config.max_steps and step - start_step >= config.max_steps:
                save(step)
                return result()
        save(step)

        if val_steps:
            vmeter = MeterDict()
            for vbatch in itertools.islice(batched(
                resilient_samples(val_dataset, num_workers=config.num_workers,
                                  on_skip=on_skip),
                config.batch_size, drop_last=True,
            ), val_steps):
                vbatch = batch_rows(batch_to_device(vbatch, device), mesh)
                vmeter.update(eval_step(model, vbatch, config, head))
            val_means = vmeter.mean(group)
            if is_main:
                print(f"epoch {epoch} fulltest: "
                      + " ".join(f"{k}={v:.4f}" for k, v in val_means.items()), flush=True)
                if logger is not None:
                    logger.scalars("fulltest", val_means, step)
    return result()
