"""Depth-hypothesis block pipelining over the mesh's ``depth`` axis (port of
``aa_rmvsnet_tpu/parallel/depth_pipeline.py``).

The recurrent regularizer makes the depth sweep sequential (the 5 x (h, c)
ConvLSTM carry), so splitting the depth axis is pipelining: stage ``p``
(the rank's depth coordinate) owns depth chunk ``p`` of ``D / P`` and a
stream of M reference-view maps fills the pipeline.  At tick ``t`` stage
``p`` sweeps map ``t - p``'s chunk, then sends the carry to stage
``p + 1``; stage 0 starts each map from zero states.  After ``P - 1`` fill
ticks every stage is busy, so M maps take ``M + P - 1`` chunk-times
instead of ``M * P`` where each stage has a card of its own.

Each stage runs FeatNet on every map and builds each map's tables itself
(the JAX package replicates them too); the port builds a map's tables at
the tick that sweeps it, so one map's tables are live at a time.  A stage
with no map at a tick skips it (the JAX program computes masked values
there), so each stage simply sweeps its chunk of maps ``0..M-1`` in turn,
and the blocking receive of the carry orders the ticks.

Winner-take-all and logsumexp across chunks are associative: every stage
keeps per-map partials, the partials are gathered to every stage, and the
merge is the JAX package's: the first maximum over the chunks in depth
order wins (the reference's running argmax), ``logaddexp`` folds the
partials in chunk order, and ``confidence = exp(max - lse)``.  Depth is bit
for bit the single sweep's; the confidence differs by the logsumexp's
reassociation.

The carry (``33 * H * W`` values per (h, c) member at ``HIDDEN_DIMS``
``(16, 16, 16, 16, 8)`` and scales 1, 1/2, 1/4, 1/2, 1) goes by
``parallel.mesh.send_carry``/``recv_carry``: under gloo through pinned
host memory, under NCCL card to card.  A collective that fails fails the
run; nothing falls back to the serial sweep.

``collect_volume`` is refused: the pipeline targets inference latency.
``gather_pack > 1`` and ``residual_dtype`` are refused too (single-mesh
levers); ``table_dtype``, ``packed_rows`` with ``table_taps``,
``fused_residual`` (bit for bit the unfused build) and ``fold_omega`` run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# The module, not its names: the models import parallel/mesh.py and
# parallel/spatial.py, so this package may be initialised while they are.
from ..models import network
from .mesh import Mesh, recv_carry, send_carry


def _check(config: network.SweepConfig, num_depth: int, stages: int) -> None:
    if config.collect_volume:
        raise ValueError("collect_volume is not supported by the depth pipeline")
    if num_depth % stages:
        raise ValueError(f"D={num_depth} not divisible by depth axis {stages}")
    if config.gather_pack > 1 or config.residual_dtype is not None:
        raise ValueError(
            "gather_pack / residual_dtype are not supported in the "
            "depth-pipelined sweep (single-mesh sweep levers only)"
        )


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """``t`` of every rank of ``group`` (a gloo group through the host)."""
    send = t.cpu() if dist.get_backend(group) == "gloo" else t
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return [p.to(t.device) for p in parts]


def _run(model, feature_of, proj_matrices: torch.Tensor, depth_values: torch.Tensor,
         mesh: Mesh, config: network.SweepConfig) -> dict:
    """The pipeline over ``M = depth_values.shape[0]`` maps; ``feature_of(m)``
    gives map ``m``'s ``(V, B, H, W, C)`` features."""
    M, B, D = depth_values.shape
    stages, stage = mesh.shape["depth"], mesh.coord("depth")
    _check(config, D, stages)
    chunk = D // stages
    group = mesh.depth_group
    model = network._cast(model, config.feature_dtype)
    parts, sending, zeros = [], None, None
    for m in range(M):  # tick m + stage
        feats = feature_of(m)
        if zeros is None:
            _, _, H, W, _ = feats.shape
            zeros = network.init_states(B, H, W, dtype=config.feature_dtype, device=feats.device)
        states = zeros
        if stage > 0:
            states = recv_carry(zeros, mesh.rank - 1, group)
        states, depth_img, max_cost, lse, _ = network._sweep_chunk(
            model, feats, proj_matrices[m], depth_values[m, :, stage * chunk:(stage + 1) * chunk],
            states, config)
        if stage < stages - 1:
            if sending is not None:
                sending[0].wait()
            sending = send_carry(states, mesh.rank + 1, group)
        parts.append(torch.stack([depth_img, max_cost, lse]))
    if sending is not None:
        sending[0].wait()
    # (P, M, 3, B, H, W): every stage's partials, in depth order.
    gathered = torch.stack(_gather(torch.stack(parts), group))
    depth_parts, max_parts, lse_parts = gathered.unbind(2)
    best = torch.argmax(max_parts, dim=0)  # the first maximum over the chunks
    depth = torch.gather(depth_parts, 0, best[None])[0]
    max_cost = max_parts.max(dim=0).values
    lse = lse_parts[0]
    for part in lse_parts[1:]:
        lse = torch.logaddexp(lse, part)
    return {"depth": depth, "photometric_confidence": torch.exp(max_cost - lse)}


def sweep_depth_pipelined(model, features: torch.Tensor, proj_matrices: torch.Tensor,
                          depth_values: torch.Tensor, mesh: Mesh,
                          config: network.SweepConfig | None = None) -> dict:
    """Pipelined plane sweep of M maps over the mesh's ``depth`` axis; every
    stage of the depth group calls it with the same inputs.

    Args:
      features: ``(M, V, B, H, W, C)`` per-map, per-view features (view 0
        = reference).
      proj_matrices: ``(M, B, V, 4, 4)``.
      depth_values: ``(M, B, D)``; D must divide into ``mesh.shape["depth"]``
        equal chunks.
      config: the sweep's settings, ``SweepConfig()`` by default.

    Returns ``depth`` and ``photometric_confidence`` of shape ``(M, B, H,
    W)`` on every stage.
    """
    return _run(model, lambda m: features[m], proj_matrices, depth_values, mesh,
                config or network.SweepConfig())


def pipeline_forward(model, imgs: torch.Tensor, proj_matrices: torch.Tensor,
                     depth_values: torch.Tensor, mesh: Mesh,
                     config: network.SweepConfig | None = None) -> dict:
    """FeatNet and the pipelined sweep for a stack of M maps: ``imgs``
    ``(M, B, V, H, W, 3)``; returns :func:`sweep_depth_pipelined`'s dict.
    Each stage runs FeatNet on map ``m`` at the tick that sweeps it."""
    config = config or network.SweepConfig()
    model = network._cast(model, config.feature_dtype)
    return _run(model, lambda m: network.extract_features(
        model, imgs[m], config.feature_dtype, config.feature_view_chunk),
        proj_matrices, depth_values, mesh, config)
