"""The core MVS network and its depth sweep (port of
``aa_rmvsnet_tpu/models/network.py``): the exact fp32 path, bf16 features,
the packed-row warp with gather super-packing and 6x6 tables, the fused
squared residual, folded omega, the quantized tables and residuals, online
WTA + logsumexp, and ``remat`` for training.

``forward`` runs FeatNet on every view, then sweeps the depth hypotheses
block by block: per block it warps each source view through its patch
table, squares the residual against the reference features, reweights it
by omega and averages over views into the variance cost; each hypothesis
then takes one step of the ConvLSTM U-Net, and an online winner-take-all +
logsumexp carry yields depth and confidence.  The JAX ``lax.scan`` over
blocks and slices is a Python loop here, and the view axis is a loop so
that one view's gathered rows are live at a time.  With
``SweepConfig.remat`` each depth block runs under one
``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint(block_step)``),
so backpropagation through time keeps only each block's input states
between the forward and the backward, and one block's activations at a
time while it runs.

Four cost-block builders, chosen by ``SweepConfig`` as in the JAX package:

- ``_build_cost_block``: a 2x2 row per (view, hypothesis, pixel), omega on
  an ``(B*Db, 32, H, W)`` batch (or, ``fold_omega="hybrid"``, folded);
- ``_build_cost_block_folded`` (``fold_omega=True``): the same gather in
  pixel-major order, so the warped volume is already depth-folded;
- ``_build_cost_block_packed`` (``packed_rows``): one 4x4 (or 6x6) row per
  (view, pixel) serves the whole block, exact where
  :func:`pick_packed_rows` passes, optionally emitting the squared
  residual straight from the blend (``fused_residual``);
- with ``gather_pack`` > 1 one packed row serves ``gather_pack`` blocks.

In bf16 (``feature_dtype``) the sweep runs on the model's parameters cast
to bf16: features, convolutions, GroupNorm, omega and the ConvLSTM in bf16
(the gate kernels compute in fp32 and store bf16); coordinates, depths,
the view sum's accumulator, WTA, logsumexp and the collected cost volume
stay fp32.  Inference casts a copy of the model (:func:`cast_model`);
training casts in the autograd graph (:func:`cast_in_graph`), so that the
gradients reach the fp32 parameters in fp32.

The quantized levers (``SweepConfig.table_dtype``, ``residual_dtype``) are
approximate and opt-in: fp8 or int8 warp tables with per-channel scales,
and a squared residual stored in fp8, int8 or both (``"dual"``) with one
per-channel scale shared by every view, which omega folds into its first
kernel and the view mean multiplies back.  They are plain torch ops, as
they are XLA code in the JAX package, inside ``quant.*`` profiler ranges.

Under a mesh whose spatial axis is above 1 (:func:`spatial_mesh`) every
rank holds a slab of rows of every view (``parallel/spatial.py``, the
collectives GSPMD inserts in the JAX package): FeatNet, omega and the
U-Net take the mesh and run on it, the source views' features
are gathered whole before their tables are built (a warp may read any
row), the homography terms cover the slab's pixels at their map rows, and
winner-take-all, logsumexp and the collected volume stay the slab's.  A
view axis may split the source views at the same time (inference only, as
in the JAX package): the row gathers run over the spatial group, the view
merge over the view group, in one order on every rank.

Public functions keep the JAX package's NHWC shapes; the modules run NCHW.
Profiler ranges (``featnet``, ``sweep.setup``, ``sweep.cost_block``,
``sweep.regularize``, ``sweep.wta``) name the layers for
``tools/profile_main_path.py`` and ``tools/profile_train_step.py``;
outside a profiler they cost a few microseconds each, a few hundred times
per map.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .aggregation import InterViewAA, omega_folded
from .feature import FeatNet
from .init import init_like_jax
from .regularizer import UNetConvLSTM, init_states
from ..parallel.mesh import spatial_rows, view_merge
from ..parallel.spatial import all_reduce_max, gather_rows
from ..ops.homography import homography_terms, max_depth_step_displacement, plane_sweep_xy
from ..ops.patch_sample import (
    F8_MAX,
    QUANT_DTYPES,
    build_patch_table_packed,
    build_patch_table_packed_quant,
    patch_bilinear_sample,
    patch_bilinear_sample_packed,
    quantize_residual,
    true_div,
)


class AARMVSNetCore(nn.Module):
    """The 187,203-parameter core: ``feature``, ``omega`` and
    ``cost_regularization``, with the reference torch ``state_dict`` keys.
    A fresh core draws the JAX package's ``init_params`` distributions
    (:func:`.init.init_like_jax`) from ``generator``, else from torch's
    global generator."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.feature = FeatNet()
        self.omega = InterViewAA()
        self.cost_regularization = UNetConvLSTM()
        init_like_jax(self, generator)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Depth-sweep settings (the JAX ``SweepConfig`` fields the port has).

    depth_block: hypotheses per block (the largest divisor of D that is at
      most this).
    remat: recompute each block in the backward pass (training).
    collect_volume: also return the ``(B, D, H, W)`` regularized cost
      volume (the training loss needs it).
    feature_dtype: ``torch.float32`` (exact) or ``torch.bfloat16`` for
      features, convolutions, omega and the ConvLSTM.
    fold_omega: ``False``, ``"hybrid"`` (the 2x2 gather, omega folded) or
      ``True`` (pixel-major gather, folded cost layout); all three compute
      the same costs.  Ignored with ``packed_rows``.
    packed_rows: one ``table_taps``-wide row per (view, pixel) serves the
      whole block; exact only where :func:`pick_packed_rows` passes.
    gather_pack: one packed row serves ``gather_pack`` blocks (packed only;
      gate with ``depth_block = gather_pack * depth_block``).
    table_taps: packed window per axis, 4 or 6 (exactness span 2 or 4 px).
    fused_residual: the packed blend emits the squared residual, so the
      warped volume never exists; bit for bit the unfused result, with
      every ``residual_dtype``.
    table_dtype: storage of the warp patch tables: ``None`` (the feature
      dtype, exact), ``torch.float8_e4m3fn`` or ``torch.int8``, quantized
      per channel (``ops.patch_sample.build_patch_table_packed_quant``)
      for a quarter of fp32's gather bytes and half of bf16's.  An int8
      table on the packed path takes the int8 blend.  Approximate.
    residual_dtype: storage of the squared residual on the folded cost
      layouts (``packed_rows``, or ``fold_omega=True``; otherwise
      ``ValueError``): ``None``, ``torch.float8_e4m3fn``, ``torch.int8``
      or ``"dual"`` (an fp8 copy for the variance and an int8 copy for
      omega).  One per-channel scale serves every view: ``max((2 a)^2 /
      qmax, 1e-12)``, ``a`` the channel's amax over the source and
      reference features, qmax 127 for int8 and 448 otherwise.  Omega
      folds it into its first kernel; on an int8 copy it runs rw0 as an
      int8 convolution and the rest of its chain in bf16 (on int8
      activations with ``AA_RMVSNET_OMEGA_INT8=chain``).  The variance
      multiplies it back.  Approximate.
    feature_view_chunk: FeatNet views per batch, 0 for all ``B*V`` at
      once (:func:`extract_features`); a chunk bounds FeatNet's peak
      memory and gives the same features.
    mesh: a :class:`..parallel.mesh.Mesh` or ``None``.  With a view axis
      that divides the source views the sweep is view-parallel
      (:func:`view_shard`): each view rank runs FeatNet on the reference
      view and its own source views, builds their tables and homography
      terms, and merges its partial view mean over the view group once per
      depth block; every rank then regularizes the same costs.  With a
      spatial axis above 1 every rank sweeps its slab of rows
      (:func:`spatial_mesh`), the view ranks of a slab their source views
      where both axes are above 1.  Other axes do not change the sweep.
      ``gather_pack > 1`` and ``residual_dtype`` raise on a view-parallel
      sweep, as in the JAX package.
    """

    depth_block: int = 16
    remat: bool = False
    collect_volume: bool = True
    feature_dtype: torch.dtype = torch.float32
    fold_omega: Any = False  # False | "hybrid" | True
    packed_rows: bool = False
    gather_pack: int = 1
    table_taps: int = 4
    fused_residual: bool = False
    table_dtype: Any = None  # None | torch.float8_e4m3fn | torch.int8
    residual_dtype: Any = None  # None | torch.float8_e4m3fn | torch.int8 | "dual"
    feature_view_chunk: int = 0
    mesh: Any = None


def pick_depth_block(num_depth: int, target: int) -> int:
    """Largest divisor of ``num_depth`` that is <= ``target``."""
    for block in range(min(target, num_depth), 0, -1):
        if num_depth % block == 0:
            return block
    return 1


def spatial_mesh(mesh):
    """``mesh`` where its spatial axis is above 1 (the sweep then runs on
    each rank's slab of rows), else None.  A view axis above 1 may come
    with it: each view rank then sweeps its source views
    (:func:`view_shard`) on its slab, and the view merge runs per slab
    over the view group, whose ranks share a spatial coordinate."""
    if mesh is None or mesh.shape["spatial"] == 1:
        return None
    return mesh


def _dtype_of(model: AARMVSNetCore) -> torch.dtype:
    """The dtype a model's convolutions run in: that of its parameters, or
    the one :func:`cast_in_graph` cast them to."""
    return getattr(model, "cast_dtype", None) or next(model.parameters()).dtype


def cast_model(model: AARMVSNetCore, dtype: torch.dtype) -> AARMVSNetCore:
    """``model`` itself when its parameters are in ``dtype``, else a copy
    in ``dtype``: the caller's model is never cast in place (the JAX
    package casts a copy of the parameter tree the same way).  No gradient
    reaches the caller's parameters through the copy; the inference path
    takes it, under ``torch.no_grad()`` or ``inference_mode()``."""
    if _dtype_of(model) == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


def cast_in_graph(model: AARMVSNetCore, dtype: torch.dtype) -> AARMVSNetCore:
    """``model`` itself when its parameters are in ``dtype``, else a shell
    of its module tree whose parameters are ``p.to(dtype)`` of the
    caller's: plain tensors in the autograd graph, whose backward returns
    fp32 gradients to the fp32 parameters (the JAX package's ``astype`` of
    the parameter tree inside the traced function, and its transpose).

    The shell is made once per forward and reaches every use of a weight
    as an attribute of its module, so a ``torch.utils.checkpoint``
    recompute of a depth block, which runs outside any context that the
    forward entered, reads the same cast tensors."""
    if _dtype_of(model) == dtype:
        return model
    params = dict(model.named_parameters())
    # The parameters are not copied: the shell's slots are refilled below.
    shell = copy.deepcopy(model, memo={id(p): None for p in params.values()})
    for name, p in params.items():
        owner, _, attr = name.rpartition(".")
        module = shell.get_submodule(owner)
        del module._parameters[attr]
        setattr(module, attr, p.to(dtype))
    shell.cast_dtype = dtype
    return shell


def _cast(model: AARMVSNetCore, dtype: torch.dtype) -> AARMVSNetCore:
    """The model in ``dtype`` for one forward: cast in the graph where one
    is recorded (training), else :func:`cast_model`'s copy."""
    if torch.is_grad_enabled():
        return cast_in_graph(model, dtype)
    return cast_model(model, dtype)


def extract_features(model: AARMVSNetCore, imgs: torch.Tensor,
                     dtype: torch.dtype = torch.float32, view_chunk: int = 0,
                     mesh=None) -> torch.Tensor:
    """FeatNet on every view in ``dtype``: all ``B*V`` views as one batch
    (``view_chunk=0``, the JAX default) or sequential chunks of
    ``view_chunk`` views, which bounds FeatNet's peak memory.  Given a
    spatial ``mesh`` (:func:`spatial_mesh`), ``imgs`` are this rank's slab
    of rows and so are the features.

    GroupNorm is per sample, so the chunk does not change the math, and on
    the CPU not the values either (FeatNet runs one sample at a time there,
    ``models/feature.py:FeatNet.forward``).  cuDNN may pick another
    algorithm for another batch, so on the card the forms agree to the
    rounding of the working type.

    Args:
      imgs: ``(B, V, H, W, 3)`` standardized images.

    Returns:
      ``(V, B, H, W, 32)`` features in ``dtype`` (view-major for the sweep).
    """
    B, V, H, W, _ = imgs.shape
    model = _cast(model, dtype)
    k = view_chunk if 0 < view_chunk < V else V

    def run(chunk):  # (B, k, H, W, 3) -> (B, k, H, W, 32)
        x = chunk.reshape(-1, H, W, 3).to(dtype).permute(0, 3, 1, 2)
        return model.feature(x, mesh).permute(0, 2, 3, 1).reshape(B, chunk.shape[1], H, W, -1)

    with record_function("featnet"):
        return torch.cat([run(imgs[:, i:i + k]).transpose(0, 1) for i in range(0, V, k)])


def _view_mean(terms) -> torch.Tensor:
    """Mean over the source views of the reweighted residuals.  The sum
    accumulates in fp32 and rounds once to the terms' dtype, as ``jnp.sum``
    does for bf16; the division runs in that dtype.  fp32 terms are summed
    in view order."""
    acc, count = None, 0
    for term in terms:
        if acc is None:
            acc, dtype = term.float(), term.dtype
        else:
            acc = acc + term
        count += 1
    return acc.to(dtype) / count


def _build_cost_block(
    model: AARMVSNetCore,
    ref_feat: torch.Tensor,
    src_tables: list[torch.Tensor],
    rot_grids: list[torch.Tensor],
    transes: list[torch.Tensor],
    depth_block: torch.Tensor,
    table_scales: list,
    hybrid_omega: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Warp + squared residual + omega reweight + view mean for one block.

    Args:
      ref_feat: ``(B, H, W, C)`` (a spatial rank's slab of rows).
      src_tables: per source view, a ``(B, Hs*W, 4C)`` 2x2 patch table of
        the whole map (``Hs = H`` but on a slab).
      rot_grids: per source view ``(B, 3, H*W)``; transes: ``(B, 3, 1)``.
      depth_block: ``(B, Db)``.
      table_scales: per source view the ``(B, 1, 4C)`` dequantization
        factors of a quantized table, or ``None``.
      hybrid_omega: omega in its folded form on a transposed copy of the
        residual (:func:`..models.aggregation.omega_folded`).
      mesh: the spatial mesh of a slab (:func:`spatial_mesh`), else None.

    Returns:
      ``(Db, B, C, H, W)`` negated variance cost slices.
    """
    B, H, W, C = ref_feat.shape
    Db = depth_block.shape[1]
    ref = ref_feat.permute(0, 3, 1, 2)[:, None]  # (B, 1, C, H, W), channels last

    def terms():
        for table, scale, rot_grid, trans in zip(src_tables, table_scales, rot_grids, transes):
            x, y = plane_sweep_xy(rot_grid, trans, depth_block)  # (B, Db, H*W)
            warped = patch_bilinear_sample(table, x.reshape(B, -1), y.reshape(B, -1),
                                           table.shape[1] // W, W, scale=scale,
                                           compute_dtype=ref_feat.dtype)
            warped = warped.view(B, Db, H, W, C).permute(0, 1, 4, 2, 3)
            residual_sq = (warped - ref) ** 2  # (B, Db, C, H, W)
            if hybrid_omega:
                flat = residual_sq.permute(0, 3, 4, 1, 2).reshape(B, H, W, Db * C)
                weights = omega_folded(model.omega, flat, Db, mesh=mesh).permute(0, 3, 1, 2)
            else:
                weights = model.omega(residual_sq.reshape(B * Db, C, H, W), mesh).view(
                    B, Db, H, W)
            yield (weights[:, :, None] + 1.0) * residual_sq

    return -_view_mean(terms()).transpose(0, 1)


def _build_cost_block_folded(
    model: AARMVSNetCore,
    ref_feat: torch.Tensor,
    src_tables: list[torch.Tensor],
    rot_grids: list[torch.Tensor],
    transes: list[torch.Tensor],
    depth_block: torch.Tensor,
    table_scales: list,
    residual_scale: torch.Tensor | None = None,
    residual_dtype: Any = None,
    mesh=None,
) -> torch.Tensor:
    """Depth-folded variant of :func:`_build_cost_block`: the 2x2 gather
    runs in pixel-major order, so each view's warped volume is already
    ``(B, H, W, Db*C)`` and omega and the variance run folded
    (:func:`_cost_from_warped`, shared with the packed path, so the
    residual levers apply here too)."""
    B, H, W, C = ref_feat.shape

    def warped():
        for table, scale, rot_grid, trans in zip(src_tables, table_scales, rot_grids, transes):
            x, y = plane_sweep_xy(rot_grid, trans, depth_block)  # (B, Db, H*W)
            xt = x.transpose(1, 2).reshape(B, -1)  # pixel-major (B, H*W*Db)
            yt = y.transpose(1, 2).reshape(B, -1)
            yield patch_bilinear_sample(table, xt, yt, table.shape[1] // W, W, scale=scale,
                                        compute_dtype=ref_feat.dtype).view(B, H, W, -1)

    return _cost_from_warped(model, ref_feat, warped(), residual_scale, residual_dtype, mesh)


def _warp_packed(table: torch.Tensor, rot_grid: torch.Tensor, trans: torch.Tensor,
                 depth_block: torch.Tensor, H: int, W: int, taps: int = 4,
                 ref_flat: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None, compute_dtype: torch.dtype | None = None,
                 residual_scale: torch.Tensor | None = None, residual_dtype: Any = None):
    """Packed warp of one source view, ``K = depth_block.shape[1]``
    hypotheses per gathered row: the folded ``(B, H, W, K*C)`` warped
    volume of the ``H x W`` reference pixels (the table holds the whole
    source map, whose height it gives), or, given ``ref_flat`` (``(B, H*W,
    C)`` reference features), the squared residual straight from the blend
    (``fused_residual``), quantized there with ``residual_scale`` to
    ``residual_dtype`` (an ``(fp8, int8)`` pair for ``"dual"``).  ``scale``:
    the dequantization factors of a quantized table."""
    x, y = plane_sweep_xy(rot_grid, trans, depth_block)  # (B, K, H*W)
    quantize = ref_flat is not None and residual_dtype is not None
    out = patch_bilinear_sample_packed(
        table, x.transpose(1, 2), y.transpose(1, 2), table.shape[1] // W, W, taps=taps,
        folded_out=True, ref=ref_flat, scale=scale, compute_dtype=compute_dtype,
        residual_inv_scale=1.0 / residual_scale if quantize else None,
        residual_dtype=residual_dtype if quantize else None,
    )  # (B, H*W, K*C): groups = pixels
    return _map_pair(lambda o: o.view(o.shape[0], H, W, -1), out)


def _map_pair(fn, r):
    """``fn`` on a residual, or on each member of a ``"dual"`` pair."""
    return tuple(fn(o) for o in r) if isinstance(r, tuple) else fn(r)


def _build_cost_block_packed(
    model: AARMVSNetCore,
    ref_feat: torch.Tensor,
    src_tables: list[torch.Tensor],
    rot_grids: list[torch.Tensor],
    transes: list[torch.Tensor],
    depth_block: torch.Tensor,
    table_scales: list,
    table_taps: int = 4,
    fused_residual: bool = False,
    residual_scale: torch.Tensor | None = None,
    residual_dtype: Any = None,
    mesh=None,
) -> torch.Tensor:
    """Packed-row variant: ONE ``table_taps``-wide row per (view, pixel)
    serves the whole block, and the blend emits pixel-major ``(B, H, W,
    Db*C)``, so omega and the variance run folded with no transpose.  Exact
    only where :func:`pick_packed_rows` passes.  ``residual_scale`` and
    ``residual_dtype``: the residual levers, quantized in the blend's
    epilogue when ``fused_residual``, else by :func:`_cost_from_warped`."""
    B, H, W, C = ref_feat.shape
    ref_flat = ref_feat.reshape(B, H * W, C) if fused_residual else None
    warped = (_warp_packed(t, r, tr, depth_block, H, W, table_taps, ref_flat, s,
                           ref_feat.dtype, residual_scale, residual_dtype)
              for t, s, r, tr in zip(src_tables, table_scales, rot_grids, transes))
    if fused_residual:
        return _cost_from_residual(model, warped, C, ref_feat.dtype, residual_scale,
                                   residual_dtype, mesh)
    return _cost_from_warped(model, ref_feat, warped, residual_scale, residual_dtype, mesh)


def _cost_from_warped(model: AARMVSNetCore, ref_feat: torch.Tensor, warped,
                      residual_scale: torch.Tensor | None = None,
                      residual_dtype: Any = None, mesh=None) -> torch.Tensor:
    """Squared residual + omega + view mean on folded warped volumes.

    Args:
      ref_feat: ``(B, H, W, C)``.
      warped: per source view a ``(B, H, W, Db*C)`` warped volume.
      residual_scale, residual_dtype: the residual levers: each view's
        squared residual is quantized once
        (``ops.patch_sample.quantize_residual``, the fused epilogue's ops
        in its order) and both consumers read the quantized tensor.

    Returns:
      ``(Db, B, C, H, W)`` negated variance cost slices.
    """
    C = ref_feat.shape[-1]

    def residuals():
        for w in warped:
            Db = w.shape[-1] // C
            ref_tiled = ref_feat.repeat(1, 1, 1, Db)  # (B, H, W, Db*C)
            r = (w - ref_tiled) ** 2
            if residual_dtype is not None:
                with record_function("quant.residual"):
                    r = quantize_residual(r, 1.0 / residual_scale, residual_dtype, Db)
            yield r

    return _cost_from_residual(model, residuals(), C, ref_feat.dtype, residual_scale,
                               residual_dtype, mesh)


def _cost_from_residual(model: AARMVSNetCore, residuals, C: int,
                        compute_dtype: torch.dtype | None = None,
                        residual_scale: torch.Tensor | None = None,
                        residual_dtype: Any = None, mesh=None) -> torch.Tensor:
    """Omega reweight + view mean on folded (possibly quantized) squared
    residuals (omega on a spatial ``mesh``'s slab where one is given).

    Args:
      residuals: per source view a ``(B, H, W, Db*C)`` squared residual, or
        for ``residual_dtype="dual"`` an ``(fp8, int8)`` pair of them.
      compute_dtype: the sweep's dtype (needed with a residual lever).
      residual_scale: the ``(C,)`` shared residual scale of a quantized
        residual.  Omega gets it folded into its first kernel: on the fp8
        residual cast to ``compute_dtype``, on the int8 one as it lies
        (omega's int8 rw0, then bf16), and on the int8 copy of a dual pair
        as ``scale * 448/127``.  The variance reads the fp8 (or int8)
        residual as ``r.to(compute_dtype) * scale``.

    Returns:
      ``(Db, B, C, H, W)`` negated variance cost slices, a strided view of
      the pixel-major result (each slice is read once, by the regularizer's
      first concatenation).
    """
    if residual_dtype == "dual":
        omega_scale = residual_scale * (F8_MAX / 127.0)
    else:
        omega_scale = residual_scale

    def terms():
        for r in residuals:
            r_var, r_omega = r if residual_dtype == "dual" else (r, r)
            B, H, W, DbC = r_var.shape
            Db = DbC // C
            if residual_dtype is not None and r_omega.dtype != torch.int8:
                with record_function("quant.omega_input"):
                    r_omega = r_omega.to(compute_dtype)
            weights = omega_folded(model.omega, r_omega, Db, omega_scale, mesh)  # (B, H, W, Db)
            r6 = r_var.view(B, H, W, Db, C)
            if residual_dtype is not None:
                with record_function("quant.variance_dequant"):
                    r6 = r6.to(compute_dtype) * residual_scale.to(compute_dtype)
            yield (weights[..., None] + 1.0) * r6

    return -_view_mean(terms()).permute(3, 0, 4, 1, 2)  # from (B, H, W, Db, C)


def pick_packed_rows(proj_matrices, depth_values, height: int, width: int,
                     depth_block: int, margin: float = 0.95, taps: int = 4) -> bool:
    """Host-side gate for ``SweepConfig.packed_rows``: True iff every
    depth block's warp positions span at most ``taps - 2`` px per pixel,
    with a safety ``margin``.  Gate with ``depth_block = gather_pack *
    depth_block`` when super-packing.

    Args:
      proj_matrices: ``(V, 4, 4)`` or ``(B, V, 4, 4)`` (numpy).
      depth_values: ``(D,)`` or ``(B, D)`` sweep depths.
    """
    pm = np.asarray(proj_matrices)
    dv = np.asarray(depth_values)
    if pm.ndim == 3:
        pm = pm[None]
    if dv.ndim == 1:
        dv = dv[None]
    for b in range(pm.shape[0]):
        step = max_depth_step_displacement(pm[b, 1:], pm[b, 0], dv[b], height, width)
        if (depth_block - 1) * step > (taps - 2.0) * margin:
            return False
    return True


def view_shard(mesh, num_views: int) -> range | None:
    """This rank's source views when the sweep is view-parallel, else None.

    The sweep is view-parallel when ``mesh`` has a view axis above 1 that
    divides the ``num_views - 1`` source views; otherwise it runs
    unsharded on every rank, without a word, as the JAX package's does.
    View rank ``v`` takes the ``v``-th run of ``(num_views - 1) / view``
    consecutive source views (1-based view indices)."""
    if mesh is None:
        return None
    k = mesh.shape["view"]
    if k <= 1 or (num_views - 1) % k:
        return None
    per = (num_views - 1) // k
    first = 1 + mesh.coord("view") * per
    return range(first, first + per)


def _sweep_chunk(model: AARMVSNetCore, features: torch.Tensor, proj_matrices: torch.Tensor,
                 depth_values: torch.Tensor, states, config: SweepConfig) -> tuple:
    """The sweep of the hypotheses ``depth_values`` from the ConvLSTM
    carry ``states``: the tables and homography terms, then block by block
    the cost, the regularizer and the online WTA + logsumexp.  :func:`sweep`
    runs it over all D hypotheses from zero states; the depth pipeline
    (``parallel/depth_pipeline.py``) over its stage's chunk from the carry
    it receives.  ``model`` is already in the sweep's dtype.

    Under a view mesh (:func:`view_shard`) the tables and terms are built
    for this rank's source views only, and each block's partial view mean
    is merged over the view group (``parallel.mesh.view_merge``);
    ``features`` may then hold all views or the reference view and this
    rank's source views only.  Under a spatial mesh (:func:`spatial_mesh`)
    ``features`` and ``states`` are this rank's slab of rows, and so are
    the results.  Both at once: each view rank's source views on its slab,
    the tables built from features gathered over the spatial group and the
    partial view mean merged over the view group, per block in the same
    order on every rank (the spatial collectives of the cost block, the
    view merge, then the regularizer's).

    Returns ``(states, depth_img, max_cost, lse, volume)``: the carry
    after the last hypothesis, the chunk's WTA depth, its maximum cost and
    its logsumexp (fp32, ``(B, H, W)``), and the per-block fp32 costs
    when ``config.collect_volume`` (else an empty list).
    """
    B, H, W, C = features.shape[1:]
    V = proj_matrices.shape[1]
    D = depth_values.shape[1]
    block = pick_depth_block(D, config.depth_block)
    dtype = config.feature_dtype
    pack = config.gather_pack if config.packed_rows else 1
    if config.gather_pack > 1 and not config.packed_rows:
        raise ValueError("gather_pack > 1 requires packed_rows")
    if config.fused_residual and not config.packed_rows:
        raise ValueError("fused_residual requires packed_rows")
    shard = view_shard(config.mesh, V)
    rows_mesh = spatial_mesh(config.mesh)
    if pack > 1 and shard is not None:
        raise ValueError("gather_pack > 1 is not supported on a view-sharded mesh")
    if D % (block * pack):
        raise ValueError(
            f"num_depth {D} not divisible by depth_block*gather_pack {block}*{pack}")
    table_dtype, residual_dtype = config.table_dtype, config.residual_dtype
    if table_dtype is not None and table_dtype not in QUANT_DTYPES:
        raise ValueError(f"table_dtype is None, float8_e4m3fn or int8, not {table_dtype}")
    if residual_dtype not in (None, "dual", *QUANT_DTYPES):
        raise ValueError(f"residual_dtype is None, float8_e4m3fn, int8 or 'dual', "
                         f"not {residual_dtype!r}")
    if residual_dtype is not None and not (config.packed_rows or config.fold_omega is True):
        raise ValueError("residual_dtype requires packed_rows or fold_omega=True "
                         "(the folded cost layouts)")
    if shard is not None and residual_dtype is not None:
        raise ValueError(
            "residual_dtype is not supported on a view-sharded mesh (the "
            "shared residual scale would be closed over by shard_map)")
    src_views = range(1, V) if shard is None else shard
    if features.shape[0] == V:
        src_index = list(src_views)
    elif shard is not None and features.shape[0] == 1 + len(shard):
        src_index = list(range(1, 1 + len(shard)))
    else:
        raise ValueError(f"sweep: {features.shape[0]} feature views for {V} cameras")

    with record_function("sweep.setup"):
        features = features.to(dtype)
        ref_feat = features[0]  # (B, H, W, C)
        # A warp may read any row of a source view: on a spatial mesh each
        # rank builds the tables (and their scales) of the whole map.
        sources = [gather_rows(features[i], rows_mesh, dim=1) for i in src_index]
        taps = config.table_taps if config.packed_rows else 2
        if table_dtype is None:
            src_tables = [build_patch_table_packed(f, taps) for f in sources]
            table_scales = [None] * len(src_index)
        else:
            with record_function("quant.tables"):
                quantized = [build_patch_table_packed_quant(f, table_dtype, taps)
                             for f in sources]
            src_tables = [t for t, _ in quantized]
            table_scales = [s for _, s in quantized]
        residual_scale = None
        if residual_dtype is not None:
            # One per-channel scale for every view's residual (so that
            # omega can fold it into its kernel): the squared residual of
            # features within +-a lies in [0, (2a)^2], mapped onto qmax.
            a = torch.stack([features[v].float().abs().amax(dim=(0, 1, 2))
                             for v in range(V)]).amax(dim=0)
            a = all_reduce_max(a, rows_mesh)
            qmax = 127.0 if residual_dtype == torch.int8 else F8_MAX
            residual_scale = torch.clamp_min(true_div((2.0 * a) ** 2, qmax), 1e-12)
        ref_proj = proj_matrices[:, 0]
        row0 = 0 if rows_mesh is None else rows_mesh.coord("spatial") * H
        terms = [homography_terms(proj_matrices[:, v], ref_proj, H, W, row0) for v in src_views]
        rot_grids = [t[0] for t in terms]
        transes = [t[1] for t in terms]

        dev = features.device
        depth_img = torch.zeros(B, H, W, dtype=torch.float32, device=dev)
        max_cost = torch.full((B, H, W), -torch.inf, dtype=torch.float32, device=dev)
        lse = torch.full((B, H, W), -torch.inf, dtype=torch.float32, device=dev)

    levers = dict(residual_scale=residual_scale, residual_dtype=residual_dtype)
    if config.packed_rows:
        build = functools.partial(_build_cost_block_packed, table_taps=config.table_taps,
                                  fused_residual=config.fused_residual, **levers)
    elif config.fold_omega == "hybrid":
        build = functools.partial(_build_cost_block, hybrid_omega=True)
    elif config.fold_omega:
        build = functools.partial(_build_cost_block_folded, **levers)
    else:
        build = _build_cost_block
    build = functools.partial(build, mesh=rows_mesh)

    def cost_blocks(dsuper):
        """The ``pack`` cost blocks of a super block.  With gather_pack > 1
        one packed gather serves them all, and each sub-block takes its
        k-major columns of the folded result."""
        if pack == 1:
            cost = build(model, ref_feat, src_tables, rot_grids, transes, dsuper, table_scales)
            return [cost if shard is None else view_merge(cost, config.mesh)]
        ref_flat = ref_feat.reshape(B, H * W, C) if config.fused_residual else None
        warped = [_warp_packed(t, r, tr, dsuper, H, W, config.table_taps, ref_flat, s,
                               dtype, **levers)
                  for t, s, r, tr in zip(src_tables, table_scales, rot_grids, transes)]
        width = block * C
        blocks = []
        for i in range(pack):
            # Both members of a dual pair keep the same columns.
            cols = [_map_pair(lambda o: o[..., i * width:(i + 1) * width], w) for w in warped]
            blocks.append(_cost_from_residual(model, cols, C, dtype, **levers, mesh=rows_mesh)
                          if config.fused_residual
                          else _cost_from_warped(model, ref_feat, cols, **levers,
                                                 mesh=rows_mesh))
        return blocks

    def block_step(states, dsuper):
        """Cost blocks + one ConvLSTM step per hypothesis of ``dsuper``.
        The model, reference features, tables and homography terms come in
        by closure; under checkpoint their gradients still flow."""
        with record_function("sweep.cost_block"):
            blocks = cost_blocks(dsuper)
        with record_function("sweep.regularize"):
            costs = []
            for cost_block in blocks:
                for cost_slice in cost_block:
                    cost, states = model.cost_regularization(cost_slice, states, rows_mesh)
                    costs.append(cost[:, 0])
        return states, torch.stack(costs).float()  # (pack * block, B, H, W)

    volume = []
    for start in range(0, D, block * pack):
        dsuper = depth_values[:, start : start + block * pack]  # (B, pack * block)
        if config.remat:
            states, costs = checkpoint(block_step, states, dsuper, use_reentrant=False)
        else:
            states, costs = block_step(states, dsuper)

        # Online WTA, one block at a time: argmax keeps the first maximum in
        # the block and the strict > the earlier block on ties, as the
        # reference's running argmax does.  No gradient flows through depth
        # or confidence.  Where no graph is recorded (inference, export) no
        # grad-mode switch is entered: an exported program records each one,
        # and splitting the graph at them doubles the export's time.
        no_grad = torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()
        with record_function("sweep.wta"), no_grad:
            for i in range(pack):
                sub = costs[i * block:(i + 1) * block]
                dblock = dsuper[:, i * block:(i + 1) * block]
                block_best = torch.argmax(sub, dim=0)
                block_max = sub.max(dim=0).values
                block_depth = torch.gather(
                    dblock.T[:, :, None, None].expand_as(sub), 0, block_best[None]
                )[0]
                depth_img = torch.where(block_max > max_cost, block_depth, depth_img)
                max_cost = torch.maximum(max_cost, block_max)
                lse = torch.logaddexp(lse, torch.logsumexp(sub, dim=0))
        if config.collect_volume:
            volume.append(costs)
    return states, depth_img, max_cost, lse, volume


def sweep(
    model: AARMVSNetCore,
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    config: SweepConfig = SweepConfig(),
) -> dict:
    """Plane sweep + recurrent regularization.

    Args:
      features: ``(V, B, H, W, C)`` per-view features (view 0 = reference);
        under a view mesh also ``(1 + S/k, B, H, W, C)``, the reference
        view and this rank's ``S/k`` source views (:func:`view_shard`).
      proj_matrices: ``(B, V, 4, 4)``.
      depth_values: ``(B, D)`` hypothesis depths in sweep order (fp32).

    Returns dict with ``depth`` ``(B, H, W)`` winner-take-all depth,
    ``photometric_confidence`` ``(B, H, W)`` softmax probability of the
    winner, and, if ``config.collect_volume``, ``cost_volume``
    ``(B, D, H, W)`` (its softmax over D is the probability volume), all
    fp32.  Under a view mesh every view rank returns the same result;
    under a spatial mesh ``features`` are this rank's slab of rows of every
    view, and the results are the slab's.
    """
    _, B, H, W, _ = features.shape
    model = _cast(model, config.feature_dtype)
    with record_function("sweep.setup"):
        states = init_states(B, H, W, dtype=config.feature_dtype, device=features.device)
    _, depth_img, max_cost, lse, volume = _sweep_chunk(
        model, features, proj_matrices, depth_values, states, config)
    out = {"depth": depth_img, "photometric_confidence": torch.exp(max_cost - lse)}
    if config.collect_volume:
        out["cost_volume"] = torch.cat(volume).permute(1, 0, 2, 3)
    return out


def forward(
    model: AARMVSNetCore,
    imgs: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    config: SweepConfig = SweepConfig(),
) -> dict:
    """Full forward: features + sweep.  ``imgs``: ``(B, V, H, W, 3)``; under
    a spatial mesh (:func:`spatial_mesh`) this rank's slab of rows of every
    view (``parallel.mesh.spatial_rows`` of the map's height), and the
    results are the slab's; with a view axis too, each view rank of a
    slab regularizes the same merged costs and returns that slab (bit for
    bit on the CPU; on the card to the rounding of its convolutions).

    Differentiable in the model's parameters through ``cost_volume`` in
    fp32 (``depth`` and ``photometric_confidence`` carry no gradient).  On
    CUDA every ConvLSTM cell launches the gate kernel once per hypothesis:
    5 x D forward launches, and under ``remat`` 5 x D more when the
    backward recomputes each block, plus 5 x D backward-kernel launches.
    """
    model = _cast(model, config.feature_dtype)
    rows_mesh = spatial_mesh(config.mesh)
    if rows_mesh is not None:
        spatial_rows(rows_mesh, imgs.shape[2] * rows_mesh.shape["spatial"])  # whole slabs
    shard = view_shard(config.mesh, imgs.shape[1])
    if shard is not None:
        # FeatNet on the reference view and this rank's source views only.
        imgs = imgs[:, [0, *shard]]
    return sweep(model, extract_features(model, imgs, config.feature_dtype,
                                         config.feature_view_chunk, rows_mesh),
                 proj_matrices, depth_values, config)


def probability_volume(cost_volume: torch.Tensor) -> torch.Tensor:
    """Softmax over the depth axis."""
    return torch.softmax(cost_volume, dim=1)
