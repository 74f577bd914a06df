"""Run configurations and named presets (port of ``EvalRunConfig`` /
``EVAL_PRESETS`` / ``eval_preset`` and ``TrainRunConfig`` /
``train_preset`` in ``aa_rmvsnet_tpu/utils/config.py``).

- ``dtu_eval_smoke``: 3 views, 192 hypotheses, 400x296, fp32;
- ``dtu_eval``: DTU evaluation, 5 views, 512 hypotheses, up to 1152x864;
- ``tnt_intermediate*``: Tanks and Temples, 7 views, inverse depth, padded;
- ``dtu_train``: DTU training, 5 views, 128 hypotheses, interval_scale
  1.06, image_scale 0.25 (the 512x640 training images at 128x160;
  reference scripts/train_dtu.sh);
- ``dtu_train_highres``: the same at image_scale 1.0 with 256 hypotheses.

``EvalRunConfig.use_bfloat16`` is carried as in the JAX package, where
``cli eval`` takes the precision from ``--fp32`` alone and never reads
it.  ``depth_block="auto"`` takes the largest block whose
:func:`sweep_memory_bytes` estimate fits :func:`memory_budget`: the
port's own estimate of its live tensors on the card, not the JAX
package's TPU one (a v5e's 12 GB, 128-lane padding, fp8 tables).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EvalRunConfig:
    nviews: int = 5
    ndepths: int = 512
    interval_scale: float = 0.4
    inverse_depth: bool = False
    pad_vertical: bool = False
    max_h: int = 864
    max_w: int = 1152
    depth_block: int = 8
    use_bfloat16: bool = True


EVAL_PRESETS: dict[str, dict] = {
    "dtu_eval_smoke": dict(nviews=3, ndepths=192, interval_scale=1.06,
                           max_h=296, max_w=400, use_bfloat16=False),
    "dtu_eval": dict(nviews=5, ndepths=512, interval_scale=0.4,
                     max_h=864, max_w=1152),
    "dtu_eval_600x800": dict(nviews=7, ndepths=512, interval_scale=0.4,
                             max_h=600, max_w=800),
    "tnt_intermediate": dict(nviews=7, ndepths=512, inverse_depth=True,
                             pad_vertical=True, max_h=544, max_w=1024),
    "tnt_intermediate_960": dict(nviews=7, ndepths=512, inverse_depth=True,
                                 pad_vertical=True, max_h=544, max_w=960),
    "tnt_intermediate_1920": dict(nviews=7, ndepths=512, inverse_depth=True,
                                  pad_vertical=True, max_h=1056, max_w=1920,
                                  depth_block=4),
}


@dataclass
class TrainRunConfig:
    datapath: str = ""
    train_list: str = ""
    val_list: str = ""
    logdir: str = "checkpoints_torch"
    nviews: int = 5
    ndepths: int = 128
    interval_scale: float = 1.06
    image_scale: float = 0.25
    batch_size: int = 1
    epochs: int = 10
    learning_rate: float = 1e-3
    lr_min: float = 2e-6
    depth_block: int = 16
    seed: int = 0
    loadckpt: str | None = None
    resume: bool = False
    summary_freq: int = 20


TRAIN_PRESETS: dict[str, dict] = {
    "dtu_train": dict(),
    "dtu_train_highres": dict(image_scale=1.0, ndepths=256),
}


#: A card's memory the estimate may not fill: cuDNN's workspaces, the
#: caching allocator's rounding and fragmentation, and the CUDA context
#: are not in :func:`sweep_memory_bytes`.
MEMORY_HEADROOM = 0.10
#: The card size assumed off the card (an 80 GB H100), so that the CPU's
#: picks are deterministic.
CPU_CARD_BYTES = 80e9


def memory_budget(device=None) -> float:
    """Bytes :func:`derive_depth_block` may plan for: the card's total
    memory (``torch.cuda.get_device_properties``) less
    :data:`MEMORY_HEADROOM` of it, or the same share of
    :data:`CPU_CARD_BYTES` for a CPU device.  ``device=None`` is the
    current card where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    total = (torch.cuda.get_device_properties(device).total_memory
             if device.type == "cuda" else CPU_CARD_BYTES)
    return total * (1.0 - MEMORY_HEADROOM)


# Bytes per pixel of the port's live tensors, by tensor and path.  The
# fitted terms (the gather's bookkeeping, the per-hypothesis transients of
# the cost block) were counted on the CPU, every tensor storage the port
# allocates at 64x96, V = 3, 5, 7, and tests/test_torch_feat_chunk.py
# holds the whole estimate to that count.
_FEATNET_PER_VIEW = {2: 1313, 4: 2414}  # one view's FeatNet at its peak
_PACKED_BOOKKEEPING = {2: 184, 4: 316}  # anchors, row indices, states
# One super block, one view at a time (gather_pack 1): per hypothesis of
# the gathered row and of omega's block.
_PACKED_PER_GATHERED = {2: 426, 4: 672}
_PACKED_PER_BLOCK = {2: 132, 4: 208}
# gather_pack > 1 gathers every view's residual first: per gathered
# hypothesis of one view, besides the residuals of all of them.
_SUPER_PER_GATHERED = {2: 236, 4: 372}
_UNPACKED_BASE = {2: 160, 4: 292}
_UNPACKED_PER_HYPOTHESIS = {2: 958, 4: 1728}
# The levers' own tensors per gathered hypothesis (of a 4x4 window) and
# per block hypothesis; the residual's stored bytes per value.
_RESIDUAL_GATHERED = {None: 0, torch.float8_e4m3fn: 32, torch.int8: 224, "dual": 192}
_RESIDUAL_BLOCK = {None: 0, torch.float8_e4m3fn: 64, torch.int8: 0, "dual": 64}
_RESIDUAL_BYTES = {torch.float8_e4m3fn: 1, torch.int8: 1, "dual": 2}


def _table_delta(table_dtype, taps: int, gather_pack: int) -> int:
    """A quantized table's own tensors per gathered hypothesis: the int8
    blend's integer weights grow with the window, the fp8 rows'
    dequantization runs before the blend."""
    if table_dtype == torch.int8:
        return 6 * taps * taps - 128 if gather_pack == 1 else 4 * taps * taps - 54
    if table_dtype is not None:
        return -192 if gather_pack == 1 else -64
    return 0


def featnet_memory_bytes(height: int, width: int, nviews: int, bf16: bool = True,
                         view_chunk: int = 0) -> float:
    """Peak bytes of ``extract_features`` on the card: each chunk of
    ``view_chunk`` views (0: all at once) at its peak, with its bf16 copy
    of the images, beside the features of the chunks before it; or the
    features and their concatenated copy at the end."""
    b = 2 if bf16 else 4
    k = view_chunk if 0 < view_chunk < nviews else nviews
    per_px = max(
        max((_FEATNET_PER_VIEW[b] + (6 if bf16 else 0)) * min(k, nviews - done)
            + 32 * b * done for done in range(0, nviews, k)),
        2 * nviews * 32 * b,
    )
    return float(height * width * per_px)


def sweep_memory_bytes(
    height: int,
    width: int,
    nviews: int,
    depth_block: int,
    ndepths: int = 512,
    packed: bool = True,
    bf16: bool = True,
    table_dtype=None,
    residual_dtype=None,
    table_taps: int = 4,
    gather_pack: int = 1,
    fused_residual: bool = True,
    collect_volume: bool = False,
    feature_view_chunk: int = 0,
) -> float:
    """Peak device bytes of one map's inference, from the port's live
    tensors (``models/network.py:extract_features`` and ``sweep``), batch
    1, no lane padding.

    The images (fp32) stay live throughout.  Then the larger of FeatNet's
    peak (:func:`featnet_memory_bytes`) and the sweep's: the features, a
    patch table per source view (``taps^2`` texels, or 2x2 unpacked, in
    the table dtype) with its homography grid, and one source view's
    cost block at a time: its gathered rows (and their bf16 copy for an
    fp8 or int8 table) and the per-hypothesis transients of the blend,
    the squared residual (spanning ``gather_pack`` blocks on the gathered
    side), omega and the view sum, with each lever's own tensors;
    ``collect_volume`` adds the fp32 ``(D, H, W)`` volume and its
    concatenation.  ``table_dtype`` and ``residual_dtype`` take the
    values of ``SweepConfig``'s fields.
    """
    b = 2 if bf16 else 4
    px = height * width
    S = nviews - 1
    C = 32
    if packed:
        taps, tb = table_taps, (b if table_dtype is None else 1)
        rows = taps * taps * C * tb
        if table_dtype == torch.int8:
            rows += taps * taps * C * b  # the int8 blend's bf16 rows
        elif table_dtype is not None:
            rows += 2 * taps * taps * C * b  # the dequantized rows and their scaling
        levers = ((96 if taps == 6 else 0) + (0 if fused_residual else 32)
                  + _table_delta(table_dtype, taps, gather_pack)
                  + _RESIDUAL_GATHERED[residual_dtype])
        if gather_pack == 1:
            per_hypothesis = (_PACKED_PER_GATHERED[b] + levers + _PACKED_PER_BLOCK[b]
                              + _RESIDUAL_BLOCK[residual_dtype])
        else:  # every view's residual of the super block is held at once
            stored = b if residual_dtype is None else _RESIDUAL_BYTES[residual_dtype]
            per_hypothesis = gather_pack * (_SUPER_PER_GATHERED[b] + levers + S * C * stored)
        block = rows + _PACKED_BOOKKEEPING[b] + per_hypothesis * depth_block
    else:
        taps, tb = 2, (b if table_dtype is None else 1)
        block = _UNPACKED_BASE[b] + _UNPACKED_PER_HYPOTHESIS[b] * depth_block
    tables = S * (taps * taps * C * tb + 12)  # + the (3, H*W) fp32 grid
    carries = 12  # depth, max cost, logsumexp
    volume = 8 * ndepths if collect_volume else 0
    sweep = nviews * C * b + tables + carries + block + volume
    featnet = featnet_memory_bytes(height, width, nviews, bf16, feature_view_chunk) / px
    return float(px * (nviews * 3 * 4 + max(featnet, sweep)))


def derive_depth_block(
    height: int,
    width: int,
    nviews: int,
    ndepths: int = 512,
    budget: float | None = None,
    candidates: tuple = (8, 4, 2, 1),
    **kwargs,
) -> int:
    """Largest candidate block dividing ``ndepths`` whose
    :func:`sweep_memory_bytes` estimate (``kwargs`` name the path) fits
    ``budget`` (default :func:`memory_budget` of the current card); 1 if
    none does.  The JAX package's candidates: a block past 8 was a dead
    end of the TPU's compiler, and the port keeps the same range."""
    if budget is None:
        budget = memory_budget()
    for db in candidates:
        if ndepths % db:
            continue
        if sweep_memory_bytes(height, width, nviews, db, ndepths, **kwargs) <= budget:
            return db
    return 1


def eval_preset(name: str, **overrides) -> EvalRunConfig:
    """The named preset with ``overrides``; ``depth_block="auto"`` is
    resolved by :func:`derive_depth_block` for ``cli eval``'s default path
    (bf16, packed rows, fused residual) on the current card."""
    if name not in EVAL_PRESETS:
        raise KeyError(f"unknown eval preset {name!r}; have {sorted(EVAL_PRESETS)}")
    merged = {**EVAL_PRESETS[name], **overrides}
    if merged.get("depth_block") == "auto":
        merged["depth_block"] = derive_depth_block(
            merged.get("max_h", 864), merged.get("max_w", 1152),
            merged.get("nviews", 5), merged.get("ndepths", 512),
        )
    return EvalRunConfig(**merged)


def train_preset(name: str = "dtu_train", **overrides) -> TrainRunConfig:
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown train preset {name!r}; have {sorted(TRAIN_PRESETS)}")
    return TrainRunConfig(**{**TRAIN_PRESETS[name], **overrides})
