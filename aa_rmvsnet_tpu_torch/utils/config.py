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
it.  ``depth_block="auto"`` (an HBM estimate for the TPU) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass


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


def eval_preset(name: str, **overrides) -> EvalRunConfig:
    if name not in EVAL_PRESETS:
        raise KeyError(f"unknown eval preset {name!r}; have {sorted(EVAL_PRESETS)}")
    merged = {**EVAL_PRESETS[name], **overrides}
    if merged.get("depth_block") == "auto":
        raise NotImplementedError("depth_block='auto' is not ported yet")
    return EvalRunConfig(**merged)


def train_preset(name: str = "dtu_train", **overrides) -> TrainRunConfig:
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown train preset {name!r}; have {sorted(TRAIN_PRESETS)}")
    return TrainRunConfig(**{**TRAIN_PRESETS[name], **overrides})
