"""Checkpoint save and resume with ``torch.save`` (port of
``aa_rmvsnet_tpu/pipeline/checkpoint.py``, which uses orbax).

A checkpoint is the reference trainer's payload (train.py:186-197, 252-257),
``{'step', 'model', 'optimizer', 'scheduler'}``, in
``<logdir>/model_<step:08d>.ckpt``.  Its ``model`` entry carries the
reference torch key names, so ``models/convert.py:load_reference_checkpoint``
loads it strictly and ``cli eval --loadckpt`` takes it as it is.  A save
writes a temporary file and renames it, so a reader never sees half a
checkpoint; resume takes the highest step.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^model_(\d+)\.ckpt$")


def checkpoint_path(logdir: str, step: int) -> str:
    return os.path.join(logdir, f"model_{step:08d}.ckpt")


def save_state(logdir: str, step: int, model, optimizer, scheduler) -> str:
    """Write the checkpoint of ``step`` atomically; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = checkpoint_path(logdir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({
        "step": step,
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
    }, tmp)
    os.replace(tmp, path)
    return path


def latest_step(logdir: str) -> int | None:
    """The highest saved step in ``logdir``, or None."""
    if not os.path.isdir(logdir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(logdir)) if m]
    return max(steps, default=None)


def restore_latest(logdir: str, model, optimizer, scheduler) -> int | None:
    """Load the highest saved step into ``model``, ``optimizer`` and
    ``scheduler`` (in place); returns that step, or None if there is none."""
    step = latest_step(logdir)
    if step is None:
        return None
    payload = torch.load(checkpoint_path(logdir, step), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"])
