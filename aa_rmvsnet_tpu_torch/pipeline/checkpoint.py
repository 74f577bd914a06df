"""Checkpoint save and resume with ``torch.save`` (port of
``aa_rmvsnet_tpu/pipeline/checkpoint.py``, which uses orbax).

A checkpoint is the reference trainer's payload (train.py:186-197, 252-257),
``{'step', 'model', 'optimizer', 'scheduler'}``, in
``<logdir>/model_<step:08d>.ckpt``.  Its ``model`` entry carries the
reference torch key names, so ``models/convert.py:load_reference_checkpoint``
loads it strictly and ``cli eval --loadckpt`` takes it as it is.  With an
evidential head, ``model`` also holds the head's tensors (its BatchNorm
running statistics included) under the reference's ``evidential.`` prefix
(reference eval.py:87-98), so the same file feeds ``cli eval --loadckpt F
--evidential_ckpt F``: ``load_reference_checkpoint`` drops those keys and
``load_evidential_checkpoint`` keeps only them.  A save
writes a temporary file and renames it, so a reader never sees half a
checkpoint; resume takes the highest step.  In data-parallel training
(``pipeline/train.py:run_training`` under a mesh) only rank 0 calls
:func:`save_state`, the other ranks wait at a barrier until it has
renamed the file, and every rank restores from the same file.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^model_(\d+)\.ckpt$")
HEAD_PREFIX = "evidential."


def checkpoint_path(logdir: str, step: int) -> str:
    return os.path.join(logdir, f"model_{step:08d}.ckpt")


def save_state(logdir: str, step: int, model, optimizer, scheduler, head=None) -> str:
    """Write the checkpoint of ``step`` atomically; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = checkpoint_path(logdir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    state = model.state_dict()
    if head is not None:
        state.update({HEAD_PREFIX + k: v for k, v in head.state_dict().items()})
    torch.save({
        "step": step,
        "model": state,
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


def restore_latest(logdir: str, model, optimizer, scheduler, head=None) -> int | None:
    """Load the highest saved step into ``model``, ``head`` (if given),
    ``optimizer`` and ``scheduler`` (in place, strictly: a head's tensors
    without a head to take them, or the reverse, raise); returns that step,
    or None if there is none."""
    step = latest_step(logdir)
    if step is None:
        return None
    payload = torch.load(checkpoint_path(logdir, step), map_location="cpu",
                         weights_only=True)
    state = payload["model"]
    if head is not None:
        head.load_state_dict({k.removeprefix(HEAD_PREFIX): v for k, v in state.items()
                              if k.startswith(HEAD_PREFIX)}, strict=True)
        state = {k: v for k, v in state.items() if not k.startswith(HEAD_PREFIX)}
    model.load_state_dict(state, strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"])
