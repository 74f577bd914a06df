"""The drivers of the cells (``"driver"`` in a workload file): ``eval``
(``run_inference``, one map a step) and ``train`` (``train_step``)."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
          "float8_e4m3fn": torch.float8_e4m3fn}


def options(values: dict) -> dict:
    """``InferConfig`` or ``TrainConfig`` keyword arguments from a workload
    file's JSON object (dtypes by name)."""
    return {k: DTYPES.get(v, v) if isinstance(v, str) else v for k, v in values.items()}
