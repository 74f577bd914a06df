"""The AA-RMVSNet core network, its blocks, the depth sweep, the training
loss and the weight bridge (port of ``aa_rmvsnet_tpu/models``, exact fp32
path)."""

from .network import (
    AARMVSNetCore,
    SweepConfig,
    extract_features,
    forward,
    pick_depth_block,
    probability_volume,
    sweep,
)
from .convert import load_reference_checkpoint, params_from_jax

__all__ = [
    "AARMVSNetCore",
    "SweepConfig",
    "extract_features",
    "forward",
    "load_reference_checkpoint",
    "params_from_jax",
    "pick_depth_block",
    "probability_volume",
    "sweep",
]
