"""The AA-RMVSNet core network, its blocks, the depth sweep, the training
loss, the evidential head, the JAX package's init and the weight bridge
(port of ``aa_rmvsnet_tpu/models``)."""

from .network import (
    AARMVSNetCore,
    SweepConfig,
    extract_features,
    forward,
    pick_depth_block,
    pick_packed_rows,
    probability_volume,
    sweep,
)
from .convert import (
    evidential_params_from_jax,
    load_evidential_checkpoint,
    load_reference_checkpoint,
    params_from_jax,
    params_to_jax,
    read_orbax,
)
from .evidential import EvidentialHead, evidential_apply
from .init import init_like_jax

__all__ = [
    "AARMVSNetCore",
    "EvidentialHead",
    "SweepConfig",
    "evidential_apply",
    "evidential_params_from_jax",
    "extract_features",
    "forward",
    "init_like_jax",
    "load_evidential_checkpoint",
    "load_reference_checkpoint",
    "params_from_jax",
    "params_to_jax",
    "pick_depth_block",
    "pick_packed_rows",
    "probability_volume",
    "read_orbax",
    "sweep",
]
