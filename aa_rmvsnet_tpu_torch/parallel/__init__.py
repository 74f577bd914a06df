"""Multi-process training on ``torch.distributed`` (port of
``aa_rmvsnet_tpu/parallel``): the data axis of the JAX package's mesh."""

from .mesh import (
    Mesh,
    all_reduce_mean,
    all_reduce_sum,
    initialize_distributed,
    local_mesh,
    make_mesh,
)

__all__ = [
    "Mesh",
    "all_reduce_mean",
    "all_reduce_sum",
    "initialize_distributed",
    "local_mesh",
    "make_mesh",
]
