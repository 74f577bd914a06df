"""Multi-process runs on ``torch.distributed`` (port of
``aa_rmvsnet_tpu/parallel``): the data, view, spatial and depth axes of
the JAX package's mesh, and the depth-block pipeline."""

from .mesh import (
    Mesh,
    all_reduce_mean,
    all_reduce_sum,
    all_reduce_sum_,
    initialize_distributed,
    local_mesh,
    make_mesh,
    recv_carry,
    send_carry,
    shard_dataset,
    spatial_rows,
    view_merge,
    views_as_replicas,
)
from .depth_pipeline import pipeline_forward, sweep_depth_pipelined

__all__ = [
    "Mesh",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_reduce_sum_",
    "initialize_distributed",
    "local_mesh",
    "make_mesh",
    "pipeline_forward",
    "recv_carry",
    "send_carry",
    "shard_dataset",
    "spatial_rows",
    "sweep_depth_pipelined",
    "view_merge",
    "views_as_replicas",
]
