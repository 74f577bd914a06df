"""Process groups and the mesh of the data-parallel trainer (port of
``aa_rmvsnet_tpu/parallel/mesh.py``).

The JAX package lays one program over a ``(data, view, spatial, depth)``
mesh of devices, and GSPMD inserts its collectives.  The port runs one
process per card on ``torch.distributed``: the ``data`` axis is the
process group's ranks, rank ``k`` on ``cuda:{k % device_count}`` (or on
the CPU), and the trainer issues the collectives itself
(``pipeline/train.py``): rank 0's weights are broadcast before the first
step, the gradients averaged before the global-norm clip, and the
evidential loss's valid count and the head's BatchNorm statistics summed
over the global batch.  Each process holds ``batch_size`` consecutive rows
of the global batch, as ``form_global_batch`` lays them out in the JAX
package, so the step equals one step on the concatenated global batch.
The view, spatial and depth axes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None) -> None:
    """Join the process group of a multi-process run; a no-op for one
    process (the JAX package's ``jax.distributed.initialize`` wrapper).

    Args:
      coordinator: ``host:port`` where process 0 listens (``tcp://``).
      num_processes: the world size.
      process_id: this process's rank.
      backend: ``"nccl"`` or ``"gloo"``; by default NCCL where CUDA is
        available, else gloo.  With NCCL the process first takes its card,
        ``cuda:{process_id % device_count}``.
    """
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator or ":" not in coordinator:
        raise ValueError(f"initialize_distributed: coordinator must be host:port, "
                         f"not {coordinator!r}")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"initialize_distributed: process_id {process_id} is not in "
                         f"[0, {num_processes})")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's mesh: this process's rank on the data axis, the world
    size, the process group (None outside a process group: one process,
    no collectives) and this rank's device."""

    rank: int
    world_size: int
    group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.world_size, "view": 1, "spatial": 1, "depth": 1}

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(data: int | None = None, view: int = 1, spatial: int = 1, depth: int = 1,
              device: str = "cuda") -> Mesh:
    """The data-parallel mesh over the process group's ranks (over this
    process alone outside one).

    Args:
      data: the data axis, the world size by default (anything else raises).
      view, spatial, depth: the JAX package's other axes; above 1 they
        raise ``NotImplementedError`` (not ported yet).
      device: ``"cuda"`` (rank ``k`` takes ``cuda:{k % device_count}``;
        raises without a card) or ``"cpu"``.
    """
    for name, size in (("view", view), ("spatial", spatial), ("depth", depth)):
        if size != 1:
            raise NotImplementedError(f"make_mesh: a {name} axis of {size}: not ported yet to "
                                      "aa_rmvsnet_tpu_torch (only the data axis is)")
    if dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if data is not None and data != world:
        raise ValueError(f"make_mesh: a data axis of {data} over {world} process(es)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(rank, world, group, dev)


def local_mesh(device: str = "cuda") -> Mesh:
    """Each process alone (``cli train --single_device``): this process's
    rank and the world size pick its data shard and make rank 0 the one
    that writes, and no process group is given, so no collective runs and
    each process steps on its own batch."""
    mesh = make_mesh(device=device)
    return dataclasses.replace(mesh, group=None)


def all_reduce_mean(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the mesh's ranks in place: one all-reduce
    of their concatenation (fp32 tensors of any shapes)."""
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks whose backward sums the cotangents over
    the ranks too: each rank's output feeds every rank's loss."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``'s ranks, differentiable (what
    ``torch.distributed.nn.functional.all_reduce`` computes, which newer
    torch deprecates)."""
    return _AllReduceSum.apply(tensor, group)
