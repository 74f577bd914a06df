"""Process groups and the mesh over ranks (port of
``aa_rmvsnet_tpu/parallel/mesh.py``).

The JAX package lays one program over a ``(data, view, spatial, depth)``
mesh of devices, and GSPMD inserts its collectives.  The port runs one
process per rank on ``torch.distributed``, rank ``k`` on ``cuda:{k %
device_count}`` (or on the CPU), lays the ranks out as the JAX package lays
out its devices (``reshape(data, view, spatial, depth)``, depth fastest),
gives every axis above 1 a process group, and calls the collectives
itself:

- ``data``: data-parallel training (``pipeline/train.py``: rank 0's
  weights broadcast before the first step, the gradients averaged over the
  data group before the global-norm clip, the evidential loss's valid count
  and the head's BatchNorm statistics summed over the global batch; each
  data rank holds ``batch_size`` consecutive rows of the global batch, as
  ``form_global_batch`` lays them out) and the eval fan-out
  (``pipeline/infer.py``: each data rank takes every ``data``-th sample);
- ``view``: the sweep's source views split over the view ranks
  (``models/network.py:sweep``), the view mean merged once per depth block
  by :func:`view_merge`;
- ``spatial``: the rows of every map split over the spatial ranks
  (``parallel/spatial.py``): spatial rank ``s`` of ``S`` holds the rows
  :func:`spatial_rows` gives it, and the halo exchanges, row gathers and
  GroupNorm statistics that GSPMD inserts in the JAX package are written
  out by hand over the spatial group;
- ``depth``: the depth-block pipeline (``parallel/depth_pipeline.py``),
  whose stages hand the ConvLSTM carry on with :func:`send_carry` and
  :func:`recv_carry`.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Any

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

AXES = ("data", "view", "spatial", "depth")


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
    """The port's mesh: this process's rank, the world size, the world's
    process group (None outside a process group: one process, no
    collectives), this rank's device, the axis sizes ``(data, view,
    spatial, depth)`` and one process group per axis: the world's where the
    axis spans the world, None where it holds one rank of a larger world
    (or there is no process group)."""

    rank: int
    world_size: int
    group: Any
    device: torch.device
    sizes: tuple[int, int, int, int]
    data_group: Any = None
    view_group: Any = None
    spatial_group: Any = None
    depth_group: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.sizes))

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (depth varies fastest)."""
        i = AXES.index(axis)
        inner = 1
        for size in self.sizes[i + 1:]:
            inner *= size
        return (self.rank // inner) % self.sizes[i]

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _rank_of(coords, sizes) -> int:
    rank = 0
    for c, size in zip(coords, sizes):
        rank = rank * size + c
    return rank


def _axis_groups(rank: int, sizes: tuple) -> dict:
    """One group per axis and setting of the other coordinates; this rank
    keeps the one it is in.  An axis that spans the whole world is the
    world's group, even at one rank (a world of one still runs its
    collectives through the backend); any other axis of one rank has no
    group.  ``dist.new_group`` is collective over the world, so every rank
    creates every group in the same order, including the groups it is not
    in."""
    world = 1
    for size in sizes:
        world *= size
    groups = {}
    for axis in AXES:
        i = AXES.index(axis)
        if sizes[i] == world:
            groups[axis] = dist.group.WORLD
            continue
        if sizes[i] == 1:
            groups[axis] = None
            continue
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):
            ranks = [_rank_of(rest[:i] + (c,) + rest[i:], sizes) for c in range(sizes[i])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return groups


def make_mesh(data: int | None = None, view: int = 1, spatial: int = 1, depth: int = 1,
              device: str = "cuda") -> Mesh:
    """The ``(data, view, spatial, depth)`` mesh over the process group's
    ranks (over this process alone outside one), laid out as the JAX
    package lays out its devices: ``rank = ((d * view + v) * spatial + s)
    * depth + p``.

    Args:
      data: the data axis; ``world // (view * spatial * depth)`` by default.
        Sizes whose product is not the world size raise the JAX package's
        ``ValueError``.
      view, spatial, depth: the view, spatial and depth axes.
      device: ``"cuda"`` (rank ``k`` takes ``cuda:{k % device_count}``;
        raises without a card) or ``"cpu"``.
    """
    if view > 1 and spatial > 1:
        warnings.warn(
            "view > 1 combined with spatial > 1: fine for inference, but "
            "GRADIENTS under this mesh are double-counted by the view-axis "
            "size (upstream XLA SPMD partitioner bug — minimal repro in "
            "tests/test_train.py:TestViewAxisSharding).  For training use "
            "(data, view) or (data, spatial).",
            UserWarning,
            stacklevel=2,
        )
    if dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    inner = view * spatial * depth
    if data is None:
        if world % inner:
            raise ValueError(f"{world} devices not divisible by view*spatial*depth={inner}")
        data = world // inner
    if data * inner != world:
        raise ValueError(f"mesh {data}x{view}x{spatial}x{depth} != {world} devices")
    sizes = (data, view, spatial, depth)
    groups = _axis_groups(rank, sizes) if group is not None else {}
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(rank, world, group, dev, sizes, data_group=groups.get("data"),
                view_group=groups.get("view"), spatial_group=groups.get("spatial"),
                depth_group=groups.get("depth"))


def views_as_replicas(mesh: Mesh | None) -> Mesh | None:
    """``mesh`` with its view axis folded into the data axis, as inference
    sees it (the JAX package replicates over its view axis there): sizes
    ``(data * view, 1, spatial, depth)``, the same layout of ranks, so
    every rank keeps its spatial and depth coordinates and groups.  The
    folded data axis has no process group (``data_group`` None): the
    result is for the sweep, not for the data axis's collectives."""
    if mesh is None or mesh.shape["view"] == 1:
        return mesh
    data, view, spatial, depth = mesh.sizes
    return dataclasses.replace(mesh, sizes=(data * view, 1, spatial, depth), data_group=None,
                               view_group=None)


def local_mesh(device: str = "cuda") -> Mesh:
    """Each process alone (``cli train --single_device``): this process's
    rank and the world size pick its data shard and make rank 0 the one
    that writes, and no process group is given, so no collective runs and
    each process steps on its own batch."""
    mesh = make_mesh(device=device)
    return dataclasses.replace(mesh, group=None, data_group=None, view_group=None,
                               spatial_group=None, depth_group=None)


#: The rows of a spatial slab come in multiples of this: the pyramid's two
#: stride-2 levels and the U-Net's two max-pools halve them twice.
SLAB_ROWS = 4


def spatial_rows(mesh: Mesh | None, height: int) -> tuple[int, int]:
    """``(row0, rows)``: the rows ``[row0, row0 + rows)`` of a map of
    ``height`` rows that this rank holds on the mesh's spatial axis
    (``(0, height)`` without one).  Raises ``ValueError`` where the axis
    does not split ``height`` into equal slabs of a multiple of
    :data:`SLAB_ROWS` rows."""
    size = 1 if mesh is None else mesh.shape["spatial"]
    if size == 1:
        return 0, height
    if height % (size * SLAB_ROWS):
        raise ValueError(f"a height of {height} rows does not split over a spatial axis of "
                         f"{size} into slabs of a multiple of {SLAB_ROWS} rows")
    rows = height // size
    return mesh.coord("spatial") * rows, rows


class _Shard:
    """Every ``num``-th sample of a dataset from ``index`` (a dataset
    without a ``shard`` method of its own)."""

    def __init__(self, dataset, index: int, num: int):
        self.dataset, self.indices = dataset, range(index, len(dataset), num)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def shard_dataset(dataset, index: int, num: int):
    """Rank ``index``'s shard of ``dataset`` among ``num`` ranks:
    ``dataset.shard(index, num)`` where it has one (``DTUTrainDataset``: its
    metas ``[index::num]``), else the same samples by index."""
    if num == 1:
        return dataset
    if hasattr(dataset, "shard"):
        return dataset.shard(index, num)
    return _Shard(dataset, index, num)


def all_reduce_mean(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` over ``group``'s ranks in place (nothing without
    a group): one all-reduce of their concatenation (fp32 tensors of any
    shapes)."""
    _all_reduce_flat(tensors, group, mean=True)


def all_reduce_sum_(tensors: list[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group``'s ranks in place (nothing without a
    group), in one all-reduce; not differentiable."""
    _all_reduce_flat(tensors, group, mean=False)


def _all_reduce_flat(tensors: list[torch.Tensor], group, mean: bool) -> None:
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat.div_(dist.get_world_size(group))
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


class _ViewMerge(torch.autograd.Function):
    """The mean over the view group of each rank's partial view mean."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        # All-reduce the storage in its own order (the cost block is a
        # permuted view of a pixel-major tensor), summed in fp32.
        order = sorted(range(x.dim()), key=lambda i: -x.stride(i))
        total = x.permute(order).to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=group)
        inverse = sorted(range(x.dim()), key=order.__getitem__)
        return total.div_(size).to(x.dtype).permute(inverse)

    @staticmethod
    def backward(ctx, grad):
        # Every view rank computes the same loss from the merged value, so
        # its cotangent is already the whole one: the sum passes it through
        # and only the division applies.
        return grad / ctx.size, None, None


def view_merge(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's view group divided by its size (the
    JAX package's ``psum(local, "view") / k`` inside ``shard_map``),
    differentiable: the backward divides the cotangent by the view size and
    does not sum it, the opposite of :func:`all_reduce_sum`'s, because every
    view rank's loss reads the same merged value.  The sum runs in fp32 and
    rounds once to ``x``'s dtype."""
    return _ViewMerge.apply(x, mesh.view_group, mesh.shape["view"])


def _flat_carry(states) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for pair in states for t in pair])


def send_carry(states, dst: int, group) -> tuple[Any, torch.Tensor]:
    """Start sending the ConvLSTM carry ``states`` (5 ``(h, c)`` pairs) to
    global rank ``dst``, as one flat message of its bytes.

    gloo's point-to-point calls take host tensors only, so under gloo a
    carry on the card is first copied, explicitly, to pinned host memory;
    under NCCL the card's tensor is sent as it is.  The compute stays on
    the card either way.  Returns ``(work, buffer)``: the send's handle and
    the buffer it reads (keep it until ``work.wait()``)."""
    flat = _flat_carry(states).view(torch.uint8)
    if flat.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        flat = host
    return dist.isend(flat, dst=dst, group=group), flat


def recv_carry(like, src: int, group) -> tuple:
    """Receive from global rank ``src`` a carry shaped, typed and placed as
    ``like`` (5 ``(h, c)`` pairs), sent by :func:`send_carry`.  Under gloo
    the bytes arrive in pinned host memory and are copied to the card."""
    ref = like[0][0]
    nbytes = sum(t.numel() for pair in like for t in pair) * ref.element_size()
    via_host = ref.is_cuda and dist.get_backend(group) == "gloo"
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=via_host,
                      device="cpu" if via_host else ref.device)
    dist.recv(buf, src=src, group=group)
    flat = buf.to(ref.device).view(ref.dtype)
    states, offset = [], 0
    for h, c in like:
        pair = []
        for t in (h, c):
            pair.append(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        states.append(tuple(pair))
    return tuple(states)
