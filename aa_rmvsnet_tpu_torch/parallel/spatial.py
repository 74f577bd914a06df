"""The spatial mesh axis: every map's rows split over the spatial ranks, with
the collectives that GSPMD inserts in the JAX package
(``aa_rmvsnet_tpu/parallel/mesh.py:12-15``) written out by hand.

Spatial rank ``s`` of ``S`` holds rows ``[s H/S, (s + 1) H/S)`` of every
map (``parallel.mesh.spatial_rows``), and at scales 1/2 and 1/4 the same
rows halved: its *slab*.  The ops below take and give slabs of NCHW
tensors (rows on dim -2), and each is differentiable, so that ``cli train
--spatial`` backpropagates through them:

- :func:`halo_rows`: the slab with its neighbours' boundary rows above and
  below (zeros past the map's top and bottom edges, the convolutions' zero
  padding); the backward sends each halo's cotangent back to the rank that
  owns those rows;
- :func:`gather_rows`: the whole map from every rank's slab; the backward
  sums each rank's cotangent of the rows over the ranks;
  :func:`gather_rows_to_first` the same on spatial rank 0 only, with no
  gradient (inference's outputs);
- :func:`group_norm_rows`: GroupNorm whose statistics cover every rank's
  rows, and the ReLU after it;
- :func:`conv2d_rows`, :func:`conv_transpose_rows`, and for NCDHW (rows on
  H, dim -2) :func:`conv3d_rows`, :func:`conv_transpose3d_rows`: a
  convolution of a slab with the halo its kernel reads, so that each
  output row is the unsharded convolution's;
- :func:`resize_rows`: the align-corners linear resize of the map's rows,
  each output row weighted from the map's rows at their global indices;
- :func:`all_reduce_max`: a non-differentiable maximum (the residual
  lever's quantization scale).

Every op but :func:`halo_rows` also takes ``mesh=None``, the unsplit map,
and is then the plain call (``gn(x)``, ``conv(x)``, ``x`` itself), so that
each model block has one ``forward(..., mesh=None)`` for both.

Every exchange is one all-gather of each rank's bytes over the spatial
group (:func:`_all_gather`): under gloo a tensor on the card is staged
through pinned host memory (gloo's all-gather takes host tensors), under
NCCL it goes card to card, and on the CPU as it is.  The sums (GroupNorm's
statistics, :func:`gather_rows`'s backward) are all-reduces of fp32
tensors, which gloo takes on the card too (through the host itself).  At
``S = 2`` the all-gather moves what two point-to-point messages would.  Every rank runs
the same graph, so the ranks issue the same collectives in the same order
in the forward, in the backward and in a remat block's recompute.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import group_norm as group_norm_ops
from ..ops.group_norm import normalize
from ..ops.resize import interp_matrix
from ..utils.spans import span
from .mesh import Mesh, all_reduce_sum


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """``t`` of every rank of ``group`` in rank order (the same shape and
    dtype on every rank), moved as bytes."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    size = dist.get_world_size(group)
    staged = flat.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        flat = host
    out = torch.empty((size, flat.numel()), dtype=torch.uint8, device=flat.device,
                      pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), flat, group=group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    return [part.view(t.dtype).view(t.shape) for part in out.unbind(0)]


def _axis(mesh: Mesh) -> tuple:
    """``(group, coordinate, size)`` of the mesh's spatial axis."""
    return mesh.spatial_group, mesh.coord("spatial"), mesh.shape["spatial"]


def slab_row0(x: torch.Tensor, mesh: Mesh | None) -> int:
    """The map row of the first row of the slab ``x`` (rows on dim -2; every
    rank's slab has as many rows); 0 without a mesh."""
    return 0 if mesh is None else mesh.coord("spatial") * x.shape[-2]


def map_rows(x: torch.Tensor, mesh: Mesh | None) -> int:
    """The rows of the whole map of which ``x`` is a slab (rows on dim
    -2)."""
    return x.shape[-2] * (1 if mesh is None else mesh.shape["spatial"])


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, above, below, group, s, size):
        ctx.meta = (above, below, group, s, size, x.shape[-2])
        h = x.shape[-2]
        if above > h or below > h:
            raise ValueError(f"a halo of {above} + {below} rows around a slab of {h}")
        # The rank above takes this slab's first rows as its halo below, the
        # rank below its last rows as its halo above.
        parts = _all_gather(torch.cat([x[..., :below, :], x[..., h - above:, :]], dim=-2),
                            group)
        zeros = lambda n: x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))  # noqa: E731
        top = parts[s - 1][..., below:, :] if s > 0 else zeros(above)
        bottom = parts[s + 1][..., :below, :] if s < size - 1 else zeros(below)
        return torch.cat([top, x, bottom], dim=-2)

    @staticmethod
    def backward(ctx, grad):
        above, below, group, s, size, h = ctx.meta
        # The halos' cotangents go back to the ranks that own those rows,
        # which add them to their own rows' cotangents.
        parts = _all_gather(torch.cat([grad[..., :above, :], grad[..., above + h:, :]], dim=-2),
                            group)
        dx = grad[..., above:above + h, :].clone()
        if s < size - 1:
            dx[..., h - above:, :] += parts[s + 1][..., :above, :]
        if s > 0:
            dx[..., :below, :] += parts[s - 1][..., above:, :]
        return dx, None, None, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, mesh: Mesh) -> torch.Tensor:
    """The slab ``x`` with ``above`` rows of the rank above on top and
    ``below`` rows of the rank below underneath, zeros past the map's first
    and last rows (rows on dim -2)."""
    return _HaloRows.apply(x, above, below, *_axis(mesh))


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group, s, size):
        ctx.meta = (dim, group, s, x.shape[dim])
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        dim, group, s, rows = ctx.meta
        # Every rank's loss reads the gathered map in its own way (its own
        # output rows), so a slab's cotangent is the sum over the ranks of
        # their cotangents of its rows, summed in fp32.  This is the
        # opposite of ``parallel.mesh.view_merge``, whose ranks all compute
        # the same loss from the merged value and pass the cotangent on.
        total = grad.float().contiguous()
        dist.all_reduce(total, group=group)
        return total.narrow(dim, s * rows, rows).to(grad.dtype), None, None, None, None


def gather_rows(x: torch.Tensor, mesh: Mesh | None, dim: int = -2) -> torch.Tensor:
    """The whole map from every spatial rank's slab ``x``, concatenated on
    ``dim`` (the rows: -2 for NCHW, 1 for ``(B, H, W, C)``)."""
    if mesh is None:
        return x
    return _GatherRows.apply(x, dim, *_axis(mesh))


def gather_rows_to_first(x: torch.Tensor, mesh: Mesh, dim: int = -2) -> torch.Tensor | None:
    """The whole map from every spatial rank's slab ``x`` on spatial rank 0
    only (None on the others), with no gradient: one gather, which moves
    to one rank what :func:`gather_rows` moves to every rank."""
    group, s, size = _axis(mesh)
    flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
    staged = flat.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        flat = flat.cpu()
    parts = None
    if s == 0:
        parts = list(torch.empty((size, flat.numel()), dtype=torch.uint8,
                                 device=flat.device).unbind(0))
    first = 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)
    dist.gather(flat, parts, dst=first, group=group)
    if s != 0:
        return None
    return torch.cat([p.to(x.device).view(x.dtype).view(x.shape) for p in parts], dim=dim)


def all_reduce_max(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the spatial ranks (no
    gradient); ``t`` itself without a mesh."""
    if mesh is None:
        return t
    return torch.stack(_all_gather(t.detach(), mesh.spatial_group)).amax(dim=0)


def spatial_mean(t: torch.Tensor, dims: tuple, mesh: Mesh | None) -> torch.Tensor:
    """The mean of ``t`` over ``dims``, which include the rows, taken over
    every rank's slab (equal slabs): the local sums all-reduced, divided by
    the whole count; ``t.mean(dims)`` without a mesh."""
    if mesh is None:
        return t.mean(dim=dims)
    count = mesh.shape["spatial"]
    for d in dims:
        count *= t.shape[d]
    return all_reduce_sum(t.sum(dim=dims), mesh.spatial_group) / count


def _takes_kernel(x: torch.Tensor, mesh: Mesh | None) -> bool:
    """Whether :func:`group_norm_rows` launches the kernel pair: a CUDA
    tensor, no mesh, no autograd graph recorded, not inside
    ``torch.compile`` or ``torch.export``."""
    return (mesh is None and x.is_cuda and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling())


def group_norm_rows(x: torch.Tensor, gn: nn.GroupNorm, mesh: Mesh | None,
                    relu: bool = False) -> torch.Tensor:
    """``gn`` on the slab ``x`` (NCHW) with each (sample, group)'s
    statistics over every rank's rows, then a ReLU where ``relu`` asks for
    one: two passes in fp32 (the mean, then the centred sum of squares),
    each local sum all-reduced (``parallel.mesh.all_reduce_sum``, whose
    backward sums the cotangents over the ranks), and the affine as the
    native kernel applies it (``ops/group_norm.py:normalize``).  Inside the
    profiler range ``groupnorm``.

    Without a mesh, ``gn(x)``; but where no autograd graph is recorded
    (inference), on a CUDA tensor and outside ``torch.compile`` and
    ``torch.export`` (whose graphs keep the aten op), the kernel pair of
    ``ops/group_norm.py`` with the ReLU fused: the same numerics summed in
    another order, spread over the whole card where aten reduces each row
    in one block.  The kernels have no backward, and the training step's
    remat runs its forward and its recompute with a graph recorded."""
    with span("groupnorm"):
        if _takes_kernel(x, mesh):
            # NCHW-contiguous, as aten's CUDA GroupNorm also makes its input
            # (FeatNet's first convolution writes channels last).
            return group_norm_ops.group_norm(x.contiguous(), gn.num_groups, gn.weight,
                                             gn.bias, gn.eps, relu)
        if mesh is None:
            y = gn(x)
        else:
            N = x.shape[0]
            x32 = x.float().reshape(N, gn.num_groups, -1)
            mean = spatial_mean(x32, (2,), mesh)  # (N, G)
            var = spatial_mean((x32 - mean[..., None]).square(), (2,), mesh)
            y = normalize(x, mean, var, gn.weight, gn.bias, gn.eps)
    return torch.relu(y) if relu else y


def conv_halo(kernel: int, stride: int, padding: int, dilation: int = 1) -> tuple[int, int]:
    """The rows ``(above, below)`` a convolution of a slab reads past it:
    output row ``o`` reads input rows ``o * stride - padding`` to ``o *
    stride - padding + (kernel - 1) * dilation``, and a slab starts and ends
    on a multiple of the stride."""
    return padding, max(0, (kernel - 1) * dilation - padding - stride + 1)


def conv2d_rows(conv: nn.Conv2d, x: torch.Tensor, mesh: Mesh | None,
                weight: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                groups: int | None = None) -> torch.Tensor:
    """``conv`` on the slab ``x`` (NCHW): the slab with the halo the kernel
    reads (:func:`conv_halo`), then the convolution with no padding on the
    rows, so that each output row is the unsharded one's.  ``weight``,
    ``bias`` and ``groups`` replace ``conv``'s (a folded form of it).
    Without a mesh, the convolution of the whole map."""
    weight = conv.weight if weight is None else weight
    bias = conv.bias if bias is None else bias
    groups = conv.groups if groups is None else groups
    if mesh is None:
        return F.conv2d(x, weight, bias, stride=conv.stride, padding=conv.padding,
                        dilation=conv.dilation, groups=groups)
    above, below = conv_halo(conv.kernel_size[0], conv.stride[0], conv.padding[0],
                             conv.dilation[0])
    if above or below:
        x = halo_rows(x, above, below, mesh)
    return F.conv2d(x, weight, bias, stride=conv.stride, padding=(0, conv.padding[1]),
                    dilation=conv.dilation, groups=groups)


def conv_transpose_rows(deconv: nn.ConvTranspose2d, x: torch.Tensor,
                        mesh: Mesh | None) -> torch.Tensor:
    """``deconv``, the 3x3 stride-2 ``padding=1, output_padding=1``
    upsampling of ``models/blocks.py:DeconvGNReLU``, on the slab ``x``:
    output row ``o`` reads input rows ``(o - 1) / 2`` to ``(o + 1) / 2``, so
    the slab's last output row reads the first row of the rank below.  The
    slab with that row, transposed with no output padding on the rows,
    gives ``2 h + 1`` rows of which the first ``2 h`` are the slab's.
    ``deconv(x)`` without a mesh."""
    if mesh is None:
        return deconv(x)
    if (deconv.kernel_size, deconv.stride, deconv.padding, deconv.output_padding) != \
            ((3, 3), (2, 2), (1, 1), (1, 1)):
        raise ValueError("conv_transpose_rows takes the 3x3 stride-2 upsampling of "
                         "DeconvGNReLU")
    h = x.shape[-2]
    y = F.conv_transpose2d(halo_rows(x, 0, 1, mesh), deconv.weight, deconv.bias, stride=2,
                           padding=1, output_padding=(0, 1))
    return y[..., :2 * h, :]


def conv3d_rows(conv: nn.Conv3d, x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``conv`` on the slab ``x`` (NCDHW, rows on H): the slab with the halo
    the kernel reads on the rows (:func:`conv_halo`), then the convolution
    padded on D and W as ``conv`` pads them and not on the rows.
    ``conv(x)`` without a mesh."""
    if mesh is None:
        return conv(x)
    above, below = conv_halo(conv.kernel_size[1], conv.stride[1], conv.padding[1],
                             conv.dilation[1])
    if above or below:
        x = halo_rows(x, above, below, mesh)
    return F.conv3d(x, conv.weight, conv.bias, stride=conv.stride,
                    padding=(conv.padding[0], 0, conv.padding[2]), dilation=conv.dilation,
                    groups=conv.groups)


def conv_transpose3d_rows(deconv: nn.ConvTranspose3d, x: torch.Tensor,
                          mesh: Mesh | None) -> torch.Tensor:
    """``deconv``, the 3x3x3 stride-2 ``padding=1, output_padding=1``
    upsampling of ``models/evidential.py:Deconv3dBN``, on the slab ``x``
    (NCDHW), as :func:`conv_transpose_rows` does it in 2D: the slab with
    the first row of the rank below, transposed with no output padding on
    the rows, gives ``2 h + 1`` rows of which the first ``2 h`` are the
    slab's.  ``deconv(x)`` without a mesh."""
    if mesh is None:
        return deconv(x)
    if (deconv.kernel_size, deconv.stride, deconv.padding, deconv.output_padding) != \
            ((3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1)):
        raise ValueError("conv_transpose3d_rows takes the 3x3x3 stride-2 upsampling of "
                         "Deconv3dBN")
    h = x.shape[-2]
    y = F.conv_transpose3d(halo_rows(x, 0, 1, mesh), deconv.weight, deconv.bias, stride=2,
                           padding=1, output_padding=(1, 0, 1))
    return y[..., :2 * h, :]


def resize_rows(x: torch.Tensor, rows: int, mesh: Mesh | None) -> torch.Tensor:
    """The align-corners linear resize of the map's rows (dim -2) to
    ``rows`` rows, of which each rank keeps its slab of ``rows / S``.
    Output row ``o`` reads map rows ``floor(o (H - 1) / (rows - 1))`` and
    the next, which may lie in the rank below: the weights are
    ``ops/resize.py:interp_matrix(H, rows)`` at the map's row indices, and
    the rows the slab lacks come by :func:`halo_rows` (the same halo on
    every rank, the most any rank needs).  A resize to the same rows is the
    identity.  Without a mesh, the weights' product with the whole map."""
    height = map_rows(x, mesh)
    if rows == height:
        return x
    weights = interp_matrix(height, rows)
    if mesh is None:
        return torch.matmul(torch.from_numpy(weights).to(x), x)
    _, s, size = _axis(mesh)
    if rows % size:
        raise ValueError(f"a resize to {rows} rows does not split over a spatial axis of "
                         f"{size}")
    h, out = x.shape[-2], rows // size
    above = below = 0
    for k in range(size):
        read = np.flatnonzero(weights[k * out:(k + 1) * out].any(axis=0))
        above = max(above, k * h - int(read[0]))
        below = max(below, int(read[-1]) - ((k + 1) * h - 1))
    local = np.pad(weights, ((0, 0), (above, below)))[s * out:(s + 1) * out,
                                                      s * h:(s + 1) * h + above + below]
    if above or below:
        x = halo_rows(x, above, below, mesh)
    return torch.matmul(torch.from_numpy(np.ascontiguousarray(local)).to(x), x)
