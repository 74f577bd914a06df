"""The row-split ops of the spatial mesh axis (``parallel/spatial.py``, and
the blocks' ``forward`` given a spatial mesh) on two gloo CPU ranks, each
held to the same module on the whole map.

Each case builds a module and its inputs from a seed, identically in every
process.  Rank ``s`` of 2 takes its slab of rows of every input (at each
input's own scale), runs the row-split form and backpropagates ``sum_i
<out_i, w_i(s)>`` with seeded ``w_i(s)``; this process computes what each
rank's outputs must be from the whole map with the unsharded module and
backpropagates the sum of both ranks' losses.  Bars: the outputs fp32
atol 1e-5; each input's gradient on each rank's rows atol 1e-5 (complete
on its owner: a halo's cotangent comes back to it); each parameter's
gradient, summed over the ranks (each holds its rows' share), atol 1e-5.
The ranks are subprocesses (``python -c``, no JAX) on a free port with a
deadline, started once for every case.  The evidential head's ops take
NCDHW slabs (rows on H, dim -2): ``conv3d_rows`` at kernel 3 stride 1 and
2 and at kernel 1, ``conv_transpose3d_rows``, ``resize_rows`` (held to
``F.interpolate``'s align-corners resize of the rows) to the same rows,
to half and to 3/2 of them (the last reads a row of the rank below), and
a train-mode ``FlaxBatchNorm3d`` whose statistics cover both ranks (its
updated running statistics held to the whole map's too).
"""

import json
import os
import sys
import textwrap

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from aa_rmvsnet_tpu_torch.models.aggregation import InterViewAA, omega_folded
from aa_rmvsnet_tpu_torch.models.blocks import DeformConv
from aa_rmvsnet_tpu_torch.models.evidential import FlaxBatchNorm3d, batch_statistics_over
from aa_rmvsnet_tpu_torch.models.feature import FeatNet
from aa_rmvsnet_tpu_torch.models.regularizer import HIDDEN_DIMS, UNetConvLSTM
from aa_rmvsnet_tpu_torch.parallel.spatial import (
    conv2d_rows,
    conv3d_rows,
    conv_transpose3d_rows,
    conv_transpose_rows,
    gather_rows,
    group_norm_rows,
    halo_rows,
    resize_rows,
)

torch.set_num_threads(1)

S = 2  # spatial ranks
ATOL = 1e-5


def _randn(*shape, seed, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _rows(t: torch.Tensor, s: int) -> torch.Tensor:
    """Rank ``s``'s slab of ``t``'s rows (dim -2)."""
    h = t.shape[-2] // S
    return t[..., s * h:(s + 1) * h, :]


def _randomize(module: nn.Module, seed: int, scale: float = 0.3) -> nn.Module:
    """Every parameter drawn from a seed (GroupNorm's affine around 1 and
    0), so that no branch starts at zero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(scale * torch.randn(p.shape, generator=g)
                    + (1.0 if name.endswith("weight") and p.dim() == 1 else 0.0))
    return module


def _deform(seed: int) -> DeformConv:
    """A deformable conv whose offsets reach several rows (and so past a
    slab of 8)."""
    module = _randomize(DeformConv(4, 6), seed)
    with torch.no_grad():
        module.p_conv.weight.mul_(6.0)
        module.p_conv.bias.copy_(_randn(18, seed=seed + 1, scale=3.0))
    return module


def _unet_states(seed: int, H: int, W: int) -> list:
    sizes = [(H, W), (H // 2, W // 2), (H // 4, W // 4), (H // 2, W // 2), (H, W)]
    return [_randn(1, hid, h, w, seed=seed + 10 * i + j, scale=0.5)
            for i, (hid, (h, w)) in enumerate(zip(HIDDEN_DIMS, sizes)) for j in range(2)]


def _pairs(flat):
    return tuple((flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2))


def _unet_outputs(cost, states):
    return [cost, *(t for pair in states for t in pair)]


def _bn_train(module: FlaxBatchNorm3d, x: torch.Tensor, groups=()) -> list:
    """``module`` in train mode on ``x`` (statistics over ``groups``' ranks
    too): its output and the running statistics it leaves, after which its
    buffers are put back, so that every call starts from the same ones."""
    saved = [b.clone() for b in module.buffers()]
    module.train()
    with batch_statistics_over(module, groups):
        y = module(x)
    out = [y, module.running_mean.clone(), module.running_var.clone()]
    module.eval()
    with torch.no_grad():
        for b, v in zip(module.buffers(), saved):
            b.copy_(v)
    return out


def _resize_case(rows: int):
    """``resize_rows`` of a 16-row map to ``rows`` rows, against
    ``F.interpolate``'s align-corners bilinear resize of the rows alone."""
    return (lambda seed: (None, [_randn(2, 3, 16, 5, seed=seed)]),
            _sliced(lambda _, x: [F.interpolate(x[0], size=(rows, 5), mode="bilinear",
                                                align_corners=True)]),
            lambda _, x, mesh: [resize_rows(x[0], rows, mesh)])


def _sliced(fn):
    """The whole-map outputs ``fn(module, inputs)``, each cut to rank ``s``'s
    rows: what a row-split op must give."""
    return lambda module, inputs, s: [_rows(t, s) for t in fn(module, inputs)]


#: name -> (build(seed) -> (module, whole inputs), whole(module, inputs, s) ->
#: rank s's outputs, slab(module, slab inputs, mesh) -> outputs).
CASES = {
    "halo_rows": (
        lambda seed: (None, [_randn(2, 3, 16, 5, seed=seed)]),
        lambda _, x, s: [F.pad(x[0], (0, 0, 2, 1))[..., s * 8:s * 8 + 11, :]],
        lambda _, x, mesh: [halo_rows(x[0], 2, 1, mesh)],
    ),
    "gather_rows": (
        lambda seed: (None, [_randn(2, 3, 16, 5, seed=seed)]),
        lambda _, x, s: [x[0]],
        lambda _, x, mesh: [gather_rows(x[0], mesh)],
    ),
    "group_norm_rows": (
        lambda seed: (_randomize(nn.GroupNorm(2, 16), seed), [_randn(2, 16, 16, 6, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [group_norm_rows(x[0], m, mesh)],
    ),
    "conv2d_rows_stride1": (
        lambda seed: (_randomize(nn.Conv2d(4, 6, 3, padding=1), seed),
                      [_randn(2, 4, 16, 7, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv2d_rows(m, x[0], mesh)],
    ),
    "conv2d_rows_stride2": (
        lambda seed: (_randomize(nn.Conv2d(4, 6, 3, stride=2, padding=1), seed),
                      [_randn(2, 4, 16, 8, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv2d_rows(m, x[0], mesh)],
    ),
    "conv_transpose_rows": (
        lambda seed: (_randomize(nn.ConvTranspose2d(4, 6, 3, stride=2, padding=1,
                                                    output_padding=1), seed),
                      [_randn(2, 4, 8, 5, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv_transpose_rows(m, x[0], mesh)],
    ),
    "deform_conv": (
        lambda seed: (_deform(seed), [_randn(1, 4, 16, 10, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [m(x[0], mesh)],
    ),
    "omega": (
        lambda seed: (_randomize(InterViewAA(), seed), [_randn(3, 32, 16, 6, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [m(x[0], mesh)],
    ),
    "omega_folded": (
        lambda seed: (_randomize(InterViewAA(), seed), [_randn(1, 3 * 32, 16, 6, seed=seed)]),
        _sliced(lambda m, x: [omega_folded(m, x[0].permute(0, 2, 3, 1), 3)
                              .permute(0, 3, 1, 2)]),
        lambda m, x, mesh: [omega_folded(m, x[0].permute(0, 2, 3, 1), 3, mesh=mesh)
                            .permute(0, 3, 1, 2)],
    ),
    "featnet": (
        lambda seed: (_randomize(FeatNet(), seed, scale=0.2), [_randn(2, 3, 16, 20, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [m(x[0], mesh)],
    ),
    "conv3d_rows_k3_s1": (
        lambda seed: (_randomize(nn.Conv3d(4, 6, 3, padding=1), seed),
                      [_randn(2, 4, 3, 16, 5, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv3d_rows(m, x[0], mesh)],
    ),
    "conv3d_rows_k3_s2": (
        lambda seed: (_randomize(nn.Conv3d(4, 6, 3, stride=2, padding=1, bias=False), seed),
                      [_randn(2, 4, 4, 16, 6, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv3d_rows(m, x[0], mesh)],
    ),
    "conv3d_rows_k1": (
        lambda seed: (_randomize(nn.Conv3d(4, 6, 1, bias=False), seed),
                      [_randn(2, 4, 3, 16, 5, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv3d_rows(m, x[0], mesh)],
    ),
    "conv_transpose3d_rows": (
        lambda seed: (_randomize(nn.ConvTranspose3d(4, 6, 3, stride=2, padding=1,
                                                    output_padding=1, bias=False), seed),
                      [_randn(2, 4, 2, 8, 3, seed=seed)]),
        _sliced(lambda m, x: [m(x[0])]),
        lambda m, x, mesh: [conv_transpose3d_rows(m, x[0], mesh)],
    ),
    "resize_rows_same": _resize_case(16),
    "resize_rows_half": _resize_case(8),
    "resize_rows_up": _resize_case(24),
    "batch_norm_3d_train": (
        lambda seed: (_randomize(FlaxBatchNorm3d(4), seed),
                      [_randn(2, 4, 3, 16, 5, seed=seed) + 0.5]),
        lambda m, x, s: (lambda y, mean, var: [_rows(y, s), mean, var])(*_bn_train(m, x[0])),
        lambda m, x, mesh: _bn_train(m, x[0], (mesh.spatial_group,)),
    ),
    "unet_step": (
        lambda seed: (_randomize(UNetConvLSTM(), seed, scale=0.2),
                      [_randn(1, 32, 16, 12, seed=seed), *_unet_states(seed, 16, 12)]),
        _sliced(lambda m, x: _unet_outputs(*m(x[0], _pairs(x[1:])))),
        lambda m, x, mesh: _unet_outputs(*m(x[0], _pairs(x[1:]), mesh)),
    ),
}


def _weights(outputs, s: int) -> list:
    """The seeded cotangents of rank ``s``'s loss, scaled so that the
    gradients are of order 1."""
    return [_randn(*o.shape, seed=1000 + 10 * s + i, scale=o.numel() ** -0.5)
            for i, o in enumerate(outputs)]


def _case(name: str):
    build, whole, slab = CASES[name]
    module, inputs = build(sorted(CASES).index(name))
    if module is not None:
        module.eval()
    return module, inputs, whole, slab


def rank_results(mesh) -> dict:
    """Every case on this rank's slabs: outputs, input and parameter
    gradients."""
    s = mesh.coord("spatial")
    out = {}
    for name in CASES:
        module, inputs, _, slab = _case(name)
        xs = [_rows(t, s).clone().requires_grad_() for t in inputs]
        outputs = slab(module, xs, mesh)
        loss = sum((o * w).sum() for o, w in zip(outputs, _weights(outputs, s)))
        loss.backward()
        out[name] = {"outputs": [o.detach() for o in outputs],
                     "input_grads": [x.grad for x in xs],
                     "param_grads": {} if module is None else
                     {k: p.grad for k, p in module.named_parameters()}}
    return out


WORKER = textwrap.dedent("""
    import json, sys
    import torch
    a = json.loads(sys.argv[1])
    sys.path.insert(0, a["tests"])
    import test_torch_spatial
    from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
    mesh = make_mesh(spatial=2, device="cpu")
    torch.save(test_torch_spatial.rank_results(mesh), a["out"])
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_parallel import _free_port, _run_ranks

    workdir = tmp_path_factory.mktemp("spatial")
    port, argvs, outs = _free_port(), [], []
    for rank in range(S):
        out = str(workdir / f"rank{rank}.pt")
        args = dict(port=port, rank=rank, out=out, tests=os.path.dirname(__file__))
        argvs.append([sys.executable, "-c", WORKER, json.dumps(args)])
        outs.append(out)
    _run_ranks(argvs)
    return [torch.load(out, weights_only=False) for out in outs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_split_matches_the_whole_map(ranks, name):
    module, inputs, whole, _ = _case(name)
    xs = [t.clone().requires_grad_() for t in inputs]
    wants = [whole(module, xs, s) for s in range(S)]
    loss = sum((o * w).sum() for s, outs in enumerate(wants)
               for o, w in zip(outs, _weights(outs, s)))
    loss.backward()
    for s, got in enumerate(r[name] for r in ranks):
        for i, (o, want) in enumerate(zip(got["outputs"], wants[s])):
            torch.testing.assert_close(o, want.detach(), atol=ATOL, rtol=0,
                                       msg=lambda m: f"rank {s} output {i}: {m}")
        for i, (g, x) in enumerate(zip(got["input_grads"], xs)):
            torch.testing.assert_close(g, _rows(x.grad, s), atol=ATOL, rtol=0,
                                       msg=lambda m: f"rank {s} input {i} gradient: {m}")
    if module is not None:
        for k, p in module.named_parameters():
            summed = sum(r[name]["param_grads"][k] for r in ranks)
            torch.testing.assert_close(summed, p.grad, atol=ATOL, rtol=0,
                                       msg=lambda m: f"{k} gradient summed over ranks: {m}")
