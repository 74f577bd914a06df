"""Gradients of the port's ConvLSTM gate op and bilinear tent, against JAX.

- The plain backward (what ``LSTMGates.backward`` runs on CPU tensors) is
  held to ``jax.vjp`` of the Pallas ``fused_lstm_gates`` (interpret mode
  on the CPU, as ``tests/test_pallas.py`` runs it), at the bars of
  ``tests/test_pallas.py:61-103``: fp32 atol 1e-5, bf16 5e-2.
- ``LSTMGates`` on the CPU gives autograd's gradients of the plain forward
  (1e-6), and a ConvLSTM cell scanned under ``torch.utils.checkpoint``
  gives the gradients of the XLA cell under ``jax.checkpoint``
  (``tests/test_pallas.py:106-137``, fp32 1e-4).
- The tent of ``patch_bilinear_sample`` has JAX's gradient at its kinks
  (integer and half-integer coordinates).

The CUDA kernel runs only on the card; its tests are in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models.blocks import ConvLSTMCell as ConvLSTMCellJ
from aa_rmvsnet_tpu.ops.pallas.gates import fused_lstm_gates
from aa_rmvsnet_tpu.ops.patch_sample import build_patch_table as build_patch_table_j
from aa_rmvsnet_tpu.ops.patch_sample import patch_bilinear_sample as patch_bilinear_sample_j
from aa_rmvsnet_tpu_torch.models.blocks import ConvLSTMCell
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.ops.patch_sample import build_patch_table, patch_bilinear_sample

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(hidden, seed=0):
    """NHWC numpy z, c and cotangents dh, dc' at the odd shape (2, 9, 13)."""
    rng = np.random.RandomState(seed)
    z = rng.randn(2, 9, 13, 4 * hidden).astype(np.float32)
    c, dh, dcn = (rng.randn(2, 9, 13, hidden).astype(np.float32) for _ in range(3))
    return z, c, dh, dcn


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hidden", [16, 8])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_backward_plain_matches_pallas_vjp(hidden, dtype):
    jdt, tdt, atol = _DTYPES[dtype]
    z, c, dh, dcn = _inputs(hidden)
    _, vjp = jax.vjp(fused_lstm_gates, jnp.asarray(z, jdt), jnp.asarray(c, jdt))
    dz_j, dc_j = vjp((jnp.asarray(dh, jdt), jnp.asarray(dcn, jdt)))
    dz_t, dc_t = gates.lstm_gates_backward_reference(
        _nchw(z, tdt), _nchw(c, tdt), _nchw(dh, tdt), _nchw(dcn, tdt))
    assert dz_t.dtype == tdt and dz_t.shape == (2, 4 * hidden, 9, 13)
    assert dc_t.dtype == tdt and dc_t.shape == (2, hidden, 9, 13)
    np.testing.assert_allclose(_nhwc(dz_t), np.asarray(dz_j, np.float32), atol=atol)
    np.testing.assert_allclose(_nhwc(dc_t), np.asarray(dc_j, np.float32), atol=atol)


@pytest.mark.parametrize("hidden", [16, 8])
@pytest.mark.parametrize("use_c_next", [True, False], ids=["both", "h_only"])
def test_function_matches_autograd_of_plain(hidden, use_c_next):
    """``h_only``: c' feeds nothing (the sweep's last depth step), so
    autograd hands the Function a zero cotangent for it."""
    z, c, dh, dcn = _inputs(hidden, seed=1)
    grads = []
    for fn in (gates.lstm_gates, gates.lstm_gates_reference):
        zt = _nchw(z).requires_grad_()
        ct = _nchw(c).requires_grad_()
        h_next, c_next = fn(zt, ct)
        loss = (h_next * _nchw(dh)).sum()
        if use_c_next:
            loss = loss + (c_next * _nchw(dcn)).sum()
        loss.backward()
        grads.append((zt.grad, ct.grad))
    (dz_f, dc_f), (dz_a, dc_a) = grads
    torch.testing.assert_close(dz_f, dz_a, atol=1e-6, rtol=0)
    torch.testing.assert_close(dc_f, dc_a, atol=1e-6, rtol=0)


def test_cpu_backward_does_not_count_launches():
    z, c, dh, _ = _inputs(8, seed=2)
    zt = _nchw(z).requires_grad_()
    before = (gates.launches, gates.backward_launches)
    h_next, _ = gates.lstm_gates(zt, _nchw(c))
    (h_next * _nchw(dh)).sum().backward()
    assert zt.grad is not None
    assert (gates.launches, gates.backward_launches) == before


def test_cell_scan_under_checkpoint_matches_jax():
    """A ConvLSTM cell scanned over T steps, each step under checkpoint:
    weight and input gradients equal JAX's ``jax.checkpoint`` scan."""
    B, H, W, C, T, hidden = 1, 8, 12, 32, 3, 16
    rng = np.random.RandomState(3)
    xs = rng.randn(T, B, H, W, C).astype(np.float32)
    params = jax.tree.map(np.asarray, ConvLSTMCellJ(hidden).init(
        jax.random.PRNGKey(1), jnp.asarray(xs[0]), ConvLSTMCellJ.zero_state(B, H, W, hidden)))

    def total_j(params, xs):
        cell = ConvLSTMCellJ(hidden)

        @jax.checkpoint
        def body(state, x):
            h, c = cell.apply(params, x, state)
            return (h, c), jnp.sum(h ** 2) + jnp.sum(jnp.sin(c))

        _, losses = jax.lax.scan(body, ConvLSTMCellJ.zero_state(B, H, W, hidden), xs)
        return jnp.sum(losses)

    g_params, g_xs = jax.grad(total_j, argnums=(0, 1))(params, jnp.asarray(xs))

    cell = ConvLSTMCell(C, hidden)
    with torch.no_grad():
        kernel = params["params"]["conv"]["kernel"]
        cell.conv.weight.copy_(torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()))
        cell.conv.bias.copy_(torch.from_numpy(np.array(params["params"]["conv"]["bias"])))
    xs_t = torch.from_numpy(xs).permute(0, 1, 4, 2, 3).contiguous().requires_grad_()

    def body(x, h, c):
        h, c = cell(x, (h, c))
        return h, c, (h ** 2).sum() + torch.sin(c).sum()

    h = torch.zeros(B, hidden, H, W)
    c = torch.zeros(B, hidden, H, W)
    total = 0.0
    for t in range(T):
        h, c, loss = torch.utils.checkpoint.checkpoint(body, xs_t[t], h, c,
                                                       use_reentrant=False)
        total = total + loss
    total.backward()

    g_kernel = np.transpose(cell.conv.weight.grad.numpy(), (2, 3, 1, 0))
    np.testing.assert_allclose(g_kernel, np.asarray(g_params["params"]["conv"]["kernel"]),
                               atol=1e-4)
    np.testing.assert_allclose(cell.conv.bias.grad.numpy(),
                               np.asarray(g_params["params"]["conv"]["bias"]), atol=1e-4)
    np.testing.assert_allclose(xs_t.grad.permute(0, 1, 3, 4, 2).numpy(), np.asarray(g_xs),
                               atol=1e-4)


@pytest.mark.parametrize("where", ["integer", "half_integer", "border"])
def test_tent_gradient_matches_jax(where):
    """d/dx and d/dy of ``patch_bilinear_sample`` equal ``jax.grad`` of the
    JAX function.  At integer coordinates the tent sits on its kinks
    (|d| at 0 and max(0, .) at d = -1), where ``torch.abs`` and
    ``torch.clamp`` would give other one-sided gradients than JAX's."""
    H, W = 5, 6
    rng = np.random.RandomState(4)
    feat = rng.randn(1, H, W, 3).astype(np.float32)
    weights = rng.randn(3).astype(np.float32)
    if where == "integer":
        x = rng.randint(0, W, (1, 12)).astype(np.float32)
        y = rng.randint(0, H, (1, 12)).astype(np.float32)
    elif where == "half_integer":
        x = rng.randint(0, W, (1, 12)).astype(np.float32) + 0.5
        y = rng.randint(0, H, (1, 12)).astype(np.float32) - 0.5
    else:  # on and just beyond the image border
        x = np.array([[-1, -1, 0, W - 1, W, W, -0.5, W - 0.5, 2, 3, 0, W - 1]], np.float32)
        y = np.array([[0, -1, H, H - 1, 2, H, 1, 3, -1, H, -0.5, H - 0.5]], np.float32)

    def loss_j(x, y):
        out = patch_bilinear_sample_j(build_patch_table_j(jnp.asarray(feat)), x, y, H, W)
        return jnp.sum(out * weights)

    gx_j, gy_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = patch_bilinear_sample(build_patch_table(torch.from_numpy(feat)), xt, yt, H, W)
    (out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy_j), atol=1e-6)
