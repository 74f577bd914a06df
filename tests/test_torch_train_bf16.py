"""The port's bf16 and folded-omega training against the JAX package's, on
the CPU.

Weights are the JAX init with perturbed deform offsets (``jax_params``),
carried to the port by ``params_from_jax``, which also carries JAX's
gradient trees onto the port's parameter names; the batch is
``tests/test_train.py:_batch`` (16x16, V=3, D=4), depth_block 2, remat.

- fp32 with ``fold_omega=True`` and ``"hybrid"`` against JAX's same lever
  at the fp32 training bars: loss rtol 1e-5, each gradient within 2e-4 of
  max(max|g|, 1e-3).
- bf16 (the sweep on the fp32 parameters cast in the graph) against JAX's
  bf16 step with ``pallas_gates=True`` (the Pallas gate kernels in
  interpret mode: fp32 gate math, as the port's kernels), the bar twice
  JAX's own bf16-to-fp32 distance, as ``tests/test_torch_packed.py`` holds
  bf16 inference: the loss, and each gradient tensor's root-mean-square
  difference over max(max|g_fp32|, 1e-3), the scale of the fp32 bar.  A
  tensor's bar is twice JAX's distance on that tensor, or twice the median
  of JAX's distances over the tensors where that is larger: the gradients
  of the omega network's biases are 1e-5 to 1e-4 (a hundredth of the
  others), and bf16 rounding makes their one to four elements noise in
  both frameworks, so their own JAX distance is one draw of it.  Measured
  on these inputs: JAX's median 0.0633; the port's worst ratio to its bar
  0.71 (``feature.intraAA.deformconv0.1.weight``); the port's loss 1.3e-6
  from JAX's bf16 loss, JAX's own bf16 distance 2.8e-5.
- The remat recompute of a bf16 step convolves with the cast (bf16)
  weights, and its gradients equal those of the step without remat bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.pipeline.train import loss_fn as loss_fn_j
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, params_from_jax
from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig, loss_fn

from test_torch_models import jax_params
from test_train import _batch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return jax_params(seed=1, size=16)


@pytest.fixture(scope="module")
def batch():
    return _batch(seed=3)


def _jax_step(tree, batch, **levers):
    """JAX's loss and gradients (on the port's names) of one remat step."""
    config = SweepConfigJ(depth_block=2, remat=True, **levers)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda params, b: loss_fn_j(params, b, config)[0]))(tree, batch)
    grads = params_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads))
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def _port_step(tree, batch, remat=True, **levers):
    """The port's loss, gradients and model after one training forward and
    backward with ``TrainConfig``'s sweep."""
    model = AARMVSNetCore()
    model.load_state_dict(params_from_jax(tree), strict=True)
    config = TrainConfig(depth_block=2, device="cpu", **levers).sweep(remat=remat)
    loss, _ = loss_fn(model, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                      config)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, model


@pytest.fixture(scope="module")
def jax_fp32(tree, batch):
    return _jax_step(tree, batch)


@pytest.mark.parametrize("fold_omega", [True, "hybrid"], ids=["folded", "hybrid"])
def test_fold_omega_step_matches_jax(tree, batch, fold_omega):
    loss_j, grads_j = _jax_step(tree, batch, fold_omega=fold_omega)
    loss, grads, _ = _port_step(tree, batch, fold_omega=fold_omega)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    for name, g_j in grads_j.items():
        scale = max(np.abs(g_j).max(), 1e-3)
        np.testing.assert_allclose(grads[name].numpy() / scale, g_j / scale, atol=2e-4,
                                   err_msg=name)


def _distances(a: dict, b: dict, scales: dict) -> dict:
    """Per tensor, the root-mean-square difference over the tensor's scale."""
    return {n: np.sqrt(np.mean((np.asarray(a[n], np.float64) - b[n]) ** 2)) / scales[n]
            for n in scales}


def test_bf16_step_tracks_jax_bf16(tree, batch, jax_fp32):
    loss_32, grads_32 = jax_fp32
    loss_16, grads_16 = _jax_step(tree, batch, feature_dtype=jnp.bfloat16, pallas_gates=True)
    loss, grads, model = _port_step(tree, batch, feature_dtype=torch.bfloat16)

    # The bf16 step's gradients reach the fp32 master weights, in fp32.
    for name, p in model.named_parameters():
        assert p.dtype == grads[name].dtype == torch.float32, name
        assert torch.isfinite(grads[name]).all(), name
    assert model.feature.conv2[0].weight.grad.abs().max() > 0

    ref_loss = abs(loss_16 - loss_32)
    assert 0 < ref_loss and abs(loss - loss_16) <= 2 * ref_loss, (loss, loss_16, loss_32)

    scales = {n: max(np.abs(g).max(), 1e-3) for n, g in grads_32.items()}
    ref = _distances(grads_16, grads_32, scales)
    got = _distances({n: g.numpy() for n, g in grads.items()}, grads_16, scales)
    floor = float(np.median(list(ref.values())))
    assert floor > 0  # the calibration is not vacuous
    ratios = {n: got[n] / (2 * max(ref[n], floor)) for n in ref}
    worst = max(ratios, key=ratios.get)
    print(f"JAX bf16 vs fp32: loss {ref_loss:.3e}, gradients median {floor:.4f}; the port's "
          f"bf16 vs JAX's: loss {abs(loss - loss_16):.3e}, worst ratio to its bar "
          f"{ratios[worst]:.2f} ({worst})")
    assert ratios[worst] <= 1, (worst, got[worst], ref[worst], floor)


class _ConvolutionDtypes(TorchDispatchMode):
    """The (input, weight) dtypes of every convolution dispatched inside."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.seen.append((args[0].dtype, args[1].dtype))
        return func(*args, **(kwargs or {}))


def test_remat_recompute_uses_the_cast_weights(tree, batch):
    """The backward of a bf16 remat step recomputes every depth block with
    the bf16 weights that the forward cast (a checkpoint's recompute runs
    outside any context the forward entered), and gives the gradients of
    the step without remat bit for bit."""
    model = AARMVSNetCore()
    model.load_state_dict(params_from_jax(tree), strict=True)
    config = TrainConfig(depth_block=2, device="cpu", feature_dtype=torch.bfloat16)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _ = loss_fn(model, tb, config.sweep(remat=True))
    with _ConvolutionDtypes() as mode:
        loss.backward()
    # Two ConvLSTM steps a block, each recomputing omega's and the
    # regularizer's convolutions: all of them in bf16.
    assert len(mode.seen) > 20
    assert set(mode.seen) == {(torch.bfloat16, torch.bfloat16)}, set(mode.seen)
    remat = {n: p.grad for n, p in model.named_parameters()}
    _, plain, _ = _port_step(tree, batch, remat=False, feature_dtype=torch.bfloat16)
    for name, g in remat.items():
        torch.testing.assert_close(g, plain[name], atol=0, rtol=0, msg=name)
