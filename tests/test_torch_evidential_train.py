"""The PyTorch port's evidential (NIG) training path against the JAX
package, on the CPU, in fp32.

Weights: the core from ``jax_params`` (the JAX init with perturbed deform
offsets) and the head from ``init_evidential`` with its BatchNorm affine
parameters and statistics randomised, crossed to the port through
``params_from_jax`` / ``evidential_params_from_jax``.  Both maps are linear,
so they also carry JAX's gradient trees onto the port's parameter names.

Bars: ``loss_emvsnet`` and ``nig_nll_loss`` rtol 1e-6 in value and in each
input's gradient; a train-mode ``ConvBN3d`` rtol 1e-6 in its updated
running statistics (atol 1e-7 for a mean near 0), 1e-5 in its output and
gradients.  The head alone and the whole path: every updated BN statistic
within 1e-5 of max(max|s|, 1e-3); the whole-path loss rtol 1e-5; each
gradient within 2e-4 of max(max|g|, 1e-3) (the bar of
``tests/test_torch_train.py``) or, where that is less, of 10 times the
port's own move on the CPU when every weight is scaled by 1 + 1e-7 noise
(``chip_smoke.py`` phase 4b's calibration); the head's outputs at
``tests/test_evidential.py``'s bars or 10 times their own move.

Why a calibrated bar: the head softmaxes the probability volume again
(``EvidentialHead.forward``), so its first convolutions see nearly constant
inputs, and train-mode BatchNorm divides their small variation by its
batch variance.  flax computes that variance as E[x^2] - E[x]^2, which
cancels; torch as E[(x - E[x])^2].  ``test_whole_path_matches_jax[two_pass]``
gives flax the two-pass form, in this process only: the loss then meets rtol
1e-6, and the gradients move closer to the port's.  The output conv's bias
has an exact gradient of 0 (softmax is shift-invariant): both sides hold
rounding noise there, which the calibration measures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import evidential as ev_j
from aa_rmvsnet_tpu.pipeline.train import TrainConfig as TrainConfigJ
from aa_rmvsnet_tpu.pipeline.train import evidential_loss_fn as evidential_loss_fn_j
from aa_rmvsnet_tpu.pipeline.train import make_evidential_eval_step
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    EvidentialHead,
    evidential_params_from_jax,
    load_evidential_checkpoint,
    load_reference_checkpoint,
    params_from_jax,
)
from aa_rmvsnet_tpu_torch.models import evidential as ev_t
from aa_rmvsnet_tpu_torch.pipeline.checkpoint import HEAD_PREFIX, checkpoint_path, latest_step
from aa_rmvsnet_tpu_torch.pipeline.train import (
    TrainConfig,
    eval_step,
    evidential_loss_fn,
    make_optimizer,
    run_training,
    train_step,
    trainable_parameters,
)

from test_torch_evidential import _randomize_bn
from test_torch_models import jax_params
from test_train import _batch

torch.set_num_threads(2)

H = W = 16
MAXDISP = 8
HEAD_BARS = {"gamma": 2e-3, "nu": 1e-3, "alpha": 1e-3, "beta": 1e-3, "prob_combine": 1e-4}
CONFIG_J = TrainConfigJ(depth_block=2, evidential=True, maxdisp=MAXDISP)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _samples(batch) -> list[dict]:
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    return [{k: v[b] for k, v in arrays.items()} for b in range(arrays["imgs"].shape[0])]


@pytest.fixture(scope="module")
def head_variables():
    init = jax.jit(ev_j.init_evidential, static_argnums=(1, 2, 3))
    return _randomize_bn(_numpy(init(jax.random.PRNGKey(1), H, W, MAXDISP)), seed=3)


@pytest.fixture(scope="module")
def core_tree():
    return jax_params(seed=1, size=H)


def _port_core(tree) -> AARMVSNetCore:
    core = AARMVSNetCore()
    core.load_state_dict(params_from_jax(tree), strict=True)
    return core


def _port_head(variables) -> EvidentialHead:
    head = EvidentialHead(MAXDISP)
    head.load_state_dict(evidential_params_from_jax(variables), strict=True)
    return head


def _nudge(*modules, scale: float = 1e-7) -> None:
    """Multiply every parameter of ``modules`` by 1 + ``scale`` N(0, 1)."""
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for module in modules:
            for p in module.parameters():
                p.mul_(1 + scale * torch.randn(p.shape, generator=gen))


def _grads(module) -> dict:
    return {name: p.grad.numpy() for name, p in module.named_parameters()}


def _assert_calibrated(got: dict, nudged: dict, want: dict, floor, what: str,
                       scale_floor: float | None = 1e-3) -> None:
    """For each tensor: max|got - want| / s within max(floor, 10 x
    max|nudged - got| / s), s = max(max|want|, scale_floor) (s = 1 where
    ``scale_floor`` is None); ``floor`` a number or a dict by name."""
    for name, w in want.items():
        w = np.asarray(w)
        s = 1.0 if scale_floor is None else max(np.abs(w).max(), scale_floor)
        err = np.abs(got[name] - w).max() / s
        move = np.abs(nudged[name] - got[name]).max() / s
        bar = max(floor[name] if isinstance(floor, dict) else floor, 10 * move)
        assert err <= bar, f"{what} {name}: error {err:.3e}, bar {bar:.3e} (move {move:.3e})"


def _assert_stats(head: EvidentialHead, want: dict) -> None:
    """Every BN running statistic within 1e-5 of max(max|s|, 1e-3)."""
    for name, buf in head.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            w = want[name].numpy()
            scale = max(np.abs(w).max(), 1e-3)
            np.testing.assert_allclose(buf.numpy() / scale, w / scale, atol=1e-5, err_msg=name)


# --------------------------------------------------------------------------- losses


@pytest.mark.parametrize("case", ["emvsnet", "nig_nll", "emvsnet_underflow"])
def test_losses_match_jax(case):
    """Value and gradient in gamma, nu, alpha and beta, a third of the pixels
    masked.  ``underflow``: beta is 0 on masked pixels, so their term is
    -inf; JAX's ``where`` keeps the loss finite, and so must the port's."""
    rng = np.random.RandomState(4)
    shape = (2, 6, 7)
    gamma = rng.uniform(420, 580, shape).astype(np.float32)
    nu = rng.uniform(0.1, 3.0, shape).astype(np.float32)
    alpha = rng.uniform(1.1, 4.0, shape).astype(np.float32)
    beta = rng.uniform(0.1, 30.0, shape).astype(np.float32)
    gt = rng.uniform(400, 600, shape).astype(np.float32)
    mask = (rng.rand(*shape) > 0.33).astype(np.float32)
    if case.endswith("underflow"):
        beta[mask == 0] = 0.0
    fn_j, fn_t = {"emvsnet": (ev_j.loss_emvsnet, ev_t.loss_emvsnet),
                  "nig_nll": (ev_j.nig_nll_loss, ev_t.nig_nll_loss)}[case.split("_u")[0]]
    inputs = (gamma, nu, alpha, beta)
    value_j, grads_j = jax.value_and_grad(
        lambda *a: fn_j(*a, jnp.asarray(gt), jnp.asarray(mask), 0.1), argnums=(0, 1, 2, 3)
    )(*(jnp.asarray(a) for a in inputs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    value_t = fn_t(*leaves, torch.from_numpy(gt), torch.from_numpy(mask), 0.1)
    value_t.backward()
    assert np.isfinite(value_t.item())
    np.testing.assert_allclose(value_t.item(), float(value_j), rtol=1e-6)
    for name, leaf, g in zip(("gamma", "nu", "alpha", "beta"), leaves, grads_j):
        g = np.asarray(g)
        # loss_emvsnet does not read alpha: no gradient in torch, zeros in JAX.
        got = np.zeros_like(g) if leaf.grad is None else leaf.grad.numpy()
        if case.endswith("underflow"):  # NaN on the masked pixels in both
            np.testing.assert_array_equal(np.isnan(got), np.isnan(g))
            keep = mask > 0
            np.testing.assert_allclose(got[keep], g[keep], rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, g, rtol=1e-6, atol=1e-12, err_msg=name)


# --------------------------------------------------------------------------- BatchNorm


def test_convbn_train_mode_matches_flax():
    """One ``ConvBN3d`` (3x3x3, 8 -> 8 channels) in train mode over 32 values
    a channel: output and the gradients of the input, the kernel and the BN
    affine parameters against flax's; the running statistics after the
    update against flax's ``mutable=["batch_stats"]`` result.  Torch's own
    ``nn.BatchNorm3d`` fails this: its running variance takes the unbiased
    batch variance, 32/31 times flax's biased one."""
    rng = np.random.RandomState(5)
    x = (1.5 * rng.randn(1, 2, 4, 4, 8) + 0.3).astype(np.float32)  # NDHWC, n = 32
    cot = rng.randn(1, 2, 4, 4, 8).astype(np.float32)
    module = ev_j.ConvBN3d(8)
    variables = _numpy(module.init(jax.random.PRNGKey(2), x))
    variables["params"]["bn"]["scale"] = rng.normal(1, 0.1, 8).astype(np.float32)
    variables["params"]["bn"]["bias"] = rng.normal(0, 0.1, 8).astype(np.float32)
    variables["batch_stats"]["bn"]["mean"] = rng.normal(0, 0.1, 8).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)

    def apply_j(params, x):
        y, mutated = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  x, train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mutated["batch_stats"]["bn"])

    (_, (y_j, stats_j)), (g_params, g_x) = jax.value_and_grad(
        apply_j, argnums=(0, 1), has_aux=True)(variables["params"], x)

    conv = ev_t.ConvBN3d(8, 8)
    bn = conv[1]
    with torch.no_grad():
        conv[0].weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(variables["params"]["conv"]["kernel"], (4, 3, 0, 1, 2)))))
        bn.weight.copy_(torch.from_numpy(variables["params"]["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["var"]))
    plain = torch.nn.BatchNorm3d(8, eps=1e-5)
    plain.load_state_dict(bn.state_dict())
    conv.train()
    xt = _ncdhw(x).requires_grad_()
    y_t = conv(xt)
    (y_t * _ncdhw(cot)).sum().backward()
    np.testing.assert_allclose(np.moveaxis(y_t.detach().numpy(), 1, -1), np.asarray(y_j),
                               atol=1e-5)
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), np.asarray(g_x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv[0].weight.grad.numpy(),
                               np.transpose(np.asarray(g_params["conv"]["kernel"]),
                                            (4, 3, 0, 1, 2)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(g_params["bn"]["scale"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(g_params["bn"]["bias"]),
                               rtol=1e-5, atol=1e-5)
    for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(buf.numpy(), np.asarray(stats_j[key]), rtol=1e-6, atol=1e-7,
                                   err_msg=key)

    # nn.BatchNorm3d on the same convolution output misses the variance bar.
    plain.train()
    with torch.no_grad():
        plain(conv[0](_ncdhw(x)))
    var_rel = np.abs(plain.running_var.numpy() - np.asarray(stats_j["var"])).max() \
        / np.abs(np.asarray(stats_j["var"])).max()
    assert var_rel > 1e-4, var_rel


# --------------------------------------------------------------------------- the head


@pytest.mark.parametrize("depth", [8, 16], ids=["D8", "D16_resampled"])
def test_head_train_mode_matches_jax(head_variables, depth):
    """The head in train mode on a fixed probability volume at 16x16,
    maxdisp 8: outputs, the gradient of ``loss_emvsnet`` in every head
    parameter, every updated BN statistic.  At D=16 the volume and the depth
    values are resampled onto maxdisp, as ``dtu_train``'s 128 -> 32."""
    rng = np.random.RandomState(6)
    logits = (2.0 * rng.randn(1, depth, H, W)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    dvals = np.linspace(425.0, 425.0 + 5.0 * (depth - 1), depth, dtype=np.float32)[None]
    gt = rng.uniform(425.0, 425.0 + 5.0 * (depth - 1), (1, H, W)).astype(np.float32)
    mask = (rng.rand(1, H, W) > 0.2).astype(np.float32)
    head_j = ev_j.EvidentialHead(maxdisp=MAXDISP)

    def loss_j(params):
        ev, mutated = head_j.apply({"params": params, "batch_stats": head_variables["batch_stats"]},
                                   jnp.asarray(prob), jnp.asarray(dvals), train=True,
                                   mutable=["batch_stats"])
        loss = ev_j.loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"],
                                 jnp.asarray(gt), jnp.asarray(mask))
        return loss, (ev, mutated["batch_stats"])

    (_, (ev_want, stats_j)), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        head_variables["params"])
    want = evidential_params_from_jax(_numpy({"params": grads_j, "batch_stats": stats_j}))

    def port(nudge: bool):
        head = _port_head(head_variables).train()
        if nudge:
            _nudge(head)
        ev = head(torch.from_numpy(prob), torch.from_numpy(dvals))
        ev_t.loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"],
                          torch.from_numpy(gt), torch.from_numpy(mask)).backward()
        return head, {k: ev[k].detach().numpy() for k in HEAD_BARS}

    head, outputs = port(False)
    nudged_head, nudged_outputs = port(True)
    _assert_calibrated(outputs, nudged_outputs, {k: ev_want[k] for k in HEAD_BARS}, HEAD_BARS,
                       "output", scale_floor=None)
    _assert_calibrated(_grads(head), _grads(nudged_head),
                       {name: want[name].numpy() for name, _ in head.named_parameters()},
                       2e-4, "gradient")
    _assert_stats(head, want)


# --------------------------------------------------------------------------- the whole path


def _state_j(core_tree, head_variables) -> dict:
    return {"core": core_tree, "head": head_variables["params"],
            "batch_stats": head_variables["batch_stats"]}


@pytest.mark.parametrize("variance", ["flax", "two_pass"])
def test_whole_path_matches_jax(core_tree, head_variables, variance, monkeypatch):
    """JAX ``evidential_loss_fn`` against the port's at 16x16, V=3, D=8,
    maxdisp 8, depth_block 2, remat: the loss, every core and head gradient
    and the BN statistics after the step.  ``two_pass``: flax's BatchNorm
    takes its variance as E[(x - E[x])^2], as torch does."""
    if variance == "two_pass":
        import flax.linen.normalization as normalization

        fast = normalization._compute_stats
        monkeypatch.setattr(normalization, "_compute_stats",
                            lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))
    batch = _batch(D=8, seed=5)
    state = _state_j(core_tree, head_variables)
    (loss_j, (stats_j, _)), grads_j = jax.jit(jax.value_and_grad(
        lambda trainable, stats, batch: evidential_loss_fn_j(trainable, stats, batch, CONFIG_J,
                                                             CONFIG_J.sweep()),
        has_aux=True))({"core": state["core"], "head": state["head"]}, state["batch_stats"],
                       batch)
    grads_core = params_from_jax(_numpy(grads_j["core"]))
    want_head = evidential_params_from_jax(_numpy({"params": grads_j["head"],
                                                   "batch_stats": stats_j}))

    config = TrainConfig(depth_block=2, evidential=True, maxdisp=MAXDISP, device="cpu")

    def port(nudge: bool):
        core, head = _port_core(core_tree).train(), _port_head(head_variables).train()
        if nudge:
            _nudge(core, head)
        loss, _ = evidential_loss_fn(core, head, _torch_batch(batch), config,
                                     config.sweep(remat=True))
        loss.backward()
        return loss.item(), core, head

    loss, core, head = port(False)
    _, nudged_core, nudged_head = port(True)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5 if variance == "flax" else 1e-6)
    _assert_calibrated(_grads(core), _grads(nudged_core),
                       {k: v.numpy() for k, v in grads_core.items()}, 2e-4, "core gradient")
    _assert_calibrated(_grads(head), _grads(nudged_head),
                       {name: want_head[name].numpy() for name, _ in head.named_parameters()},
                       2e-4, "head gradient")
    _assert_stats(head, want_head)
    assert core.feature.conv2[0].weight.grad.abs().max() > 0


def test_eval_step_matches_jax(core_tree, head_variables):
    """``eval_step`` with a head against JAX ``make_evidential_eval_step``:
    the head in eval mode (running statistics untouched), loss rtol 1e-5,
    the error of gamma rtol 1e-5, the threshold rates within one pixel."""
    batch = _batch(D=8, seed=6)
    want = make_evidential_eval_step(CONFIG_J)(_state_j(core_tree, head_variables), batch)
    core, head = _port_core(core_tree), _port_head(head_variables)
    stats_before = {k: v.clone() for k, v in head.state_dict().items()}
    config = TrainConfig(depth_block=2, evidential=True, maxdisp=MAXDISP, device="cpu")
    got = eval_step(core, _torch_batch(batch), config, head)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["abs_depth_error"]), float(want["abs_depth_error"]),
                               rtol=1e-5)
    for tau in (2, 4, 8, 16, 32):
        key = f"thres{tau}mm_error"
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1.0 / (H * W),
                                   err_msg=key)
    assert not head.training
    for k, v in head.state_dict().items():
        torch.testing.assert_close(v, stats_before[k], rtol=0, atol=0, msg=k)


# --------------------------------------------------------------------------- the loop


def test_loss_falls_and_core_head_and_statistics_change(core_tree, head_variables):
    """Six ``train_step`` calls on one batch (JAX ``tests/test_train.py``'s
    ``test_loss_decreases_and_both_subtrees_update``)."""
    config = TrainConfig(learning_rate=1e-3, total_steps=100, depth_block=2, evidential=True,
                         maxdisp=MAXDISP, device="cpu")
    core, head = _port_core(core_tree), _port_head(head_variables)
    before = {**core.state_dict(), **{HEAD_PREFIX + k: v for k, v in head.state_dict().items()}}
    before = {k: v.clone() for k, v in before.items()}
    optimizer, scheduler = make_optimizer(trainable_parameters(core, head), config,
                                          config.total_steps)
    batch = _torch_batch(_batch(D=8, seed=5))
    losses = []
    for _ in range(6):
        metrics, images = train_step(core, optimizer, scheduler, batch, config, head)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], f"no learning: {losses}"
    assert {"loss", "abs_depth_error", "loss_components/nu", "loss_components/alpha",
            "loss_components/beta"} == metrics.keys()
    for k in ("depth_est", "error_map", "alea_1", "epis_1", "alea_2", "epis_2"):
        assert images[k].shape == (1, H, W) and torch.isfinite(images[k]).all(), k

    def changed(prefix, kinds):
        return any(not torch.equal(v, before[prefix + k]) for k, v in kinds)

    assert changed("", core.named_parameters()), "no gradient reached the core"
    assert changed(HEAD_PREFIX, head.named_parameters()), "no gradient reached the head"
    assert changed(HEAD_PREFIX, ((k, v) for k, v in head.named_buffers()
                                 if k.endswith("running_var"))), "BN stats did not update"


def test_checkpoint_and_resume_with_the_head(core_tree, head_variables, tmp_path):
    """``run_training`` with a head, stopped after step 3 of 4 and resumed
    into a fresh core and head: step 4's loss, every weight and every BN
    statistic equal the uninterrupted run's bit for bit.  The checkpoint
    holds the core's keys and the head's under ``evidential.``, and loads
    strictly with both loaders."""
    dataset = _samples(_batch(B=2, D=8, seed=7))
    config = TrainConfig(epochs=2, depth_block=2, num_workers=0, evidential=True,
                         maxdisp=MAXDISP, device="cpu")
    whole_core, whole_head = _port_core(core_tree), _port_head(head_variables)
    full = run_training(whole_core, dataset, config, val_dataset=dataset, head=whole_head)
    assert full["step"] == 4 and np.isfinite(full["losses"]).all()
    assert 0.0 <= full["val"]["thres2mm_error"] <= 1.0 and np.isfinite(full["val"]["loss"])

    logdir = str(tmp_path / "run")
    first = run_training(_port_core(core_tree), dataset,
                         TrainConfig(**{**config.__dict__, "logdir": logdir, "max_steps": 3}),
                         head=_port_head(head_variables))
    assert first["losses"] == full["losses"][:3] and latest_step(logdir) == 3

    core, head = AARMVSNetCore(), EvidentialHead(MAXDISP)  # fresh: everything restored
    resumed = run_training(core, dataset,
                           TrainConfig(**{**config.__dict__, "logdir": logdir, "resume": True}),
                           head=head)
    assert resumed["start_step"] == 3 and resumed["step"] == 4
    assert resumed["losses"] == full["losses"][3:]
    for a, b in ((whole_core, core), (whole_head, head)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(x, y, atol=0, rtol=0, msg=name)

    path = checkpoint_path(logdir, 4)
    keys = torch.load(path, weights_only=True)["model"].keys()
    assert {k for k in keys if not k.startswith(HEAD_PREFIX)} == core.state_dict().keys()
    assert {k.removeprefix(HEAD_PREFIX) for k in keys if k.startswith(HEAD_PREFIX)} \
        == head.state_dict().keys()
    loaded_core = load_reference_checkpoint(AARMVSNetCore(), path)
    loaded_head = load_evidential_checkpoint(EvidentialHead(MAXDISP), path)
    for a, b in ((loaded_core, core), (loaded_head, head)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(x, y, atol=0, rtol=0, msg=name)


def test_head_and_config_must_agree():
    dataset = _samples(_batch(D=8))
    with pytest.raises(ValueError, match="needs an evidential head"):
        run_training(AARMVSNetCore(), dataset, TrainConfig(evidential=True, device="cpu"))
    with pytest.raises(ValueError, match="needs an evidential head"):
        run_training(AARMVSNetCore(), dataset, TrainConfig(device="cpu"),
                     head=EvidentialHead(MAXDISP))
    with pytest.raises(ValueError, match="maxdisp"):
        run_training(AARMVSNetCore(), dataset, TrainConfig(evidential=True, device="cpu"),
                     head=EvidentialHead(MAXDISP))
