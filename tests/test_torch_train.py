"""The PyTorch port's training path against the JAX package, on the CPU.

Loss, whole-path parameter gradients (BPTT through the remat sweep),
Adam with the cosine schedule, the train and eval steps, and checkpoint
resume.  Weights come from the JAX package's ``init_params`` through
``params_from_jax``; that map is linear, so it also carries JAX's gradient
tree onto the port's parameter names.  Gradient bar: the normalised one of
``tests/test_train.py:246-249`` (each tensor divided by
max(|g_jax|, 1e-3), atol 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aa_rmvsnet_tpu.models import init_params
from aa_rmvsnet_tpu.models.losses import depth_classification_loss as loss_j
from aa_rmvsnet_tpu.models.network import SweepConfig as SweepConfigJ
from aa_rmvsnet_tpu.pipeline.train import TrainConfig as TrainConfigJ
from aa_rmvsnet_tpu.pipeline.train import loss_fn as loss_fn_j
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, SweepConfig, load_reference_checkpoint
from aa_rmvsnet_tpu_torch.models import params_from_jax
from aa_rmvsnet_tpu_torch.models.losses import depth_classification_loss
from aa_rmvsnet_tpu_torch.pipeline.checkpoint import checkpoint_path, latest_step
from aa_rmvsnet_tpu_torch.pipeline.train import (
    TrainConfig,
    clip_by_global_norm,
    cosine_decay,
    eval_step,
    loss_fn,
    make_optimizer,
    run_training,
    train_step,
)

from test_torch_models import jax_params
from test_train import _batch

torch.set_num_threads(2)


# One jitted program serves both whole-path cases (eager tracing of the
# remat sweep's gradient is several times slower than its compile).
_value_and_grad_j = jax.jit(jax.value_and_grad(
    lambda params, batch: loss_fn_j(params, batch, SweepConfigJ(depth_block=2, remat=True))[0]
))


def _model(tree) -> AARMVSNetCore:
    net = AARMVSNetCore()
    net.load_state_dict(params_from_jax(tree), strict=True)
    return net


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _samples(batch) -> list[dict]:
    """The batch's samples as ``DTUTrainDataset``-style numpy dicts."""
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    B = arrays["imgs"].shape[0]
    return [{k: v[b] for k, v in arrays.items()} for b in range(B)]


def test_loss_matches_jax():
    rng = np.random.RandomState(0)
    B, D, H, W = 2, 8, 12, 10
    logits = rng.randn(B, D, H, W).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    depth_values = np.linspace(400, 600, D, dtype=np.float32)[None].repeat(B, 0)
    gt = rng.uniform(380, 620, (B, H, W)).astype(np.float32)
    mask = (rng.rand(B, H, W) > 0.3).astype(np.float32)
    lj, wj = loss_j(*(jnp.asarray(a) for a in (prob, gt, mask, depth_values)))
    lt, wt = depth_classification_loss(*(torch.from_numpy(a) for a in (prob, gt, mask, depth_values)))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("offsets", ["jax_init", "perturbed"])
def test_whole_path_gradients_match_jax(offsets):
    """Loss and every parameter gradient of one remat training forward.
    At the JAX init every deformable offset is exactly zero, so every
    deform sample sits on the tent's kinks."""
    tree = (jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(1), 16, 16))
            if offsets == "jax_init" else jax_params(seed=1, size=16))
    batch = _batch(seed=3)
    loss_value_j, grads_j = _value_and_grad_j(tree, batch)
    grads_j = params_from_jax(jax.tree.map(np.asarray, grads_j))

    model = _model(tree)
    loss, _ = loss_fn(model, _torch_batch(batch), SweepConfig(depth_block=2, remat=True))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_value_j), rtol=1e-5)
    for name, p in model.named_parameters():
        g_j = grads_j[name].numpy()
        scale = max(np.abs(g_j).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / scale, g_j / scale, atol=2e-4,
                                   err_msg=name)
    # FeatNet's gradient reaches it only through the patch tables and the
    # reference features that each checkpointed block captures.
    assert model.feature.conv2[0].weight.grad.abs().max() > 0


def test_remat_matches_no_remat_gradients():
    tree = jax_params(seed=2, size=16)
    batch = _torch_batch(_batch(seed=3))
    grads = []
    for remat in (True, False):
        model = _model(tree)
        loss, _ = loss_fn(model, batch, SweepConfig(depth_block=2, remat=remat))
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], atol=1e-5, rtol=0, msg=name)


def test_adam_and_schedule_match_optax():
    """Identical gradients through ``optax.adam(cosine_decay_schedule)``
    and the port's optimizer for 5 steps: parameters atol 1e-6."""
    T, lr, lr_min = 10, 1e-3, 2e-6
    rng = np.random.RandomState(5)
    shapes = [(4, 3, 3, 3), (7,), (2, 5)]
    params0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grad_steps = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(5)]

    tx = optax.adam(optax.cosine_decay_schedule(lr, T, alpha=lr_min / lr))
    params_j = [jnp.asarray(p) for p in params0]
    state = tx.init(params_j)
    for grads in grad_steps:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, params_j)
        params_j = optax.apply_updates(params_j, updates)

    params_t = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    optimizer, scheduler = make_optimizer(
        params_t, TrainConfig(learning_rate=lr, lr_min=lr_min), total_steps=T)
    for grads in grad_steps:
        for p, g in zip(params_t, grads):
            p.grad = torch.from_numpy(g)
        optimizer.step()
        scheduler.step()
    for a, b in zip(params_t, params_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_grad_clip_matches_optax(max_norm):
    rng = np.random.RandomState(7)
    grads = [rng.randn(*s).astype(np.float32) for s in [(4, 3), (7,), (2, 2, 2)]]
    clipped_j, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_by_global_norm(params, max_norm)
    for p, g in zip(params, clipped_j):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-6, atol=1e-7)


def test_schedule_matches_optax_cosine_decay():
    """The rate at t in {0, 1, T/2, T-1, T}, rel 1e-6.  optax is evaluated
    in float64: in float32 its ``1 + cos(pi t / T)`` cancels near t = T
    and is off by 6e-6 relative at T - 1."""
    T, lr, lr_min = 100, 1e-3, 2e-6
    schedule = optax.cosine_decay_schedule(lr, T, alpha=lr_min / lr)
    param = torch.nn.Parameter(torch.zeros(1))
    optimizer, scheduler = make_optimizer([param], TrainConfig(learning_rate=lr, lr_min=lr_min),
                                          total_steps=T)
    for t in range(T + 1):
        if t in (0, 1, T // 2, T - 1, T):
            with jax.enable_x64():
                expected = float(schedule(jnp.asarray(t, jnp.int64)))
            np.testing.assert_allclose(optimizer.param_groups[0]["lr"], expected, rtol=1e-6)
            np.testing.assert_allclose(lr * cosine_decay(t, T, lr_min / lr), expected, rtol=1e-6)
        optimizer.step()
        scheduler.step()


def test_loss_decreases_overfitting_one_batch():
    config = TrainConfig(learning_rate=3e-3, total_steps=100, depth_block=2, device="cpu")
    model = _model(jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), 16, 16)))
    optimizer, scheduler = make_optimizer(model.parameters(), config, config.total_steps)
    batch = _torch_batch(_batch())
    losses = []
    for _ in range(8):
        metrics, images = train_step(model, optimizer, scheduler, batch, config)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"no learning: {losses}"
    assert images["depth_est"].shape == (1, 16, 16)


def test_eval_step_metrics():
    model = _model(jax_params(seed=0, size=16))
    metrics = eval_step(model, _torch_batch(_batch(seed=2)), TrainConfig(depth_block=2))
    for k in ("loss", "abs_depth_error", "thres2mm_error", "thres32mm_error"):
        assert np.isfinite(float(metrics[k])), k
    for tau in (2, 4, 8, 16, 32):
        assert 0.0 <= float(metrics[f"thres{tau}mm_error"]) <= 1.0


def test_resume_continues_the_uninterrupted_run_exactly(tmp_path):
    """Stop after step 3 of 4 (mid-epoch), restore into a fresh model and
    optimizer: step 4's loss and the final parameters equal those of the
    run that never stopped, bit for bit (its validation passes leave the
    weights alone).  The checkpoint's ``model`` loads with the reference
    loader (strict)."""
    tree = jax_params(seed=3, size=16)
    dataset = _samples(_batch(B=2, seed=6))
    config = TrainConfig(epochs=2, depth_block=2, num_workers=0, device="cpu")

    whole = _model(tree)
    full = run_training(whole, dataset, config, val_dataset=dataset)
    assert full["step"] == 4 and len(full["losses"]) == 4
    assert 0.0 <= full["val"]["thres2mm_error"] <= 1.0 and np.isfinite(full["val"]["loss"])

    logdir = str(tmp_path / "run")
    first = run_training(_model(tree), dataset,
                         TrainConfig(**{**config.__dict__, "logdir": logdir, "max_steps": 3}))
    assert first["losses"] == full["losses"][:3]
    assert latest_step(logdir) == 3

    resumed_model = AARMVSNetCore()  # a fresh init: every weight restored
    resumed = run_training(resumed_model, dataset,
                           TrainConfig(**{**config.__dict__, "logdir": logdir, "resume": True}))
    assert resumed["start_step"] == 3 and resumed["step"] == 4
    assert resumed["losses"] == full["losses"][3:]
    for (name, a), b in zip(whole.named_parameters(), resumed_model.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)

    loaded = load_reference_checkpoint(AARMVSNetCore(), checkpoint_path(logdir, 4))
    for a, b in zip(loaded.parameters(), resumed_model.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_unported_train_options_are_refused():
    """bf16 and folded omega are ported and reach the sweep; what neither
    the JAX package nor the port takes is refused: another feature dtype,
    another fold, a mesh that is no ``parallel.mesh.Mesh``."""
    sweep = TrainConfig(feature_dtype=torch.bfloat16, fold_omega="hybrid").sweep()
    assert (sweep.feature_dtype, sweep.fold_omega, sweep.remat) == (torch.bfloat16, "hybrid",
                                                                    True)
    assert TrainConfig(fold_omega=True).sweep(remat=False).fold_omega is True
    for option, error in (({"feature_dtype": torch.float16}, ValueError),
                          ({"fold_omega": "folded"}, ValueError),
                          ({"fold_omega": 1}, ValueError),
                          ({"mesh": object()}, TypeError)):
        with pytest.raises(error, match="TrainConfig"):
            TrainConfig(**option)


def test_evidential_config_has_the_jax_defaults():
    config, want = TrainConfig(evidential=True), TrainConfigJ(evidential=True)
    assert (config.maxdisp, config.evidential_weight_reg) \
        == (want.maxdisp, want.evidential_weight_reg) == (32, 0.1)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(AARMVSNetCore(), _samples(_batch()), TrainConfig())
