"""The PyTorch port's network against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` with the deformable
convs' ``p_conv`` / ``m_conv`` kernels replaced by seeded noise (sigma 0.1)
in the tree both packages use (zero-initialised they give exactly-zero
offsets, and deform parity would prove nothing); they cross to the port
through ``params_from_jax``.  Bars: modules atol 1e-4 (flax's GroupNorm
takes the variance as E[x^2] - E[x]^2, torch's as E[(x - mean)^2], ~1e-6
apart); the whole ``forward`` is held to the JAX package's own bars for
its numerically transparent levers (``tests/test_models.py:432-442``):
cost volume atol 5e-4, depth atol 1e-3, confidence atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import network as network_j
from aa_rmvsnet_tpu.models.convert import _RULES, convert_state_dict
from aa_rmvsnet_tpu.models.regularizer import init_states as init_states_j
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    SweepConfig,
    extract_features,
    forward,
    load_reference_checkpoint,
    params_from_jax,
    probability_volume,
)
from aa_rmvsnet_tpu_torch.models.regularizer import init_states
from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

from test_models import _random_scene, _rotated_scene

torch.set_num_threads(2)
disable_tf32()  # on a card, cuDNN would run the fp32 convolutions in TF32


def jax_params(seed=0, size=32):
    """JAX init with perturbed deform offset/modulation kernels (numpy).
    The init runs under ``jit``: one compile instead of one per operation
    (~7 s against ~24 s on the CPU), with the same values."""
    init = jax.jit(network_j.init_params, static_argnums=(1, 2))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), size, size))
    rng = np.random.RandomState(100 + seed)
    intra = tree["params"]["feature"]["intraAA"]
    for k in range(3):
        deform = intra[f"deformconv{k}"]["deform"]
        for name in ("p_conv", "m_conv"):
            shape = deform[name]["kernel"].shape
            deform[name]["kernel"] = (0.1 * rng.randn(*shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def model(params):
    net = AARMVSNetCore()
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_weight_bridge_round_trip_is_exact(params):
    state = params_from_jax(params)
    back = convert_state_dict({k: v.numpy() for k, v in state.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_reference_checkpoint_loads_strict(params, tmp_path):
    """The port's keys are the reference torch names, so a reference
    ``.ckpt`` (``{'model': ...}`` with DataParallel prefixes) loads with
    ``strict=True``."""
    net = AARMVSNetCore()
    expected = {f"{prefix}.{leaf}" for prefix, _ in _RULES for leaf in ("weight", "bias")}
    assert set(net.state_dict()) == expected
    assert sum(p.numel() for p in net.parameters()) == 187_203

    state = {"module." + k: v for k, v in params_from_jax(params).items()}
    path = tmp_path / "model.ckpt"
    torch.save({"epoch": 0, "model": state, "optimizer": {}}, path)
    loaded = load_reference_checkpoint(AARMVSNetCore(), path)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, state["module." + k], rtol=0, atol=0)


def test_featnet_matches(params, model):
    imgs = np.random.RandomState(0).randn(1, 2, 16, 24, 3).astype(np.float32)
    feats_j = np.asarray(network_j.extract_features(params, jnp.asarray(imgs)))
    with torch.no_grad():
        feats_t = extract_features(model, torch.from_numpy(imgs)).numpy()
    assert feats_t.shape == (2, 1, 16, 24, 32)
    np.testing.assert_allclose(feats_t, feats_j, atol=1e-4)


def test_inter_view_aa_matches(params, model):
    x = np.abs(np.random.RandomState(1).randn(3, 12, 16, 32)).astype(np.float32)
    w_j = network_j.AARMVSNetCore().apply(
        params, jnp.asarray(x), method=network_j.AARMVSNetCore.omega_weights)
    with torch.no_grad():
        w_t = model.omega(_nchw(x))
    np.testing.assert_allclose(_nhwc(w_t), np.asarray(w_j), atol=1e-4)


def test_unet_convlstm_step_matches(params, model):
    rng = np.random.RandomState(2)
    B, H, W = 1, 12, 16
    x = rng.randn(B, H, W, 32).astype(np.float32)
    states_j = jax.tree.map(
        lambda a: (0.5 * rng.randn(*a.shape)).astype(np.float32),
        init_states_j(B, H, W))
    cost_j, new_j = network_j.AARMVSNetCore().apply(
        params, jnp.asarray(x), states_j, method=network_j.AARMVSNetCore.regularize)
    states_t = tuple((_nchw(h), _nchw(c)) for h, c in states_j)
    zeros = init_states(B, H, W, device="cpu")
    assert [tuple(h.shape) for h, _ in zeros] == [tuple(h.shape) for h, _ in states_t]
    with torch.no_grad():
        cost_t, new_t = model.cost_regularization(_nchw(x), states_t)
    np.testing.assert_allclose(_nhwc(cost_t), np.asarray(cost_j), atol=1e-4)
    for (h_t, c_t), (h_j, c_j) in zip(new_t, new_j):
        np.testing.assert_allclose(_nhwc(h_t), np.asarray(h_j), atol=1e-4)
        np.testing.assert_allclose(_nhwc(c_t), np.asarray(c_j), atol=1e-4)


@pytest.mark.parametrize("scene", [_random_scene, _rotated_scene])
def test_forward_matches(params, model, scene):
    imgs, proj, depths = scene(seed=4) if scene is _random_scene else scene()
    out_j = network_j.forward(
        params, jnp.asarray(imgs), jnp.asarray(proj), jnp.asarray(depths),
        network_j.SweepConfig(depth_block=4, collect_volume=True))
    with torch.no_grad():
        out_t = forward(model, torch.from_numpy(imgs), torch.from_numpy(proj),
                        torch.from_numpy(depths),
                        SweepConfig(depth_block=4, collect_volume=True))
    vol_j = np.asarray(out_j["cost_volume"])
    vol_t = out_t["cost_volume"].numpy()
    assert vol_t.shape == (1, 32, 32, 32)
    np.testing.assert_allclose(vol_t, vol_j, atol=5e-4)
    np.testing.assert_allclose(
        out_t["photometric_confidence"].numpy(),
        np.asarray(out_j["photometric_confidence"]), atol=1e-5)
    np.testing.assert_allclose(
        probability_volume(out_t["cost_volume"]).numpy(),
        np.asarray(network_j.probability_volume(out_j["cost_volume"])), atol=1e-5)

    # Depth: a pixel may flip only on a near-tie, i.e. where the JAX cost
    # volume's top two values lie within 1e-4 (far inside the 5e-4 cost
    # bar); every other pixel must agree to 1e-3.
    depth_t = out_t["depth"].numpy()
    depth_j = np.asarray(out_j["depth"])
    top2 = np.sort(vol_j, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    off = np.abs(depth_t - depth_j) > 1e-3
    assert not np.any(off & ~near_tie), int(np.sum(off & ~near_tie))
    assert off.sum() <= 0.001 * off.size
