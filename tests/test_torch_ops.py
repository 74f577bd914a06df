"""Tensor ops of the PyTorch port against the JAX package, on the CPU.

Same numpy inputs (seeded) through both; the port takes NCHW where its
modules do and NHWC where the JAX function's public shape is NHWC.  Bars:
coordinates atol 1e-4 px (the two packages invert the 4x4 projection with
different fp32 LU code), bilinear samples atol 1e-5, the deformable conv
atol 1e-4 (its 9 taps are summed in another order), resize atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.ops import deform as deform_j
from aa_rmvsnet_tpu.ops import homography as homography_j
from aa_rmvsnet_tpu.ops import patch_sample as patch_j
from aa_rmvsnet_tpu.ops.resize import resize_bilinear_align_corners as resize_j
from aa_rmvsnet_tpu_torch.ops import deform, homography, patch_sample
from aa_rmvsnet_tpu_torch.ops.resize import resize_bilinear_align_corners

from test_models import _random_scene, _rotated_scene

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("scene", [_random_scene, _rotated_scene])
def test_plane_sweep_coordinates(scene):
    _, proj, depths = scene(B=2, V=3, H=16, W=20, D=6, seed=3)
    for v in (1, 2):
        rot_j, tr_j = homography_j.homography_terms(
            jnp.asarray(proj[:, v]), jnp.asarray(proj[:, 0]), 16, 20)
        x_j, y_j = homography_j.plane_sweep_xy(rot_j, tr_j, jnp.asarray(depths))
        rot_t, tr_t = homography.homography_terms(
            _t(proj[:, v]), _t(proj[:, 0]), 16, 20)
        x_t, y_t = homography.plane_sweep_xy(rot_t, tr_t, _t(depths))
        assert x_t.shape == (2, 6, 16 * 20) and x_t.dtype == torch.float32
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-4)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4)


def test_zero_denominator_guard():
    """A point on the source camera plane gets z + 1e-4, not inf/NaN."""
    rot = torch.tensor([[[1.0], [2.0], [0.0]]])  # (B=1, 3, N=1), z-term 0
    trans = torch.zeros(1, 3, 1)
    x, y = homography.plane_sweep_xy(rot, trans, torch.tensor([[5.0]]))
    np.testing.assert_allclose([x.item(), y.item()], [5.0 / 1e-4, 10.0 / 1e-4],
                               rtol=1e-6)


def test_patch_table_matches():
    feat = np.random.RandomState(0).randn(2, 7, 9, 5).astype(np.float32)
    np.testing.assert_array_equal(
        patch_sample.build_patch_table(_t(feat)).numpy(),
        np.asarray(patch_j.build_patch_table(jnp.asarray(feat))))


def test_patch_bilinear_sample_matches_with_borders():
    """Inside, straddling every border, fully outside, exact integer and
    edge coordinates: same samples, zero outside, no NaN."""
    rng = np.random.RandomState(1)
    B, H, W, C = 2, 7, 9, 8
    feat = rng.randn(B, H, W, C).astype(np.float32)
    x = rng.uniform(-2.5, W + 1.5, (B, 300)).astype(np.float32)
    y = rng.uniform(-2.5, H + 1.5, (B, 300)).astype(np.float32)
    edges_x = np.array([0, W - 1, -1, W, -0.5, W - 0.5, 3, 1e6, -1e6], np.float32)
    edges_y = np.array([H - 1, 0, 2, -1, H - 0.5, -0.5, H, 3, 3], np.float32)
    x = np.concatenate([x, np.tile(edges_x, (B, 1))], axis=1)
    y = np.concatenate([y, np.tile(edges_y, (B, 1))], axis=1)

    table_j = patch_j.build_patch_table(jnp.asarray(feat))
    out_j = np.asarray(patch_j.patch_bilinear_sample(
        table_j, jnp.asarray(x), jnp.asarray(y), H, W))
    table_t = patch_sample.build_patch_table(_t(feat))
    out_t = patch_sample.patch_bilinear_sample(table_t, _t(x), _t(y), H, W).numpy()
    assert out_t.shape == (B, x.shape[1], C) and np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    far = (x < -1) | (x > W) | (y < -1) | (y > H)
    assert far.any() and np.all(out_t[far] == 0.0)


def test_deform_conv_matches_with_perturbed_offsets():
    rng = np.random.RandomState(2)
    B, H, W, C, O = 2, 8, 12, 6, 5
    x = rng.randn(B, H, W, C).astype(np.float32)
    offset = (1.5 * rng.randn(B, H, W, 18)).astype(np.float32)
    modulation = (1.0 / (1.0 + np.exp(-rng.randn(B, H, W, 9)))).astype(np.float32)
    kernel = (0.2 * rng.randn(3, 3, C, O)).astype(np.float32)  # HWIO
    bias = rng.randn(O).astype(np.float32)

    out_j = np.asarray(deform_j.deform_conv(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(modulation),
        jnp.asarray(kernel), jnp.asarray(bias)))
    oracle = np.asarray(deform_j.deform_conv_apply(
        deform_j.deform_sample(jnp.asarray(x), jnp.asarray(offset),
                               jnp.asarray(modulation)),
        jnp.asarray(kernel), jnp.asarray(bias)))
    nchw = lambda a: _t(a).permute(0, 3, 1, 2).contiguous()
    out_t = deform.deform_conv(
        nchw(x), nchw(offset), nchw(modulation),
        _t(kernel).permute(3, 2, 0, 1).contiguous(), _t(bias),
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-4)
    np.testing.assert_allclose(out_t, oracle, atol=1e-4)


@pytest.mark.parametrize("scale", [2, 4])
def test_resize_align_corners_matches(scale):
    x = np.random.RandomState(3).randn(2, 5, 7, 4).astype(np.float32)
    out_j = np.asarray(resize_j(jnp.asarray(x), 5 * scale, 7 * scale))
    out_t = resize_bilinear_align_corners(
        _t(x).permute(0, 3, 1, 2), 5 * scale, 7 * scale).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5)
