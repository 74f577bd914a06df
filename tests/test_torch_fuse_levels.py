"""The fusion kernel's exact rewrite of the level test, on the CPU.

``csrc/fusion_core.cu`` does not test ``dist < i / dist_base and rel < i /
rel_base`` as the C++ core and the plain version
(``ops/fusion.py:fuse_ref_reference``) do.  It compares the squared
distance with ``S(i / dist_base)`` (``ops/fusion.py:dist_sq_threshold``: no
square root), and tests no level where the relative difference misses the
loosest relative threshold; ``ops/fusion.py:kernel_levels`` builds these
constants on the host.  Here:

- ``sqrt(s) < t`` and ``s < S(t)`` agree at ``S(t)``, at its neighbours
  within 4 ulps and on 10^6 random ``s``, at several ``dist_base`` values,
  and where ``t * t`` leaves the normal range;
- the kernel's test (written below in numpy) against the per-level loop,
  for 1, 9 and 16 levels, on random values, values at each threshold and
  one ulp either side, 0, inf, NaN and negative relative differences (a
  negative reference depth), with rising and falling relative thresholds;
- the kernel's test on the plain version's own distances and relative
  differences against its counts, on a plane and on inputs with every
  special depth;
- what the wrapper hands the kernel, built on the CPU: the thresholds in
  order (``ops/fusion.py:kernel_levels``), the ``FuseLevels`` layout, and
  the refusals of ``ops/fusion.py:check_kernel_inputs``.
- the operation count of the kernel's bound
  (``ops/fusion.py:fp64_operations``).

The kernel itself is held to the plain version bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 7).
"""

import ctypes

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu_torch.ops import fusion
from aa_rmvsnet_tpu_torch.utils.synthetic import fusion_edge_case, plane_cameras

LEVELS = (1, 9, 16)
BASES = [(4.0, 1300.0), (1.0, 300.0), (4.0, -1300.0)]


def kernel_test(sq: np.ndarray, rel: np.ndarray, levels) -> np.ndarray:
    """``fusion_core.cu``'s level test: ``(num_levels, ...)`` passes of
    squared distances ``sq`` and relative differences ``rel``."""
    nl = levels.num_levels
    tested = rel < levels.rel_max  # elsewhere the kernel skips the levels
    return np.stack([tested & (sq < levels.dist_sq[i]) & (rel < levels.rel[i])
                     for i in range(nl)])


def per_level(sq, rel, num_levels, dist_base, rel_base) -> np.ndarray:
    """The plain version's test: ``(num_levels, ...)`` passes."""
    dist = np.sqrt(sq)
    return np.stack([(dist < dt) & (rel < rt) for dt, rt in
                     fusion.level_thresholds(num_levels, dist_base, rel_base)])


def _ulps(x: float, k: int) -> float:
    for _ in range(abs(k)):
        x = np.nextafter(x, np.inf if k > 0 else -np.inf)
    return float(x)


@pytest.mark.parametrize("dist_base", [4.0, 1.0, 0.5, 3.0, 7.3])
def test_dist_sq_threshold_is_exact(dist_base):
    rng = np.random.RandomState(0)
    random = rng.uniform(0.0, (20.0 / dist_base) ** 2, 10**6)
    for i in range(2, 2 + fusion.MAX_LEVELS):
        t = i / dist_base
        S = fusion.dist_sq_threshold(t)
        near = np.array([_ulps(S, k) for k in range(-4, 5)])
        for s in (near, random):
            np.testing.assert_array_equal(np.sqrt(s) < t, s < S)
        assert np.sqrt(S) >= t > np.sqrt(_ulps(S, -1))


@pytest.mark.parametrize("t, want", [(0.0, 0.0), (-1.0, 0.0), (float("nan"), 0.0),
                                     (float("inf"), float("inf"))])
def test_dist_sq_threshold_without_a_finite_positive_threshold(t, want):
    assert fusion.dist_sq_threshold(t) == want
    s = np.array([0.0, 5e-324, 1.0, 1e300, np.inf, np.nan])
    np.testing.assert_array_equal(np.sqrt(s) < t, s < want)


@pytest.mark.parametrize("t", [1e-170, 1e-160, 1e150, 1.5e154])
def test_dist_sq_threshold_at_the_ends_of_the_range(t):
    """Where t * t underflows into the subnormals or overflows."""
    S = fusion.dist_sq_threshold(t)
    near = np.array([_ulps(S, k) for k in range(-4, 5) if _ulps(S, k) >= 0.0])
    np.testing.assert_array_equal(np.sqrt(near) < t, near < S)


def _level_values(num_levels, dist_base, rel_base):
    """Squared distances and relative differences at every threshold, one ulp
    either side, at the special values and at random, crossed."""
    rng = np.random.RandomState(num_levels)
    thresholds = fusion.level_thresholds(num_levels, dist_base, rel_base)
    sq, rel = [0.0, np.inf, np.nan, 1e-300], [0.0, -0.0, np.inf, -np.inf, np.nan, -1e-3, -5.0]
    for dt, rt in thresholds:
        S = fusion.dist_sq_threshold(dt)
        sq += [_ulps(S, k) for k in (-1, 0, 1)] + [_ulps(dt * dt, k) for k in (-1, 0, 1)]
        rel += [_ulps(rt, k) for k in (-1, 0, 1)]
    top_d, top_r = abs(thresholds[-1][0]), abs(thresholds[-1][1])
    sq = np.concatenate([sq, rng.uniform(0, 2 * top_d, 1000) ** 2])
    rel = np.concatenate([rel, rng.uniform(-top_r, 2 * top_r, 1000)])
    return np.meshgrid(sq, rel, indexing="ij")


@pytest.mark.parametrize("dist_base, rel_base", BASES)
@pytest.mark.parametrize("num_levels", LEVELS)
def test_kernel_level_test_matches_the_per_level_loop(num_levels, dist_base, rel_base):
    sq, rel = (a.reshape(-1) for a in _level_values(num_levels, dist_base, rel_base))
    levels = fusion.kernel_levels(num_levels, dist_base, rel_base)
    want = per_level(sq, rel, num_levels, dist_base, rel_base)
    np.testing.assert_array_equal(kernel_test(sq, rel, levels), want)
    assert want.any() and not want.all()
    assert (~(rel < levels.rel_max)).any()  # the skip is reached


def _plane_case():
    h, w = 37, 53
    cams = plane_cameras(h, w, 5, 300.0, 2.0)
    rng = np.random.RandomState(9)
    depths = (500.0 + 1.5 * rng.randn(5, h, w)).astype(np.float32)
    depths[4] = 0.0
    srcs = [1, 3, 0, 1, 4]
    return depths, 2, srcs, np.stack([fusion.pair_matrices(*cams[2], *cams[s]) for s in srcs])


@pytest.mark.parametrize("case", ["plane", "edges"])
@pytest.mark.parametrize("num_levels", LEVELS)
def test_kernel_level_test_on_the_plain_versions_terms(case, num_levels):
    """The kernel's level test on ``pair_terms``' own distances gives the
    plain version's counts, loose counts and sums, bit for bit."""
    depths, ref, srcs, mats = _plane_case() if case == "plane" else \
        fusion_edge_case(29, 41, 12, seed=3)
    depths = torch.from_numpy(depths)
    levels = fusion.kernel_levels(num_levels, 4.0, 1300.0)
    h, w = depths.shape[1:]
    xg = torch.arange(w, dtype=torch.float64)[None, :].expand(h, w)
    yg = torch.arange(h, dtype=torch.float64)[:, None].expand(h, w)
    counts = np.zeros((num_levels, h, w), np.int32)
    loose = np.zeros((h, w), np.int32)
    reproj_sum = torch.zeros(h, w)
    for s, m in zip(srcs, mats.tolist()):
        _, rel, depth_reproj, xr, yr = fusion.pair_terms(depths[ref], depths[s], m)
        sq = ((xr - xg) * (xr - xg) + (yr - yg) * (yr - yg)).numpy()
        passed = kernel_test(sq, rel.numpy(), levels)
        counts += passed
        loose += passed[-1]
        reproj_sum = reproj_sum + torch.where(torch.from_numpy(passed[-1]),
                                              depth_reproj.float(), 0.0)
    want = fusion.fuse_ref_reference(depths, ref, torch.tensor(srcs, dtype=torch.int32),
                                     torch.from_numpy(mats), num_levels)
    np.testing.assert_array_equal(counts, want[0].numpy())
    np.testing.assert_array_equal(loose, want[1].numpy())
    assert torch.equal(reproj_sum, want[2])
    share = (want[0] > 0).float().mean(dim=(1, 2))
    assert 0.01 < share[0] < 0.99, share


def test_kernel_levels_as_the_kernel_reads_them():
    levels = fusion.kernel_levels(9, 4.0, 1300.0)
    # the thresholds: S(i / 4) and i / 1300 for i in 2..10, zeros past them
    assert levels.num_levels == 9
    assert list(levels.dist_sq[:9]) == [fusion.dist_sq_threshold(i / 4.0) for i in range(2, 11)]
    assert list(levels.rel[:9]) == [i / 1300.0 for i in range(2, 11)]
    assert list(levels.dist_sq[9:]) == list(levels.rel[9:]) == [0.0] * 7
    assert levels.rel_max == 10 / 1300.0


def test_kernel_levels_falling_and_nan_thresholds():
    falling = fusion.kernel_levels(9, 4.0, -1300.0)
    assert list(falling.rel[:9]) == [i / -1300.0 for i in range(2, 11)]
    assert falling.rel_max == 2 / -1300.0
    nan = fusion.kernel_levels(3, float("nan"), float("nan"))
    assert list(nan.dist_sq[:3]) == [0.0] * 3
    assert all(np.isnan(nan.rel[:3])) and nan.rel_max == -np.inf


def test_levels_struct_layout():
    """``KernelLevels`` has the C struct's offsets: an int, then doubles."""
    assert [getattr(fusion.KernelLevels, f).offset for f in
            ("num_levels", "dist_sq", "rel", "rel_max")] == [0, 8, 136, 264]
    assert ctypes.sizeof(fusion.KernelLevels) == 272


@pytest.mark.parametrize("change, error, match", [
    ({"num_src": fusion.MAX_SOURCES + 1}, ValueError, "at most 102"),
    ({"num_levels": 0}, ValueError, "num_levels 0"),
    ({"num_levels": fusion.MAX_LEVELS + 1}, ValueError, "num_levels 17"),
    ({"ref": 6}, ValueError, "reference view 6"),
    ({"mats_dtype": torch.float32}, TypeError, "float64 matrices"),
    ({"mats_cols": 59}, ValueError, r"\(S, 60\)"),
])
def test_kernel_input_refusals(change, error, match):
    """What the kernel cannot take is refused on any device, before a launch;
    ``MAX_SOURCES`` sources of ``(S, 60)`` float64 matrices pass."""
    num_src = change.get("num_src", 3)
    depths = torch.zeros(6, 4, 5)
    index = torch.zeros(num_src, dtype=torch.int32)
    mats = torch.zeros(num_src, change.get("mats_cols", 60),
                       dtype=change.get("mats_dtype", torch.float64))
    with pytest.raises(error, match=match):
        fusion.check_kernel_inputs(depths, change.get("ref", 0), index, mats,
                                   change.get("num_levels", 9))
    if "num_src" in change:  # the largest count passes
        fusion.check_kernel_inputs(depths, 0, index[:-1], mats[:-1])


def test_fp64_operations_count():
    """94 float64 operations a pixel-source and 17 a pixel (the pixel times
    its depth, the reference ray) when every source shares the reference
    intrinsics: 957 a pixel for 10 sources."""
    assert fusion.FP64_OPS_PER_PIXEL_SOURCE == 94
    cams = plane_cameras(8, 10, 11, 2000.0, 2.0)
    mats = np.stack([fusion.pair_matrices(*cams[5], *cams[s]) for s in range(11) if s != 5])
    assert fusion.fp64_operations(80, mats) == 80 * (2 + 15 + 10 * 94)


@pytest.mark.parametrize("num_src, rays", [(1, 1), (3, 2), (12, 2)])
def test_fp64_operations_counts_each_reference_ray(num_src, rays):
    """The reference ray counts once for each distinct kinv_ref (every
    third source of ``fusion_edge_case`` moves the reference's principal
    point)."""
    _, _, _, mats = fusion_edge_case(6, 7, num_src, seed=1)
    assert fusion.fp64_operations(42, mats) == 42 * (2 + 15 * rays + num_src * 94)
