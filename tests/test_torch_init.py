"""The port's fresh weights against the JAX package's init, on the CPU.

A fresh ``AARMVSNetCore()`` must draw what JAX ``init_params(PRNGKey(0))``
draws, and a fresh ``EvidentialHead()`` what ``init_evidential(PRNGKey(1))``
draws (the JAX CLI's ``train`` and ``train --evidential`` starts).  Both
cross to the flax layout through the JAX package's own converters, leaf by
leaf:

- zeros exactly where JAX has zeros (every bias, the deformable convs'
  ``p_conv`` and ``m_conv`` kernels and biases, BN means);
- GroupNorm / BatchNorm scales and BN variances equal (1);
- every other kernel lecun-normal: ``rms(w) / sqrt(1 / fan_in)`` within five
  standard errors of 1 (the standard error of a truncated-at-2 normal's rms
  over n draws is 0.584 / sqrt(n), from its kurtosis 2.366), pooled over all
  kernels too, and no ``|w|`` past the truncation, ``2.2737 sqrt(1 /
  fan_in)``.  JAX's own draws pass the same checks.

PyTorch's default init fails them: its biases are not zero and its
kaiming-uniform kernels have ``rms / sqrt(1 / fan_in)`` of 1/sqrt(3).
"""

import jax
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import network as network_j
from aa_rmvsnet_tpu.models.convert import convert_evidential_state_dict, convert_state_dict
from aa_rmvsnet_tpu.models.evidential import init_evidential
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead

TRUNCATION = 2.0 / 0.87962566103423978
RMS_STD_ERROR = 0.584  # times 1 / sqrt(n)


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def trees():
    core_j = jax.jit(network_j.init_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), 32, 32)
    head_j = jax.jit(init_evidential)(jax.random.PRNGKey(1))
    torch.manual_seed(0)
    core_t = convert_state_dict({k: v.numpy() for k, v in AARMVSNetCore().state_dict().items()})
    head_t = convert_evidential_state_dict(
        {k: v.numpy() for k, v in EvidentialHead().state_dict().items()})
    return {"core": (_flat(core_j), _flat(core_t)), "head": (_flat(head_j), _flat(head_t))}


@pytest.mark.parametrize("net", ["core", "head"])
def test_zeros_and_norms_equal_jax(trees, net):
    jax_leaves, port_leaves = trees[net]
    assert port_leaves.keys() == jax_leaves.keys()
    zeros = 0
    for name, want in jax_leaves.items():
        got = port_leaves[name]
        assert got.shape == want.shape and got.dtype == np.float32, name
        if not want.any() or not name.endswith("['kernel']"):
            np.testing.assert_array_equal(got, want, err_msg=name)
            zeros += not want.any()
        else:
            assert got.any(), name
    if net == "core":
        # 3 deform convs x (p_conv, m_conv) x (kernel, bias), and every
        # other bias and GroupNorm bias
        assert sum(not v.any() for k, v in jax_leaves.items() if "p_conv" in k or "m_conv" in k) == 12
    assert zeros > 0


@pytest.mark.parametrize("net", ["core", "head"])
def test_kernels_are_lecun_normal(trees, net):
    pooled = {"jax": [], "port": []}
    for name, want in trees[net][0].items():
        if not name.endswith("['kernel']") or not want.any():
            continue
        sigma = np.sqrt(1.0 / np.prod(want.shape[:-1]))  # (*k, C_in, C_out)
        for who, leaf in (("jax", want), ("port", trees[net][1][name])):
            unit = leaf.astype(np.float64) / sigma
            rms = np.sqrt(np.mean(unit**2))
            assert abs(rms - 1.0) <= 5 * RMS_STD_ERROR / np.sqrt(unit.size), (who, name, rms)
            assert np.abs(unit).max() <= TRUNCATION * (1 + 1e-6), (who, name)
            pooled[who].append(unit.ravel())
    for who, units in pooled.items():
        unit = np.concatenate(units)
        rms = np.sqrt(np.mean(unit**2))
        assert abs(rms - 1.0) <= 5 * RMS_STD_ERROR / np.sqrt(unit.size), (who, rms)
        assert abs(np.mean(unit)) <= 5 * 0.8796 / np.sqrt(unit.size), who


@pytest.mark.parametrize("net", [AARMVSNetCore, EvidentialHead], ids=["core", "head"])
def test_generator_makes_the_draw_reproducible(net):
    a, b = (net(generator=torch.Generator().manual_seed(3)).state_dict() for _ in range(2))
    c = net(generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
