"""FeatNet view chunks and the automatic depth block of the port.

``SweepConfig.feature_view_chunk`` (``cli eval --feat_chunk``): FeatNet on
all views as one batch (0, the JAX default) or in chunks, bit for bit the
same features on the CPU, where FeatNet computes each view alone (the JAX
package's own test allows 1e-5, ``tests/test_models.py:570``), and JAX's
``extract_features`` at the module bar of ``tests/test_torch_models.py``
(atol 1e-4).

``depth_block="auto"`` (``utils/config.py:derive_depth_block``): the
JAX package's candidates and rule on the port's own memory estimate,
``sweep_memory_bytes``, which is held here to a count of every tensor
storage the port's ``forward`` allocates (a dispatch mode that adds each
new storage's bytes and subtracts them when it is freed) at 64x96.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from aa_rmvsnet_tpu.models import network as network_j
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.models import (
    AARMVSNetCore,
    SweepConfig,
    extract_features,
    forward,
    params_from_jax,
)
from aa_rmvsnet_tpu_torch.models.network import cast_model
from aa_rmvsnet_tpu_torch.pipeline import infer
from aa_rmvsnet_tpu_torch.utils import config
from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

from scenefix import make_plane_scene
from test_torch_models import jax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    return seeded_model(0)


def _imgs(views=5, batch=2, h=32, w=48):
    return torch.from_numpy(
        np.random.RandomState(7).randn(batch, views, h, w, 3).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 5])
def test_feature_view_chunk_is_exact(model, chunk, dtype):
    """Chunks of 1, 2 (uneven: 2 + 2 + 1), 3 and all 5 views give the
    one-batch features bit for bit, in fp32 and bf16."""
    imgs = _imgs()
    with torch.no_grad():
        full = extract_features(model, imgs, dtype)
        chunked = extract_features(model, imgs, dtype, view_chunk=chunk)
    assert full.shape == (5, 2, 32, 48, 32) and full.dtype == dtype
    assert torch.equal(chunked, full)


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_extract_features_matches_jax(chunk):
    params = jax_params(seed=2)
    net = AARMVSNetCore()
    net.load_state_dict(params_from_jax(params))
    imgs = np.random.RandomState(8).randn(1, 3, 16, 24, 3).astype(np.float32)
    want = np.asarray(network_j.extract_features(params, jnp.asarray(imgs), view_chunk=chunk))
    with torch.no_grad():
        got = extract_features(net.eval(), torch.from_numpy(imgs), view_chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_forward_with_feature_chunks_is_exact(model):
    (sample,) = plane_scene(32, 48, 3, 16, maps=1, seed=4, focal=400.0, baseline=2.0,
                            plane_depth=500.0, depth_min=460.0, depth_interval=5.0)
    args = [torch.from_numpy(sample[k])[None]
            for k in ("imgs", "proj_matrices", "depth_values")]
    with torch.no_grad():
        outs = [forward(model, *args, SweepConfig(depth_block=4, feature_view_chunk=k))
                for k in (0, 1)]
    for key in outs[0]:
        assert torch.equal(outs[0][key], outs[1][key]), key


def test_derive_depth_block_picks():
    """Under the CPU's fixed card (80 GB less 10 %): 8 at dtu_eval and at
    tnt_intermediate_1920; monotone in the budget; the divisibility rule;
    ``eval_preset(depth_block="auto")`` resolves to the estimate's pick."""
    budget = config.memory_budget("cpu")
    assert budget == config.CPU_CARD_BYTES * (1 - config.MEMORY_HEADROOM)
    assert config.memory_budget() == budget  # no card here
    assert config.derive_depth_block(864, 1152, 5, 512, budget) == 8
    assert config.derive_depth_block(1056, 1920, 7, 512, budget) == 8
    picks = [config.derive_depth_block(1056, 1920, 7, 512, b)
             for b in np.geomspace(budget, 1e9, 40)]
    assert picks == sorted(picks, reverse=True) and picks[-1] == 1 and len(set(picks)) == 4
    assert config.derive_depth_block(864, 1152, 5, 12, budget=1e18) == 4
    for name in ("dtu_eval", "tnt_intermediate_1920"):
        cfg = config.eval_preset(name, depth_block="auto")
        assert cfg.depth_block == config.derive_depth_block(cfg.max_h, cfg.max_w, cfg.nviews,
                                                            cfg.ndepths)
    # The estimate grows with size, views, block, the gather pack and the volume.
    base = config.sweep_memory_bytes(864, 1152, 5, 8)
    for grown in (config.sweep_memory_bytes(1056, 1920, 5, 8),
                  config.sweep_memory_bytes(864, 1152, 7, 8),
                  config.sweep_memory_bytes(864, 1152, 5, 16),
                  config.sweep_memory_bytes(864, 1152, 5, 8, gather_pack=2),
                  config.sweep_memory_bytes(864, 1152, 5, 8, collect_volume=True),
                  config.sweep_memory_bytes(864, 1152, 5, 8, bf16=False)):
        assert grown > base


class _LiveBytes(TorchDispatchMode):
    """Peak bytes of the tensor storages created inside the mode."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.seen = set()

    def _free(self, key, n):
        self.live -= n
        self.seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {a.untyped_storage().data_ptr() for a in tree_flatten((args, kwargs))[0]
                  if isinstance(a, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key, n = storage.data_ptr(), storage.nbytes()
            if n == 0 or key in self.seen or key in inputs:
                continue
            self.seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._free, key, n)
        return out


_PATHS = {
    "bf16 packed fused": (dict(depth_block=8, feature_dtype=torch.bfloat16, packed_rows=True,
                               fused_residual=True), dict()),
    "fp32 unpacked": (dict(depth_block=8), dict(packed=False, bf16=False)),
    "production stack": (
        dict(depth_block=4, feature_dtype=torch.bfloat16, packed_rows=True, fused_residual=True,
             table_dtype=torch.int8, residual_dtype="dual", gather_pack=2, table_taps=6),
        dict(table_dtype=torch.int8, residual_dtype="dual", gather_pack=2, table_taps=6)),
    "fp8 levers, chunk 1": (
        dict(depth_block=2, feature_dtype=torch.bfloat16, packed_rows=True, fused_residual=True,
             table_dtype=torch.float8_e4m3fn, residual_dtype=torch.float8_e4m3fn,
             feature_view_chunk=1),
        dict(table_dtype=torch.float8_e4m3fn, residual_dtype=torch.float8_e4m3fn,
             feature_view_chunk=1)),
}


@pytest.mark.parametrize("path", list(_PATHS))
def test_memory_estimate_counts_the_live_tensors(model, path):
    """``sweep_memory_bytes`` against the counted peak of ``forward`` (the
    images included): within 5 %, except that where int8 or fp8 tables
    meet ``gather_pack`` 2 the estimate may be over by up to 15 % (it
    counts the int8 blend's bf16 rows beside every view's residual of the
    super block, which do not live at once); never under by more than
    5 %."""
    sweep_kwargs, estimate_kwargs = _PATHS[path]
    H, W, V, D = 64, 96, 5, 16
    (sample,) = plane_scene(H, W, V, D, maps=1, seed=5, focal=400.0, baseline=0.3,
                            plane_depth=600.0, depth_min=590.0, depth_interval=1.0)
    args = [torch.from_numpy(sample[k])[None]
            for k in ("imgs", "proj_matrices", "depth_values")]
    with torch.no_grad(), _LiveBytes() as count:
        forward(model, *args, SweepConfig(collect_volume=False, **sweep_kwargs))
    counted = count.peak + args[0].nbytes
    estimate = config.sweep_memory_bytes(H, W, V, sweep_kwargs["depth_block"], D,
                                         **estimate_kwargs)
    high = 1.15 if path == "production stack" else 1.05
    assert 0.95 <= estimate / counted <= high, (estimate, counted)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_featnet_estimate_counts_one_view_at_a_time(model, dtype):
    """``featnet_memory_bytes`` for chunks of one view against the counted
    peak of ``extract_features`` within 1 %: on the CPU FeatNet runs one
    view at a time whatever the chunk (``models/feature.py``), so the
    one-batch term is held to the card's peak in ``chip_smoke.py`` phase
    5e instead."""
    H, W, V = 64, 96, 5
    imgs = _imgs(views=V, batch=1, h=H, w=W)
    net = cast_model(model, dtype)  # the bf16 copy of the weights is not FeatNet's
    with torch.no_grad(), _LiveBytes() as count:
        extract_features(net, imgs, dtype, view_chunk=1)
    estimate = config.featnet_memory_bytes(H, W, V, dtype == torch.bfloat16, view_chunk=1)
    assert abs(estimate / count.peak - 1) <= 0.01, (estimate, count.peak)


def test_cli_eval_takes_feat_chunk_and_auto_block(tmp_path, monkeypatch):
    """``cli eval --feat_chunk 2 --depth_block auto`` reaches
    ``run_inference`` with the chunk and the estimate's pick for the path
    its flags ask for."""
    make_plane_scene(str(tmp_path), H=64, W=80, num_views=3)
    (tmp_path / "list.txt").write_text("scan1\n")
    torch.save({"model": AARMVSNetCore().state_dict()}, tmp_path / "m.ckpt")
    seen = {}
    monkeypatch.setattr(infer, "run_inference",
                        lambda model, ds, cfg: seen.setdefault("cfg", cfg) and
                        {"count": 0, "maps_per_s": 0.0})
    base = ["eval", "--testpath", str(tmp_path), "--testlist", str(tmp_path / "list.txt"),
            "--loadckpt", str(tmp_path / "m.ckpt"), "--device", "cpu",
            "--preset", "tnt_intermediate_1920", "--feat_chunk", "2"]
    cli.main(base + ["--depth_block", "auto"])
    cfg = seen.pop("cfg")
    assert cfg.feature_view_chunk == 2
    assert cfg.depth_block == config.derive_depth_block(1056, 1920, 7, 512,
                                                        feature_view_chunk=2)
    assert infer.sweep_config(cfg, (True, 1, 4)).feature_view_chunk == 2
    cli.main(base + ["--depth_block", "4"])
    assert seen["cfg"].depth_block == 4
