"""The port's quantized levers end to end on the CPU: the JAX package's
guardrails on the port's own weights, the refusals, the drop warning on
unpacked samples, and ``cli eval`` with each flag (the parity tests
against JAX are in ``test_torch_quant.py``).

The JAX package's guardrail tests cannot run without its checkpoint, so
they run here on ``utils/synthetic.py:matching_model`` weights, against
the port's exact packed path.

    python -m pytest tests/test_torch_quant_pipeline.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu.models import network as network_j
from aa_rmvsnet_tpu.models.convert import convert_state_dict
from aa_rmvsnet_tpu_torch import cli
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, SweepConfig, forward, pick_packed_rows
from aa_rmvsnet_tpu_torch.pipeline import infer
from aa_rmvsnet_tpu_torch.utils.synthetic import matching_model, plane_scene, seeded_model

from test_models import _random_scene

torch.set_num_threads(2)

F8, I8 = torch.float8_e4m3fn, torch.int8
_LEVERS = {
    "fp8_tables_unpacked": dict(table_dtype=F8),
    "int8_tables_packed": dict(packed_rows=True, table_dtype=I8),
    "fp8_residual": dict(packed_rows=True, table_dtype=F8, residual_dtype=F8),
    "int8_residual": dict(packed_rows=True, table_dtype=F8, residual_dtype=I8),
    "dual_residual": dict(packed_rows=True, table_dtype=F8, residual_dtype="dual"),
}


@pytest.fixture(scope="module")
def model():
    return seeded_model(0)


# (e) the JAX package's guardrails on the port's weights ----------------------

GUARD_H, GUARD_W, GUARD_V, GUARD_D, GUARD_BIN = 128, 160, 3, 32, 2.5


@pytest.fixture(scope="module")
def guard():
    """A photoconsistent plane (the middle of three cameras 16 apart, the
    plane at 480 on a hypothesis, so the sources are whole-pixel shifts)
    and ``matching_model`` weights, whose costs peak at the match as a
    trained network's do.  Sharpness 1000 makes most pixels confident
    (fp32 confidence > 0.3 on 88 % of them), so the confident-pixel bar
    bites.  The base is the port's exact packed fp32 path."""
    sample = plane_scene(GUARD_H, GUARD_W, GUARD_V, GUARD_D, maps=2, seed=7, focal=600.0,
                         baseline=16.0, plane_depth=480.0, depth_min=425.0,
                         depth_interval=GUARD_BIN)[1]
    assert pick_packed_rows(sample["proj_matrices"], sample["depth_values"], GUARD_H, GUARD_W, 4)
    net = matching_model(0, sharpness=1000.0)
    args = [torch.from_numpy(sample[k])[None] for k in ("imgs", "proj_matrices", "depth_values")]

    def run(**config):
        with torch.no_grad():
            out = forward(net, *args, SweepConfig(depth_block=4, collect_volume=False, **config))
        return out["depth"].numpy(), out["photometric_confidence"].numpy()

    base = run(packed_rows=True)
    confident = base[1] > 0.3
    assert confident.mean() > 0.5, confident.mean()  # the bar is not vacuous
    return sample, net, run, base[0], confident


@pytest.mark.parametrize("lever,bar,conf_bar", [
    ("fp8_tables_unpacked", 0.90, None),
    ("int8_tables_packed", 0.90, None),
    ("fp8_residual", 0.90, 0.99),
    ("dual_residual", 0.90, 0.99),
])
def test_guardrail_on_matching_weights(guard, lever, bar, conf_bar):
    """``tests/test_models.py:306-345`` (tables: >= 90 % of pixels within
    one bin) and ``:637-690`` (residuals: >= 90 % of all pixels and >= 99 %
    of confident ones), against the exact packed path.  Measured: fp8
    tables 99.79 %, int8 tables 99.91 %, fp8 residual 99.56 % (99.89 %
    confident), dual 98.58 % (99.47 %)."""
    _, _, run, base_depth, confident = guard
    depth, _ = run(**_LEVERS[lever])
    within = np.abs(depth - base_depth) <= GUARD_BIN + 1e-6
    print(f"{lever}: {within.mean():.4%} within one bin, {within[confident].mean():.4%} of "
          f"the {confident.mean():.2%} confident pixels")
    assert within.mean() >= bar, within.mean()
    if conf_bar is not None:
        assert within[confident].mean() >= conf_bar, within[confident].mean()


def test_guardrail_int8_residual_tracks_jax_int8_residual(guard):
    """The int8 residual misses the JAX bar (>= 90 %, >= 98 % confident)
    on these weights, in the JAX package as in the port.  Its step, the
    shared scale (2 amax)^2 / 127, is 0.33 to 0.98 per channel here: He-normal
    features have an amax 15-25 times their standard deviation, so every
    near-match residual rounds to 0 and a run of hypotheses ties at the
    top.  Held instead to JAX's own int8 residual on the same weights and
    scene: within 2 percentage points of its share (measured: the port
    19.67 %, JAX 18.65 %), and far under the dual residual."""
    sample, net, run, base_depth, confident = guard
    depth, _ = run(**_LEVERS["int8_residual"])
    within = np.abs(depth - base_depth) <= GUARD_BIN + 1e-6

    # JAX's lever against the port's exact path: the exact fp32 paths agree
    # (test_torch_packed.py), and one JAX compile less.
    params_j = convert_state_dict({k: v.numpy() for k, v in net.state_dict().items()})
    args_j = [jnp.asarray(sample[k])[None] for k in ("imgs", "proj_matrices", "depth_values")]
    out_j = network_j.forward(params_j, *args_j, network_j.SweepConfig(
        depth_block=4, packed_rows=True, collect_volume=False,
        table_dtype=jnp.float8_e4m3fn, residual_dtype=jnp.int8))
    within_j = np.abs(np.asarray(out_j["depth"]) - base_depth) <= GUARD_BIN + 1e-6
    print(f"int8 residual: port {within.mean():.4%}, JAX {within_j.mean():.4%} within one bin")
    assert abs(within.mean() - within_j.mean()) <= 0.02
    assert within.mean() < 0.5  # the lossiness is the lever's, and shows


# (f) refusals, the drop warning, the CLI --------------------------------------

@pytest.mark.parametrize("config", [
    dict(residual_dtype=torch.float8_e4m3fn),
    dict(residual_dtype=torch.int8, fold_omega="hybrid"),
    dict(residual_dtype="dual"),
])
def test_residual_lever_requires_a_folded_layout(model, config):
    with pytest.raises(ValueError, match="packed_rows"):
        forward(model, *map(torch.from_numpy, _random_scene(seed=9, D=4)),
                SweepConfig(depth_block=4, **config))


@pytest.mark.parametrize("config", [dict(table_dtype=torch.float16),
                                    dict(packed_rows=True, residual_dtype=torch.bfloat16)])
def test_unknown_lever_dtypes_raise(model, config):
    with pytest.raises(ValueError, match="not"):
        forward(model, *map(torch.from_numpy, _random_scene(seed=9, D=4)),
                SweepConfig(depth_block=4, **config))


def test_residual_lever_dropped_with_a_warning_on_unpacked_samples(model, tmp_path, capsys):
    """``packed_rows="auto"`` on a sample whose gate fails: the residual
    lever is dropped with the JAX package's warning (once per packed mode)
    and the maps are written; with ``fold_omega=True`` it is kept."""
    (sample,) = plane_scene(16, 20, 3, 8, maps=1, seed=1, focal=400.0, baseline=90.0,
                            plane_depth=500.0, depth_min=425.0, depth_interval=2.5)
    config = infer.InferConfig(out_root=str(tmp_path), depth_block=4, num_workers=0,
                               device="cpu", feature_dtype=torch.float32,
                               residual_dtype=torch.float8_e4m3fn)
    assert infer.resolve_packed_mode(sample, config) == (False, 1, 4)
    stats = infer.run_inference(model, [sample, sample], config, progress=False)
    out = capsys.readouterr().out
    assert stats["count"] == 2 and stats["modes"] == [(False, 1, 4)] * 2
    assert out.count("WARNING: fp8 residual storage dropped for an unpacked sample") == 1
    kept = infer.sweep_config(infer.InferConfig(out_root="", fold_omega=True,
                                                residual_dtype="dual"), (False, 1, 4))
    assert kept.residual_dtype == "dual" and "WARNING" not in capsys.readouterr().out
    packed = infer.sweep_config(infer.InferConfig(out_root="", residual_dtype=torch.int8,
                                                  table_dtype=torch.int8), (True, 2, 6))
    assert packed.residual_dtype == torch.int8 and packed.table_dtype == torch.int8


@pytest.mark.parametrize("flags,table,residual", [
    ([], None, None),
    (["--fp8_tables"], torch.float8_e4m3fn, None),
    (["--int8_tables"], torch.int8, None),
    (["--fp8_tables", "--int8_tables"], torch.int8, None),
    (["--fp8_residual"], None, torch.float8_e4m3fn),
    (["--int8_residual", "--fp8_residual"], None, torch.int8),
    (["--dual_residual", "--int8_residual"], None, "dual"),
    (["--int8_tables", "--dual_residual", "--gather_pack", "2", "--table_taps", "6"],
     torch.int8, "dual"),
])
def test_cli_levers_reach_infer_config(monkeypatch, tmp_path, flags, table, residual):
    """Each flag reaches ``InferConfig`` with the JAX CLI's precedence
    (``aa_rmvsnet_tpu/cli.py:358-367``)."""
    from aa_rmvsnet_tpu_torch.data import eval_dataset
    from aa_rmvsnet_tpu_torch.models import convert

    seen = {}
    monkeypatch.setattr(eval_dataset, "EvalDataset", lambda *a, **k: [])
    monkeypatch.setattr(convert, "load_reference_checkpoint", lambda m, path: m)

    def fake_run(model, ds, config, progress=True):
        seen["config"] = config
        return {"count": 0, "maps_per_s": 0.0}

    monkeypatch.setattr(infer, "run_inference", fake_run)
    cli.main(["eval", "--testpath", str(tmp_path), "--testlist", "x", "--loadckpt", "x",
              "--device", "cpu", *flags])
    config = seen["config"]
    assert config.table_dtype == table and config.residual_dtype == residual
    if "--gather_pack" in flags:
        assert (config.gather_pack, config.table_taps) == (2, 6)


def test_cli_eval_runs_the_production_stack(tmp_path, capsys):
    """``cli eval --int8_tables --dual_residual --gather_pack 2
    --table_taps 6`` on a JPEG plane scene, on the CPU: packed mode (True,
    2, 4) (cameras 2 apart), finite maps, depth in the sweep."""
    from scenefix import make_plane_scene

    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm

    H, W, V, D = 32, 40, 3, 16
    make_plane_scene(str(tmp_path), H=H, W=W, num_views=V)
    (tmp_path / "list.txt").write_text("scan1\n")
    ckpt = tmp_path / "model.ckpt"
    torch.save({"model": AARMVSNetCore(torch.Generator().manual_seed(0)).state_dict()}, ckpt)
    cli.main(["eval", "--device", "cpu", "--testpath", str(tmp_path), "--testlist",
              str(tmp_path / "list.txt"), "--outdir", str(tmp_path / "out"), "--loadckpt",
              str(ckpt), "--preset", "dtu_eval_smoke", "--view_num", str(V), "--numdepth",
              str(D), "--max_h", str(H), "--max_w", str(W), "--depth_block", "4",
              "--int8_tables", "--dual_residual", "--gather_pack", "2", "--table_taps", "6"])
    out = capsys.readouterr().out
    assert out.count("packed mode (True, 2, 4)") == V, out
    for v in range(V):
        depth, _ = read_pfm(str(tmp_path / f"out/scan1/depth_est_0/{v:08d}.pfm"))
        assert depth.shape == (H, W) and np.isfinite(depth).all()
