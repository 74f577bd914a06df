"""The port's profiler ranges (``aa_rmvsnet_tpu_torch/utils/spans.py``).

Under ``torch.profiler`` a toy ``run_inference`` with a head (32x40, V=3,
D=16, bf16 packed defaults) records every range of the eval path as a host
``user_annotation``, read as ``benchmark/trace.py`` reads a trace, and
every range that a per-layer metric reads begins and ends with work of
its own, as on a toy map on the unpacked warp with 7 views (the
``tnt_intermediate_1920`` cell's path), through the 2x2 tables and through
the warp kernel's path; ``run_inference`` counts its
gate's ``pick_packed_rows`` calls a map; a toy training step records
``train.*``, and two lever sweeps every ``quant.*``.  With no profiler running ``span`` enters no
``record_function``, and the maps are the same either way;
``torch.compile`` traces through it, and the port loads no compiler stack
for it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aa_rmvsnet_tpu_torch.core.pfm import read_pfm
from aa_rmvsnet_tpu_torch.models import network
from aa_rmvsnet_tpu_torch.models.network import SweepConfig, forward
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
from aa_rmvsnet_tpu_torch.pipeline.train import (
    TrainConfig,
    batch_to_device,
    make_optimizer,
    train_step,
    trainable_parameters,
)
from aa_rmvsnet_tpu_torch.utils import spans
from aa_rmvsnet_tpu_torch.utils.synthetic import (
    plane_scene,
    plane_train_sample,
    seeded_head,
    seeded_model,
)
from benchmark import trace

H, W, V, D = 32, 40, 3, 16
SCENE = dict(seed=3, focal=40.0, baseline=0.5, plane_depth=470.0, depth_min=425.0,
             depth_interval=5.0)
EVAL_RANGES = {
    "featnet", "sweep.setup", "sweep.cost_block", "sweep.warp", "sweep.omega", "groupnorm",
    "sweep.regularize", "sweep.wta", "evidential.volumes", "evidential.dres",
    "evidential.hourglass_up", "evidential.hourglass", "evidential.classify", "head.deconv",
    "infer.upload", "infer.gate", "infer.output",
}
#: The ranges whose device span a per-layer metric reads (``range_s``).
METRIC_RANGES = (
    "sweep.cost_block", "sweep.regularize", "sweep.warp", "sweep.omega", "groupnorm",
    "evidential.volumes", "evidential.dres", "evidential.hourglass_up", "evidential.hourglass",
    "evidential.classify", "head.deconv",
)
#: The ranges of the sweep whose device span a per-layer metric reads.
SWEEP_METRIC_RANGES = ("sweep.cost_block", "sweep.regularize", "sweep.warp", "sweep.omega",
                       "groupnorm")
#: Host operators that run no work of their own: views, allocations, and
#: casts or copies that return their input (they then have no children).
NO_WORK = {
    "aten::view", "aten::_unsafe_view", "aten::reshape", "aten::_reshape_alias",
    "aten::as_strided", "aten::permute", "aten::transpose", "aten::t", "aten::expand",
    "aten::expand_as", "aten::unsqueeze", "aten::squeeze", "aten::select", "aten::slice",
    "aten::narrow", "aten::split", "aten::split_with_sizes", "aten::chunk", "aten::unbind",
    "aten::unflatten", "aten::flatten", "aten::movedim", "aten::view_as", "aten::alias",
    "aten::detach", "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::resolve_conj", "aten::resolve_neg", "aten::lift_fresh", "aten::to",
    "aten::contiguous", "aten::result_type",
}
TRAIN_RANGES = {"train.forward", "train.backward", "train.optimizer"}
QUANT_RANGES = {
    "quant.tables", "quant.int8_blend", "quant.dequant_rows", "quant.residual",
    "quant.omega_input", "quant.variance_dequant", "quant.omega_int8_rw0",
    "quant.omega_int8_chain",
}
FAMILIES = ("depth_est_0", "confidence_0", "aleatoric_0", "epistemic_0")


def _profiled(fn, calls_of=()):
    """``fn()`` under a CPU profiler; the ranges by category and name, as
    ``benchmark/trace.py`` reads them from a trace, and the host's calls of
    the ranges named in ``calls_of`` (:func:`_host_calls`)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    exported = []  # a profile exports its trace once: keep what trace.events reads
    export = prof.export_chrome_trace

    def export_and_keep(path):
        export(path)
        with open(path) as f:
            exported.extend(json.load(f)["traceEvents"])

    prof.export_chrome_trace = export_and_keep
    ranges = {(kind, name) for kind, name, _, _ in trace.events(prof)}
    return (ranges, _host_calls(exported, calls_of)) if calls_of else ranges


def _host_calls(raw, names) -> list[dict]:
    """Each call of a range in ``names`` in the Chrome trace events ``raw``,
    as the host ran it: ``{"name", "children"}``, where a child is a nested
    range or an operator (``"op": True``), each with its own children, in
    order of their start."""
    nodes = sorted(({"name": ev["name"], "op": ev["cat"] == "cpu_op", "tid": ev["tid"],
                     "start": float(ev["ts"]), "end": float(ev["ts"]) + float(ev["dur"]),
                     "children": []}
                    for ev in raw
                    if ev.get("ph") == "X" and ev.get("cat") in ("cpu_op", "user_annotation")),
                   key=lambda n: (n["start"], -n["end"]))
    open_nodes: dict = {}  # per thread, the nodes that hold the current one
    for node in nodes:
        stack = open_nodes.setdefault(node["tid"], [])
        while stack and stack[-1]["end"] <= node["start"]:
            stack.pop()
        if stack:
            stack[-1]["children"].append(node)
        stack.append(node)
    return [n for n in nodes if not n["op"] and n["name"] in names]


def _works(node) -> bool:
    """Whether host operator ``node`` runs work, itself or below it."""
    return node["name"] not in NO_WORK or any(_works(c) for c in node["children"])


def _owned_work(node, owner: str):
    """The operators under range ``node`` that run work, in order, each
    with the innermost range open around it."""
    for child in node["children"]:
        if not child["op"]:
            yield from _owned_work(child, child["name"])
        elif _works(child):
            yield child["name"], owner


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    """One toy ``run_inference`` with a head, without and with the
    profiler, counting the ``record_function`` entries of ``span``."""
    root = tmp_path_factory.mktemp("spans")
    samples = plane_scene(H, W, V, D, maps=1, **SCENE)
    model, head = seeded_model(0), seeded_head(1, maxdisp=8)
    entered = []
    real = spans.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "record_function", counted)
        for name, profile in (("off", False), ("on", True)):
            config = InferConfig(out_root=str(root / name), num_workers=0, device="cpu",
                                 evidential=head)
            entered.clear()

            def run():
                runs[name] = run_inference(model, samples, config, progress=False)

            ranges, calls = _profiled(run, METRIC_RANGES) if profile else (run(), None)
            runs[name] = dict(runs[name], entered=list(entered), ranges=ranges, calls=calls,
                              maps={f: read_pfm(os.path.join(root, name, "scan1", f,
                                                             "00000000.pfm"))[0]
                                    for f in FAMILIES})
    return runs


def test_toy_run_is_packed(toy_runs):
    """The toy scene takes the packed warp, so the run reaches the ranges
    of ``cli eval``'s defaults."""
    assert [tuple(m) for m in toy_runs["on"]["modes"]] == [(True, 1, 4)]


def test_eval_ranges_are_host_annotations(toy_runs):
    names = {name for kind, name in toy_runs["on"]["ranges"] if kind == "user_annotation"}
    assert EVAL_RANGES <= names, sorted(EVAL_RANGES - names)


def test_no_record_function_without_a_profiler(toy_runs):
    assert toy_runs["off"]["entered"] == []
    assert EVAL_RANGES <= set(toy_runs["on"]["entered"])
    assert spans.span("groupnorm") is spans.span("sweep.warp")


def _assert_own_ends(calls, name):
    calls = [call for call in calls if call["name"] == name]
    assert calls
    for call in calls:
        work = list(_owned_work(call, name))
        assert work, name
        assert work[0][1] == name and work[-1][1] == name, (work[0], work[-1])


@pytest.mark.parametrize("name", METRIC_RANGES)
def test_metric_ranges_begin_and_end_with_their_own_work(toy_runs, name):
    """Kineto gives a kernel to the innermost range open at its launch
    alone, so a range's device span runs from its own first kernel to its
    own last.  Every call of a range that a metric reads therefore begins
    and ends with work of its own, and a range nested in it (``groupnorm``,
    ``sweep.warp``, ``sweep.omega``, ``head.deconv``) sits in between:
    were a nested range to take the first or the last kernel, the outer
    span would shrink and read as a gain."""
    _assert_own_ends(toy_runs["on"]["calls"], name)


@pytest.fixture(scope="module")
def unpacked_run(tmp_path_factory):
    """One profiled toy map on the unpacked bf16 warp with 7 views (the
    fused residual off, as ``run_inference`` runs a map whose gate fails)."""
    samples = plane_scene(H, W, 7, D, maps=1, **SCENE)
    config = InferConfig(out_root=str(tmp_path_factory.mktemp("unpacked")), num_workers=0,
                         device="cpu", packed_rows=False)
    out = {}

    def run():
        out["stats"] = run_inference(seeded_model(0), samples, config, progress=False)

    _, out["calls"] = _profiled(run, SWEEP_METRIC_RANGES)
    return out


@pytest.mark.parametrize("name", SWEEP_METRIC_RANGES)
def test_unpacked_metric_ranges_begin_and_end_with_their_own_work(unpacked_run, name):
    """The rule above on the unpacked warp's cost block (a 2x2 gather and
    omega on each hypothesis apart, six source views)."""
    assert [tuple(m) for m in unpacked_run["stats"]["modes"]] == [(False, 1, 4)]
    _assert_own_ends(unpacked_run["calls"], name)


@pytest.fixture(scope="module")
def warp_kernel_run(tmp_path_factory):
    """The unpacked toy map again on the warp kernel's path
    (``ops/warp.py``, its plain version on the CPU), the rule that sends a
    map there on the card forced."""
    samples = plane_scene(H, W, 7, D, maps=1, **SCENE)
    config = InferConfig(out_root=str(tmp_path_factory.mktemp("warp_kernel")), num_workers=0,
                         device="cpu", packed_rows=False)
    out = {}

    def run():
        out["stats"] = run_inference(seeded_model(0), samples, config, progress=False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(network, "_takes_warp_kernel", lambda features, config: True)
        _, out["calls"] = _profiled(run, SWEEP_METRIC_RANGES)
    return out


@pytest.mark.parametrize("name", SWEEP_METRIC_RANGES)
def test_warp_kernel_metric_ranges_begin_and_end_with_their_own_work(warp_kernel_run, name):
    """The rule above where one call emits each view's squared residual:
    the cost block still opens with the coordinates and closes with the
    view mean, outside ``sweep.warp``."""
    assert [tuple(m) for m in warp_kernel_run["stats"]["modes"]] == [(False, 1, 4)]
    _assert_own_ends(warp_kernel_run["calls"], name)


def test_gate_calls_count_each_maps_gate_passes(toy_runs, tmp_path):
    """One ``pick_packed_rows`` call a map where the 4x4 gate passes at one
    block (the defaults); under the super-pack and 6x6 levers, on cameras
    140 units apart, the end reference tries (2, 4), (2, 6), (1, 4) and
    passes at (1, 6), the middle one passes at (2, 6)."""
    assert toy_runs["on"]["gate_calls"] == [1] and toy_runs["off"]["gate_calls"] == [1]
    samples = plane_scene(H, W, V, D, maps=2, **dict(SCENE, baseline=140.0))
    config = InferConfig(out_root=str(tmp_path), num_workers=0, device="cpu",
                         gather_pack=2, table_taps=6)
    stats = run_inference(seeded_model(0), samples, config, progress=False)
    assert [tuple(m) for m in stats["modes"]] == [(True, 1, 6), (True, 2, 6)]
    assert stats["gate_calls"] == [4, 2]


@pytest.mark.parametrize("family", FAMILIES)
def test_maps_equal_with_and_without_a_profiler(toy_runs, family):
    np.testing.assert_array_equal(toy_runs["on"]["maps"][family],
                                  toy_runs["off"]["maps"][family])


def test_train_and_lever_ranges_are_host_annotations(monkeypatch):
    """A toy training step records ``train.*``; a sweep with int8 tables,
    the dual residual and the int8 omega chain, and one with fp8 tables and
    an fp8 residual, record every ``quant.*`` between them."""
    sample = plane_train_sample(H, W, V, D, **SCENE)
    batch = batch_to_device({k: np.asarray(v)[None] for k, v in sample.items()}, "cpu")
    config = TrainConfig(depth_block=8, total_steps=10, device="cpu")
    model = seeded_model(0)
    optimizer, scheduler = make_optimizer(trainable_parameters(model), config, 10)
    (eval_sample,) = plane_scene(H, W, V, D, maps=1, **SCENE)
    inputs = [torch.from_numpy(np.asarray(eval_sample[k]))[None]
              for k in ("imgs", "proj_matrices", "depth_values")]
    levers = [dict(table_dtype=torch.int8, residual_dtype="dual"),
              dict(table_dtype=torch.float8_e4m3fn, residual_dtype=torch.float8_e4m3fn)]
    monkeypatch.setenv("AA_RMVSNET_OMEGA_INT8", "chain")

    def run():
        train_step(model, optimizer, scheduler, batch, config)
        with torch.no_grad():
            for lever in levers:
                forward(model, *inputs, SweepConfig(
                    depth_block=8, collect_volume=False, feature_dtype=torch.bfloat16,
                    packed_rows=True, fused_residual=True, **lever))

    names = {name for kind, name in _profiled(run) if kind == "user_annotation"}
    assert TRAIN_RANGES | QUANT_RANGES <= names, sorted((TRAIN_RANGES | QUANT_RANGES) - names)


def test_compiled_code_traces_through_spans():
    """``torch.compile`` reads ``span`` as the context that does nothing, so
    a range leaves the graph whole."""

    def f(x):
        with spans.span("groupnorm"):
            return x * 2.0

    compiled = torch.compile(f, fullgraph=True, backend="eager")
    torch.testing.assert_close(compiled(torch.ones(3)), torch.full((3,), 2.0))


def test_the_port_loads_no_compiler_stack():
    """The entry points the benchmark times import no ``torch._dynamo``
    (seconds of every run's set-up)."""
    code = ("import sys; import aa_rmvsnet_tpu_torch.pipeline.infer, "
            "aa_rmvsnet_tpu_torch.pipeline.train; print('torch._dynamo' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
