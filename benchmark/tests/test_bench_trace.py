"""The window's arithmetic on a synthetic trace and clock: the idle share,
the kernels under a range, the rate and the map boundary."""

from __future__ import annotations

import types

import pytest

from benchmark import manifest as manifests
from benchmark import run as runner
from benchmark import trace


def Event(kind, name, start, end):
    return (kind, name, start, end)


MS = 1_000_000


def synthetic():
    """A 100 ms window: kernels busy 0-10, 20-30 (two overlapping), 50-60
    and 95-105 ms (clipped at the window's end); ``sweep.cost_block`` spans
    0-30 on the device."""
    return ([
        Event("user_annotation", trace.WINDOW, 0, 100 * MS),
        Event("user_annotation", "bench.map", 0, 60 * MS),
        Event("gpu_user_annotation", "sweep.cost_block", 0, 30 * MS),
        Event("kernel", "a", 0, 10 * MS),
        Event("kernel", "lstm_gates_kernel", 20 * MS, 28 * MS),
        Event("gpu_memcpy", "copy", 25 * MS, 30 * MS),
        Event("kernel", "b", 50 * MS, 60 * MS),
        Event("kernel", "b", 95 * MS, 105 * MS),
        Event("kernel", "before", -10 * MS, -5 * MS),
    ])


def test_events_of_a_real_trace():
    """A CPU trace's host ranges come back in order, in nanoseconds."""
    import torch

    with trace.profile() as prof:
        with trace.window_range():
            with torch.profiler.record_function("bench.map"):
                torch.ones(8).sum()
    got = [e for e in trace.events(prof) if e[0] == "user_annotation"]
    assert [e[1] for e in got] == [trace.WINDOW, "bench.map"]
    (_, _, w0, w1), (_, _, m0, m1) = got
    assert w0 <= m0 < m1 <= w1


def test_summary_of_a_synthetic_trace():
    s = trace.summarize(synthetic())
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.035)  # 10 + 10 + 10 + 5 ms, the copy inside
    assert s["kernels"] == 4
    assert s["range_s"]["sweep.cost_block"] == pytest.approx(0.023)  # a, the gate, the copy
    assert s["ops"]["b"] == [2, pytest.approx(0.02)]
    labels = dict(s["breakdown"]["idle_gaps"])
    # 10-20 and 30-50 ms inside bench.map, 60-95 ms only in the window
    assert labels["host in bench.map (2 gaps)"] == pytest.approx(0.03)
    assert labels[f"host in {trace.WINDOW} (1 gaps)"] == pytest.approx(0.035)
    assert dict(s["breakdown"]["device_ops"])["sweep.cost_block: a"] == pytest.approx(0.01)


def test_readers_on_the_summary():
    s = trace.summarize(synthetic())
    s.update(maps=1, depth_steps=2, gate_seconds=[0.25, 0.75], gate_bytes=3.35e12 * 0.004,
             flops={"bfloat16": 989e12 * 0.001, "float32": 67e12 * 0.002},
             peaks=runner.peaks("NVIDIA H100 80GB HBM3"))
    read = {name: manifests.reader(name)(s) for name in (
        "device_idle_pct.eval", "sweep.cost_block_ms", "infer.gate_s_per_map", "mfu.eval",
        "lstm_gates_roofline.eval", "head.ms_per_map", "sweep.regularize_ms")}
    assert read["device_idle_pct.eval"] == pytest.approx(65.0)
    assert read["sweep.cost_block_ms"] == pytest.approx(11.5)
    assert read["infer.gate_s_per_map"] == pytest.approx(0.5)
    assert read["mfu.eval"] == pytest.approx(3.0)  # 3 ms of least time in 100 ms
    assert read["lstm_gates_roofline.eval"] == pytest.approx(50.0)  # 4 ms of bytes in 8 ms
    assert read["head.ms_per_map"] is None and read["sweep.regularize_ms"] is None
    s["peaks"] = None
    assert manifests.reader("mfu.eval")(s) is None


class Clock:
    """A host clock that only the fake cell's steps move."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class FakeCell:
    unit = "map"

    def __init__(self, work, seed, device, variant=None):
        self.durations = [4.0, 3.0, 5.0, 6.0, 2.0]

    def setup(self, seconds):
        CLOCK.now += 7.0

    def step(self, i):
        CLOCK.now += self.durations[i]
        return i != 1

    def check(self, count):
        return {"x": 0.5}


CLOCK = Clock()


def test_window_ends_at_the_first_boundary_at_or_after_its_length(monkeypatch):
    work = {"driver": "fake", "chips": 1, "limits": {"x": 1.0}, "config_data": {}}
    manifest = {"end_to_end": [{"name": n, "unit": "u"} for n in
                               ("setup_s", "maps_per_s", "peak_mem_gib")], "per_layer": []}
    monkeypatch.setattr(runner, "time", types.SimpleNamespace(perf_counter=CLOCK.perf_counter))
    monkeypatch.setattr(manifests, "driver", lambda name: types.SimpleNamespace(Cell=FakeCell))
    result, numbers = runner.run_cell("fake", 1, 10.0, False, "cpu", manifest=manifest,
                                      work=work)
    # Maps end at 4, 7, 12 s: the third crosses 10 s and closes the window.
    assert result["attempted"] == 3 and result["failed"] == 1
    assert result["metrics"]["maps_per_s"]["value"] == pytest.approx(3 / 12.0)
    assert result["metrics"]["setup_s"]["value"] == pytest.approx(7.0)
    assert result["correct"] is False  # a failed map fails the run
    assert result["checks"] == {"x": {"value": 0.5, "limit": 1.0}}
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
