"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import manifest as manifests

ROOT = manifests.ROOT
WHY = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return manifests.load()


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= len(manifest["command"]) <= 32
    assert all(WHY.match(w) and not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in manifest[key]]
    assert len(names) == len(set(names))
    assert all(manifests.NAME.match(n) for n in names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert manifests.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert manifests.NAME.match(w["traffic"]) and w["chips"] in (1, 4) and WHY.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert WHY.match(m["layer"])


def test_every_config_has_a_cell_and_every_cell_its_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    assert {c["name"] for c in manifest["configs"]} == {w["config"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = {m["name"] for m in manifests.end_to_end(manifest, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifests.per_layer(manifest, cell)


def test_files_found_by_name(manifest):
    for w in manifest["workloads"]:
        work = manifests.cell(manifest, w["name"])
        assert work["config_data"]["reduced"] == []
        assert manifests.driver(work["driver"]).Cell
        assert set(work["limits"]) and all(v > 0 for v in work["limits"].values())
    for m in manifest["per_layer"]:
        assert callable(manifests.reader(m["name"]))
    for c in manifest["configs"]:
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["source"] == c["source"]


def test_a_cell_the_manifest_lacks_is_refused(manifest):
    with pytest.raises(KeyError):
        manifests.cell(manifest, "dtu_eval.nonexistent")
    with pytest.raises(ValueError):
        manifests.reader("../run")


def test_layers_are_in_perf_md(manifest):
    text = (ROOT / "PERF.md").read_text()
    for m in manifest["per_layer"]:
        assert m["layer"] in text, m["layer"]
