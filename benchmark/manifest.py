"""``BENCHMARK.json`` and the files it names, found by name.

- a cell ``<name>``: ``benchmark/workloads/<name>.json`` (its driver, its
  traffic's parameters, the run's options and the limits of its check);
- a configuration ``<name>``: ``benchmark/configs/<name>.json``;
- a per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, whose
  ``read(summary)`` returns the number or ``None``;
- a driver ``<name>``: ``benchmark/drivers/<name>.py``.

A new cell, configuration or metric is a new file and new entries in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    """The cell's ``BENCHMARK.json`` entry merged with its workload file and
    its configuration file (under ``"config_data"``).  Raises ``KeyError``
    for a cell the manifest does not declare, ``ValueError`` where the
    workload file disagrees with the manifest."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    if not NAME.match(name):
        raise ValueError(f"cell name {name!r} is not a plain name")
    with open(HERE / "workloads" / f"{name}.json") as f:
        work = json.load(f)
    for key in ("config", "traffic", "chips"):
        if work.get(key) != entry[key]:
            raise ValueError(f"{name}: workload file has {key}={work.get(key)!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(ROOT / config["file"]) as f:
        work["config_data"] = json.load(f)
    work["name"] = name
    return work


def end_to_end(manifest: dict, name: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]


def per_layer(manifest: dict, name: str) -> list[dict]:
    """The per-layer metrics declared for the cell: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(manifest, name)}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def reader(metric: str):
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"metric name {metric!r} is not a plain name")
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    if not NAME.match(name) or "." in name:
        raise ValueError(f"driver name {name!r} is not a plain module name")
    return importlib.import_module(f"benchmark.drivers.{name}")
