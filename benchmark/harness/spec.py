"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, one file
per cell (``cells/<workload>.json``), per configuration
(``configs/<config>.json``) and per end-to-end metric
(``end_to_end/<name>.json``).  Nothing here names a cell, a configuration
or a metric: each is found by the name ``BENCHMARK.json`` gives it."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = HERE.parent                                   # the checkout's root



def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its cell file and
    configuration file, and the metrics it reports."""

    name: str
    entry: dict                    # the workload's entry in BENCHMARK.json
    params: dict                   # cells/<name>.json
    config: dict                   # configs/<config>.json
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, name: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` lists, or
    without the key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` under ``root`` declares it;
    KeyError for a workload it does not name."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    params = load_json(root / "benchmark" / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if params.get(key) != entry[key]:
            raise ValueError(f"cells/{name}.json: {key} {params.get(key)!r}, "
                             f"BENCHMARK.json says {entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, entry=entry, params=params, config=config, end_to_end=e2e,
                per_layer=per_layer)


def end_to_end_kind(name: str, root: Path = ROOT) -> dict:
    """How the end-to-end metric ``name`` reduces a window's calls
    (``end_to_end/<name>.json``)."""
    return load_json(root / "benchmark" / "end_to_end" / f"{name}.json")
