"""The benchmark's files: every configuration, cell and metric file parses,
every name and unit keeps to the allowed characters, every cell and metric
finds its driver or reader, and a new cell is picked up by adding files."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark.harness import spec
from conftest import BENCH, ROOT, copy_benchmark

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keys_names_units(section):
    kind = {"configs": "config", "workloads": "workload"}.get(section, section)
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME_RE.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metric_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        assert w["chips"] == 1
        assert NAME_RE.match(w["config"]) and NAME_RE.match(w["traffic"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("benchmark/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert len(data["source"]) <= 200 and data["assumed"]
    for d in data["designs"]:
        assert (ROOT / d["frozen"]).is_file()


def test_files_resolve():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        importlib.import_module(f"benchmark.drivers.{cell.params['driver']}")
        assert set(cell.params["limits"])
    for m in BENCH["end_to_end"]:
        assert spec.end_to_end_kind(m["name"])["kind"] in ("rate", "time_per", "percentile",
                                                           "setup")
    for m in BENCH["per_layer"]:
        reader = importlib.import_module(f"benchmark.layer_metrics.{m['name'].split('.')[0]}")
        assert callable(reader.read)


def test_file_names_use_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if ".cache" in path.parts or "__pycache__" in path.parts:
            continue
        for part in path.relative_to(ROOT).parts:
            assert re.fullmatch(r"[A-Za-z0-9_.-]{1,64}", part), part


def test_new_cell_is_picked_up_from_files_alone(tmp_path):
    """A cell added as a BENCHMARK.json entry and a cell file, with no edit
    of any code, is found with its driver, configuration and metrics."""
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "oc3_spar.sweep_narrow", "config": "oc3_spar",
                               "traffic": "sweep_narrow", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "oc3_spar.sweep_wide" in m.get("workloads", []):
            m["workloads"].append("oc3_spar.sweep_narrow")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    params = json.loads((root / "benchmark/cells/oc3_spar.sweep_wide.json").read_text())
    params.update(traffic="sweep_narrow")
    params["traffic_params"]["n_variants"] = 64
    (root / "benchmark/cells/oc3_spar.sweep_narrow.json").write_text(json.dumps(params))
    cell = spec.cell("oc3_spar.sweep_narrow", root)
    assert cell.params["traffic_params"]["n_variants"] == 64
    assert cell.config["name"] == "oc3_spar"
    assert {m["name"] for m in cell.end_to_end} == {"solves_per_s", "latency_p90_s", "setup_s"}
    assert "k1_roofline.sweep" in {m["name"] for m in cell.per_layer}
    with pytest.raises(KeyError):
        spec.cell("oc3_spar.sweep_narrow")
