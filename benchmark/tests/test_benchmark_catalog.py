"""BENCHMARK.json holds to the benchmark's contract, every entry finds its
file by name, and a new configuration, cell or metric is files and entries
only."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.run import ROOT, Catalog, run_cell

from .conftest import SEED, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    # a full check of 24 cells fits 43,200 s
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_shapes_of_entries():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    cells = {w["name"] for w in DOC["workloads"]}
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    for m in metrics:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        names.append(m["name"])
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in e2e
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        # a metric lists only cells that report the end-to-end metric it moves
        moved = next(e for e in DOC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("cell", sorted(w["name"] for w in DOC["workloads"]))
def test_every_cell_finds_its_files_and_reports_enough(cell):
    catalog = Catalog()
    w = catalog.cell(cell)
    traffic = catalog.traffic(w)
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
    config = catalog.config(w)
    for kind in ("model", "obs"):
        key = "model" if kind == "model" else "observation"
        if key in config:
            assert (ROOT / "benchmark" / "reference" / f"{kind}_{config[key]}.py").is_file()
    e2e = [m["name"] for m in catalog.metrics(w, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert catalog.metrics(w, trace=True)
    for m in catalog.metrics(w, False) + catalog.metrics(w, True):
        assert callable(catalog.reader(m))


def test_a_new_cell_config_and_metric_are_files_and_entries_only(tmp_path):
    """A copy of the benchmark with a new configuration (the same model at
    other data), a new cell on it with its own traffic, and a new per-layer
    metric: the harness finds and runs them without a code edit."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "benchmark/configs/sir_binomial.json").read_text())
    config["data"]["theta_true"] = [1.5, 1.0]
    (tmp_path / "benchmark/configs/sir_binomial_slow.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "benchmark/workloads/sir_binomial.chains2048.json").read_text())
    traffic.update(TINY["sir_binomial.chains2048"], chains=4)
    (tmp_path / "benchmark/workloads/sir_binomial_slow.chains4.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/metrics/rows_per_call.py").write_text(
        "def read(f):\n    return f.get('pmmh_rows')\n")
    doc["configs"].append({"name": "sir_binomial_slow", "source": "a test",
                           "file": "benchmark/configs/sir_binomial_slow.json", "reduced": [],
                           "why": "a test"})
    doc["workloads"].append({"name": "sir_binomial_slow.chains4", "config": "sir_binomial_slow",
                             "traffic": "chains4", "chips": 1, "why": "a test"})
    for group in ("end_to_end", "per_layer"):
        for m in doc[group]:
            if "sir_binomial.chains2048" in m.get("workloads", []):
                m["workloads"].append("sir_binomial_slow.chains4")
    doc["per_layer"].append({"name": "rows_per_call", "unit": "rows", "better": "higher",
                             "source": "program_counter", "layer": "chain loop",
                             "moves": "device_us_per_iter", "workloads": ["sir_binomial_slow.chains4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    catalog = Catalog(tmp_path)
    traced = run_cell("sir_binomial_slow.chains4", SEED, 0.2, True, "cpu", catalog=catalog)
    assert traced["correct"]
    assert traced["metrics"]["rows_per_call"] == {"value": 4.0, "unit": "rows"}
    assert "ess_per_s" in traced["metrics"] and "iters_per_s.host" in traced["metrics"]
    plain = run_cell("sir_binomial_slow.chains4", SEED, 0.2, False, "cpu", catalog=catalog)
    # the cell's other end-to-end metric is read from the device's trace,
    # which a CPU run does not have
    assert set(plain["metrics"]) == {"setup_s"}
