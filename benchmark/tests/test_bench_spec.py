"""BENCHMARK.json against the contract it is written to, and the discovery
of every file it names by name."""
import json
import os
import re

import pytest

from benchmark import plugins, traffic
from benchmark.trace import matvec_specs

ROOT = plugins.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = plugins.benchmark_spec()


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    cells = len(SPEC["workloads"])
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            allowed = ({"name", "unit", "better", "bound", "source"}
                       if kind == "end_to_end" else
                       {"name", "unit", "better", "source", "layer",
                        "moves"})
            assert set(m) - {"workloads"} == allowed
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_what_it_must():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in plugins.metrics_of(SPEC, w["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = plugins.metrics_of(SPEC, w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_files_found_by_name(cell):
    w = plugins.cell(SPEC, cell)
    cfg = plugins.config(SPEC, w["config"])
    assert cfg["name"] == w["config"]
    assert plugins.load_file("systems", cfg["system"]).Driver
    assert plugins.load_file("references", cfg["reference"]).check
    mix = traffic.load(w["traffic"])
    assert mix["loop"] == "closed"
    for m in plugins.metrics_of(SPEC, cell, "per_layer"):
        assert callable(plugins.load_file("metrics", m["name"]).read)


def test_matvec_files_found_by_name():
    specs = matvec_specs()
    assert {"b1", "b2"} <= set(specs)
    for spec in specs.values():
        assert ":" in spec["entry"] and spec["kernels"]
        assert callable(plugins.load_file("work", spec["work"]).work)


def test_config_files_state_their_cut():
    for c in SPEC["configs"]:
        cfg = plugins.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
        assert cfg["assumed"] and cfg["limits"]
        json.dumps(cfg)
