"""Loading the benchmark's files by the names in ``BENCHMARK.json``.

A configuration, a traffic mix, a per-layer metric, a matvec's kernel
names and its work count each sit in a file of their own under
``benchmark/``; a later change adds a file and edits none.  Python files
are loaded by path, so a name may hold ``-`` or ``.``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_file(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded once."""
    key = f"benchmark.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    importlib.import_module(f"benchmark.{kind}")    # the parent package
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec() -> Dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: Dict, name: str) -> Dict:
    """The configuration file that ``BENCHMARK.json`` names for ``name``."""
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(spec: Dict, cell_name: str, kind: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics that the cell
    reports: those that list it under ``workloads``, or, without that key,
    (end to end) every cell, (per layer) every cell that reports the
    end-to-end metric the metric moves."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return [m for m in spec[kind] if m["name"] in e2e]
    return [m for m in spec[kind]
            if cell_name in m.get("workloads", [cell_name] if m["moves"]
                                  in e2e else [])]
