"""Runtime configuration parsing.

Equivalent of the reference input-parsing layer
(src/00_file_handling/input_parsing/): ``JsonInputParser``
(JsonInputParser.hpp:38 — JSON config with dotted-path lookup),
``FemusInputParser`` (FemusInputParser.hpp:36 — flat ``key value`` file,
femus_conf.in style), and ad-hoc argv handling (CmdLine).

One class, three loaders; values are plain Python scalars/lists consumed at
setup time.  A jax-free own copy of ``femus_tpu.utils.config``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence


class InputParser:
    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = data or {}

    # -- JsonInputParser -------------------------------------------------
    @classmethod
    def from_json(cls, path: str) -> "InputParser":
        with open(path) as f:
            return cls(json.load(f))

    # -- FemusInputParser: "key value" lines, '#' comments ---------------
    @classmethod
    def from_keyvalue(cls, path: str) -> "InputParser":
        data: Dict[str, Any] = {}
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                key, _, val = line.partition(" ")
                data[key.strip()] = _coerce(val.strip())
        return cls(data)

    # -- CmdLine: --key=value / --flag ----------------------------------
    @classmethod
    def from_argv(cls, argv: Sequence[str]) -> "InputParser":
        data: Dict[str, Any] = {}
        for a in argv:
            if not a.startswith("--"):
                continue
            key, eq, val = a[2:].partition("=")
            data[key] = _coerce(val) if eq else True
        return cls(data)

    # -- dotted-path getters (JsonInputParser GetValueFromPath style) ----
    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in path.split("/" if "/" in path else "."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_size(self, path: str) -> int:
        v = self.get(path, [])
        return len(v) if isinstance(v, (list, dict)) else 0

    def have(self, path: str) -> bool:
        sentinel = object()
        return self.get(path, sentinel) is not sentinel

    def merge(self, other: "InputParser") -> "InputParser":
        """Other's keys win (e.g. argv over file)."""
        merged = dict(self._data)
        merged.update(other._data)
        return InputParser(merged)

    def __getitem__(self, path: str) -> Any:
        sentinel = object()
        v = self.get(path, sentinel)
        if v is sentinel:
            raise KeyError(path)
        return v


def _coerce(s: str) -> Any:
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s
