"""Full-state checkpoint / resume for long runs.

The reference has two checkpoint layers (SURVEY.md §5.4): per-variable binary
solution dumps (MultiLevelSolution.cpp SaveSolution/LoadSolution,
MultiLevelSolution.hpp:348-352) and run-directory restart bookkeeping
(Files::ConfigureRestart, Files.cpp:66-95).  Here one checkpoint holds the
*whole* run state as a nested dict of arrays — solution fields per level,
simulation time/step, transient old-solution fields, particle clouds
(markers/MPM) — written atomically as one ``.npz`` bundle per step.

The layout is the one of ``femus_tpu.utils.checkpoint``'s npz path
(``use_orbax=False``): ``<dir>/ckpt_<step>/state.npz`` with "/"-joined key
paths ("#i" for list items), written under a temporary name and renamed,
newest ``max_to_keep`` kept.  A checkpoint written by either package
restores in the other.  orbax is a JAX library and no dependency of the
port: ``use_orbax=True`` raises.

State is captured/restored through small adapter functions so any of the
framework's objects (MultiLevelSolution, MarkerCloud, MPMState, transient
systems) can participate without a hard dependency on this module.
Captured arrays are host numpy; tensors on any device are copied to the
host.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..convert import to_numpy


# ---------------------------------------------------------------------------
# state capture / restore adapters
# ---------------------------------------------------------------------------

def capture_solution(ml_sol) -> Dict[str, Any]:
    """Snapshot a MultiLevelSolution into a nested dict of host arrays."""
    levels = []
    for l in range(len(ml_sol.sol)):
        levels.append({
            "sol": {k: to_numpy(v).copy() for k, v in ml_sol.sol[l].items()},
            "old": {k: to_numpy(v).copy()
                    for k, v in ml_sol.sol_old[l].items()},
        })
    return {"levels": levels}


def restore_solution(ml_sol, state: Dict[str, Any]) -> None:
    for l, lev in enumerate(state["levels"]):
        for k, v in lev.get("sol", {}).items():
            ml_sol.sol[l][k][:] = to_numpy(v)
        for k, v in lev.get("old", {}).items():
            if k in ml_sol.sol_old[l]:
                ml_sol.sol_old[l][k][:] = to_numpy(v)


def capture_system(system) -> Dict[str, Any]:
    """Snapshot transient bookkeeping of a System (time, dt, step count)."""
    out = {}
    for attr in ("time", "dt", "step_count", "_time", "_dt"):
        if hasattr(system, attr):
            v = getattr(system, attr)
            if isinstance(v, (int, float)):
                out[attr] = np.asarray(v)
    return out


def restore_system(system, state: Dict[str, Any]) -> None:
    for attr, v in state.items():
        if hasattr(system, attr):
            cur = getattr(system, attr)
            setattr(system, attr, type(cur)(v) if isinstance(
                cur, (int, float)) else v)


def _is_array(v) -> bool:
    return torch.is_tensor(v) or isinstance(v, np.ndarray)


def capture_particles(cloud) -> Dict[str, Any]:
    """Snapshot a MarkerCloud or MPMState (any dataclass of arrays or
    tensors, and of dicts of them) as host arrays."""
    fields = getattr(cloud, "__dataclass_fields__", None)
    if fields is None:
        raise TypeError("expected a dataclass of arrays")
    out: Dict[str, Any] = {}
    for k in fields:
        v = getattr(cloud, k)
        if _is_array(v):
            out[k] = to_numpy(v).copy()
        elif isinstance(v, dict) and all(_is_array(x) for x in v.values()):
            out[k] = {kk: to_numpy(x).copy() for kk, x in v.items()}
    return out


def _like(cur, v):
    """``v`` in the form of ``cur``: a tensor of its dtype on its device,
    or a numpy array of its dtype."""
    if torch.is_tensor(cur):
        return torch.as_tensor(to_numpy(v), dtype=cur.dtype,
                               device=cur.device)
    if isinstance(cur, np.ndarray):
        return to_numpy(v).astype(cur.dtype)
    return v


def restore_particles(cloud, state: Dict[str, Any]):
    """A copy of ``cloud`` with the checkpointed arrays substituted, each
    as the field it replaces holds it (a tensor on the cloud's device, or
    a host array)."""
    kw = {}
    for k, v in state.items():
        cur = getattr(cloud, k)
        if isinstance(v, dict):
            kw[k] = {kk: _like(cur.get(kk) if isinstance(cur, dict)
                               else None, x) for kk, x in v.items()}
        else:
            kw[k] = _like(cur, v)
    return dataclasses.replace(cloud, **kw)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Numbered, atomic checkpoints under a directory, newest-k retention.

    save(step, state) / restore(step=None) / latest_step().  ``state`` is a
    nested dict (and list) of arrays; tensors are copied to the host.
    ``use_orbax``: None or False (the npz layout); True raises, orbax being
    a JAX library."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 use_orbax: Optional[bool] = None):
        if use_orbax:
            raise ValueError("CheckpointManager: use_orbax=True needs orbax, "
                             "a JAX library the port does not use; the port "
                             "writes the npz layout (use_orbax=False)")
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state: Dict[str, Any]) -> None:
        flat: Dict[str, Any] = {}
        _flatten("", state, flat)
        tmp = os.path.join(self.dir, f".tmp_ckpt_{step}")
        final = os.path.join(self.dir, f"ckpt_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"),
                 **{k: to_numpy(v) for k, v in flat.items()})
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        data = np.load(os.path.join(self.dir, f"ckpt_{step}", "state.npz"),
                       allow_pickle=False)
        out: Dict[str, Any] = {}
        for k in data.files:
            _insert(out, k.split("/"), data[k])
        return _unlistify(out)

    def _steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("ckpt_"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        for s in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{s}"))


def _flatten(prefix: str, tree: Any, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}{k}/", v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}#{i}/", v, out)
    else:
        out[prefix[:-1]] = tree


def _insert(tree: Dict[str, Any], path, leaf) -> None:
    key = path[0]
    if len(path) == 1:
        tree[key] = leaf
        return
    child = tree.setdefault(key, {})
    _insert(child, path[1:], leaf)


def _unlistify(tree: Any) -> Any:
    """Convert '#i' dict layers back to lists (the npz round-trip)."""
    if isinstance(tree, dict):
        if tree and all(k.startswith("#") for k in tree):
            items = sorted(tree.items(), key=lambda kv: int(kv[0][1:]))
            return [_unlistify(v) for _, v in items]
        return {k: _unlistify(v) for k, v in tree.items()}
    return tree
