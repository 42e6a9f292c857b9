"""Native (C++) host set-up kernels, built at first use and loaded with
ctypes: the port's own copy of the JAX package's ``native`` module.

The reference's set-up-critical native machinery (METIS element
partitioning, MeshMetisPartitioning.cpp:41-99, and CSR sparsity
construction, LinearEquation.hpp:161) has C++ equivalents in
``src/femus_native.cpp``: recursive coordinate bisection, greedy dual-graph
partitioning with refinement sweeps, the edge cut, and a sorted,
deduplicated CSR from COO pairs.

Build: ``g++ -O3 -std=c++17 -shared -fPIC`` into the git-ignored
``build/`` at the checkout root, beside the CUDA libraries
(``_cuda_build.py``); the file name carries a hash of the source, so an
edited source is rebuilt.  Without a C++ toolchain every function runs its
numpy recursion instead (host set-up, not a device path); :func:`available`
says which one runs, and ``parallel.partition.PartitionInfo.impl`` records
it.  The numpy versions are also callable directly (``*_numpy``): the
plain versions the tests hold the native ones against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import deque
from typing import Optional

import numpy as np

from .._cuda_build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "femus_native.cpp")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_state = {"lib": None, "tried": False}


def library_path() -> str:
    """``build/femus_native-<hash of source and flags>.so``."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()
                             ).hexdigest()[:16]
    return str(BUILD_DIR / f"femus_native-{tag}.so")


def build() -> str:
    """Compile the library if it is not built yet (raises if ``g++`` fails
    or is missing); returns its path."""
    so = library_path()
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native set-up kernels "
                               "need a C++ toolchain")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([gxx, *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)            # atomic: a reader never sees half
    return so


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when no C++ toolchain is present (the
    numpy versions then run; decided once per process)."""
    if _state["tried"]:
        return _state["lib"]
    _state["tried"] = True
    if shutil.which("g++") is None and not os.path.exists(library_path()):
        return None
    lib = ctypes.CDLL(build())
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rcb_partition.argtypes = [ctypes.c_int64, ctypes.c_int32, f64p,
                                  ctypes.c_int32, i32p]
    lib.rcb_partition.restype = None
    lib.greedy_graph_partition.argtypes = [
        ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int32,
        ctypes.c_int32, i32p]
    lib.greedy_graph_partition.restype = None
    lib.edge_cut.argtypes = [ctypes.c_int64, ctypes.c_int32, i32p, i32p]
    lib.edge_cut.restype = ctypes.c_int64
    lib.csr_from_coo.argtypes = [ctypes.c_int64, i64p, i64p,
                                 ctypes.c_int64, i64p, i64p]
    lib.csr_from_coo.restype = ctypes.c_int64
    _state["lib"] = lib
    return lib


def available() -> bool:
    """True when the native library runs (else the numpy versions do)."""
    return _load() is not None


def impl() -> str:
    """``"native"`` or ``"numpy"``: which implementation the functions of
    this module run."""
    return "native" if available() else "numpy"


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection of element centroids -> part ids."""
    cent = np.ascontiguousarray(centroids, np.float64)
    lib = _load()
    if lib is None:
        return rcb_partition_numpy(cent, nparts)
    out = np.empty(cent.shape[0], np.int32)
    lib.rcb_partition(cent.shape[0], cent.shape[1], cent, nparts, out)
    return out


def rcb_partition_numpy(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """The numpy recursion of :func:`rcb_partition`."""
    cent = np.ascontiguousarray(centroids, np.float64)
    out = np.empty(cent.shape[0], np.int32)

    def rec(ids, p0, np_):
        if np_ <= 1 or len(ids) <= 1:
            out[ids] = p0
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        nl = np_ // 2
        k = max(1, min(len(ids) - 1, len(ids) * nl // np_))
        order = np.argpartition(c[:, axis], k)
        rec(ids[order[:k]], p0, nl)
        rec(ids[order[k:]], p0 + nl, np_ - nl)

    rec(np.arange(cent.shape[0]), 0, nparts)
    return out


def greedy_graph_partition(neigh: np.ndarray, nparts: int,
                           sweeps: int = 6) -> np.ndarray:
    """BFS region growing over the element dual graph + refinement sweeps
    (METIS K-way stand-in).  The numpy version grows the regions only (no
    refinement sweeps), as the JAX package's does."""
    nb = np.ascontiguousarray(neigh, np.int32)
    lib = _load()
    if lib is None:
        return greedy_graph_partition_numpy(nb, nparts)
    out = np.empty(nb.shape[0], np.int32)
    lib.greedy_graph_partition(nb.shape[0], nb.shape[1], nb, nparts, sweeps,
                               out)
    return out


def greedy_graph_partition_numpy(neigh: np.ndarray,
                                 nparts: int) -> np.ndarray:
    """Region growing of :func:`greedy_graph_partition` in Python (slow;
    small meshes only)."""
    nb = np.ascontiguousarray(neigh, np.int32)
    ne = nb.shape[0]
    part = np.full(ne, -1, np.int32)
    size = np.zeros(nparts, np.int64)
    target = -(-ne // nparts)
    seed = 0
    for p in range(nparts):
        while seed < ne and part[seed] >= 0:
            seed += 1
        if seed >= ne:
            break
        q = deque([seed])
        part[seed] = p
        size[p] += 1
        while q and size[p] < target:
            e = q.popleft()
            for o in nb[e]:
                if o >= 0 and part[o] < 0 and size[p] < target:
                    part[o] = p
                    size[p] += 1
                    q.append(o)
    for e in range(ne):
        if part[e] < 0:
            ns = [part[o] for o in nb[e] if o >= 0 and part[o] >= 0]
            part[e] = ns[0] if ns else int(np.argmin(size))
            size[part[e]] += 1
    return part


def edge_cut(neigh: np.ndarray, part: np.ndarray) -> int:
    """Dual-graph edges whose two elements lie in different parts."""
    nb = np.ascontiguousarray(neigh, np.int32)
    pt = np.ascontiguousarray(part, np.int32)
    lib = _load()
    if lib is None:
        return edge_cut_numpy(nb, pt)
    return int(lib.edge_cut(nb.shape[0], nb.shape[1], nb, pt))


def edge_cut_numpy(neigh: np.ndarray, part: np.ndarray) -> int:
    nb = np.asarray(neigh)
    pt = np.asarray(part)
    e = np.repeat(np.arange(nb.shape[0]), nb.shape[1])
    o = nb.ravel()
    sel = (o >= 0) & (o > e)
    return int(np.sum(pt[e[sel]] != pt[o[sel]]))


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """(indptr, indices) with sorted, deduplicated columns per row."""
    r = np.ascontiguousarray(rows, np.int64)
    c = np.ascontiguousarray(cols, np.int64)
    lib = _load()
    if lib is None:
        return csr_from_coo_numpy(r, c, n_rows)
    indptr = np.empty(n_rows + 1, np.int64)
    indices = np.empty(len(r), np.int64)
    nnz = lib.csr_from_coo(len(r), r, c, n_rows, indptr, indices)
    return indptr, indices[:nnz].copy()


def csr_from_coo_numpy(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """:func:`csr_from_coo` through scipy."""
    import scipy.sparse as sp
    r = np.asarray(rows, np.int64)
    c = np.asarray(cols, np.int64)
    m = sp.csr_matrix((np.ones(len(r), np.int8), (r, c)))
    m.resize(n_rows, max(int(c.max()) + 1, 1) if len(c) else 1)
    m.sum_duplicates()
    m.sort_indices()
    return m.indptr.astype(np.int64), m.indices.astype(np.int64)
