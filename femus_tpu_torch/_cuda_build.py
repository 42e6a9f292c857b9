"""Build and load the package's CUDA kernels.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
into a shared library under ``build/`` at the checkout root (git-ignored),
then loaded with ``ctypes``.  A library's file name carries a hash of its
source and flags, so an edited source is always rebuilt.  Nothing here runs
at import time: the first call of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

from .utils.telemetry import count, span

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every kernel source of the package, relative to the package directory
KERNEL_SOURCES = ["algebra/csrc/sell_spmv.cu",
                  "algebra/csrc/patch_stencil.cu",
                  "algebra/csrc/dia_spmv.cu",
                  "algebra/csrc/stencil_spmv.cu",
                  "algebra/csrc/vanka_colour.cu",
                  "algebra/csrc/vanka_invert.cu"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, the toolkit's
    default location, or ``nvcc`` on PATH)."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(source: str) -> Path:
    """Where the library built from ``source`` (relative to the package)
    lives: ``build/<stem>-<hash of source and flags>.so``."""
    src = PACKAGE_DIR / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together.  Returns the compiler's
    output (register and spill report) per built source; raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        count("rebuild.kernel_build")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(PACKAGE_DIR / source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for source, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, out)           # atomic: a reader never sees half
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        with span("setup.kernel_load"):
            count("rebuild.kernel_load")
            build([source])
            lib = _loaded[source] = ctypes.CDLL(str(library_path(source)))
    return lib
