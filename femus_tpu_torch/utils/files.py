"""Run-directory management and restart bookkeeping.

Equivalent of the reference ``Files`` class (src/00_file_handling/Files.hpp:38):
timestamped per-run output directories, input copying, log redirection, and
the ``run_to_restart_from`` pointer file that chains restarted runs
(Files.cpp:66-95 ConfigureRestart, :270-282 PrintRunForRestart).

All host-side; no device interaction.  A jax-free own copy of
``femus_tpu.utils.files``.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import sys
from typing import Optional

RESTART_POINTER = "run_to_restart_from"
LAST_RUN_POINTER = "last_run"


class Files:
    """Creates ``<output_root>/<timestamp>/`` for a run; knows which previous
    run to restart from via the ``run_to_restart_from`` pointer file."""

    def __init__(self, output_root: str = "output", input_dir: str = "input"):
        self.output_root = output_root
        self.input_dir = input_dir
        self.run_dir: Optional[str] = None
        self.restart_dir: Optional[str] = None

    # -- reference CheckIODirectories + ComposeOutdirName ----------------
    def setup(self, restart: bool = False, stamp: Optional[str] = None) -> str:
        os.makedirs(self.output_root, exist_ok=True)
        if stamp is None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.run_dir = os.path.join(self.output_root, stamp)
        os.makedirs(self.run_dir, exist_ok=True)
        if restart:
            self.configure_restart()
        self._write_pointer(LAST_RUN_POINTER, stamp)
        return self.run_dir

    def _pointer_path(self, name: str) -> str:
        return os.path.join(self.output_root, name)

    def _write_pointer(self, name: str, value: str) -> None:
        with open(self._pointer_path(name), "w") as f:
            f.write(value + "\n")

    def _read_pointer(self, name: str) -> Optional[str]:
        p = self._pointer_path(name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            v = f.read().strip()
        return v or None

    # -- reference ConfigureRestart (Files.cpp:66-95) --------------------
    def configure_restart(self) -> Optional[str]:
        """Resolve the input dir of the run to restart from: the explicit
        ``run_to_restart_from`` pointer if present, else the last run."""
        stamp = self._read_pointer(RESTART_POINTER) or self._read_pointer(
            LAST_RUN_POINTER)
        if stamp is None:
            return None
        cand = os.path.join(self.output_root, stamp)
        self.restart_dir = cand if os.path.isdir(cand) else None
        return self.restart_dir

    # -- reference PrintRunForRestart (Files.cpp:270-282) ----------------
    def mark_for_restart(self) -> None:
        """Record this run as the restart source for the next run."""
        assert self.run_dir is not None
        self._write_pointer(RESTART_POINTER, os.path.basename(self.run_dir))

    # -- reference CopyInputFiles ----------------------------------------
    def copy_input(self) -> None:
        if self.run_dir and os.path.isdir(self.input_dir):
            dst = os.path.join(self.run_dir, "input")
            shutil.copytree(self.input_dir, dst, dirs_exist_ok=True)

    # -- reference RedirectCout (Files.hpp:131) --------------------------
    @contextlib.contextmanager
    def redirect_stdout(self, filename: str = "run.log"):
        """Redirect prints to ``<run_dir>/<filename>`` for the duration."""
        assert self.run_dir is not None
        path = os.path.join(self.run_dir, filename)
        old = sys.stdout
        with open(path, "a") as f:
            sys.stdout = f
            try:
                yield path
            finally:
                sys.stdout = old

    def path(self, *parts: str) -> str:
        assert self.run_dir is not None
        return os.path.join(self.run_dir, *parts)
