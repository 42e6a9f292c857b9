"""Reference-application equivalents (SURVEY.md §2.3).

Each module wires meshes + unknowns + forms + BCs into a runnable problem,
the way each ``applications/*/main.cpp`` of the reference does, so golden
runs and benchmarks can share one setup.  The meshes are the reference's
Gambit files under ``FEMUS_DIR``; every function that reads one takes its
path (``mesh_path``), so a caller can hand it a mesh of its own.
"""
import os

# the FEMuS source tree whose unittests and applications hold the
# reference meshes (the location the JAX package reads them from)
FEMUS_DIR = os.path.join(os.sep, "root", "reference")
