"""Import hygiene and device policy of the PyTorch port.

The port imports neither JAX nor anything of the JAX package, and its
entry points run on the card unless the caller asks for the host: without
CUDA they raise instead of falling back.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import femus_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(femus_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="femus_tpu_torch."))


def test_importing_every_module_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'femus_tpu' or "
            "k.startswith('femus_tpu.'))\n"
            "print(len(sys.modules), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout
    assert len(_modules()) >= 20


def test_no_source_file_imports_the_jax_package():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    root = n.split(".")[0]
                    assert root not in ("jax", "jaxlib", "femus_tpu"), \
                        f"{path}: imports {n}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from femus_tpu_torch.algebra.bell import build_bell_plan, relayout_ell
    from femus_tpu_torch.algebra.mg import build_hierarchy
    from femus_tpu_torch.assembly.engine import Assembler, Unknown
    from femus_tpu_torch.mesh.generation import unit_box
    from femus_tpu_torch.mesh.multilevel import MultiLevelMesh
    from femus_tpu_torch.systems.problem import MultiLevelProblem
    from femus_tpu_torch.systems.solution import MultiLevelSolution
    from femus_tpu_torch.systems.system import LinearImplicitSystem

    mesh = unit_box((2, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Assembler(mesh, [Unknown("u")])
    a = Assembler(mesh, [Unknown("u")], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        relayout_ell(build_bell_plan(a.pattern),
                     torch.zeros(a.pattern.cols.shape, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_hierarchy(None, [])
    ml_mesh = MultiLevelMesh(unit_box((2, 2)), 2)
    ml_sol = MultiLevelSolution(ml_mesh)
    ml_sol.add_solution("u")
    prob = MultiLevelProblem(ml_mesh, ml_sol)
    sys_ = prob.add_system(LinearImplicitSystem, "P")
    sys_.add_unknown("u")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys_.init()
    sys_.init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys_.solve(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys_.step_fn(device="cuda")


def test_cuda_matvec_never_falls_back_to_the_host():
    """A CUDA tensor goes to the kernel or raises: here (no card, or a
    mismatched plan) it raises rather than running the plain version."""
    from femus_tpu_torch.algebra import bell
    from femus_tpu_torch.algebra.sparse import pattern_from_pairs

    pat = pattern_from_pairs(np.arange(64), np.arange(64), 64, 64)
    op = bell.relayout_ell(bell.build_bell_plan(pat),
                           torch.ones(64, 1, dtype=torch.float64),
                           device="cpu")
    with pytest.raises((ValueError, RuntimeError, AssertionError)):
        bell.spmv_bell_cuda(op, torch.ones(64, dtype=torch.float64))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
