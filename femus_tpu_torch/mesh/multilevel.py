"""Multilevel mesh: hierarchy of uniformly refined levels.

Equivalent of ``MultiLevelMesh`` (MultiLevelMesh.hpp:47: level array,
RefineMesh :161, EraseCoarseLevels :171).  Level 0 is coarsest.
"""
from __future__ import annotations

from typing import List

from ..utils.telemetry import timed
from .mesh import Mesh
from .patches import refine_patched
from .patches3d import refine_patched_hex
from .refine import refine


class MultiLevelMesh:
    @timed("setup.mesh")
    def __init__(self, coarse: Mesh, n_levels: int = 1):
        self.levels: List[Mesh] = [coarse]
        self.refine_to(n_levels)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def dim(self) -> int:
        return self.levels[0].dim

    def finest(self) -> Mesh:
        return self.levels[-1]

    def refine_to(self, n_levels: int) -> None:
        while len(self.levels) < n_levels:
            self.levels.append(refine(self.levels[-1]))

    def erase_coarse_levels(self, n: int) -> None:
        """Drop the n coarsest levels (reference EraseCoarseLevels :171)."""
        self.levels = self.levels[n:]
        self.levels[0].parent_elem = None
        self.levels[0].child_slot = None


class PatchedMultiLevelMesh(MultiLevelMesh):
    """Hierarchy whose refined levels carry patch-coherent node numberings
    (mesh/patches.py): level l >= 1 is ``refine_patched(coarse, l)`` and
    exposes its :class:`~femus_tpu_torch.mesh.patches.PatchPlan` as
    ``mesh.patch_plan``, enabling the patch-stencil operator path
    (SolverConfig.operator = "patch").  Element ORDER matches the plain
    refine() chain at every level, so prolongation lineage
    (``parent_elem``) stays valid across levels.  A hex coarse mesh gets
    the 3-D plans (``mesh.patches3d.refine_patched_hex``)."""

    @timed("setup.mesh")
    def __init__(self, coarse: Mesh, n_levels: int = 1):
        coarse.patch_plan = None
        self.levels = [coarse]
        self.refine_to(n_levels)

    def refine_to(self, n_levels: int) -> None:
        build = refine_patched_hex if self.levels[0].geom == "hex" \
            else refine_patched
        while len(self.levels) < n_levels:
            fine, plan = build(self.levels[0], len(self.levels))
            fine.patch_plan = plan
            self.levels.append(fine)
