"""Multilevel mesh: hierarchy of uniformly refined levels.

Equivalent of ``MultiLevelMesh`` (MultiLevelMesh.hpp:47: level array,
RefineMesh :161, EraseCoarseLevels :171).  Level 0 is coarsest.
"""
from __future__ import annotations

from typing import List

from .mesh import Mesh
from .refine import refine


class MultiLevelMesh:
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
