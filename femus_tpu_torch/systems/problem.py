"""MultiLevelProblem: top-level container binding meshes, solutions, systems."""
from __future__ import annotations

from typing import Dict, Type

from ..mesh.multilevel import MultiLevelMesh
from .solution import MultiLevelSolution
from .system import System


class MultiLevelProblem:
    def __init__(self, ml_mesh: MultiLevelMesh, ml_sol: MultiLevelSolution,
                 quad_order="fifth"):
        self.ml_mesh = ml_mesh
        self.ml_sol = ml_sol
        self.quad_order = quad_order
        self.systems: Dict[str, System] = {}

    def add_system(self, cls: Type[System], name: str, **kw) -> System:
        sys = cls(self, name, **kw)
        self.systems[name] = sys
        return sys

    def get_system(self, name: str) -> System:
        return self.systems[name]
