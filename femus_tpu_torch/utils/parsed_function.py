"""Runtime-parsed analytic expressions.

Equivalent of the reference ``ParsedFunction`` (src/02_calculus/, backed by
the optional fparser library): an expression string in the variables
``x, y, z, t`` evaluated vectorized. Used for boundary conditions and initial
conditions given as strings (MultiLevelSolution parsed-function BCs,
MultiLevelSolution.hpp:420-427).

The expression is compiled once into Python bytecode and evaluated in a
restricted namespace exposing only numpy math — no builtins.  A host
own copy of ``femus_tpu.utils.parsed_function``; the coordinates may be a
torch tensor on any device (copied to the host), the values are numpy.
"""
from __future__ import annotations

import numpy as np

from ..convert import to_numpy

_SAFE = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
    "acos": np.arccos, "atan": np.arctan, "atan2": np.arctan2,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "exp": np.exp, "log": np.log, "log10": np.log10, "sqrt": np.sqrt,
    "abs": np.abs, "min": np.minimum, "max": np.maximum,
    "floor": np.floor, "ceil": np.ceil, "sign": np.sign,
    "pow": np.power, "pi": np.pi, "e": np.e,
}


class ParsedFunction:
    """``ParsedFunction("sin(pi*x)*cos(pi*y)")`` -> callable(x, t=0)."""

    def __init__(self, expression: str, variables: str = "x,y,z,t"):
        self.expression = expression
        self.variables = [v.strip() for v in variables.split(",")]
        if "__" in expression:
            raise ValueError("double underscore not allowed in expression")
        self._code = compile(expression, "<parsed_function>", "eval")
        for name in self._code.co_names:
            if name not in _SAFE and name not in self.variables:
                raise ValueError(f"unknown symbol '{name}' in expression")

    def __call__(self, x, t: float = 0.0):
        """x: (..., dim) coordinates; returns array of shape (...,)."""
        x = to_numpy(x).astype(float)
        pts = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
        ns = dict(_SAFE)
        for i, v in enumerate(self.variables[:3]):
            ns[v] = pts[:, i] if i < pts.shape[1] else np.zeros(len(pts))
        if len(self.variables) > 3:
            ns[self.variables[3]] = t
        out = eval(self._code, {"__builtins__": {}}, ns)  # noqa: S307
        out = np.broadcast_to(np.asarray(out, dtype=float), (len(pts),))
        return out.reshape(x.shape[:-1]) if x.ndim > 1 else float(out[0])
