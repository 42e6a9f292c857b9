"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, full 700 W power limit), and the least time a piece of work needs.

A frozen copy of the constants of the repository's ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S``, ``F64_FLOPS_PER_S``):
HBM3 at 3.35 TB/s; 67 TFLOP/s in float32 and 34 TFLOP/s in float64
outside the tensor cores.  A matvec's work in bf16 or fp16 values is
counted against the float32 rate, its accumulation type.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float64": 34e12, "float32": 67e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The larger of the bytes over the HBM bandwidth and the operations
    over the peak rate of ``dtype`` ("float64"; anything else counts as
    "float32")."""
    rate = FLOPS_PER_S["float64" if dtype == "float64" else "float32"]
    return max(nbytes / HBM_BYTES_PER_S, flops / rate)
