"""Output writers: VTK (.vtu/.pvtu), GMV (binary), XDMF (+HDF5).

``build_writer`` mirrors the reference Writer factory (Writer.hpp:44,
build :58-61 over WriterEnum {VTK, GMV, XDMF}).  Host numpy own copies of
``femus_tpu.io``: the files are byte for byte the JAX package's, and the
arrays handed in may be torch tensors on any device.
"""
from .gmv import GMVWriter, read_gmv, write_gmv                 # noqa: F401
from .vtk import (VTKWriter, nodal_field, write_parallel,       # noqa: F401
                  write_pvtu, write_vtu)
from .xdmf import XDMFWriter, read_xdmf_h5, write_xdmf          # noqa: F401

_WRITERS = {"vtk": VTKWriter, "gmv": GMVWriter, "xdmf": XDMFWriter}


def build_writer(kind: str, ml_sol):
    """Writer::build equivalent: kind in {"vtk", "gmv", "xdmf"}."""
    try:
        return _WRITERS[kind.lower()](ml_sol)
    except KeyError:
        raise ValueError(f"unknown writer '{kind}'; one of {sorted(_WRITERS)}")
