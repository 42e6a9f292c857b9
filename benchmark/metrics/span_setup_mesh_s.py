"""span_setup_mesh_s (set-up): the program span ``setup.mesh`` (the mesh
hierarchy: refinement, patch plans, RCM renumbering), its total over the
run, in s."""
from benchmark.spans import setup_s


def read(run):
    return setup_s("setup.mesh")
