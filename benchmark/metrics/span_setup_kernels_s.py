"""span_setup_kernels_s (set-up): the program span ``setup.kernel_load``
(each CUDA library's load, and its nvcc build where the checkout has none
built), its total over the run, in s; nothing where no kernel ran."""
from benchmark.spans import setup_s


def read(run):
    return setup_s("setup.kernel_load")
