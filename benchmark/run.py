"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``femus_tpu_torch``).
The last line of standard output is the result, as JSON; the numbers the
reference compared, each beside its limit, end standard error.
"""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the checkout's root, in place of this file's folder, whose module
    # names (trace, traffic) would hide the standard library's
    sys.path[0] = root
    from benchmark.harness import main
    sys.exit(main(t_start=T_START))
