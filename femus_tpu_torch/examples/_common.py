"""What the examples share: their precision and their command line.

The examples run in float64, the JAX examples' own precision, on the card
unless the caller asks for the host (``main(device="cpu")``, or ``--device
cpu`` on the command line); without CUDA and without that request they
raise.  Their knobs are the JAX examples' environment variables.
"""
from __future__ import annotations

import argparse
import os

import torch

DTYPE = torch.float64


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def cli(main) -> None:
    """``python -m femus_tpu_torch.examples.<name> [--device cpu]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
