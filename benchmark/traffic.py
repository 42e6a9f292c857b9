"""The one traffic generator: reads a mix's parameters from
``benchmark/traffic/<name>.json`` and yields the solves a closed-loop
client sends, drawn from the seed.  Every solve is cold: the driver puts
the problem's own initial state back before it.

Keys of a mix:

- ``loop``: "closed" (one client; the next solve starts when the last has
  ended) -- the only loop these solvers' users run.
- ``modes``: null, or the right-hand side as a sum of sine modes
  sin(k pi x) sin(l pi y): ``count`` modes with 1 <= k, l <= ``max_k``,
  amplitudes uniform in ``amplitude`` with a random sign, drawn anew for
  every solve.
- ``compare``: how many of the window's solves the reference judges, drawn
  from the seed (-1: every one).
- ``trace_solves``: how many solves, from the window's first, a traced run
  profiles.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    """The mix ``benchmark/traffic/<name>.json``, checked."""
    with open(os.path.join(HERE, "traffic", name + ".json")) as fh:
        mix = json.load(fh)
    if mix.get("loop") != "closed":
        raise ValueError(f"traffic {name}: loop must be 'closed'")
    for key in ("compare", "trace_solves"):
        if not isinstance(mix.get(key), int):
            raise ValueError(f"traffic {name}: {key} must be a whole number")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the seed (any whole number >= 0)."""
    return np.random.default_rng([stream, int(seed)])


def _draw_modes(spec: Dict, gen: np.random.Generator) -> np.ndarray:
    n, top = int(spec["count"]), int(spec["max_k"])
    lo, hi = spec["amplitude"]
    k = gen.integers(1, top + 1, size=n)
    l = gen.integers(1, top + 1, size=n)
    a = gen.uniform(lo, hi, size=n) * gen.choice([-1.0, 1.0], size=n)
    return np.stack([k, l, a], axis=1).astype(np.float64)


def requests(mix: Dict, seed: int) -> Iterator[Dict]:
    """Endless solves: {"index", "modes" ((count, 3) rows of k, l,
    amplitude, or None)}.  The first is the warm-up."""
    gen = rng(seed, 0)
    spec = mix.get("modes")
    i = 0
    while True:
        modes = _draw_modes(spec, gen) if spec else None
        yield {"index": i, "modes": modes}
        i += 1


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``gen`` (``k`` < 0 keeps every item).  ``offer(i, take)`` calls
    ``take()`` only for an item that enters the sample."""

    def __init__(self, k: int, gen: np.random.Generator):
        self.k, self.gen, self.items = k, gen, {}

    def offer(self, i: int, take) -> None:
        if self.k < 0 or i < self.k:
            self.items[i] = take()
            return
        j = int(self.gen.integers(0, i + 1))
        if j < self.k:
            victim = sorted(self.items)[j]
            del self.items[victim]
            self.items[i] = take()

    def sample(self):
        return [self.items[i] for i in sorted(self.items)]
