"""The controls of ``correct``: the plain reference put in the program's
place and computed one precision below what the configurations state
(float32 with TF32 off, so TF32: the channel's Newton with every product's
operands rounded to TF32 and float32 sums; the patch's fast
diagonalisation with its 1-D matrices rounded to TF32 and decomposed in
float32, every product in TF32) has to come out not correct against each
cell's limits.

At the cells' own sizes these run on the card's machine (marked ``cuda``;
they skip without a card); here at sizes a test run can hold, where the
control reads lower, as its error grows with the mesh."""
import json

import numpy as np
import pytest

from benchmark import plugins, traffic
from benchmark.references.channel_mesh import write_neu
from benchmark.references.ns_channel import ChannelReference
from benchmark.references import poisson_patch
from benchmark.references.poisson_patch import PoissonReference

SPEC = plugins.benchmark_spec()


def _limit(config: str, number: str = "rel_residual") -> float:
    return plugins.config(SPEC, config)["limits"][number]


def _needs_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("runs at the cell's own size on the card's machine")


def _channel_control(tmp_path, refinements):
    ref = ChannelReference(write_neu(str(tmp_path / "channel.neu"), 44, 8),
                           refinements)
    sound = ref.relative_residual(ref.newton())
    control = ref.relative_residual(ref.newton(control=True))
    return sound, control


def _patch_control(n, seeds):
    """{number: (sound, control)} for each seed: the reference's float64
    solve and its TF32 control in the program's place, over the seed's
    first solves, as many as a run judges."""
    ref = PoissonReference(n)
    mix = traffic.load("cold_modes")
    out = []
    for seed in seeds:
        reqs = traffic.requests(mix, seed)
        modes = [next(reqs)["modes"] for _ in range(mix["compare"])]
        sound, control = (poisson_patch.numbers(
            ref, [(ref.solve(m, control=c), m) for m in modes])
            for c in (False, True))
        out.append({k: (sound[k], control[k]) for k in sound})
    return out


def test_channel_control_fails_small(tmp_path):
    sound, control = _channel_control(tmp_path, 1)
    assert sound < 1e-12
    assert control > _limit("dfg-2d1-square-obstacle")


def test_patch_control_fails_small():
    for read in _patch_control(256, (1, 2, 3)):
        for number, (sound, control) in read.items():
            assert sound < 1e-9
            assert control > _limit("poisson-q2-patch-1m", number)


@pytest.mark.cuda
def test_channel_control_fails_at_size(tmp_path):
    _needs_card()
    sound, control = _channel_control(tmp_path, 3)
    print(json.dumps({"control": "channel.steady", "sound": sound,
                      "tf32": control}))
    assert control > _limit("dfg-2d1-square-obstacle")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3,
                                  4_000_000_007])
def test_patch_control_fails_at_size(seed):
    _needs_card()
    cfg = plugins.config(SPEC, "poisson-q2-patch-1m")["mesh"]
    n = cfg["coarse_cells"] * 2 ** (cfg["levels"] - 1)
    read, = _patch_control(n, (seed,))
    print(json.dumps({"control": "patch.solve", "seed": seed, **read}))
    for number, (sound, control) in read.items():
        assert np.isfinite(control)
        assert control > _limit("poisson-q2-patch-1m", number)
