"""Port parity: the stacked Navier-Stokes cavity with rediscretized coarse
levels on the BELL operator (the plain frame matvec on the host), against
femus_tpu in float64: equal GMRES iterations over 4 Newton steps, u, v, p
to 1e-8, the fine level routed onto the BELL frame.  The "assembled" case
of the same test is in test_torch_rediscretize.py: the two long cases sit
in two files so that a parallel run (``--dist loadfile``) gives them to
two workers.
"""
import pytest

from cavity_cases import check_cavity_rediscretized


@pytest.mark.parametrize("operator", ["bell"])
def test_cavity_rediscretized_matches_jax(operator):
    check_cavity_rediscretized(operator)
