"""Port parity: the halo-exchange SpMV (``parallel/halo.py``) and the rank
launcher (``parallel/ranks.py``) against femus_tpu, in float64 on the host.

The HaloPlan arrays EQUAL the JAX package's for 2-8 shards.  Four gloo
ranks (spawned processes meeting through a file store) run the SpMV of a
Q2 Poisson operator and of the cavity's Navier-Stokes Jacobian through
both transports, with and without overlap, with the ELL gather and the
sliced-ELL blocks of kernel B1 (its plain version on the CPU); the joined
result is within 1e-12 of the global matvec and of the JAX package's
``make_halo_spmv`` on ``device_mesh(4)``.  A rank that raises or hangs
fails the launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femus_tpu.assembly.bc import apply_dirichlet_values as japply
from femus_tpu.assembly.bc import generate_bdc as jbdc
from femus_tpu.assembly.engine import Assembler as JAssembler
from femus_tpu.assembly.engine import Unknown as JUnknown
from femus_tpu.assembly.forms import navier_stokes as jns
from femus_tpu.assembly.forms import poisson as jpoisson
from femus_tpu.mesh.generation import unit_box as junit_box
from femus_tpu.mesh.reorder import rcm_reorder as jrcm
from femus_tpu.parallel import halo as jhalo
from femus_tpu.parallel.spmd import device_mesh as jdevice_mesh
from femus_tpu_torch.algebra.sparse import pad_pattern
from femus_tpu_torch.parallel import cases, halo
from femus_tpu_torch.parallel.ranks import launch
from femus_tpu_torch.parallel.spmd import padded_rows

S = 4
CASES = [("poisson", 8, "f64"), ("cavity", 4, "f64")]
VARIANTS = [(fmt, tr, ov) for fmt in ("ell", "bell")
            for tr in ("all_to_all", "ppermute") for ov in (False, True)]

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: beside the other test workers
    and the spawned ranks, the many small torch ops of these cases spend
    their time in thread barriers otherwise (the 3-D patch solve took
    minutes under a parallel run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _jax_assembler(case, n, shards):
    if case == "poisson":
        a = JAssembler(junit_box((n, n), "quad"),
                       [JUnknown("u", "biquadratic")], quad_order="fifth",
                       pad_dofs_to=shards)
        a.set_volume_form(jpoisson("u", "biquadratic",
                                   rhs=lambda x: 1.0 + 0.0 * x[:, 0]))
        jbdc(a, lambda var, x, grp, t: (True, 0.0))
        return a
    a = JAssembler(jrcm(junit_box((n, n), "quad")),
                   [JUnknown("u", "biquadratic"),
                    JUnknown("v", "biquadratic"),
                    JUnknown("p", "disc_linear")], quad_order="fifth",
                   pad_dofs_to=shards, interleave=True)
    a.set_volume_form(jns(("u", "v"), "p", pres_family="disc_linear",
                          nu=0.01))
    jbdc(a, cases._lid)
    return a


@pytest.mark.parametrize("case,n", [("poisson", 8), ("cavity", 4)])
@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_halo_plan_equal(case, n, shards):
    ja = _jax_assembler(case, n, shards)
    tp = pad_pattern(cases._operator(case, n, "cpu", torch.float64)[0]
                     .pattern, ja.n_dofs_pad, ja.n_dofs_pad)
    assert padded_rows(tp.n_rows, shards) == ja.n_dofs_pad
    jp = jhalo.build_halo_plan(ja.pattern, shards)
    pp = halo.build_halo_plan(tp, shards)
    for f in ("n_shards", "rows_per_shard", "m", "n_rows", "offs"):
        assert getattr(jp, f) == getattr(pp, f), f
    for f in ("send_idx", "cols_local", "bnd_rows"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(pp, f))
    assert len(jp.off_send) == len(pp.off_send)
    for a, b in zip(jp.off_send, pp.off_send):
        np.testing.assert_array_equal(a, b)
    assert jp.banded == pp.banded


@pytest.fixture(scope="module")
def ranks():
    """One launch of 4 gloo ranks running every case and variant."""
    return launch(cases.halo_rank, S, (CASES, VARIANTS), device="cpu",
                  timeout=240, quiet=True)


@pytest.fixture(scope="module")
def reference():
    """Per case: x, the JAX package's global product and its halo SpMV on
    device_mesh(4)."""
    out = {}
    for case, n, dt in CASES:
        ja = _jax_assembler(case, n, S)
        u = jnp.asarray(japply(ja, np.zeros(ja.n_dofs_pad)))
        _, data = jax.jit(ja.make_assemble_fn())(u)
        x = np.random.default_rng(0).standard_normal(ja.n_dofs_pad)
        y_glob = np.asarray(ja.op_with(data) @ jnp.asarray(x))
        dm = jdevice_mesh(S)
        plan = jhalo.build_halo_plan(ja.pattern, S)
        spmv, sh = jhalo.make_halo_spmv(plan, dm)
        dd = jax.device_put(data, jax.sharding.NamedSharding(
            dm, jax.sharding.PartitionSpec("mesh", None)))
        y_halo = np.asarray(jax.jit(spmv)(dd, jax.device_put(
            jnp.asarray(x), sh)))
        out[f"{case}-{n}-{dt}"] = (ja.n_dofs, x, y_glob, y_halo)
    return out


@pytest.mark.parametrize("case", [f"{c}-{n}-{d}" for c, n, d in CASES])
@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["/".join(map(str, v)) for v in VARIANTS])
def test_halo_spmv_matches_global_and_jax(ranks, reference, case, variant):
    fmt, tr, ov = variant
    key = f"{fmt}/{tr}/{'overlap' if ov else 'seq'}"
    n, x, y_glob, y_halo = reference[case]
    y = np.concatenate([r[case]["y"][key] for r in ranks])
    assert y.shape == y_glob.shape
    np.testing.assert_allclose(y[:n], y_glob[:n], rtol=0, atol=1e-12)
    np.testing.assert_allclose(y[:n], y_halo[:n], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(y[n:], x[n:])      # identity pad rows
    note = ranks[0][case]["note"][key]
    assert note["transport"] == tr and note["asked"] == tr
    # the ranks' own rows tile the padded vector
    assert [r[case]["rows"] for r in ranks] == [
        (s * len(y) // S, (s + 1) * len(y) // S) for s in range(S)]


def test_transport_rule():
    """auto: ppermute on a banded graph, all_to_all past 6 offsets; a gloo
    group of CUDA ranks takes all_to_all (gloo's send/recv refuse CUDA
    tensors), and ppermute asked for there raises."""
    from femus_tpu_torch.parallel.ranks import RankGroup
    pat = pad_pattern(cases._operator("poisson", 8, "cpu", torch.float64)[0]
                      .pattern, 296, 296)
    cpu = RankGroup(S, 1, torch.device("cpu"), "gloo")
    card = RankGroup(S, 1, torch.device("cuda", 0), "gloo")
    nccl = RankGroup(S, 1, torch.device("cuda", 1), "nccl")
    plan = halo.build_halo_plan(pat, S)
    assert plan.banded
    pick = lambda g, t="auto": halo.choose_transport(plan, g, t)[0]  # noqa
    assert pick(cpu) == pick(nccl) == "ppermute"
    assert pick(card) == "all_to_all"
    with pytest.raises(ValueError, match="refuse CUDA tensors"):
        pick(card, "ppermute")
    assert pick(cpu, "all_to_all") == pick(card, "all_to_all") == \
        "all_to_all"
    wide = halo.build_halo_plan(pat, 8)
    wide.offs = tuple(range(-7, 8))
    assert halo.choose_transport(wide, cpu)[0] == "all_to_all"
    with pytest.raises(ValueError):
        pick(cpu, "broadcast")
    one = RankGroup(1, 0, torch.device("cpu"), "none")
    assert halo.HaloExchange(halo.build_halo_plan(pat, 1), one).transport \
        == "none"


@pytest.mark.parametrize("hang", [False, True])
def test_launch_fails_on_a_failed_or_hung_rank(hang):
    with pytest.raises((RuntimeError, TimeoutError)) as err:
        launch(cases.fail_rank, 2, (1, hang), device="cpu",
               timeout=4 if hang else 60, quiet=True)
    assert ("fails on purpose" in str(err.value)) != hang
    assert isinstance(err.value, TimeoutError) == hang
