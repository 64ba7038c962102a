"""The port's Frank–Wolfe primal, its plan lanes and the primal/certified
engines against the reference.

Both packages run the same algorithm on the same instances (the reference's
generators, handed over through ``Topology.from_arrays``), so the bounds
are held within rel 1e-3 at the same iters/lr and ``tol=0`` (no lane stops
at another window), and every bracket must contain the HiGHS optimum.

The schedule's bits.  The port computes each step's learning rate and
Adam's bias corrections on the host in float64 and rounds them to float32
(``primal._schedule``), so every device gets the same bits; the reference
computes them in float32 inside its compiled loop, where XLA folds
``pi*i/iters`` and ``cos`` its own way.  The two differ by an ulp in most
steps (149 of 200 learning rates and all 200 of ``1 - 0.999**t`` at iters =
200), and an ulp in the step moves the lengths.  The lengths converge to
the dual optimum, where many shortest paths tie; once two tied paths differ
by ~1e-6 of their value, the SP-DAG's tie test (relative 1e-6) splits a
pair's demand in one package and not in the other, and the FW direction
moves a whole demand unit.  A lockstep replay of the reference's step,
evaluated op by op, shows one such flip on ``_pile``'s n = 16 instance at
step 124 (``sp`` differs by 0.5); the two lower bounds then end 1.6e-3
apart at 200 steps.  On its own schedule the port misses rel 1e-3 in lb or
``final_util`` on 10 of 12 seeded RRG(12..20, 4) instances at 200 steps,
while ub, a minimum over the iterates, stays within 4e-4 on all of them.
So the parity tests hand the port the reference's own schedule bits
(``_reference_schedule``: the reference's three float32 lines run by XLA)
and hold the rest of the step to rel 1e-3;
``test_schedule_is_the_reference_schedule`` holds the port's schedule to
the reference's own float32 error, and
``test_unaligned_schedule_keeps_the_bracket`` holds the unaligned port to
the reference's ub and to the LP bracket.  The reference itself shows the
same sensitivity: its plan lane and its single solve of the same instance
differ by 0.52% (ROADMAP R1).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as r_engine  # noqa: E402
from repro.core import graphs as r_graphs  # noqa: E402
from repro.core import lp as r_lp  # noqa: E402
from repro.core import primal as r_primal  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro.core import vl2 as r_vl2  # noqa: E402
from repro.core.plan import BatchPlan as RPlan  # noqa: E402
from repro_torch.core import engine as p_engine  # noqa: E402
from repro_torch.core import graphs as p_graphs  # noqa: E402
from repro_torch.core import primal as p_primal  # noqa: E402
from repro_torch.core.graphs import Topology  # noqa: E402
from repro_torch.core.plan import BatchPlan as PPlan  # noqa: E402

_REL = 1e-3
_NS = (12, 14, 16, 20)
_ITERS = 200


def _pile(ns=_NS, deg=4, servers=3):
    """(reference topologies, port topologies, demands): the port gets the
    reference's exact instances through from_arrays."""
    rt, pt, dems = [], [], []
    for s, n in enumerate(ns):
        t = r_graphs.random_regular_graph(n, deg, seed=s, servers=servers)
        rt.append(t)
        pt.append(Topology.from_arrays(dataclasses.asdict(t)))
        dems.append(r_traffic.make("permutation", t.servers, seed=s + 1))
    return rt, pt, dems


@contextlib.contextmanager
def _reference_schedule():
    """Run the port with the reference's schedule bits: step ``i``'s
    learning rate and bias corrections computed by the reference's own
    float32 lines (``repro.core.primal._solve_one``) under ``jax.jit``."""
    tables = {}

    def schedule(i, iters, lr):
        if (iters, lr) not in tables:
            @jax.jit
            def f(i, lr_peak):
                t = i + 1
                return (lr_peak * 0.5 * (1 + jnp.cos(jnp.pi * i / iters))
                        + 1e-3, 1 - 0.9 ** t, 1 - 0.999 ** t)
            tables[iters, lr] = [
                tuple(float(x) for x in f(jnp.int32(k), jnp.float32(lr)))
                for k in range(iters)]
        return tables[iters, lr][i]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_primal, "_schedule", schedule)
        yield


def _theta(topo, dem):
    return r_lp.max_concurrent_flow(np.asarray(topo.cap), dem,
                                    want_flows=False).throughput


@pytest.fixture(scope="module")
def singles():
    """One solve of each ``_pile`` instance in each package."""
    rt, pt, dems = _pile()
    ref = [r_primal.solve_primal(t, d, iters=_ITERS) for t, d in zip(rt, dems)]
    with _reference_schedule():
        port = [p_primal.solve_primal(t, d, iters=_ITERS, device="cpu")
                for t, d in zip(pt, dems)]
    return ref, port, [_theta(t, d) for t, d in zip(pt, dems)]


@pytest.mark.parametrize("i", range(len(_NS)), ids=[f"n{n}" for n in _NS])
def test_solve_primal_matches_reference(singles, i):
    ref, port, theta = singles
    r, p = ref[i], port[i]
    assert p.throughput_lb == pytest.approx(r.throughput_lb, rel=_REL)
    assert p.throughput_ub == pytest.approx(r.throughput_ub, rel=_REL)
    assert p.final_util == pytest.approx(r.final_util, rel=_REL)
    assert p.iterations == r.iterations == _ITERS
    # the bracket contains the LP optimum
    assert p.throughput_lb <= theta[i] * (1 + 1e-6)
    assert theta[i] <= p.throughput_ub * (1 + 1e-6)
    assert p.gap == pytest.approx(
        (p.throughput_ub - p.throughput_lb) / p.throughput_ub)


def test_schedule_is_the_reference_schedule():
    """The port's host-side schedule is the reference's float32 one at
    every step, to the reference's own float32 error: the learning rate
    within rel 3e-6 (XLA folds ``pi * i / iters`` and ``cos`` in float32,
    up to 33 ulps off at iters = 1000), the bias corrections within 5e-6
    (the reference's float32 ``0.999 ** t`` is off by up to 4.8e-6, which
    ``1 - 0.999 ** t`` keeps as an absolute error)."""
    for iters in (200, 800, 1000):
        with _reference_schedule():
            ref = np.array([p_primal._schedule(i, iters, 0.08)
                            for i in range(iters)])
        port = np.array([p_primal._schedule(i, iters, 0.08)
                         for i in range(iters)])
        np.testing.assert_allclose(port[:, 0], ref[:, 0], rtol=3e-6)
        np.testing.assert_allclose(port[:, 1:], ref[:, 1:], rtol=0,
                                   atol=5e-6)
        assert np.array_equal(port.astype(np.float32), port)


def test_unaligned_schedule_keeps_the_bracket(singles):
    """The port on its own schedule: the reference's ub within rel 1e-3
    and the LP bracket on every instance (lb and ``final_util`` go where
    the tie flips of the module docstring send them)."""
    ref, _, theta = singles
    _, pt, dems = _pile()
    for r, t, d, th in zip(ref, pt, dems, theta):
        p = p_primal.solve_primal(t, d, iters=_ITERS, device="cpu")
        assert p.throughput_ub == pytest.approx(r.throughput_ub, rel=_REL)
        assert p.throughput_lb <= th * (1 + 1e-6) <= p.throughput_ub * (
            1 + 2e-6)
        assert p.iterations == _ITERS


def test_plan_lanes_match_reference_plan_lanes(singles):
    """Padded plan lanes (pow2: n = 12, 14 padded to 16, n = 20 alone in
    bucket 32) against the reference's plan lanes.  The n = 20 lane is
    R1's lane, which the reference cannot reproduce itself: at 200 steps
    its plan lane's lb is 2.6e-3 below its own ``solve_primal`` (0.5131 vs
    0.5145).  The port's lane (0.5149) is within 8e-4 of the latter and
    3.4e-3 above the former (``final_util`` 4.0e-3 below), a tie flip of
    the kind the module docstring shows, so that lane is held to its ub,
    to the LP bracket and to the port's own single solve, bit for bit (the
    port's lanes do not depend on their batch)."""
    rt, pt, dems = _pile()
    ref = RPlan.build(rt, dems, devices=1).execute(solver="primal",
                                                   iters=_ITERS)
    plan = PPlan.build(pt, dems)
    with _reference_schedule():
        port = plan.execute(solver="primal", iters=_ITERS, device="cpu")
    assert [s.meta["padded_n"] for s in port] == [16, 16, 16, 20]
    for n, r, p in zip(_NS, ref, port):
        assert p.meta["ub"] == pytest.approx(r.meta["ub"], rel=_REL)
        assert p.iterations == r.iterations == _ITERS
        assert set(p.meta) == set(r.meta)
        for k in ("bucket", "padded_n", "nodes", "batch_size", "chunk",
                  "chunks", "devices", "plan"):
            assert p.meta[k] == r.meta[k], k
        if n == 20:
            continue
        assert p.value == pytest.approx(r.value, rel=_REL)
        assert p.meta["final_util"] == pytest.approx(r.meta["final_util"],
                                                     rel=_REL)
    _, port_single, theta = singles
    lane = port[3]
    assert lane.value == port_single[3].throughput_lb
    assert lane.meta["ub"] == port_single[3].throughput_ub
    assert lane.meta["final_util"] == port_single[3].final_util
    for p, th in zip(port, theta):
        assert p.value <= th * (1 + 1e-6) and th <= p.meta["ub"] * (1 + 1e-6)


# the conformance corpus without the adversarial pattern (not ported yet)
_VL2 = r_vl2.VL2Spec(d_a=4, d_i=4, servers_per_tor=5)
_TOPOLOGIES = {
    "random_regular": lambda: r_graphs.random_regular_graph(
        16, 4, seed=0, servers=3),
    "biased_two_cluster": lambda: r_graphs.biased_two_cluster_graph(
        [6] * 8, [4] * 8, cross_bias=0.6, seed=1, servers=2),
    "vl2": lambda: r_vl2.vl2_topology(_VL2, n_tor=4),
}
_PATTERNS = ("permutation", "all_to_all", "all_to_one", "stride")
_CASES = [(t, p) for t in sorted(_TOPOLOGIES) for p in _PATTERNS]
_CORPUS_ITERS = 1000


@pytest.fixture(scope="module")
def corpus():
    """The corpus through each package's certified engine, one batched
    solve each, and the LP optimum of every case."""
    rt, dems = [], []
    for topo_name, pattern in _CASES:
        rt.append(_TOPOLOGIES[topo_name]())
        dems.append(r_traffic.make(pattern, rt[-1].servers, seed=11))
    pt = [Topology.from_arrays(dataclasses.asdict(t)) for t in rt]
    ref = r_engine.get_engine("certified", iters=_CORPUS_ITERS,
                              devices=1).solve_batch(rt, dems)
    with _reference_schedule():
        port = p_engine.get_engine("certified", iters=_CORPUS_ITERS,
                                   device="cpu").solve_batch(pt, dems)
    return ref, port, [_theta(t, d) for t, d in zip(pt, dems)]


@pytest.mark.parametrize("i", range(len(_CASES)),
                         ids=[f"{t}-{p}" for t, p in _CASES])
def test_certified_corpus_brackets_the_lp(corpus, i):
    ref, port, theta = corpus
    r, p = ref[i], port[i]
    assert p.bound == "bracket" and p.engine == "certified"
    assert p.meta["lb"] <= theta[i] * (1 + 1e-6), "lb above the optimum"
    assert theta[i] <= p.meta["ub"] * (1 + 1e-6), "ub below the optimum"
    assert p.meta["gap"] < 0.05
    assert p.meta["lb"] == pytest.approx(r.meta["lb"], rel=_REL)
    assert p.meta["ub"] == pytest.approx(r.meta["ub"], rel=_REL)


def test_unroutable_demand_gives_zero_lb():
    """Two components with demand across them: θ* = 0, so lb = 0 in both
    packages; under ``on_disconnected="drop"`` an instance with no routable
    demand is never solved and reports a zero bracket."""
    a = r_graphs.random_regular_graph(8, 3, seed=0).cap
    cap = np.zeros((16, 16))
    cap[:8, :8] = a
    cap[8:, 8:] = a
    dem = np.zeros((16, 16))
    dem[0, 9] = dem[3, 12] = 1.0
    ref = r_primal.solve_primal(cap, dem, iters=30)
    port = p_primal.solve_primal(cap, dem, iters=30, device="cpu")
    assert ref.throughput_lb == port.throughput_lb == 0.0
    assert port.throughput_ub == pytest.approx(ref.throughput_ub, rel=_REL)
    topo = Topology(cap=cap, servers=np.ones(16, np.int64))
    [res] = p_engine.get_engine("certified", iters=30, device="cpu",
                                on_disconnected="drop").solve_batch([topo],
                                                                    [dem])
    assert res.meta["disconnected"] and res.meta["lb"] == res.meta["ub"] == 0
    assert res.meta["dropped_demand_fraction"] == 1.0
    single = p_engine.get_engine("primal", iters=30, device="cpu",
                                 on_disconnected="drop").solve(topo, dem)
    assert single.throughput == 0.0 and single.meta["ub"] == 0.0


def test_empty_and_mismatched_batches():
    empty = p_primal.solve_primal_batch([], [], device="cpu")
    assert len(empty) == 0 and empty.iterations.dtype == np.int32
    _, pt, dems = _pile((12, 14))
    with pytest.raises(ValueError, match="equal length"):
        p_primal.solve_primal_batch([pt[0].cap], dems, device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        p_engine.get_engine("certified", device="cpu").solve_batch(pt,
                                                                   dems[:1])
    assert p_engine.get_engine("certified", device="cpu").solve_batch(
        [], []) == []


def test_early_stopping_keeps_the_bracket():
    """Lanes stop at a window end before the cap with the bracket intact,
    and a stopped lane is the full run frozen early: ``tol`` changes
    nothing but ``done``, so its lb is at most, and its ub at least, the
    full run's.  The stop window itself is not held to the reference's:
    the stop test compares the gap's shrinkage over a window with ``tol``,
    and the tie flips of the module docstring move the gap by more than
    that (the reference's own plan lane and single solve of ``_pile``'s
    n = 20 instance stop at 450 and 275)."""
    _, pt, dems = _pile((16, 16))   # two instances, unpadded lanes
    out = p_engine.get_engine("certified", iters=800, tol=1e-3,
                              device="cpu").solve_batch(pt, dems)
    full = p_engine.get_engine("certified", iters=800,
                               device="cpu").solve_batch(pt, dems)
    for p, f, t, d in zip(out, full, pt, dems):
        assert p.meta["iterations"] < 800 == f.meta["iterations"]
        assert p.meta["iterations"] % 25 == 0
        th = _theta(t, d)
        assert p.meta["lb"] <= th * (1 + 1e-6) <= p.meta["ub"] * (1 + 2e-6)
        assert p.meta["lb"] <= f.meta["lb"] and p.meta["ub"] >= f.meta["ub"]
        single = p_primal.solve_primal(t, d, iters=800, tol=1e-3,
                                       device="cpu")
        assert (single.throughput_lb, single.throughput_ub,
                single.iterations) == (p.meta["lb"], p.meta["ub"],
                                       p.meta["iterations"])


def test_primal_engine_result_contract():
    _, pt, dems = _pile((16,))
    eng = p_engine.get_engine("primal", iters=100, device="cpu")
    single = eng.solve(pt[0], dems[0])
    assert single.engine == "primal" and single.bound == "lower"
    assert not single.is_upper_bound
    assert set(single.meta) == {"iterations", "final_util", "ub"}
    [batched] = eng.solve_batch(pt, dems)
    # an unpadded lane is the single solve, bit for bit
    assert batched.throughput == single.throughput
    assert batched.bound == "lower"
    assert {"iterations", "final_util", "ub", "bucket", "chunk",
            "plan"} <= set(batched.meta)


def test_certified_engine_bracket_contract():
    _, pt, dems = _pile((12, 16))
    eng = p_engine.get_engine("certified", iters=100, device="cpu")
    out = eng.solve_batch(pt, dems)
    for t, d, got in zip(pt, dems, out):
        assert got.engine == "certified" and got.bound == "bracket"
        assert got.is_upper_bound and got.throughput == got.meta["ub"]
        assert 0 <= got.meta["lb"] <= got.meta["ub"]
        assert got.meta["gap"] == pytest.approx(
            (got.meta["ub"] - got.meta["lb"]) / got.meta["ub"])
        single = eng.solve(t, d)
        assert single.bound == "bracket"
        assert set(single.meta) == {"lb", "ub", "gap", "iterations",
                                    "final_util"}
        assert single.meta["lb"] == pytest.approx(got.meta["lb"], rel=_REL)
        assert single.meta["ub"] == pytest.approx(got.meta["ub"], rel=_REL)
    # the dual engine's meta keeps its own keys
    [dual] = p_engine.get_engine("dual", iters=20, device="cpu").solve_batch(
        pt[:1], dems[:1])
    assert set(dual.meta) == {"iterations", "final_ratio", "batch_size",
                              "bucket", "padded_n", "nodes", "chunk",
                              "chunks", "devices", "plan"}
    eng = p_engine.get_engine("certified", iters=30, bucket=None,
                              max_lanes=4, device="cpu")
    assert isinstance(eng, p_engine.CertifiedEngine)
    assert eng.bucket is None and eng.max_lanes == 4
    with pytest.raises(ValueError, match="bucket mode"):
        p_engine.get_engine("certified", bucket="fib")


def _vl2_build(mod):
    return lambda x, seed: mod.vl2_topology(
        mod.VL2Spec(d_a=4, d_i=4, servers_per_tor=5), n_tor=int(x))


def test_run_sweep_aggregates_brackets_as_reference():
    """``lb_mean`` / ``gap_max`` against the reference's on a VL2 sweep,
    whose shortest paths do not tie: lb reaches θ exactly in both packages,
    so the gap is the ub's and the tie flips of the module docstring cannot
    move it.  Each point is also its own runs' brackets, exactly."""
    from repro_torch.core import vl2 as p_vl2

    class Kept(p_engine.CertifiedEngine):
        def solve_batch(self, topos, dems):
            self.kept = super().solve_batch(topos, dems)
            return self.kept

    sweep = dict(xs=(3.0, 4.0), runs=2, traffic="stride")
    a = r_engine.run_sweep(r_engine.Sweep(**sweep), _vl2_build(r_vl2),
                           r_engine.get_engine("certified", iters=100,
                                               devices=1))
    eng = Kept(iters=100, device="cpu")
    with _reference_schedule():
        b = p_engine.run_sweep(p_engine.Sweep(**sweep), _vl2_build(p_vl2),
                               eng)
    for k, (x, y) in enumerate(zip(a, b)):
        assert y.lb_mean == pytest.approx(x.lb_mean, rel=_REL)
        assert y.gap_max == pytest.approx(x.gap_max, rel=_REL)
        assert y.mean == pytest.approx(x.mean, rel=_REL)
        rs = eng.kept[2 * k:2 * k + 2]
        assert y.lb_mean == np.mean([r.meta["lb"] for r in rs])
        assert y.gap_max == max(r.meta["gap"] for r in rs) > 0
        assert y.values == tuple(r.throughput for r in rs)


def test_exact_sweep_points_carry_no_bracket():
    from repro_torch.core import vl2 as p_vl2
    pts = p_engine.run_sweep(p_engine.Sweep(xs=(2.0,), runs=2),
                             _vl2_build(p_vl2), "exact")
    assert pts[0].lb_mean is None and pts[0].gap_max is None
    assert pts[0].meta == {}
