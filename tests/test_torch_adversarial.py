"""The port's worst-case traffic search (``core/adversarial.py``) and its
demand-gradient dual solve against the reference, on the CPU.

The hose projection is the same float32 arithmetic in both frameworks up
to the order of its row and column sums, so it is held within rtol 1e-6
and its pullback within rtol 1e-5.  The dual solve's values are held
within rel 1e-3, as every solver value of the port is (Adam's exp/sqrt
round differently in the two frameworks).  The demand gradient is
``−dist/α`` at the final lengths: it is held at a descent of 60 steps,
where the two trajectories still agree to ~1e-6.  Later the lengths of
edges that carry no shortest path drift apart at the same bound (the dual
optimum is not unique there), and so do the distances they set.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import adversarial as r_adv  # noqa: E402
from repro.core import graphs as r_graphs  # noqa: E402
from repro.core import mcf as r_mcf  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro_torch.core import adversarial as p_adv  # noqa: E402
from repro_torch.core import apsp as p_apsp  # noqa: E402
from repro_torch.core import engine as p_engine  # noqa: E402
from repro_torch.core import graphs as p_graphs  # noqa: E402
from repro_torch.core import mcf as p_mcf  # noqa: E402
from repro_torch.core import traffic as p_traffic  # noqa: E402
from repro_torch.core.plan import SOLVERS, BatchPlan  # noqa: E402

# float32 lanes and a Sinkhorn-style projection: the reference's own
# feasibility tolerance, in flow units (tests/test_adversarial.py)
TOL = 1e-4
_REL = 1e-3
# the search budget of these tests: short descents, where the port and
# the reference run the same trajectory to ~1e-6
_BUDGET = dict(rounds=3, candidates=4, iters=60)


def _two_cluster(mod):
    return mod.biased_two_cluster_graph([6] * 8, [4] * 8, cross_bias=0.6,
                                        seed=1, servers=2)


@pytest.fixture(scope="module")
def search():
    """One port search (every candidate kept) and the reference's."""
    port = p_adv.find_worst_tm(_two_cluster(p_graphs), seed=0,
                               keep_fleet=True, device="cpu", **_BUDGET)
    ref = r_adv.find_worst_tm(_two_cluster(r_graphs), seed=0, **_BUDGET)
    return port, ref


@pytest.mark.parametrize("seed,servers", [
    (0, [3, 0, 2, 5, 1, 0, 4]),
    (1, [2] * 9),
    (2, [0, 7, 1, 1, 0, 3, 2, 6, 0, 4, 2, 1]),
])
def test_hose_projection_matches_reference(seed, servers):
    servers = np.asarray(servers)
    n = len(servers)
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 3.0, size=(3, n, n)).astype(np.float32)
    got = p_adv._fleet_project(torch.from_numpy(logits),
                               torch.from_numpy(servers), 8).numpy()
    want = np.asarray(r_adv._fleet_project(
        jnp.asarray(logits), jnp.asarray(servers, jnp.float32), 8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        p_adv.hose_feasible(logits[0], servers, proj_iters=3),
        r_adv.hose_feasible(logits[0], servers, proj_iters=3),
        rtol=1e-6, atol=1e-7)
    dead = servers == 0
    for dem in got:
        assert p_adv.hose_violation(dem, servers) <= TOL
        assert np.all(np.diag(dem) == 0)
        assert np.all(dem[dead] == 0) and np.all(dem[:, dead] == 0)
    assert p_adv.hose_violation(got[0], servers) == \
        r_adv.hose_violation(got[0], servers)


@pytest.mark.parametrize("seed,servers", [
    (0, [3, 1, 2, 5, 1, 4, 2, 2]),
    (1, [3, 0, 2, 5, 1, 4, 0, 2]),
])
def test_hose_pullback_matches_reference(seed, servers):
    """The pullback against the reference's.  With zero-server switches the
    reference's is NaN everywhere (the row scale's derivative there is
    0/(1e-30)² = 0/0 in float32, and the NaN spreads through the column
    sums); the port's is 0 on those rows and columns, and its live block
    equals the reference's pullback of the live switches alone."""
    servers = np.asarray(servers)
    n = len(servers)
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.0, size=(4, n, n)).astype(np.float32)
    ct = rng.normal(0.0, 1.0, size=(4, n, n)).astype(np.float32)
    got = p_adv._fleet_pullback(torch.from_numpy(logits),
                                torch.from_numpy(ct),
                                torch.from_numpy(servers), 8).numpy()
    live = np.flatnonzero(servers > 0)
    block = np.ix_(np.arange(4), live, live)
    want = np.asarray(r_adv._fleet_pullback(
        jnp.asarray(logits[block]), jnp.asarray(ct[block]),
        jnp.asarray(servers[live], jnp.float32), 8))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[block], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # dead rows and columns and the diagonal take no gradient
    dead = servers == 0
    assert np.all(got[:, dead] == 0) and np.all(got[:, :, dead] == 0)
    assert np.all(got[:, np.arange(n), np.arange(n)] == 0)


def _mixed_pile():
    """Four lanes padded to 16 nodes (12, 14, 16, 16 real), two with
    permutation demand and two with hose-feasible demand on every pair."""
    caps = np.zeros((4, 16, 16), np.float32)
    dems = np.zeros((4, 16, 16), np.float32)
    nv = np.array([12, 14, 16, 16], np.int32)
    for s, n in enumerate(nv):
        t = r_graphs.random_regular_graph(int(n), 4, seed=s, servers=3)
        caps[s, :n, :n] = t.cap
        if s % 2:
            rng = np.random.default_rng(s)
            dems[s, :n, :n] = r_adv.hose_feasible(rng.normal(size=(n, n)),
                                                  t.servers)
        else:
            dems[s, :n, :n] = r_traffic.make("permutation", t.servers,
                                             seed=s + 1)
    return caps, dems, nv


def test_dual_demgrad_matches_reference():
    caps, dems, nv = _mixed_pile()
    want = r_mcf.solve_dual_demgrad_batch(caps, dems, n_valid=nv, iters=60)
    got = p_mcf.solve_dual_demgrad_batch(caps, dems, n_valid=nv, iters=60,
                                         device="cpu")
    np.testing.assert_allclose(got.throughput_ub, want.throughput_ub,
                               rtol=_REL)
    np.testing.assert_allclose(got.final_ratio, want.final_ratio, rtol=_REL)
    assert np.array_equal(got.iterations, want.iterations)
    assert got.dem_grad.shape == want.dem_grad.shape == (4, 16, 16)
    for g, w, n in zip(got.dem_grad, want.dem_grad, nv):
        np.testing.assert_allclose(g, w, rtol=_REL)
        # padded pairs carry exactly no gradient; valid ones are -dist/α
        assert np.all(g[n:] == 0) and np.all(g[:, n:] == 0)
        off = ~np.eye(n, dtype=bool)
        assert np.all(g[:n, :n][off] < 0)
        assert np.all(np.diag(g) == 0)
    # the bound is the plain dual's, bit for bit
    plain = p_mcf.solve_dual_batch(caps, dems, n_valid=nv, iters=60,
                                   device="cpu")
    assert np.array_equal(plain.throughput_ub, got.throughput_ub)
    assert np.array_equal(plain.final_ratio, got.final_ratio)
    assert np.array_equal(plain.iterations, got.iterations)


def test_dem_grad_is_minus_dist_over_alpha():
    caps, dems, nv = _mixed_pile()
    # no descent step: the final lengths are 1 on every edge
    got = p_mcf.solve_dual_demgrad_batch(caps, dems, n_valid=nv, iters=0,
                                         device="cpu")
    c, d = torch.from_numpy(caps), torch.from_numpy(dems)
    node = torch.arange(16)[None, :] < torch.from_numpy(nv)[:, None]
    pair = node[:, :, None] & node[:, None, :]
    eye = torch.eye(16, dtype=torch.bool)
    w = torch.where((c > 0) & pair, 1.0, p_mcf._INF)
    w = torch.where(eye, 0.0, w)
    dist = torch.where(pair, p_apsp.apsp(w, "squaring"), 0.0)
    # α summed as the descent sums it: pairwise halving fixed by N
    terms = torch.where(pair, d, 0.0) * dist
    alpha = p_apsp._sum_sources(terms.reshape(len(nv), 16 * 16))
    # and, from a source independent of the halving, the same α in float64
    np.testing.assert_allclose(alpha.double().numpy(),
                               terms.double().sum(dim=(1, 2)).numpy(),
                               rtol=1e-6)
    assert np.array_equal(got.dem_grad,
                          (-dist / alpha[:, None, None]).numpy())
    # after a descent: Σ dem·g = −α/α = −1 on every lane
    got = p_mcf.solve_dual_demgrad_batch(caps, dems, n_valid=nv, iters=40,
                                         device="cpu")
    np.testing.assert_allclose((dems * got.dem_grad).sum(axis=(1, 2)), -1.0,
                               rtol=1e-5)


def test_plan_dual_demgrad_crops_and_keeps_dual_meta():
    assert "dual-demgrad" in SOLVERS
    topos = [p_graphs.random_regular_graph(n, 4, seed=n, servers=2)
             for n in (10, 13, 16)]
    dems = [p_traffic.make("permutation", t.servers, seed=1) for t in topos]
    plan = BatchPlan.build(topos, dems)
    grad = plan.execute(solver="dual-demgrad", iters=30, device="cpu")
    dual = plan.execute(solver="dual", iters=30, device="cpu")
    for t, a, b in zip(topos, grad, dual):
        g = a.meta["dem_grad"]
        assert isinstance(g, np.ndarray) and g.shape == (t.n, t.n)
        assert np.all(g <= 0) and np.all(np.diag(g) == 0)
        assert a.value == b.value and a.iterations == b.iterations
        assert {k: v for k, v in a.meta.items() if k != "dem_grad"} == \
            dict(b.meta)
    # the primal's meta keeps its scalars
    (p,) = BatchPlan.build(topos[:1], dems[:1]).execute(
        solver="primal", iters=20, device="cpu")
    assert all(isinstance(p.meta[k], float) for k in ("ub", "final_util"))


def test_first_round_matches_reference(search):
    port, ref = search
    a, b = port.history[0], ref.history[0]
    assert a["round"] == b["round"] == 1
    for k in ("best_ub", "round_min_ub", "round_mean_ub", "baseline_ub"):
        assert a[k] == pytest.approx(b[k], rel=_REL), k
    # the same seeded baseline and initial logits give the same demands
    r_topo = _two_cluster(r_graphs)
    n = r_topo.n
    rng = np.random.default_rng((0, r_adv._LOGITS_KEY))
    logits = rng.normal(0.0, 1.0, size=(3, n, n)).astype(np.float32)
    want = np.asarray(r_adv._fleet_project(
        jnp.asarray(logits), jnp.asarray(r_topo.servers, jnp.float32), 8))
    np.testing.assert_allclose(np.stack(port.fleet[:3]), want, rtol=1e-6,
                               atol=1e-7)
    assert p_adv._BASELINE_KEY == r_adv._BASELINE_KEY
    assert p_adv._LOGITS_KEY == r_adv._LOGITS_KEY


def test_search_contract(search):
    port, _ = search
    servers = _two_cluster(p_graphs).servers
    assert len(port.fleet) == 3 * 3   # (candidates - 1) x rounds
    for dem in port.fleet + (port.tm,):
        assert p_adv.hose_violation(dem, servers) <= TOL
    assert 0 < port.lb <= port.ub <= port.baseline_ub
    assert port.baseline_lb <= port.baseline_ub
    mins = [h["best_ub"] for h in port.history]
    assert all(a >= b for a, b in zip(mins, mins[1:]))
    s = port.stats
    assert s["search_executes"] == s["rounds"] == 3
    assert s["certify_executes"] == 1 and s["executes"] == 1 + s["rounds"]
    assert len(s["compile_keys"]) == 1
    assert s["last_plan"]["instances"] == s["candidates"] == 4


def test_search_is_seeded(search):
    port, _ = search
    again = p_adv.find_worst_tm(_two_cluster(p_graphs), seed=0,
                                keep_fleet=True, device="cpu", **_BUDGET)
    np.testing.assert_array_equal(port.tm, again.tm)
    assert (port.lb, port.ub) == (again.lb, again.ub)
    assert port.history == again.history


def test_adversarial_engine_and_traffic_entry():
    topo = p_graphs.random_regular_graph(10, 3, seed=2, servers=3)
    res = p_engine.get_engine("adversarial", rounds=2, candidates=3,
                              iters=40, device="cpu").solve(
        topo.with_server_nodes())
    m = res.meta
    assert res.bound == "bracket" and res.engine == "adversarial"
    assert res.throughput == m["ub"] and 0 < m["lb"] <= m["ub"]
    assert m["tm"].shape == (10, 10)   # searched at switch level
    assert p_adv.hose_violation(m["tm"], topo.servers) <= TOL
    assert m["baseline_lb"] <= m["baseline_ub"] and m["uniform_gap_pct"] >= 0
    assert m["executes"] == 1 + m["rounds"]
    tm = p_traffic.make("adversarial", topo.servers, seed=0, topo=topo,
                        rounds=1, candidates=2, iters=30, device="cpu")
    assert tm.shape == (10, 10)
    assert p_adv.hose_violation(tm, topo.servers) <= TOL
    with pytest.raises(ValueError, match="topo"):
        p_traffic.make("adversarial", topo.servers, seed=0)


def test_find_worst_tm_rejects_bad_inputs():
    topo = _two_cluster(p_graphs)
    with pytest.raises(ValueError, match="Topology"):
        p_adv.find_worst_tm(np.asarray(topo.cap), device="cpu")
    with pytest.raises(ValueError, match="rounds >= 1"):
        p_adv.find_worst_tm(topo, rounds=0, device="cpu")
    with pytest.raises(ValueError, match="candidates >= 2"):
        p_adv.find_worst_tm(topo, candidates=1, device="cpu")
    lonely = p_graphs.random_regular_graph(8, 3, seed=0,
                                           servers=[5, 0, 0, 0, 0, 0, 0, 0])
    with pytest.raises(ValueError, match=">= 2 switches"):
        p_adv.find_worst_tm(lonely, device="cpu")
    with pytest.raises(ValueError, match="baseline TM"):
        p_adv.find_worst_tm(topo, baseline=np.ones((3, 3)), device="cpu")
