"""The port's routing-restricted bounds (``repro_torch.core.routing``,
``kernels/paths.py``, ``EcmpEngine``/``KspEngine``) against the reference.

Tolerances: path tensors are numpy on both sides and must be identical.
The ECMP operator is exact arithmetic up to the order of a few additions
(the port sums in incoming-ELL order, the reference in its einsum's), so
ECMP lower bounds and utilisations agree within rtol 1e-5.  The ideal
upper bound is the dual descent's (rel 1e-3, the solver values' contract)
and so is the KSP lower bound, whose Adam steps round in float32 on both
sides with schedules computed in another order.  The certificates hold
exactly: ``ecmp <= ksp <= θ_exact <= ub`` against HiGHS.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import graphs as r_graphs  # noqa: E402
from repro.core import routing as r_routing  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro.core import vl2 as r_vl2  # noqa: E402
from repro.core.engine import get_engine as r_get_engine  # noqa: E402
from repro.kernels import paths as r_paths  # noqa: E402
from repro_torch.core import lp as p_lp  # noqa: E402
from repro_torch.core import routing as p_routing  # noqa: E402
from repro_torch.core.engine import get_engine as p_get_engine  # noqa: E402
from repro_torch.kernels import paths as p_paths  # noqa: E402

_REL = 1e-3
_ECMP_RTOL = 1e-5
_ITERS = 150
_K = 4
_NMAX = 16


def _corpus():
    """(cap, dem) switch-level instances of three families, N <= 16."""
    out = []
    for s in range(2):
        t = r_graphs.random_regular_graph(16, 3, seed=s, servers=2)
        out.append((r_graphs.as_cap(t), r_traffic.make(
            "permutation", t.servers, seed=s + 1)))
    t = r_graphs.biased_two_cluster_graph([3] * 6, [3] * 6, 0.6, seed=1,
                                          servers=2)
    out.append((r_graphs.as_cap(t), r_traffic.make("permutation", t.servers,
                                                   seed=5)))
    t = r_vl2.vl2_topology(r_vl2.VL2Spec(d_a=4, d_i=4, servers_per_tor=2),
                           n_tor=4)
    out.append((r_graphs.as_cap(t), r_traffic.make("permutation", t.servers,
                                                   seed=7)))
    return out


def _stack(corpus, nmax=_NMAX):
    caps = np.zeros((len(corpus), nmax, nmax), np.float32)
    dems = np.zeros_like(caps)
    nv = np.empty(len(corpus), np.int32)
    for i, (c, d) in enumerate(corpus):
        n = c.shape[0]
        caps[i, :n, :n], dems[i, :n, :n], nv[i] = c, d, n
    return caps, dems, nv


@pytest.fixture(scope="module")
def solved():
    """Both packages' ECMP and KSP on the padded corpus, one batch each."""
    caps, dems, nv = _stack(_corpus())
    kw = dict(n_valid=nv, iters=_ITERS)
    return {"ecmp": (r_routing.solve_ecmp_batch(caps, dems, **kw),
                     p_routing.solve_ecmp_batch(caps, dems, device="cpu",
                                                **kw)),
            "ksp": (r_routing.solve_ksp_batch(caps, dems, k=_K, **kw),
                    p_routing.solve_ksp_batch(caps, dems, k=_K,
                                              device="cpu", **kw))}


def _rrg_cap(n, d, seed):
    return r_graphs.as_cap(r_graphs.random_regular_graph(n, d, seed=seed))


@pytest.mark.parametrize("k,max_hops", [(1, 4), (4, 6), (8, 9)])
@pytest.mark.parametrize("cap_of", [
    lambda: _rrg_cap(12, 3, 0), lambda: _rrg_cap(14, 4, 3),
    lambda: r_graphs.as_cap(r_graphs.biased_two_cluster_graph(
        [4] * 5, [4] * 5, 0.5, seed=2)),
    # a padded lane: real nodes first, zero rows and columns after
    lambda: np.pad(_rrg_cap(8, 3, 4), (0, 4)),
], ids=["rrg12", "rrg14", "two_cluster", "padded"])
def test_k_shortest_paths_equal_reference(cap_of, k, max_hops):
    cap = cap_of()
    got = p_paths.k_shortest_paths(cap, k, max_hops)
    want = r_paths.k_shortest_paths(cap, k, max_hops)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(p_paths.path_hops(got), r_paths.path_hops(want))
    assert np.array_equal(p_paths.path_edge_counts(got, cap.shape[0]),
                          r_paths.path_edge_counts(want, cap.shape[0]))


def test_paths_tensor_equal_reference_on_padded_lanes():
    caps, _, nv = _stack(_corpus())
    caps[1] = caps[0]                  # a replicated lane is deduped
    nv[1] = nv[0]
    got = p_routing._paths_tensor(caps, nv, _K, 9)
    assert np.array_equal(got, r_routing._paths_tensor(caps, nv, _K, 9))
    # no path visits a padded node
    for lane, n in enumerate(nv):
        assert got[lane].max() < n


@pytest.mark.parametrize("i", range(4))
def test_ecmp_matches_reference(solved, i):
    ref, got = solved["ecmp"]
    assert got.throughput_lb[i] == pytest.approx(ref.throughput_lb[i],
                                                 rel=_ECMP_RTOL)
    assert got.final_util[i] == pytest.approx(ref.final_util[i],
                                              rel=_ECMP_RTOL)
    assert got.throughput_ub[i] == pytest.approx(ref.throughput_ub[i],
                                                 rel=_REL)
    assert got.iterations[i] == ref.iterations[i]


@pytest.mark.parametrize("i", range(4))
def test_ksp_matches_reference(solved, i):
    ref, got = solved["ksp"]
    assert got.throughput_lb[i] == pytest.approx(ref.throughput_lb[i],
                                                 rel=_REL)
    assert got.final_util[i] == pytest.approx(ref.final_util[i], rel=_REL)
    assert got.throughput_ub[i] == pytest.approx(ref.throughput_ub[i],
                                                 rel=_REL)
    assert got.iterations[i] == ref.iterations[i]


@pytest.mark.parametrize("i", range(4))
def test_routing_lattice_against_the_lp(solved, i):
    cap, dem = _corpus()[i]
    theta = p_lp.max_concurrent_flow(cap, dem, want_flows=False).throughput
    ecmp, ksp = solved["ecmp"][1], solved["ksp"][1]
    assert 0 < ecmp.throughput_lb[i] <= ksp.throughput_lb[i]
    assert ksp.throughput_lb[i] <= theta * (1 + 1e-6)
    assert theta <= ecmp.throughput_ub[i] * (1 + 1e-6)
    assert theta <= ksp.throughput_ub[i] * (1 + 1e-6)


def _split(cap, dem):
    """The ECMP split of one padded lane, as ``_ecmp_eval`` builds it."""
    caps, dems, nv = _stack([(cap, dem)])
    d, emask, _ = p_routing._masked(torch.from_numpy(caps),
                                    torch.from_numpy(dems),
                                    torch.from_numpy(nv))
    w = torch.where(emask, 1.0, p_routing._INF)
    w = torch.where(torch.eye(_NMAX, dtype=torch.bool), 0.0, w)
    dist = p_routing.apsp_mod.apsp(w, "squaring")
    return d, dist, *p_routing._ecmp_split(emask, dist)


@pytest.mark.parametrize("i", range(4))
def test_ecmp_early_exit_is_bit_identical_to_all_hops(i):
    d, dist, idx, share = _split(*_corpus()[i])
    early, ran = p_routing._ecmp_fixed_point(d, idx, share, _NMAX)
    full = d
    for _ in range(_NMAX):
        full = p_routing._ecmp_hop(full, d, idx, share)
    assert torch.equal(early, full)
    finite = dist[dist < p_routing._INF / 2]
    assert 2 <= ran <= int(finite.max()) + 1 < _NMAX
    # hop ``ran`` repeated its input: ran - 1 hops reach the fixed point,
    # ran - 2 do not
    short = d
    for h in range(ran - 1):
        before, short = short, p_routing._ecmp_hop(short, d, idx, share)
    assert torch.equal(short, full)
    assert not torch.equal(before, full)


def test_ecmp_hops_cap_truncates_like_the_reference():
    caps, dems, nv = _stack(_corpus()[:1])
    got = p_routing.solve_ecmp_batch(caps, dems, n_valid=nv, iters=10,
                                     hops=1, device="cpu")
    want = r_routing.solve_ecmp_batch(caps, dems, n_valid=nv, iters=10,
                                      hops=1)
    assert got.ecmp_hops[0] == 1
    assert got.throughput_lb[0] == pytest.approx(want.throughput_lb[0],
                                                 rel=_ECMP_RTOL)


def test_ksp_loads_do_not_depend_on_the_batch():
    """A lane's loads are bit-equal alone and beside a wider lane (other
    table widths), and agree with a sequential scatter-add."""
    small, big = _rrg_cap(10, 3, 1), _rrg_cap(16, 5, 2)
    nmax = 16
    caps = np.stack([np.pad(small, (0, 6)), big]).astype(np.float32)
    nv = np.array([10, 16], np.int32)
    paths = p_routing._paths_tensor(caps, nv, 6, 8)
    rng = np.random.default_rng(0)
    wgt = torch.from_numpy(rng.uniform(0.1, 3.0, paths.shape[:3])
                           .astype(np.float32))
    both = p_routing._edge_loads(
        wgt, p_routing._path_tables(paths, nmax, "cpu"))
    alone = p_routing._edge_loads(
        wgt[:1], p_routing._path_tables(paths[:1], nmax, "cpu"))
    assert torch.equal(both[0], alone[0])
    p = paths[0]
    valid = p[:, :, 0] >= 0
    loads = np.zeros(nmax * nmax, np.float64)
    a, b = p[:, :, :-1], p[:, :, 1:]
    ok = (a >= 0) & (b >= 0)
    contrib = np.where(ok, np.where(valid, wgt[0].numpy(), 0)[:, :, None], 0)
    np.add.at(loads, (a * nmax + b)[ok], contrib[ok])
    np.testing.assert_allclose(alone[0].numpy(), loads, rtol=1e-6)


def test_tree_sum_ignores_trailing_padding():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (5, 11)).astype(np.float32))
    for pad in (0, 5, 21, 53):
        y = torch.cat([x, torch.zeros(5, pad)], 1)
        assert torch.equal(p_routing._tree_sum(y, 1),
                           p_routing._tree_sum(x, 1))
    assert torch.allclose(p_routing._tree_sum(x, 1), x.sum(1))


def test_padded_lane_matches_unpadded_solve():
    t = r_graphs.random_regular_graph(8, 3, seed=5, servers=2)
    cap, dem = r_graphs.as_cap(t), r_traffic.make("permutation", t.servers,
                                                  seed=6)
    caps, dems, nv = _stack([(cap, dem)], nmax=12)
    for solve, kw in ((p_routing.solve_ecmp_batch, {}),
                      (p_routing.solve_ksp_batch, {"max_hops": 7})):
        batch = solve(caps, dems, n_valid=nv, iters=120, device="cpu", **kw)
        direct = solve(cap[None], dem[None], iters=120, device="cpu", **kw)
        assert batch.throughput_lb[0] == pytest.approx(
            direct.throughput_lb[0], rel=1e-4)
        assert batch.throughput_ub[0] == pytest.approx(
            direct.throughput_ub[0], rel=1e-4)


def test_ksp_monotone_in_k_against_path_lp():
    t = r_graphs.random_regular_graph(10, 3, seed=2, servers=2)
    cap, dem = r_graphs.as_cap(t), r_traffic.make("permutation", t.servers,
                                                  seed=3)
    theta = p_lp.max_concurrent_flow(cap, dem, want_flows=False).throughput
    ks = (1, 2, 4, 8)
    vals = [p_routing.solve_ksp(cap, dem, k=k, iters=200, device="cpu")
            for k in ks]
    ecmp = p_routing.solve_ecmp(cap, dem, iters=10, device="cpu")
    lps = []
    for k in ks:
        paths = p_paths.k_shortest_paths(cap, k=k, max_hops=9)
        lps.append(p_routing.path_lp_throughput(cap, dem, paths))
        assert lps[-1] == pytest.approx(
            r_routing.path_lp_throughput(cap, dem, paths), rel=1e-9)
    for lo, hi in zip(lps, lps[1:]):
        assert hi >= lo - 1e-9, (ks, lps)
    assert lps[-1] <= theta * (1 + 1e-6)
    for lo, hi in zip(vals, vals[1:]):
        assert hi.throughput_lb >= lo.throughput_lb - 0.01 * theta
    for v, lp in zip(vals, lps):
        # MW never beats its own LP; the ECMP floor may, below k paths
        assert v.throughput_lb <= max(lp, ecmp.throughput_lb) * (1 + 2e-3)


def test_disconnected_demand_reports_zero():
    cap = np.zeros((6, 6), np.float32)
    cap[0, 1] = cap[1, 0] = cap[2, 3] = cap[3, 2] = 1.0
    dem = np.zeros_like(cap)
    dem[0, 2] = 1.0
    assert p_routing.solve_ecmp(cap, dem, iters=30,
                                device="cpu").throughput_lb == 0.0
    assert p_routing.solve_ksp(cap, dem, iters=30, k=2,
                               device="cpu").throughput_lb == 0.0


@pytest.mark.parametrize("name", ["ecmp", "ksp"])
def test_one_execute_per_sweep_and_compile_keys_equal_reference(name):
    """Mixed sizes in two buckets: one plan whose compile keys equal the
    reference's, results within tolerance, the engines' meta contract."""
    topos, dems = [], []
    for s, n in enumerate((10, 12, 14, 18)):
        t = r_graphs.random_regular_graph(n, 3, seed=s, servers=2)
        topos.append(t)
        dems.append(r_traffic.make("permutation", t.servers, seed=s + 1))
    kw = dict(iters=60, **({"k": 3} if name == "ksp" else {}))
    r_eng = r_get_engine(name, **kw)
    p_eng = p_get_engine(name, device="cpu", **kw)
    want = r_eng.solve_batch(topos, dems)
    got = p_eng.solve_batch(topos, dems)
    assert p_eng.last_plan.compile_keys == r_eng.last_plan.compile_keys
    assert p_eng.last_plan.chunks == r_eng.last_plan.chunks
    for g, w in zip(got, want):
        assert g.bound == "lower" and g.engine == name
        assert g.throughput == pytest.approx(w.throughput, rel=_REL)
        assert g.meta["ub"] == pytest.approx(w.meta["ub"], rel=_REL)
        assert g.meta["ideal_gap_pct"] == pytest.approx(
            w.meta["ideal_gap_pct"], abs=0.1)
        assert {"ub", "final_util", "iterations",
                "ideal_gap_pct"} <= set(g.meta)
    one = p_eng.solve(topos[0], dems[0])
    assert one.throughput == pytest.approx(got[0].throughput, rel=1e-4)


def test_empty_and_mismatched_batches():
    z = np.zeros((0, 4, 4), np.float32)
    for solve in (p_routing.solve_ecmp_batch, p_routing.solve_ksp_batch):
        assert len(solve(z, z, device="cpu")) == 0
        with pytest.raises(ValueError, match="equal length"):
            solve(np.zeros((1, 4, 4)), z, device="cpu")
