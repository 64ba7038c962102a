"""The port's lifecycle layer (``repro_torch.lifecycle``) against the
reference.

``failures`` and the attach/recabling half of ``expansion`` are numpy on
both sides: the same seeds must give identical fleets and wirings.  The
degradation surface runs the certified engine on the CPU, so its plan
accounting (executes, refills, compile keys) must equal the reference's
and its upper bounds agree within rel 1e-3 (the solver values' contract).
So do its lower bounds on the RRG and two-cluster families.  On VL2 they
part (ROADMAP R5): in a degraded VL2's first Frank–Wolfe steps the max
utilisation is pinned by an edge that both flows load equally, the line
search's objective is flat over all of [0, 1], and γ is whatever the
ternary search's float ties give (0.625 in the port; the reference's
fused blend rounds otherwise).  From there the iterates differ: on one
trial the reference's lb reaches 9.9999 at step 5 and the port's 8.966 (θ
= 10).  Both are certified, so the VL2 points are held to HiGHS: each lb
quantile at most the same quantile of the trials' θ, the mean ub at least
their mean.  The expansion planner's search is held to its own contract: a
monotone certified lb and every step within the recabling budget.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import lifecycle as r_life  # noqa: E402
from repro.core import graphs as r_graphs  # noqa: E402
from repro.core import vl2 as r_vl2  # noqa: E402
from repro.core.engine import CertifiedEngine as RCertified  # noqa: E402
from repro.design import moves as r_moves  # noqa: E402
from repro.design.spaces import Candidate as RCandidate  # noqa: E402
from repro_torch import lifecycle as p_life  # noqa: E402
from repro_torch.core import graphs as p_graphs  # noqa: E402
from repro_torch.core import lp as p_lp  # noqa: E402
from repro_torch.core import mcf as p_mcf  # noqa: E402
from repro_torch.core import traffic as p_traffic  # noqa: E402
from repro_torch.core import vl2 as p_vl2  # noqa: E402
from repro_torch.core.engine import CertifiedEngine as PCertified  # noqa: E402
from repro_torch.core.engine import DualEngine as PDual  # noqa: E402
from repro_torch.design import moves as p_moves  # noqa: E402
from repro_torch.design.spaces import Candidate as PCandidate  # noqa: E402

_REL = 1e-3
_VL2 = dict(d_a=4, d_i=4, servers_per_tor=2)


def _families(graphs, vl2):
    return {"rrg": graphs.random_regular_graph(12, 3, seed=0, servers=2),
            "two_cluster": graphs.biased_two_cluster_graph(
                [3] * 6, [3] * 6, 0.5, seed=0, servers=2),
            "vl2": vl2.rewired_vl2_topology(vl2.VL2Spec(**_VL2), 4, seed=0)}


def _same_topo(a, b):
    assert np.array_equal(a.cap, b.cap)
    assert np.array_equal(a.servers, b.servers)
    assert (a.labels is None and b.labels is None) or \
        np.array_equal(a.labels, b.labels)


@pytest.mark.parametrize("kind", ["links", "switches", "srg"])
@pytest.mark.parametrize("family", ["rrg", "two_cluster", "vl2"])
def test_scenario_fleets_equal_reference(family, kind):
    r_base = _families(r_graphs, r_vl2)[family]
    p_base = _families(p_graphs, p_vl2)[family]
    _same_topo(r_base, p_base)
    want = r_life.scenario_fleet(r_base, kind, (0.0, 0.1, 0.3, 1.0), 3,
                                 seed=4)
    got = p_life.scenario_fleet(p_base, kind, (0.0, 0.1, 0.3, 1.0), 3,
                                seed=4)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _same_topo(g.topo, w.topo)
        assert (g.kind, g.fraction, g.trial, g.seed, g.failed_links,
                g.dead_switches, g.server_fraction) == \
            (w.kind, w.fraction, w.trial, w.seed, w.failed_links,
             w.dead_switches, w.server_fraction)
    assert list(p_life.FAIL_KINDS) == list(r_life.FAIL_KINDS)


def test_srg_groups_and_bad_inputs_equal_reference():
    r_base = _families(r_graphs, r_vl2)["vl2"]
    p_base = _families(p_graphs, p_vl2)["vl2"]
    for g, w in zip(p_life.srg_from_labels(p_base),
                    r_life.srg_from_labels(r_base)):
        assert np.array_equal(g, w)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="fraction"):
        p_life.fail_links(p_base, 1.5, rng)
    with pytest.raises(ValueError, match="unknown failure kind"):
        p_life.scenario_fleet(p_base, "meteor", [0.1], 1)
    with pytest.raises(ValueError, match="trials"):
        p_life.scenario_fleet(p_base, "links", [0.1], trials=0)


_SURFACE = dict(fractions=(0.1, 0.4), trials=2, seed=0)


@pytest.fixture(scope="module")
def surfaces():
    want = r_life.degradation_surface(
        _families(r_graphs, r_vl2), engine=RCertified(iters=60, tol=1e-3),
        **_SURFACE)
    got = p_life.degradation_surface(
        _families(p_graphs, p_vl2),
        engine=PCertified(iters=60, tol=1e-3, device="cpu"), **_SURFACE)
    return want, got


def _thetas(family, kind):
    """HiGHS θ of every trial of one (family, kind), fraction-major, on the
    demand ``degradation_surface`` draws and keeps."""
    fam_i = list(_families(p_graphs, p_vl2)).index(family)
    base = _families(p_graphs, p_vl2)[family]
    out = []
    for sc in p_life.scenario_fleet(base, kind, _SURFACE["fractions"],
                                    _SURFACE["trials"], seed=0):
        ds = int(np.random.default_rng((0, 7, fam_i, sc.trial))
                 .integers(1 << 31))
        dem = p_traffic.make("permutation", base.servers, ds)
        kept, dropped = p_mcf.drop_disconnected(sc.topo.cap, dem)
        # a trial with nothing routable is the certified zero bracket
        out.append(0.0 if dropped >= 1.0 else p_lp.max_concurrent_flow(
            sc.topo.cap, kept, want_flows=False).throughput)
    return np.reshape(out, (len(_SURFACE["fractions"]), -1))


def test_surface_plan_accounting_equals_reference(surfaces):
    want, got = surfaces
    for key in ("executes", "refills", "compile_keys",
                "instances_per_execute", "families", "kinds", "fractions",
                "trials", "engine"):
        assert got.stats[key] == want.stats[key], key
    assert got.stats["executes"] == 3 and got.stats["refills"] == 2


@pytest.mark.parametrize("i", range(18))
def test_surface_points_match_reference(surfaces, i):
    w, g = surfaces[0].points[i], surfaces[1].points[i]
    assert (g.family, g.kind, g.fraction, g.trials, g.dead_trials) == \
        (w.family, w.kind, w.fraction, w.trials, w.dead_trials)
    assert g.reachable_mean == w.reachable_mean
    assert g.ub_mean == pytest.approx(w.ub_mean, rel=_REL)
    assert g.lb_q10 <= g.lb_med <= g.lb_q90 and g.gap_max >= 0.0
    if g.family != "vl2":
        for f in ("lb_q10", "lb_med", "lb_q90"):
            assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                  rel=_REL), f
        assert g.gap_max == pytest.approx(w.gap_max, abs=_REL)
        return
    theta = _thetas(g.family, g.kind)[_SURFACE["fractions"].index(
        g.fraction)]
    # lb <= θ trial by trial puts every quantile of lb under θ's
    q = np.quantile(theta, (0.1, 0.5, 0.9))
    assert np.all(np.array([g.lb_q10, g.lb_med, g.lb_q90])
                  <= q * (1 + 1e-6))
    assert theta.mean() <= g.ub_mean * (1 + 1e-6)


def test_surface_total_failure_is_certified_zero():
    fams = {"rrg": p_graphs.random_regular_graph(12, 3, seed=0, servers=2)}
    res = p_life.degradation_surface(
        fams, kinds=("switches",), fractions=(1.0,), trials=2,
        engine=PCertified(iters=15, device="cpu"), seed=0)
    (p,) = res.points
    assert p.lb_med == p.ub_mean == 0.0 and p.gap_max == 0.0
    assert p.reachable_mean == 0.0 and p.dead_trials == 2


def test_surface_rejects_non_certifying_engine():
    fams = {"rrg": p_graphs.random_regular_graph(12, 3, seed=0, servers=2)}
    with pytest.raises(ValueError, match="primal"):
        p_life.degradation_surface(fams, engine=PDual(iters=8,
                                                      device="cpu"),
                                   trials=1)


@pytest.mark.parametrize("ports,max_breaks,seed", [
    ([6, 4], 4, 3), ([4, 4], None, 0), ([6, 6], 6, 1), ([2], 0, 2)])
def test_attach_and_recabling_equal_reference(ports, max_breaks, seed):
    r_base = r_graphs.random_regular_graph(16, 4, seed=1, servers=2)
    p_base = p_graphs.random_regular_graph(16, 4, seed=1, servers=2)
    want = r_life.attach_new_switches(r_base, ports, seed=seed,
                                      max_breaks=max_breaks)
    got = p_life.attach_new_switches(p_base, ports, seed=seed,
                                     max_breaks=max_breaks)
    _same_topo(got.topo, want.topo)
    assert (got.broken_links, got.spare_ports) == \
        (want.broken_links, want.spare_ports)
    assert p_life.recabled_links(p_base.cap, got.topo.cap) == \
        r_life.recabled_links(r_base.cap, want.topo.cap) == got.broken_links


def test_vl2_attach_with_labels_and_forbidden_equals_reference():
    spec = dict(d_a=4, d_i=2, servers_per_tor=4)
    r_base = r_vl2.rewired_vl2_topology(r_vl2.VL2Spec(**spec), 4, seed=0)
    p_base = p_vl2.rewired_vl2_topology(p_vl2.VL2Spec(**spec), 4, seed=0)
    n = p_base.n + 2
    lab = np.concatenate([p_base.labels, [2, 2]])
    tor = lab == 0
    forb = tor[:, None] & tor[None, :]
    kw = dict(labels=[2, 2], seed=5, max_breaks=3, forbidden=forb,
              link_unit=p_vl2.FABRIC)
    want = r_life.attach_new_switches(r_base, [4, 4], **kw)
    got = p_life.attach_new_switches(p_base, [4, 4], **kw)
    _same_topo(got.topo, want.topo)
    assert got.topo.n == n
    with pytest.raises(ValueError, match="labels"):
        p_life.attach_new_switches(p_base, [4])


def test_expansion_space_and_swaps_equal_reference():
    r_base = r_graphs.random_regular_graph(16, 4, seed=1, servers=2)
    p_base = p_graphs.random_regular_graph(16, 4, seed=1, servers=2)
    r_att = r_life.attach_new_switches(r_base, [6, 6], seed=0, max_breaks=6)
    p_att = p_life.attach_new_switches(p_base, [6, 6], seed=0, max_breaks=6)
    r_space = r_life.ExpansionSpace(r_att.topo, r_base.cap)
    p_space = p_life.ExpansionSpace(p_att.topo, p_base.cap)
    assert np.array_equal(p_space.base_cap, r_space.base_cap)
    assert np.array_equal(p_space.swappable_links(p_att.topo),
                          r_space.swappable_links(r_att.topo))
    assert np.array_equal(p_space.rewirable_mask(p_att.topo),
                          r_space.rewirable_mask(r_att.topo))
    _same_topo(p_space.initial(3).topo, r_space.initial(3).topo)
    a, b = RCandidate(topo=r_att.topo), PCandidate(topo=p_att.topo)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    start = p_life.recabled_links(p_base.cap, p_att.topo.cap)
    for _ in range(8):
        na = r_moves.swap_edges(a, ra, r_space, swaps=2)
        nb = p_moves.swap_edges(b, rb, p_space, swaps=2)
        assert (na is None) == (nb is None)
        if na is None:
            break
        _same_topo(nb.topo, na.topo)
        assert p_life.recabled_links(p_base.cap, nb.topo.cap) <= start
        a, b = na, nb
    assert ra.bit_generator.state == rb.bit_generator.state


def test_plan_expansion_is_monotone_and_within_budget():
    spec = p_vl2.VL2Spec(d_a=4, d_i=2, servers_per_tor=4)
    start = p_vl2.rewired_vl2_topology(spec, n_tor=4, seed=0)

    def forbid(t):
        tor = t.labels == 0
        return tor[:, None] & tor[None, :]

    budget = 2
    res = p_life.plan_expansion(
        start, [[4, 4], [4, 4]], max_recabled_links=budget,
        engine=PCertified(iters=40, tol=1e-3, device="cpu"),
        new_labels=[2], forbidden_fn=forbid, link_unit=p_vl2.FABRIC,
        rounds=1, fleet=3, elite=2, runs=2, seed=0)
    lbs = [s.lb for s in res.steps]
    assert len(res.steps) == 3 and res.stats["lb_trajectory"] == tuple(lbs)
    assert all(b >= a for a, b in zip(lbs, lbs[1:])), lbs
    assert all(0 < s.lb <= s.ub * (1 + 1e-6) for s in res.steps)
    assert all(s.recabled <= budget for s in res.steps)
    assert [s.topo.n for s in res.steps] == [start.n, start.n + 2,
                                             start.n + 4]
    final = res.steps[-1].topo
    tor = final.labels == 0
    assert np.all(final.cap[np.ix_(tor, tor)] == 0)
    for s in res.steps[1:]:
        assert np.allclose(s.topo.cap.sum(1)[:start.n], start.cap.sum(1))
    # 1 + rounds search executes and one certification per optimize call
    assert res.stats["executes"] == 2 + 2 * (1 + 1 + 1)
