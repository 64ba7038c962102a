"""The port's design layer (``repro_torch.design``, ``heterogeneous.
optimize_spec``, ``vl2.designed_vl2_topology``) against the reference.

``spaces`` and ``moves`` are numpy on both sides, so the same rng state
must give the same candidates bit for bit.  The search loop is held bit
for bit too, apart from solver noise: ``BatchPlan.execute`` is replaced in
both packages by one shared numpy scorer, so the two optimizers see the
same scores and must visit the same candidates, keep the same elites and
leave the same rng state.  A real search on the CPU is held to the
reference's round-0 scores within rel 1e-3 (the solver values' contract)
and to the execute and compile-key counts.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import design as r_design  # noqa: E402
from repro.core import engine as r_engine  # noqa: E402
from repro.core import heterogeneous as r_het  # noqa: E402
from repro.core import vl2 as r_vl2  # noqa: E402
from repro.core.plan import BatchPlan as RPlan  # noqa: E402
from repro_torch import design as p_design  # noqa: E402
from repro_torch.core import engine as p_engine  # noqa: E402
from repro_torch.core import heterogeneous as p_het  # noqa: E402
from repro_torch.core import vl2 as p_vl2  # noqa: E402
from repro_torch.core.plan import BatchPlan as PPlan  # noqa: E402

_VL2 = dict(d_a=4, d_i=4, servers_per_tor=4)
_TWO = dict(n_large=3, k_large=12, n_small=7, k_small=5, num_servers=25)
_REL = 1e-3


def _spaces(kind):
    """(reference space, port space, moves) of one kind."""
    if kind == "vl2":
        r_spec, p_spec = r_vl2.VL2Spec(**_VL2), p_vl2.VL2Spec(**_VL2)
        return (r_design.VL2Space(r_spec, r_spec.n_tor_full),
                p_design.VL2Space(p_spec, p_spec.n_tor_full), ("swap",))
    return (r_design.TwoClassSpace(r_het.TwoClassSpec(**_TWO)),
            p_design.TwoClassSpace(p_het.TwoClassSpec(**_TWO)),
            ("swap", "servers", "bias"))


def _same_candidate(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert np.array_equal(a.topo.cap, b.topo.cap)
    assert np.array_equal(a.topo.servers, b.topo.servers)
    assert np.array_equal(a.topo.labels, b.topo.labels)
    assert dict(a.params) == dict(b.params)
    assert (a.seed, a.origin) == (b.seed, b.origin)


def _same_evaluated(a, b):
    _same_candidate(a.cand, b.cand)
    assert (a.score, a.values, a.lb, a.ub) == (b.score, b.values, b.lb, b.ub)


@pytest.mark.parametrize("kind", ["vl2", "two_class"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_spaces_and_moves_equal_reference(kind, seed):
    r_space, p_space, _ = _spaces(kind)
    a, b = r_space.initial(seed), p_space.initial(seed)
    _same_candidate(a, b)
    assert np.array_equal(r_space.rewirable_mask(a.topo),
                          p_space.rewirable_mask(b.topo))
    fa, fb = r_space.forbidden_pairs(a.topo), p_space.forbidden_pairs(b.topo)
    assert (fa is None and fb is None) or np.array_equal(fa, fb)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for name in ("swap", "servers", "bias") * 3:
        na = r_design.MOVES[name](a, ra, r_space)
        nb = p_design.MOVES[name](b, rb, p_space)
        _same_candidate(na, nb)
        if na is not None:
            a, b = na, nb
    assert ra.bit_generator.state == rb.bit_generator.state
    assert sorted(p_design.MOVES) == sorted(r_design.MOVES)


@pytest.fixture
def shared_scorer(monkeypatch):
    """``BatchPlan.execute`` of both packages replaced by one numpy scorer:
    a value that moves with the wiring and the demand, the primal's lb 0.9
    of it with the value as its ``ub``."""
    w = np.random.default_rng(0).uniform(0.5, 1.5, (64, 64))

    def execute(self, solver="dual", **_):
        out = []
        for cap, dem in zip(self.caps, self.dems):
            n = cap.shape[0]
            v = float((cap * w[:n, :n]).sum()
                      / (1.0 + (dem * w[:n, :n].T).sum()))
            out.append(types.SimpleNamespace(
                value=0.9 * v if solver == "primal" else v, iterations=0,
                meta={"ub": v}))
        return out

    monkeypatch.setattr(RPlan, "execute", execute)
    monkeypatch.setattr(PPlan, "execute", execute)


def _engines():
    return (r_engine.DualEngine(iters=40, tol=1e-3),
            p_engine.DualEngine(iters=40, tol=1e-3, device="cpu"))


def _same_result(a, b):
    assert a.history == b.history
    _same_evaluated(a.best, b.best)
    _same_evaluated(a.reference, b.reference)
    assert len(a.elites) == len(b.elites)
    for x, y in zip(a.elites, b.elites):
        _same_evaluated(x, y)
    assert a.state.rng_state == b.state.rng_state
    assert (a.state.rounds_done, a.state.executes, a.state.compile_keys,
            a.state.eval_seeds) == (b.state.rounds_done, b.state.executes,
                                    b.state.compile_keys, b.state.eval_seeds)
    for x, y in zip(a.state.elites, b.state.elites):
        _same_evaluated(x, y)
    assert {k: v for k, v in a.stats.items() if k != "last_plan"} == \
        {k: v for k, v in b.stats.items() if k != "last_plan"}
    assert a.stats["last_plan"] == b.stats["last_plan"]


@pytest.mark.parametrize("kind", ["vl2", "two_class"])
def test_search_loop_equals_reference(shared_scorer, kind):
    r_space, p_space, moves = _spaces(kind)
    r_eng, p_eng = _engines()
    kw = dict(moves=moves, rounds=3, fleet=5, elite=2, runs=2, seed=3)
    a = r_design.optimize(r_space, engine=r_eng, **kw)
    b = p_design.optimize(p_space, engine=p_eng, **kw)
    _same_result(a, b)
    assert b.stats["search_executes"] == 1 + 3
    assert b.stats["certify_executes"] == 1
    assert b.best.lb >= b.reference.lb
    # resume: 1 round, then 2 more from the state, equals 3 in one go
    first = p_design.optimize(p_space, engine=p_eng, **{**kw, "rounds": 1})
    rest = p_design.optimize(p_space, engine=p_eng, state=first.state,
                             **{**kw, "rounds": 2})
    assert rest.state.rng_state == b.state.rng_state
    for x, y in zip(rest.state.elites, b.state.elites):
        _same_candidate(x.cand, y.cand)
    assert [h["round"] for h in rest.history] == [2, 3]
    assert rest.history == b.history[2:]
    r_first = r_design.optimize(r_space, engine=r_eng, **{**kw, "rounds": 1})
    r_rest = r_design.optimize(r_space, engine=r_eng, state=r_first.state,
                               **{**kw, "rounds": 2})
    _same_result(r_rest, rest)


def test_drivers_equal_reference(shared_scorer):
    r_eng, p_eng = _engines()
    r_spec, p_spec = r_vl2.VL2Spec(**_VL2), p_vl2.VL2Spec(**_VL2)
    a = r_vl2.designed_vl2_topology(r_spec, 5, 2, engine=r_eng)
    b = p_vl2.designed_vl2_topology(p_spec, 5, 2, engine=p_eng)
    assert np.array_equal(a.cap, b.cap)
    assert np.array_equal(a.servers, b.servers)
    a = r_het.optimize_spec(r_het.TwoClassSpec(**_TWO), engine=r_eng,
                            rounds=2, fleet=4, elite=2, seed=1)
    b = p_het.optimize_spec(p_het.TwoClassSpec(**_TWO), engine=p_eng,
                            rounds=2, fleet=4, elite=2, seed=1)
    _same_result(a, b)


def test_real_search_tracks_reference():
    r_space, p_space, moves = _spaces("vl2")
    r_eng, p_eng = _engines()
    kw = dict(moves=moves, rounds=2, fleet=3, elite=2, runs=2, seed=0)
    a = r_design.optimize(r_space, engine=r_eng, **kw)
    b = p_design.optimize(p_space, engine=p_eng, **kw)
    for k in ("best_score", "mean_score"):
        assert b.history[0][k] == pytest.approx(a.history[0][k], rel=_REL)
    assert b.best.lb >= b.reference.lb - 1e-6
    assert 0 < b.best.lb <= b.best.ub
    for k in ("executes", "search_executes", "certify_executes",
              "instances_per_round", "compile_keys"):
        assert b.stats[k] == a.stats[k], k
    assert b.stats["search_executes"] == 1 + 2
    # every search round on one (padded_n, lanes) shape
    assert len(b.stats["last_plan"]["compile_keys"]) == 1


def test_robust_mode_brackets_the_worst_tm():
    _, p_space, moves = _spaces("vl2")
    _, p_eng = _engines()
    res = p_design.optimize(p_space, engine=p_eng, moves=moves, rounds=1,
                            fleet=3, elite=2, runs=2, seed=0,
                            robust={"rounds": 2, "candidates": 3,
                                    "iters": 40})
    r = res.stats["robust"]
    assert (r["rounds"], r["candidates"], r["iters"]) == (2, 3, 40)
    # one search (2 rounds + 1 certification) per unique candidate
    unique = {id(e.cand) for e in res.elites + [res.reference]}
    assert r["executes"] == 3 * len(unique)
    for ev in res.elites + [res.reference]:
        assert 0 < ev.lb <= ev.ub
    assert res.best.lb == max(e.lb for e in res.elites + [res.reference])
    assert res.stats["search_executes"] == 1 + 1
    assert res.stats["certify_executes"] == 1


def test_optimizer_rejects_bad_inputs():
    _, p_space, _ = _spaces("vl2")
    with pytest.raises(ValueError, match="fleet >= 1"):
        p_design.optimize(p_space, fleet=0)
    with pytest.raises(ValueError, match="unknown move"):
        p_design.optimize(p_space, moves=("teleport",))
    with pytest.raises(ValueError, match="BatchPlan"):
        p_design.optimize(p_space, engine="exact")
