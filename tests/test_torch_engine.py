"""The port's dual engine and BatchPlan against the reference.

The descent is the same algorithm on the same instances, but Adam's
exp/log/sqrt and the subgradient's source sums round differently in the
two frameworks, so bounds are held within rel 1e-3 (not bit for bit) and
above the LP optimum; the plan's structure must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as r_engine  # noqa: E402
from repro.core import graphs as r_graphs  # noqa: E402
from repro.core import lp as r_lp  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro.core.plan import BatchPlan as RPlan  # noqa: E402
from repro_torch.core import engine as p_engine  # noqa: E402
from repro_torch.core import mcf as p_mcf  # noqa: E402
from repro_torch.core.graphs import Topology  # noqa: E402
from repro_torch.core.plan import BatchPlan as PPlan  # noqa: E402

_REL = 1e-3


def _pile(ns=(12, 14, 16, 20), deg=4, servers=3):
    """(reference topologies, port topologies, demands) from one seed set:
    the port gets the reference's exact instances through from_arrays."""
    rt, pt, dems = [], [], []
    for s, n in enumerate(ns):
        t = r_graphs.random_regular_graph(n, deg, seed=s, servers=servers)
        rt.append(t)
        pt.append(Topology.from_arrays(dataclasses.asdict(t)))
        dems.append(r_traffic.make("permutation", t.servers, seed=s + 1))
    return rt, pt, dems


def test_dual_bounds_match_reference_and_exceed_lp():
    rt, pt, dems = _pile()
    ref = r_engine.get_engine("dual", iters=150, devices=1)
    port = p_engine.get_engine("dual", iters=150, device="cpu")
    a = ref.solve_batch(rt, dems)
    b = port.solve_batch(pt, dems)
    for x, y in zip(a, b):
        assert y.throughput == pytest.approx(x.throughput, rel=_REL)
        assert y.meta["iterations"] == x.meta["iterations"] == 150
        assert y.bound == "upper" and y.engine == "dual"
    for t, d, y in zip(pt[:2], dems[:2], b[:2]):
        theta = r_lp.max_concurrent_flow(t.cap, d, want_flows=False)
        assert y.throughput >= theta.throughput * (1 - 1e-6)
    # the plan made the same decisions, and reports them the same way
    assert port.last_plan.as_dict() == ref.last_plan.as_dict()
    for x, y in zip(a, b):
        for k in ("bucket", "padded_n", "nodes", "batch_size", "chunk",
                  "chunks", "devices", "plan"):
            assert y.meta[k] == x.meta[k], k


@pytest.mark.parametrize("max_lanes,bucket", [(None, "pow2"), (2, "pow2"),
                                              (3, None), (1, 8)])
def test_plan_structure_equal_on_mixed_pile(max_lanes, bucket):
    rt, pt, dems = _pile((12, 14, 16, 20, 24, 33, 16))
    r = RPlan.build(rt, dems, bucket=bucket, max_lanes=max_lanes, devices=1)
    p = PPlan.build(pt, dems, bucket=bucket, max_lanes=max_lanes)
    assert p.stats.as_dict() == r.stats.as_dict()
    assert [dataclasses.astuple(c) for c in p.chunks] == \
        [dataclasses.astuple(c) for c in r.chunks]
    for rc, pc in zip(r.chunks, p.chunks):
        for x, y in zip(r._pack(rc), p._pack(pc)):
            assert np.array_equal(x, y)
        assert r._density_hints(rc) == p._density_hints(pc)


def test_refill_keeps_structure():
    _, pt, dems = _pile()
    plan = PPlan.build(pt, dems, max_lanes=2)
    _, pt2, dems2 = _pile(deg=5, servers=2)
    again = plan.refill(pt2, dems2)
    assert again.chunks == plan.chunks
    assert again.stats == plan.stats
    assert np.array_equal(again.caps[0], np.asarray(pt2[0].cap, np.float32))
    with pytest.raises(ValueError, match="refill needs"):
        plan.refill(pt2[:2], dems2[:2])
    _, other, od = _pile((12, 14, 16, 24))
    with pytest.raises(ValueError, match="rebuild the plan"):
        plan.refill(other, od)


def test_early_stop_and_single_solve_track_reference():
    rt, pt, dems = _pile((16,))
    r = r_engine.get_engine("dual", iters=300, tol=1e-3).solve(rt[0],
                                                              dems[0])
    p = p_engine.get_engine("dual", iters=300, tol=1e-3,
                            device="cpu").solve(pt[0], dems[0])
    assert p.throughput == pytest.approx(r.throughput, rel=_REL)
    assert p.meta["iterations"] < 300
    assert abs(p.meta["iterations"] - r.meta["iterations"]) <= 25


def test_on_disconnected_drop_and_auto_engine():
    t = r_graphs.random_regular_graph(12, 3, seed=0, servers=2)
    cap = np.zeros((16, 16))
    cap[:12, :12] = t.cap
    cap[12:, 12:] = r_graphs.random_regular_graph(4, 2, seed=1).cap
    topo = Topology(cap=cap, servers=np.full(16, 2, np.int64))
    dem = r_traffic.make("all_to_all", topo.servers, 0)
    res = p_engine.get_engine("dual", iters=60, device="cpu",
                              on_disconnected="drop").solve_batch([topo],
                                                                  [dem])[0]
    kept, frac = p_mcf.drop_disconnected(topo, dem)
    assert res.meta["dropped_demand_fraction"] == pytest.approx(frac)
    assert 0 < frac < 1 and np.isfinite(res.throughput)
    with pytest.raises(ValueError, match="disconnected"):
        p_engine.get_engine("dual", device="cpu",
                            on_disconnected="raise").solve_batch([topo],
                                                                 [dem])
    auto = p_engine.get_engine("auto", exact_max_nodes=12, iters=40,
                               device="cpu")
    _, pt, dems = _pile((12, 16))
    out = auto.solve_batch(pt, dems)
    assert [r.bound for r in out] == ["exact", "upper"]


def test_run_sweep_matches_reference_on_exact_engine():
    sweep = p_engine.Sweep(xs=(3, 4), runs=2)

    def build(mod):
        return lambda x, seed: mod.random_regular_graph(10, int(x),
                                                        seed=seed, servers=2)
    from repro_torch.core import graphs as p_graphs
    a = r_engine.run_sweep(r_engine.Sweep(xs=(3, 4), runs=2),
                           build(r_graphs), "exact")
    b = p_engine.run_sweep(sweep, build(p_graphs), "exact")
    assert [(x.x, x.mean, x.values) for x in a] == \
        [(y.x, y.mean, y.values) for y in b]
    assert sorted(p_engine.ENGINES) == ["adversarial", "auto", "certified",
                                        "dual", "dual-pallas", "exact",
                                        "primal"]
    assert p_engine.get_engine("dual-pallas").name == "dual-pallas"
    with pytest.raises(ValueError, match="unknown engine"):
        p_engine.get_engine("ecmp")
