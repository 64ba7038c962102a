"""The port's host layer (graphs, traffic, bounds, LP oracle) against the
reference: the same seeds must give identical arrays and an identical LP
optimum, since both are the same numpy/scipy code."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bounds as r_bounds  # noqa: E402
from repro.core import graphs as r_graphs  # noqa: E402
from repro.core import lp as r_lp  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro_torch.core import bounds as p_bounds  # noqa: E402
from repro_torch.core import graphs as p_graphs  # noqa: E402
from repro_torch.core import lp as p_lp  # noqa: E402
from repro_torch.core import traffic as p_traffic  # noqa: E402


def _families(g):
    return {
        "rrg": lambda: g.random_regular_graph(24, 4, seed=3, servers=2),
        "two-cluster": lambda: g.biased_two_cluster_graph(
            [5] * 12, [3] * 12, 0.5, seed=2, servers=[2] * 24),
        "power-law": lambda: g.random_graph_from_degrees(
            g.power_law_degrees(20, 3, 8, 2.5, seed=4), seed=5, servers=1),
        "multi": lambda: g.random_graph_from_degrees(
            [7, 7, 2, 2, 2, 2], seed=6, allow_multi=True),
        "expanded": lambda: g.random_regular_graph(
            10, 3, seed=7, servers=2).with_server_nodes(nic_capacity=2.0),
    }


def _same_topology(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k] is None:
            assert fb[k] is None, k
        else:
            assert np.array_equal(fa[k], fb[k]), k
            assert fa[k].dtype == fb[k].dtype, k


@pytest.mark.parametrize("family", sorted(_families(r_graphs)))
def test_generators_identical(family):
    ref = _families(r_graphs)[family]()
    port = _families(p_graphs)[family]()
    _same_topology(ref, port)
    assert r_graphs.degree_stats(ref.cap) == p_graphs.degree_stats(port.cap)
    assert np.array_equal(r_graphs.connected_components(ref),
                          p_graphs.connected_components(port))


def test_from_arrays_round_trips_reference_instance():
    ref = r_graphs.biased_two_cluster_graph([4] * 6, [3] * 6, 1.0, seed=1,
                                            servers=2)
    fields = dataclasses.asdict(ref)
    port = p_graphs.Topology.from_arrays(fields)
    _same_topology(ref, port)
    fields["cap"][0, 1] = 99.0     # the port owns copies of the arrays
    assert port.cap[0, 1] != 99.0
    with pytest.raises(ValueError, match="unknown Topology fields"):
        p_graphs.Topology.from_arrays({**dataclasses.asdict(ref), "x": 1})


def test_coarsen_and_ell_export_identical():
    ref = r_graphs.random_regular_graph(10, 3, seed=7, servers=2)
    port = p_graphs.random_regular_graph(10, 3, seed=7, servers=2)
    dem = r_traffic.make("permutation", ref.with_server_nodes().servers, 3)
    rt, rd = ref.with_server_nodes().coarsen(dem)
    pt, pd = port.with_server_nodes().coarsen(dem)
    _same_topology(rt, pt)
    assert np.array_equal(rd, pd)
    re, pe = ref.to_ell(), port.to_ell()
    assert np.array_equal(re.idx, pe.idx) and np.array_equal(re.wgt, pe.wgt)
    rr, pr = (g.random_regular_ell(32, 4, seed=2) for g in (r_graphs,
                                                            p_graphs))
    assert np.array_equal(rr.idx, pr.idx) and np.array_equal(rr.wgt, pr.wgt)
    assert np.array_equal(
        r_graphs.distribute_servers([4, 6, 9, 3], 11, beta=1.5),
        p_graphs.distribute_servers([4, 6, 9, 3], 11, beta=1.5))


@pytest.mark.parametrize("pattern,kw", [
    ("permutation", {}), ("all_to_all", {}), ("all_to_one", {}),
    ("stride", {"frac": 0.5}),
])
def test_traffic_identical(pattern, kw):
    servers = r_graphs.random_regular_graph(16, 4, seed=1, servers=3).servers
    for seed in (0, 1, 7):
        ref = r_traffic.make(pattern, servers, seed, **kw)
        port = p_traffic.make(pattern, servers, seed, **kw)
        assert np.array_equal(ref, port) and ref.dtype == port.dtype


def test_traffic_adversarial_not_ported_yet():
    """Named when the pattern was missing; it is ported now: the registry
    has the reference's names, and "adversarial", like the reference's,
    needs the topology it attacks (its search: test_torch_adversarial)."""
    assert sorted(p_traffic.PATTERNS) == sorted(r_traffic.PATTERNS)
    with pytest.raises(ValueError, match="topology it attacks"):
        p_traffic.make("adversarial", np.ones(4, np.int64), 0)


@pytest.mark.parametrize("n,r,seed", [(12, 4, 0), (16, 5, 1)])
def test_lp_theta_identical(n, r, seed):
    ref = r_graphs.random_regular_graph(n, r, seed=seed, servers=2)
    port = p_graphs.Topology.from_arrays(dataclasses.asdict(ref))
    dem = r_traffic.make("permutation", ref.servers, seed + 1)
    a = r_lp.max_concurrent_flow(ref, dem)
    b = p_lp.max_concurrent_flow(port, dem)
    assert a.throughput == b.throughput
    assert np.array_equal(a.edge_flow, b.edge_flow)
    assert r_lp.aspl_hops(ref, dem) == p_lp.aspl_hops(port, dem)


def test_bounds_identical():
    for n, r in ((40, 10), (512, 16), (100, 7)):
        assert r_bounds.aspl_lower_bound(n, r) == p_bounds.aspl_lower_bound(
            n, r)
        assert (r_bounds.throughput_upper_bound(n, r, 4096.0)
                == p_bounds.throughput_upper_bound(n, r, 4096.0))
    args = (120.0, 14.0, 2.3, 30, 50)
    assert (r_bounds.het_throughput_upper_bound(*args)
            == p_bounds.het_throughput_upper_bound(*args))
    assert r_bounds.cut_threshold(0.7, 30, 50) == p_bounds.cut_threshold(
        0.7, 30, 50)
