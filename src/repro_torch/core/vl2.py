"""VL2 and its degree-proportional random rewiring (paper §7, Fig. 11; the
port of ``repro.core.vl2``).

VL2 [Greenberg et al., SIGCOMM'09]: ToRs with 20 x 1GbE servers and 2 x 10GbE
uplinks to two aggregation switches; full bipartite 10GbE mesh between
aggregation (D_A ports) and core/intermediate (D_I ports) switches.  Such a
VL2 supports D_A*D_I/4 ToRs at full throughput by construction.

The paper's rewiring keeps every piece of equipment (same ToRs, same agg,
same core switches) but (a) spreads ToR uplinks over agg AND core switches in
proportion to their port counts and (b) wires all remaining agg/core ports as
a uniform random graph.  Capacity units: 1 = 1GbE, so fabric links are 10.

Throughput checks run through ``repro_torch.core.engine``: the ``engine``
argument of the experiments accepts a registry name ("exact", "dual", ...) or a
``ThroughputEngine`` instance, and batching engines check all seeded runs of
a candidate topology in one ``solve_batch`` call.

The reference's ``designed_vl2_topology`` (the fleet optimizer's wiring
of the same equipment) needs the design layer, which the port does not
have yet; it arrives with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import engine as engine_mod
from repro_torch.core import graphs, traffic

__all__ = [
    "VL2Spec", "vl2_topology", "rewired_vl2_topology",
    "supports_full_throughput",
    "max_tors_at_full_throughput",
]

FABRIC = 10.0   # 10GbE in units of 1GbE


@dataclasses.dataclass(frozen=True)
class VL2Spec:
    d_a: int                    # ports per aggregation switch (10G)
    d_i: int                    # ports per core/intermediate switch (10G)
    servers_per_tor: int = 20

    @property
    def n_agg(self) -> int:
        return self.d_i            # full bipartite: core degree = #agg

    @property
    def n_core(self) -> int:
        return self.d_a // 2       # agg splits ports half down / half up

    @property
    def n_tor_full(self) -> int:
        return self.d_a * self.d_i // 4


def vl2_topology(spec: VL2Spec, n_tor: int | None = None,
                 server_nodes: bool = False) -> graphs.Topology:
    """The stock VL2 topology.  Node order: [ToRs | aggs | cores]; labels
    0=ToR, 1=agg, 2=core.  ``server_nodes=True`` returns the server-
    expanded view (each server its own degree-1 leaf on a 1GbE NIC link);
    the planning engines contract it back onto this ToR-level graph by
    default (``Topology.coarsen`` — exact, smaller padded lanes)."""
    n_tor = spec.n_tor_full if n_tor is None else n_tor
    if n_tor > spec.n_tor_full:
        raise ValueError("VL2 wiring cannot host more than D_A*D_I/4 ToRs")
    na, nc = spec.n_agg, spec.n_core
    n = n_tor + na + nc
    cap = np.zeros((n, n))
    agg0, core0 = n_tor, n_tor + na
    # ToR i: two uplinks to distinct aggs, assigned round-robin; with a
    # single agg (na == 1) both uplinks land on it, doubling that capacity
    for i in range(n_tor):
        a1 = (2 * i) % na
        a2 = (2 * i + 1) % na
        cap[i, agg0 + a1] += FABRIC
        cap[agg0 + a1, i] += FABRIC
        cap[i, agg0 + a2] += FABRIC
        cap[agg0 + a2, i] += FABRIC
    # full bipartite agg <-> core
    for a in range(na):
        for c in range(nc):
            cap[agg0 + a, core0 + c] += FABRIC
            cap[core0 + c, agg0 + a] += FABRIC
    servers = np.concatenate([np.full(n_tor, spec.servers_per_tor, np.int64),
                              np.zeros(na + nc, np.int64)])
    labels = np.concatenate([np.zeros(n_tor, np.int64),
                             np.ones(na, np.int64),
                             np.full(nc, 2, np.int64)])
    topo = graphs.Topology(cap=cap, servers=servers, labels=labels)
    return topo.with_server_nodes() if server_nodes else topo


def rewired_vl2_topology(spec: VL2Spec, n_tor: int, seed: int,
                         server_nodes: bool = False) -> graphs.Topology:
    """Same equipment as ``vl2_topology`` but rewired per the paper:
    ToR uplinks spread over agg+core in proportion to port count; all
    remaining agg/core ports wired uniformly at random (all links 10G).
    ``server_nodes`` as in ``vl2_topology``."""
    na, nc = spec.n_agg, spec.n_core
    n = n_tor + na + nc
    agg0, core0 = n_tor, n_tor + na
    rng = np.random.default_rng(seed)

    # --- distribute the 2*n_tor ToR uplinks over agg/core by port count ----
    uplinks = 2 * n_tor
    ports = np.concatenate([np.full(na, spec.d_a), np.full(nc, spec.d_i)])
    total_ports = int(ports.sum())
    if uplinks > total_ports:
        raise ValueError("not enough fabric ports for the ToR uplinks")
    ideal = uplinks * ports / total_ports
    take = np.floor(ideal).astype(np.int64)
    rem = uplinks - int(take.sum())
    if rem > 0:
        take[np.argsort(-(ideal - take))[:rem]] += 1
    take = np.minimum(take, ports)      # safety; ports >> take in practice

    cap = np.zeros((n, n))
    # round-robin the ToR uplink endpoints over the per-switch quotas so each
    # ToR's two uplinks land on different switches whenever possible
    endpoints = np.repeat(np.arange(na + nc), take)
    endpoints = rng.permutation(endpoints)
    for i in range(n_tor):
        e1, e2 = endpoints[2 * i], endpoints[2 * i + 1]
        if e1 == e2:
            alt = np.flatnonzero(endpoints != e1)
            if len(alt):
                j = int(alt[rng.integers(len(alt))])
                endpoints[2 * i + 1], endpoints[j] = endpoints[j], endpoints[2 * i + 1]
                e2 = endpoints[2 * i + 1]
        for e in (e1, e2):
            u = agg0 + int(e)
            cap[i, u] += FABRIC
            cap[u, i] += FABRIC

    # --- random graph over the remaining agg/core ports --------------------
    used = np.bincount(endpoints, minlength=na + nc)
    deg = ports - used
    if deg.sum() % 2 != 0:
        deg[int(np.argmax(deg))] -= 1
    sub = graphs._random_graph_cap(deg, seed + 1, capacity=FABRIC)
    cap[agg0:, agg0:] += sub

    servers = np.concatenate([np.full(n_tor, spec.servers_per_tor, np.int64),
                              np.zeros(na + nc, np.int64)])
    labels = np.concatenate([np.zeros(n_tor, np.int64),
                             np.ones(na, np.int64),
                             np.full(nc, 2, np.int64)])
    topo = graphs.Topology(cap=cap, servers=servers, labels=labels)
    return topo.with_server_nodes() if server_nodes else topo


def _criterion_value(result) -> float:
    """The throughput figure a pass/fail criterion should judge: the
    certified LOWER bound when the engine reports a bracket (so "supports
    full throughput" is a certified claim, not an optimistic upper-bound
    one), else the result's headline throughput."""
    return result.meta.get("lb", result.throughput)


def supports_full_throughput(topo: graphs.Topology, runs: int, seed0: int,
                             engine="exact", tol: float = 1e-6,
                             traffic_fn=None) -> bool:
    """Paper's criterion: >= 1 unit (1 Gbps) for every flow of a random
    permutation (or ``traffic_fn(servers, seed)``), across all runs.

    On a bracket engine (``get_engine("certified")``) the test uses each
    run's certified lower bound, so a True answer is a proof, not an
    upper-bound estimate.
    """
    eng = engine_mod.as_engine(engine)
    dems = [(traffic.random_permutation(topo.servers, seed0 + rr)
             if traffic_fn is None else traffic_fn(topo.servers, seed0 + rr))
            for rr in range(runs)]
    if eng.batches:
        results = eng.solve_batch([topo] * runs, dems)
        return all(_criterion_value(r) >= 1.0 - tol for r in results)
    for dem in dems:       # sequential engine: keep the early exit
        if _criterion_value(eng.solve(topo, dem)) < 1.0 - tol:
            return False
    return True


def max_tors_at_full_throughput(spec: VL2Spec, build_fn, lo: int, hi: int,
                                runs: int = 3, seed0: int = 0,
                                engine="exact",
                                traffic_fn=None) -> int:
    """Binary search the largest n_tor with full throughput (paper Fig. 11).
    ``build_fn(spec, n_tor, seed) -> Topology`` — ``vl2_topology`` (stock)
    or ``rewired_vl2_topology`` (paper recipe) fit the slot."""
    def ok(n_tor: int) -> bool:
        if n_tor <= 0:
            return True
        try:
            topo = build_fn(spec, n_tor, seed0)
        except ValueError:
            return False      # not physically wirable -> not supported
        return supports_full_throughput(topo, runs, seed0 + 17, engine,
                                        traffic_fn=traffic_fn)

    while not ok(lo):
        hi = lo
        lo = lo // 2
        if lo == 0:
            raise ValueError("even 1 ToR is infeasible")
    while ok(hi):
        lo, hi = hi, hi * 2
        if hi > 4096:
            break
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo
