"""VL2 (Greenberg et al., SIGCOMM'09, §4) rewired as in Singla et al.,
NSDI'14, §7 / Fig. 11: the same ToRs, aggregation and intermediate switches,
with the ToR uplinks spread over aggregation and core in proportion to
their ports and every other fabric port wired uniformly at random.

A frozen copy of the port's ``core.vl2.rewired_vl2_topology`` (switch
level; capacities in 1GbE units, so fabric links are 10), drawing from
numpy's generator in the same order as the package.
"""
from __future__ import annotations

import numpy as np

from families.random_regular import random_graph_cap

FABRIC = 10.0   # 10GbE in units of 1GbE


def build(params: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(capacity [N, N], servers [N]) of VL2(``d_a``, ``d_i``) rewired, with
    ``n_tor`` ToRs of ``servers_per_tor`` servers; node order [ToRs | aggs |
    cores]."""
    d_a, d_i = int(params["d_a"]), int(params["d_i"])
    n_tor = int(params["n_tor"])
    servers_per_tor = int(params.get("servers_per_tor", 20))
    na, nc = d_i, d_a // 2
    n = n_tor + na + nc
    agg0 = n_tor
    rng = np.random.default_rng(seed)

    uplinks = 2 * n_tor
    ports = np.concatenate([np.full(na, d_a), np.full(nc, d_i)])
    total_ports = int(ports.sum())
    if uplinks > total_ports:
        raise ValueError("not enough fabric ports for the ToR uplinks")
    ideal = uplinks * ports / total_ports
    take = np.floor(ideal).astype(np.int64)
    rem = uplinks - int(take.sum())
    if rem > 0:
        take[np.argsort(-(ideal - take))[:rem]] += 1
    take = np.minimum(take, ports)

    cap = np.zeros((n, n))
    endpoints = np.repeat(np.arange(na + nc), take)
    endpoints = rng.permutation(endpoints)
    for i in range(n_tor):
        e1, e2 = endpoints[2 * i], endpoints[2 * i + 1]
        if e1 == e2:
            alt = np.flatnonzero(endpoints != e1)
            if len(alt):
                j = int(alt[rng.integers(len(alt))])
                endpoints[2 * i + 1], endpoints[j] = (endpoints[j],
                                                      endpoints[2 * i + 1])
                e2 = endpoints[2 * i + 1]
        for e in (e1, e2):
            u = agg0 + int(e)
            cap[i, u] += FABRIC
            cap[u, i] += FABRIC

    used = np.bincount(endpoints, minlength=na + nc)
    deg = ports - used
    if deg.sum() % 2 != 0:
        deg[int(np.argmax(deg))] -= 1
    cap[agg0:, agg0:] += random_graph_cap(deg, seed + 1, capacity=FABRIC)
    servers = np.concatenate([np.full(n_tor, servers_per_tor, np.int64),
                              np.zeros(na + nc, np.int64)])
    return cap, servers
