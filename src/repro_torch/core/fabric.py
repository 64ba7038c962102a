"""Fabric design + collective cost model — the paper as a training feature
(the port of ``repro.core.fabric``).

The paper designs data-center fabrics; a multi-pod training job consumes one:
the cross-pod (DCN) hop of a hierarchical all-reduce runs over exactly the
kind of heterogeneous switch fabric the paper optimises.  This module

  1. designs a pod-interconnect fabric from a heterogeneous switch inventory
     using the paper's two rules (attach end-points in proportion to port
     count; wire the rest uniformly at random), and
  2. turns any such fabric into an *achievable collective bandwidth* figure
     via max-concurrent-flow — the number the roofline's cross-pod collective
     term divides by, instead of a flat per-link constant.

Pods attach with ``nics_per_pod`` unit-capacity links each; throughput is per
unit demand, so a collective pattern with per-pod demand d GB moves at
``theta * link_gbps`` GB/s per unit, i.e. finishes in d / (theta*link_gbps).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import engine as engine_mod
from repro_torch.core import graphs

__all__ = [
    "FabricDesign", "design_fabric", "collective_demand",
    "collective_bandwidth", "compare_with_traditional",
]


@dataclasses.dataclass(frozen=True)
class FabricDesign:
    topology: graphs.Topology    # switch-level fabric; servers[i] = #pod NICs
    pod_switch: np.ndarray       # [num_pods * nics] switch hosting each pod NIC
    num_pods: int
    nics_per_pod: int
    link_gbps: float             # capacity of one unit link in GB/s


def _pod_demand_to_switch(design: FabricDesign,
                          pod_dem: np.ndarray) -> np.ndarray:
    """Aggregate a pod-level demand matrix to switch level, splitting each
    pod's traffic evenly over its NICs."""
    n = design.topology.n
    dem = np.zeros((n, n))
    nic_sw = design.pod_switch.reshape(design.num_pods, design.nics_per_pod)
    for s in range(design.num_pods):
        for t in range(design.num_pods):
            if pod_dem[s, t] == 0:
                continue
            share = pod_dem[s, t] / (design.nics_per_pod ** 2)
            for a in nic_sw[s]:
                for b in nic_sw[t]:
                    if a != b:
                        dem[a, b] += share
    return dem


def design_fabric(port_counts: Sequence[int], num_pods: int,
                  nics_per_pod: int = 1, link_gbps: float = 25.0,
                  seed: int = 0, proportional: bool = True) -> FabricDesign:
    """Design a pod-interconnect fabric from a switch inventory.

    proportional=True  — the paper's rule: pod NICs spread over switches in
                         proportion to port count; rest wired random.
    proportional=False — the 'traditional' strawman: pod NICs packed onto the
                         smallest switches only (ToR-style), rest random.
    """
    ports = np.asarray(port_counts, np.int64)
    n = len(ports)
    total_nics = num_pods * nics_per_pod
    if total_nics >= ports.sum():
        raise ValueError("inventory too small for the pod count")
    if proportional:
        srv = graphs.distribute_servers(ports, total_nics, beta=1.0)
    else:
        srv = np.zeros(n, np.int64)
        order = np.argsort(ports)            # smallest switches first
        left = total_nics
        for i in order:
            take = min(left, ports[i] - 1)
            srv[i] = take
            left -= take
            if left == 0:
                break
        if left:
            raise ValueError("small switches cannot host all pod NICs")
    deg = ports - srv
    if deg.sum() % 2 != 0:
        deg = deg.copy()
        deg[int(np.argmax(deg))] -= 1
    cap = graphs._random_graph_cap(deg, seed, allow_multi=True)
    # NIC -> switch assignment, round-robin over the switch server slots
    pod_switch = np.repeat(np.arange(n), srv)
    rng = np.random.default_rng(seed + 1)
    pod_switch = rng.permutation(pod_switch)[:total_nics]
    topo = graphs.Topology(cap=cap, servers=srv, labels=None)
    return FabricDesign(topology=topo, pod_switch=pod_switch,
                        num_pods=num_pods, nics_per_pod=nics_per_pod,
                        link_gbps=link_gbps)


def collective_demand(num_pods: int, pattern: str) -> np.ndarray:
    """Pod-level demand matrix for one 'round' of a collective, normalised to
    1 unit per sending pod."""
    p = num_pods
    dem = np.zeros((p, p))
    if pattern == "ring":          # reduce-scatter/all-gather ring step
        for i in range(p):
            dem[i, (i + 1) % p] = 1.0
    elif pattern == "alltoall":    # MoE-style dispatch
        dem[:] = 1.0 / max(p - 1, 1)
        np.fill_diagonal(dem, 0.0)
    elif pattern == "allgather":   # everyone -> everyone, full copies
        dem[:] = 1.0
        np.fill_diagonal(dem, 0.0)
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    return dem


def collective_bandwidth(design: FabricDesign, pattern: str = "ring",
                         engine="exact") -> float:
    """Achievable per-pod bandwidth (GB/s) for the collective pattern: the
    max concurrent rate theta at which every pod can sustain its demand."""
    pod_dem = collective_demand(design.num_pods, pattern)
    dem = _pod_demand_to_switch(design, pod_dem)
    th = engine_mod.as_engine(engine).solve(design.topology, dem).throughput
    return th * design.link_gbps   # theta is per-unit-demand = per pod


def compare_with_traditional(port_counts: Sequence[int], num_pods: int,
                             nics_per_pod: int = 1, link_gbps: float = 25.0,
                             pattern: str = "ring", runs: int = 3,
                             seed0: int = 0,
                             engine="exact") -> dict[str, float]:
    """Paper-rule fabric vs ToR-style packing, mean over seeds."""
    out = {}
    for name, prop in (("paper", True), ("traditional", False)):
        vals = [collective_bandwidth(
            design_fabric(port_counts, num_pods, nics_per_pod, link_gbps,
                          seed0 + 101 * rr, proportional=prop),
            pattern, engine) for rr in range(runs)]
        out[name] = float(np.mean(vals))
    out["gain"] = out["paper"] / out["traditional"] - 1.0
    return out
