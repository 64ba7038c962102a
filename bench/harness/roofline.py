"""The yardstick for the APSP forward: the least time the card could take for
the closure a descent step needs, counted from the problem and not from
any kernel, so a change of backend, route or launch pattern is read against
the same work.

Per lane: the closure of an N-node graph with E directed edges from every
source needs at least as many Bellman–Ford rounds as the graph's hop
diameter (a shortest path under any lengths has at least as many hops as
the fewest), each round N·E relaxations of 2 fp32 instructions (an add and
a min); and it reads the lane's [N, N] lengths once and writes its [N, N]
distances once, in float32.  The least time is the larger of the two terms
summed over the lanes, at the peaks of one NVIDIA H100 SXM (700 W) below.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
H100 = {"fp32_instr_per_s": 33.5e12,    # 132 SMs x 128 lanes x 1.98 GHz
        "hbm_bytes_per_s": 3.35e12}


def hop_diameter(cap: np.ndarray) -> int:
    """Largest fewest-hop distance between two switches joined by a path
    (breadth-first from every source at once)."""
    adj = (np.asarray(cap) > 0).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    n = adj.shape[0]
    reach = np.eye(n, dtype=np.float32)
    hops = 0
    while True:
        nxt = np.minimum(reach + reach @ adj, 1.0)
        if np.array_equal(nxt, reach):
            return hops
        reach = nxt
        hops += 1


def forward_work(cap: np.ndarray) -> tuple[float, float]:
    """(fp32 instructions, bytes) the closure of one lane needs."""
    cap = np.asarray(cap)
    n = cap.shape[0]
    edges = int(((cap > 0) & ~np.eye(n, dtype=bool)).sum())
    return 2.0 * n * edges * hop_diameter(cap), 2.0 * n * n * 4


def least_seconds(works: list[tuple[float, float]],
                  peaks: dict = H100) -> tuple[float, str]:
    """The least time of closing these lanes together, and which term
    bounds it."""
    ops = sum(w[0] for w in works) / peaks["fp32_instr_per_s"]
    mem = sum(w[1] for w in works) / peaks["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= mem else (mem, "bytes")
