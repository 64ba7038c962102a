"""Random regular graphs RRG(n, r) with ``servers`` servers on every switch
(Singla et al., NSDI'14, §3-4; the Jellyfish construction).

A frozen copy of the port's ``core.graphs.random_regular_graph``: the
configuration model with double-edge-swap repair, drawing from numpy's
generator in the same order, so a seed gives the package's matrix bit for
bit.  The repair keeps its edge lists sorted and updates them in place
instead of rescanning the [N, N] matrix each swap (0.29 s an RRG(512, 16)
becomes ~0.02 s); the draws, and so the graph, are the same.
"""
from __future__ import annotations

import numpy as np


def _pair_stubs(stubs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    s = rng.permutation(stubs)
    half = len(s) // 2
    return np.stack([s[:half], s[half: 2 * half]], axis=1)


class _Keys:
    """A sorted array of linear keys ``a * n + b`` (a <= b): the row-major
    order in which ``np.nonzero`` / ``np.argwhere`` list them."""

    def __init__(self, keys: np.ndarray):
        self.keys = np.asarray(keys, np.int64)

    def set(self, key: int, present: bool) -> None:
        i = int(np.searchsorted(self.keys, key))
        there = i < len(self.keys) and self.keys[i] == key
        if present and not there:
            self.keys = np.insert(self.keys, i, key)
        elif there and not present:
            self.keys = np.delete(self.keys, i)


def _repair_multigraph(adj: np.ndarray, rng: np.random.Generator,
                       max_iter: int = 4_000) -> np.ndarray:
    """Remove self-loops and multi-edges by double-edge swaps, preserving
    the degree sequence (the package's algorithm and draws)."""
    adj = adj.copy()
    n = adj.shape[0]
    edges = _Keys(np.flatnonzero(np.triu(adj, 0)))     # nonzero(triu(adj, 0))
    multi = _Keys(np.flatnonzero(np.triu(adj, 1) > 1))  # argwhere(triu > 1)
    for _ in range(max_iter):
        bad_self = np.flatnonzero(np.diag(adj) > 0)
        if len(bad_self) == 0 and len(multi.keys) == 0:
            return adj
        if len(bad_self) > 0:
            u, v = int(bad_self[0]), int(bad_self[0])
        else:
            u, v = divmod(int(multi.keys[0]), n)
        keys = edges.keys
        if len(keys) == 0:
            break
        for _try in range(200):
            i = int(rng.integers(len(keys)))
            x, y = divmod(int(keys[i]), n)
            if rng.random() < 0.5:
                x, y = y, x
            if len({u, v, x, y}) < (3 if u == v else 4):
                continue
            if adj[u, x] > 0 or adj[v, y] > 0 or u == x or v == y:
                continue
            for a, b, step in ((u, v, -1), (x, y, -1), (u, x, 1), (v, y, 1)):
                adj[a, b] += step
                if a != b:
                    adj[b, a] += step
                else:
                    adj[a, a] += step
            for a, b in ((u, v), (x, y), (u, x), (v, y)):
                lo, hi = min(a, b), max(a, b)
                edges.set(lo * n + hi, adj[lo, hi] > 0)
                if lo != hi:
                    multi.set(lo * n + hi, adj[lo, hi] > 1)
            break
    raise RuntimeError("could not repair multigraph into a simple graph")


def _repair_self_loops(adj: np.ndarray, rng: np.random.Generator,
                       max_iter: int = 20_000) -> np.ndarray:
    """Remove self-loops only (multi-edges allowed), preserving degrees."""
    adj = adj.copy()
    for _ in range(max_iter):
        loops = np.flatnonzero(np.diag(adj) > 0)
        if len(loops) == 0:
            return adj
        u = int(loops[0])
        xs, ys = np.nonzero(np.triu(adj, 1))
        cand = [(x, y) for x, y in zip(xs, ys) if x != u and y != u]
        if not cand:
            adj[u, u] -= 2
            continue
        x, y = cand[int(rng.integers(len(cand)))]
        adj[u, u] -= 2
        adj[x, y] -= 1
        adj[y, x] -= 1
        adj[u, x] += 1
        adj[x, u] += 1
        adj[u, y] += 1
        adj[y, u] += 1
    raise RuntimeError("could not remove self-loops")


def random_graph_cap(degrees, seed: int, capacity: float = 1.0
                     ) -> np.ndarray:
    """[N, N] float64 capacities of a simple graph with these degrees (the
    package's ``_random_graph_cap`` with ``allow_multi=False``)."""
    degrees = np.asarray(degrees, dtype=np.int64)
    n = len(degrees)
    if degrees.sum() % 2 != 0:
        raise ValueError("degree sum must be even")
    for attempt in range(4):
        rng = np.random.default_rng(seed + 7919 * attempt)
        stubs = np.repeat(np.arange(n), degrees)
        pairs = _pair_stubs(stubs, rng)
        adj = np.zeros((n, n), dtype=np.int64)
        np.add.at(adj, (pairs[:, 0], pairs[:, 1]), 1)
        np.add.at(adj, (pairs[:, 1], pairs[:, 0]), 1)
        try:
            adj = _repair_multigraph(adj, rng)
            return adj.astype(np.float64) * capacity
        except RuntimeError:
            if attempt == 3:
                adj = _repair_self_loops(adj, rng)
                return adj.astype(np.float64) * capacity
    raise AssertionError("unreachable")


def build(params: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(capacity [N, N], servers [N]) of RRG(``n``, ``r``) with ``servers``
    a switch and links of ``capacity`` (default 1 = one line rate)."""
    n, r = int(params["n"]), int(params["r"])
    if n * r % 2 != 0 or r >= n:
        raise ValueError(f"no RRG({n}, {r})")
    cap = random_graph_cap([r] * n, seed, float(params.get("capacity", 1.0)))
    return cap, np.full(n, int(params["servers"]), np.int64)


def theorem1(params: dict, flows: float) -> float:
    """Theorem 1 with the Cerf et al. bound on the path length: no r-regular
    graph on n switches carries ``flows`` unit flows at a higher rate."""
    from harness.bounds import throughput_upper_bound
    return throughput_upper_bound(int(params["n"]), int(params["r"]), flows)
