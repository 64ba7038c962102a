"""Exact maximum concurrent flow via scipy's HiGHS LP solver (paper §3).

The paper measures topology capacity as the solution of the standard maximum
concurrent multicommodity flow problem (CPLEX).  We reproduce it exactly with
the bundled HiGHS solver, using the standard per-*source* commodity
aggregation: all flows sharing a source s are one single-source flow variable
vector f_s[e] whose divergence at each node v is θ·dem[s, v] (and
−θ·Σ_v dem[s, v] at s).  Flow decomposition of a single-source flow shows this
is exact for concurrent flow — every path starts at s, so the per-sink
delivery is pinned at θ·dem[s, t].

This reduces the commodity count from O(N²) to ≤ N and is what makes
paper-scale instances (N ≈ 40–200) solve in seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.optimize
import scipy.sparse as sp

from repro_torch.core.graphs import Topology, as_cap

__all__ = ["FlowResult", "max_concurrent_flow", "aspl_hops", "edge_list"]


@dataclasses.dataclass(frozen=True)
class FlowResult:
    throughput: float          # θ: per-unit-demand concurrent rate
    edges: np.ndarray          # [E, 2] directed edge endpoints (u, v)
    edge_cap: np.ndarray       # [E] capacity per directed edge
    edge_flow: np.ndarray      # [E] total flow per directed edge at optimum
    status: str

    @property
    def utilization(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.edge_cap > 0, self.edge_flow / self.edge_cap, 0.0)

    @property
    def mean_utilization(self) -> float:
        """Capacity-weighted network utilisation U = Σf / Σc."""
        return float(self.edge_flow.sum() / self.edge_cap.sum())


def edge_list(cap: Topology | np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Directed edges (both directions) from a symmetric capacity matrix."""
    cap = as_cap(cap)
    us, vs = np.nonzero(cap)
    edges = np.stack([us, vs], axis=1)
    return edges, cap[us, vs].astype(np.float64)


def max_concurrent_flow(cap: Topology | np.ndarray, dem: np.ndarray,
                        want_flows: bool = True) -> FlowResult:
    """Solve max θ s.t. a multicommodity flow routes θ·dem concurrently.

    cap: Topology or [N, N] symmetric capacity matrix.
    dem: [N, N] demand matrix (dem[u, v] = flow volume u -> v at θ = 1).
    """
    cap = as_cap(cap)
    n = cap.shape[0]
    edges, ecap = edge_list(cap)
    ne = len(edges)
    if ne == 0 or dem.sum() == 0:
        raise ValueError("empty network or empty demand")

    sources = np.flatnonzero(dem.sum(axis=1) > 0)
    ns = len(sources)
    nvar = 1 + ns * ne          # [theta, f_{s0,e0..}, f_{s1,..}, ...]

    # --- equality: conservation per (source, node v != source) -------------
    rows, cols, vals = [], [], []
    rhs_rows = 0
    row_of = {}
    for si, s in enumerate(sources):
        for v in range(n):
            if v == s:
                continue            # redundant row (flows sum to zero)
            row_of[(si, v)] = rhs_rows
            rhs_rows += 1
    # incidence entries
    for si, s in enumerate(sources):
        base = 1 + si * ne
        for ei, (u, v) in enumerate(edges):
            if v != s:
                rows.append(row_of[(si, v)])
                cols.append(base + ei)
                vals.append(1.0)     # edge into v
            if u != s:
                rows.append(row_of[(si, u)])
                cols.append(base + ei)
                vals.append(-1.0)    # edge out of u
    # theta column: -dem[s, v]
    for si, s in enumerate(sources):
        for v in range(n):
            if v == s:
                continue
            d = dem[s, v]
            if d != 0:
                rows.append(row_of[(si, v)])
                cols.append(0)
                vals.append(-float(d))
    a_eq = sp.coo_matrix((vals, (rows, cols)), shape=(rhs_rows, nvar)).tocsc()
    b_eq = np.zeros(rhs_rows)

    # --- inequality: capacity per directed edge ----------------------------
    rows, cols, vals = [], [], []
    for si in range(ns):
        base = 1 + si * ne
        rows.extend(range(ne))
        cols.extend(range(base, base + ne))
        vals.extend([1.0] * ne)
    a_ub = sp.coo_matrix((vals, (rows, cols)), shape=(ne, nvar)).tocsc()
    b_ub = ecap.copy()

    c = np.zeros(nvar)
    c[0] = -1.0                     # maximise theta

    res = scipy.optimize.linprog(
        c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
        bounds=[(0, None)] * nvar, method="highs")
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")

    theta = float(res.x[0])
    if want_flows:
        f = res.x[1:].reshape(ns, ne)
        edge_flow = f.sum(axis=0)
    else:
        edge_flow = np.zeros(ne)
    return FlowResult(throughput=theta, edges=edges, edge_cap=ecap,
                      edge_flow=edge_flow, status=res.message)


def aspl_hops(cap: Topology | np.ndarray,
              dem: np.ndarray | None = None) -> float:
    """Average shortest path length in hops.  If ``dem`` is given, the average
    is demand-weighted (the paper's ⟨D⟩ for a traffic matrix); otherwise it is
    over all connected ordered pairs."""
    import scipy.sparse.csgraph as csgraph

    cap = as_cap(cap)
    adj = sp.csr_matrix((cap > 0).astype(np.float64))
    dist = csgraph.shortest_path(adj, method="D", unweighted=True)
    if dem is None:
        mask = np.isfinite(dist) & ~np.eye(cap.shape[0], dtype=bool)
        return float(dist[mask].mean())
    w = dem / dem.sum()
    if not np.all(np.isfinite(dist[dem > 0])):
        return float("inf")
    return float((dist * w).sum())
