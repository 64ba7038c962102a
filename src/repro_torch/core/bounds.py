"""Throughput and path-length bounds (paper §4, §6.2).

* ``aspl_lower_bound`` — Cerf–Cowan–Mullin–Stanton Moore-style lower bound d*
  on the average shortest path length of any r-regular graph on N nodes.
* ``throughput_upper_bound`` — Theorem 1: T ≤ N·r / (⟨D⟩·f), with ⟨D⟩ ≥ d*.
* ``het_throughput_upper_bound`` — Eqn (1): the two-cluster heterogeneous
  bound min{path-bound, cut-bound}.
* ``cut_threshold`` — C̄* below which throughput *must* drop (Fig. 10).

These are *analytic* UPPER bounds: closed-form, computable without building
(or solving) any topology, and valid for EVERY member of their graph class
— a different kind of claim from the solver engines' per-instance bounds.
Units follow the rest of the repo: capacities in multiples of the base
line-speed (1 = one 1GbE link, both directions counted — the paper's C and
C̄), path lengths in hops, throughput as the dimensionless per-unit-demand
rate θ, flow counts f in unit-demand flows.
"""
from __future__ import annotations


__all__ = [
    "aspl_lower_bound",
    "throughput_upper_bound",
    "het_throughput_upper_bound",
    "cut_threshold",
]


def aspl_lower_bound(n: int, r: int) -> float:
    """d* from [Cerf et al. 1974]:

        d* = ( sum_{j=1}^{k-1} j·r·(r-1)^{j-1} + k·R ) / (N - 1)
        R  = N - 1 - sum_{j=1}^{k-1} r·(r-1)^{j-1}  >= 0,  k largest such.

    Interpretation: in the best case the r-regular graph is a Moore tree from
    every vertex — r·(r-1)^{j-1} vertices at hop j; R leftover vertices sit at
    hop k."""
    if r < 2:
        raise ValueError("need r >= 2")
    if n <= 1:
        return 0.0
    total = 0.0       # vertices accounted for in the Moore tree
    weighted = 0.0    # sum of j * (#vertices at hop j)
    k = 1
    while True:
        at_j = r * (r - 1) ** (k - 1)
        if total + at_j >= n - 1:
            break
        total += at_j
        weighted += k * at_j
        k += 1
    R = (n - 1) - total
    weighted += k * R
    return weighted / (n - 1)


def throughput_upper_bound(n: int, r: int, f: float,
                           aspl: float | None = None) -> float:
    """Theorem 1 (+ Cerf bound): per-flow throughput θ of ANY r-regular
    topology on n switches (r unit-capacity links each) carrying f
    unit-demand flows is at most n·r/(⟨D⟩·f); with ⟨D⟩ (hops) unknown,
    substituting the lower bound d* keeps it a valid certified upper
    bound on every such topology at once."""
    d = aspl if aspl is not None else aspl_lower_bound(n, r)
    if f <= 0:
        return float("inf")
    return n * r / (d * f)


def het_throughput_upper_bound(total_capacity: float, cut_capacity: float,
                               aspl: float, n1: int, n2: int) -> float:
    """Eqn (1): T <= min{ C/(⟨D⟩·(n1+n2)), C̄·(n1+n2)/(2·n1·n2) } for random
    permutation traffic over n1 (resp. n2) servers in cluster 1 (resp. 2).

    ``total_capacity``/``cut_capacity`` count both directions (paper's C, C̄);
    ``aspl`` is the demand-weighted average shortest path length."""
    f = n1 + n2
    path_bound = total_capacity / (aspl * f)
    if n1 == 0 or n2 == 0:
        return path_bound
    cut_bound = cut_capacity * (n1 + n2) / (2.0 * n1 * n2)
    return min(path_bound, cut_bound)


def cut_threshold(t_star: float, n1: int, n2: int) -> float:
    """C̄* = T*·2·n1·n2/(n1+n2): if the cross-cluster capacity C̄ is below
    this, throughput MUST be below the plateau value T* (paper Fig. 10)."""
    return t_star * 2.0 * n1 * n2 / (n1 + n2)
