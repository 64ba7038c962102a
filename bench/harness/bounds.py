"""Theorem 1 of Singla et al., NSDI'14 (§4), with the Cerf et al. lower bound
on the average path length: a frozen copy of the port's
``core.bounds.throughput_upper_bound`` and ``aspl_lower_bound``."""
from __future__ import annotations


def aspl_lower_bound(n: int, r: int) -> float:
    """d*: the average shortest path length of a Moore tree of degree r on
    n nodes, a lower bound for every r-regular graph."""
    if r < 2:
        raise ValueError("need r >= 2")
    if n <= 1:
        return 0.0
    total = 0.0
    weighted = 0.0
    k = 1
    while True:
        at_j = r * (r - 1) ** (k - 1)
        if total + at_j >= n - 1:
            break
        total += at_j
        weighted += k * at_j
        k += 1
    weighted += k * ((n - 1) - total)
    return weighted / (n - 1)


def throughput_upper_bound(n: int, r: int, f: float,
                           aspl: float | None = None) -> float:
    """θ <= n·r / (<D>·f) for f unit flows on any r-regular graph of n
    switches with unit links; <D> >= d* when the path length is unknown."""
    d = aspl if aspl is not None else aspl_lower_bound(n, r)
    if f <= 0:
        return float("inf")
    return n * r / (d * f)
