"""Traffic matrices (paper §3, §8.1); a copy of ``repro.core.traffic``
whose ``"adversarial"`` pattern runs the port's worst-case search
(``repro_torch.core.adversarial``).

All traffic is specified at server level and aggregated to a switch-level
demand matrix ``dem[N, N]`` where dem[u, v] = number of unit-demand server
flows from switch u to switch v.  Flows between servers on the same switch
never enter the network and are dropped (they trivially achieve any
throughput).  Network throughput is the max θ such that every flow can be
routed at rate θ (max concurrent flow).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "make",
    "PATTERNS",
    "random_permutation",
    "all_to_all",
    "all_to_one",
    "stride",
    "adversarial",
    "num_flows",
]

# sub-stream keying: patterns that need a second independent RNG stream
# derive it as default_rng((seed, _KEY)) — a SeedSequence over (seed, key)
# — instead of ``seed + 1``, which collides with a caller sweeping
# consecutive seeds (seed=k's sub-stream == seed=k+1's main stream).
_STRIDE_REST_KEY = int.from_bytes(b"stride-rest", "little")


def _aggregate(src_sw: np.ndarray, dst_sw: np.ndarray, n: int) -> np.ndarray:
    dem = np.zeros((n, n), dtype=np.float64)
    keep = src_sw != dst_sw
    np.add.at(dem, (src_sw[keep], dst_sw[keep]), 1.0)
    return dem


def random_permutation(servers: np.ndarray, seed: int) -> np.ndarray:
    """Each server sends to exactly one other server and receives from exactly
    one (a random derangement over servers).

    A derangement needs at least two servers; fewer raise ``ValueError``
    (the old code silently fell out of its fixup loop on ``sum(servers) <
    2`` and returned an all-zero demand matrix, which downstream solvers
    reject with far more confusing errors).
    """
    servers = np.asarray(servers, np.int64)
    n = len(servers)
    s = int(servers.sum())
    if s < 2:
        raise ValueError(
            f"random_permutation needs >= 2 servers total, got {s} "
            "(a derangement over fewer servers does not exist)")
    sw_of_server = np.repeat(np.arange(n), servers)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(s)
    # derangement-ify: cycle the fixed points among themselves (one pass),
    # or swap a lone fixed point with a neighbour.  For s >= 2 each pass
    # strictly clears every current fixed point without creating new ones
    # among them, so this terminates in a handful of iterations; the cap
    # is a belt-and-braces guard that now FAILS LOUDLY instead of
    # returning a non-derangement.
    for _ in range(100):
        fixed = np.flatnonzero(perm == np.arange(s))
        if len(fixed) == 0:
            break
        if len(fixed) == 1:
            j = (fixed[0] + 1) % s
            perm[fixed[0]], perm[j] = perm[j], perm[fixed[0]]
        else:
            perm[fixed] = perm[np.roll(fixed, 1)]
    if (perm == np.arange(s)).any():
        raise RuntimeError(
            "random_permutation failed to build a derangement in 100 "
            f"fixup passes (s={s}, seed={seed}); this should be impossible "
            "for s >= 2 — please report")
    return _aggregate(sw_of_server, sw_of_server[perm], n)


def all_to_all(servers: np.ndarray) -> np.ndarray:
    """Every server sends one unit flow to every other server."""
    servers = np.asarray(servers, np.float64)
    dem = np.outer(servers, servers)
    np.fill_diagonal(dem, 0.0)
    return dem


def all_to_one(servers: np.ndarray, seed: int) -> np.ndarray:
    """Every server sends to one random server (paper §8.1(b)).

    The target switch is drawn server-weighted among switches that HAVE
    servers; a fleet with no servers (or with every server on one switch,
    so no flow could ever cross the network) raises ``ValueError`` instead
    of dividing by zero / returning an all-zero demand matrix that
    downstream solvers reject with far more confusing errors.
    """
    servers = np.asarray(servers, np.int64)
    n = len(servers)
    total = int(servers.sum())
    if total == 0:
        raise ValueError(
            "all_to_one needs >= 1 server, got 0 (no sender, no target)")
    occupied = np.flatnonzero(servers > 0)
    if len(occupied) < 2:
        raise ValueError(
            "all_to_one needs servers on >= 2 switches, got "
            f"{len(occupied)} (all traffic would stay on-switch and the "
            "demand matrix would be all-zero)")
    rng = np.random.default_rng(seed)
    target_sw = int(rng.choice(occupied, p=servers[occupied] / total))
    dem = np.zeros((n, n), np.float64)
    dem[:, target_sw] = servers
    dem[target_sw, target_sw] = 0.0
    return dem


def stride(servers: np.ndarray, frac: float, seed: int) -> np.ndarray:
    """x% Stride (paper §8.1(c)): a fraction ``frac`` of switches (ToRs) engage
    in a ToR-level permutation — each sends *all* its servers' traffic to one
    other ToR in the set; the rest run a server-level random permutation among
    themselves.

    ``frac`` must lie in [0, 1] — out-of-range values used to crash deep
    inside ``rng.choice`` with an opaque numpy error (k > n)."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(
            f"stride frac must be in [0, 1], got {frac!r} (the fraction "
            "of switches engaging in the ToR-level permutation)")
    servers = np.asarray(servers, np.int64)
    n = len(servers)
    rng = np.random.default_rng(seed)
    k = int(round(frac * n))
    stride_sw = rng.choice(n, size=k, replace=False)
    dem = np.zeros((n, n), np.float64)
    if k >= 2:
        p = rng.permutation(stride_sw)        # ToR-level cycle p0->p1->...->p0
        for u, v in zip(p, np.roll(p, -1)):
            dem[u, v] += servers[u]
    rest = np.setdiff1d(np.arange(n), stride_sw)
    if len(rest) >= 2 and servers[rest].sum() >= 2:
        # independent sub-stream (NOT seed + 1, which would alias the
        # server-level permutation of the next seed in a seed sweep)
        sub = random_permutation(servers[rest], (seed, _STRIDE_REST_KEY))
        dem[np.ix_(rest, rest)] += sub
    return dem


def adversarial(servers: np.ndarray, seed: int, *, topo=None,
                **search_kw) -> np.ndarray:
    """Near-worst-case hose-feasible demand matrix for a SPECIFIC topology.

    Unlike every other pattern, adversarial traffic is a property of the
    (topology, servers) pair, not of ``servers`` alone: the worst TM is
    found by gradient descent ON throughput through the differentiable
    dual solve (``repro_torch.core.adversarial.find_worst_tm``).  Pass the
    topology via the ``topo=`` keyword; ``search_kw`` forwards the search
    knobs (rounds / candidates / iters / device / ...).  Raises
    ``ValueError`` without a topology — there is no topology-free worst
    case.
    """
    if topo is None:
        raise ValueError(
            "traffic pattern 'adversarial' needs the topology it attacks: "
            "traffic.make('adversarial', servers, seed, topo=topo).  The "
            "worst-case TM is a property of the wiring, not of the server "
            "counts alone.")
    from repro_torch.core.adversarial import find_worst_tm  # lazy: a cycle
    return find_worst_tm(topo, seed=seed, **search_kw).tm


def num_flows(dem: np.ndarray) -> float:
    """Number of (unit-demand) flows in the demand matrix."""
    return float(dem.sum())


# --- named pattern registry -------------------------------------------------
# Every entry has the uniform signature (servers, seed, **pattern_kw) ->
# dem[N, N] so sweep drivers can stay pattern-agnostic; unknown keyword
# arguments raise TypeError rather than being silently ignored.
# Deterministic patterns ignore the seed.  "adversarial" additionally
# needs the topology it attacks (kw: ``topo=``) — see ``adversarial``.
PATTERNS = {
    "permutation": lambda servers, seed: random_permutation(servers, seed),
    "all_to_all": lambda servers, seed: all_to_all(servers),
    "all_to_one": lambda servers, seed: all_to_one(servers, seed),
    "stride": lambda servers, seed, frac=1.0: stride(servers, frac, seed),
    "adversarial": lambda servers, seed, **kw: adversarial(servers, seed,
                                                           **kw),
}


def make(name: str, servers: np.ndarray, seed: int = 0, **kw) -> np.ndarray:
    """Build the named traffic pattern's switch-level demand matrix.

    Known names: permutation, all_to_all, all_to_one, stride (kw:
    ``frac``), adversarial (kw: ``topo`` + search knobs).
    """
    try:
        fn = PATTERNS[name]
    except KeyError:
        raise ValueError(
            f"unknown traffic pattern {name!r}; known: {sorted(PATTERNS)}"
        ) from None
    return fn(np.asarray(servers, np.int64), seed, **kw)
