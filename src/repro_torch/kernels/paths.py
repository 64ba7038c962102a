"""k-shortest path-set enumeration from converged (min,+) distances.

A numpy copy of the reference's ``kernels/paths.py`` for the port: the
same arrays from the same capacities.  The routing-restricted solvers
(``repro_torch.core.routing``) need, per (s, t)
pair, the k shortest *simple* paths as a static-shape tensor they can jit
over.  This module produces that tensor host-side with one dense
tensorized dynamic program — the same (min,+) relaxation the APSP
backends run, lifted from the tropical semiring to its k-best extension:

1. **k-best walk lengths.**  ``D[u, t, 0:K']`` holds the K' shortest
   walk lengths u -> t using walks of at most ``max_hops`` hops.  The
   Bellman recurrence over the k-min semiring is exact on walk
   *multisets* — every walk decomposes uniquely as (first hop, shorter
   walk), so ``D' = kmin_v (w[u, v] + D[v, t, :])`` (plus the empty walk
   at u == t, level 0) converges in ``max_hops`` rounds.  One round is a
   dense ``[N, N, N·K']`` broadcast + partition — the k-best analogue of
   one (min,+) squaring step.
2. **Deviation tables.**  At the fixed point, a stable argsort of each
   (u, t) row's candidate multiset maps every level to its unique
   (next hop, sub-level) decomposition — the SP-DAG next-hop membership
   test ``dist[u, t] == w[u, v] + dist[v, t]`` at level 0, extended to k
   levels (Yen-style deviations ride the same table: level j deviates
   from level j-1 exactly where their (next hop, sub-level) choices
   split).
3. **Lock-step extraction.**  All ``N² × K'`` walks are materialised
   simultaneously, one hop per step, by fancy-indexed gathers into the
   deviation tables (``max_hops`` numpy steps total — no per-path Python
   loop).
4. **Simplicity filter.**  Walks with a repeated node are discarded and
   the first k *simple* walks per pair are kept, so every emitted path
   is simple, starts at s, ends at t, uses only real positive-capacity
   edges, and per-pair lengths are non-decreasing in k
   (``tests/test_torch_routing.py`` holds the arrays to the reference's,
   padded matrices included).  ``K' = 2k + 2`` walk levels are searched
   by default, so the result is exactly the k shortest simple paths
   unless more than k + 2 non-simple walks interleave them (rare on hop
   metrics, where any loop costs >= 2 extra hops); the set is always a
   valid (possibly conservative) k-shortest path set, which is all the
   lower-bound solvers require.

Everything here is host-side numpy: enumeration happens once per
instance at plan-pack time (like bucket padding), and only the padded
``[pairs, k, max_hops + 1]`` int32 tensor (and the edge lists built from
it) goes to the device.  Memory: steps 1-2 build ``[N, N, N·K']`` float32
candidates (K' = 18 at k = 8: 151 MB at N = 128) and an int64 argsort of
the same size, so the port enumerates paths at N <= 128.
"""
from __future__ import annotations

import numpy as np

__all__ = ["k_shortest_paths", "path_hops", "path_edge_counts", "_INF"]

_INF = 1.0e18   # non-edge sentinel, matches repro_torch.core.apsp._INF


def _hop_weights(cap: np.ndarray) -> np.ndarray:
    """Hop-metric weights: 1 on positive-capacity edges, _INF elsewhere
    (including the diagonal — an empty walk is not an edge)."""
    cap = np.asarray(cap)
    w = np.where(cap > 0, 1.0, _INF).astype(np.float32)
    np.fill_diagonal(w, _INF)
    return w


def _k_best_walks(w: np.ndarray, kp: int, max_hops: int) -> np.ndarray:
    """K'-best walk lengths ``D[u, t, 0:kp]`` over <= max_hops hops."""
    n = w.shape[0]
    d = np.full((n, n, kp), _INF, np.float32)
    idx = np.arange(n)
    d[idx, idx, 0] = 0.0
    for _ in range(max_hops):
        # cand[u, t, :] = kp smallest of {w[u, v] + D[v, t, j]}
        m = (w[:, :, None, None] + d[None, :, :, :])        # [u, v, t, j]
        m = m.transpose(0, 2, 1, 3).reshape(n, n, n * kp)   # [u, t, v*j]
        cand = np.partition(m, kp - 1, axis=-1)[:, :, :kp]
        cand.sort(axis=-1)
        new = cand
        # the empty walk at u == t occupies level 0 and shifts the rest
        diag = new[idx, idx, : kp - 1].copy()
        new[idx, idx, 1:] = diag
        new[idx, idx, 0] = 0.0
        if np.array_equal(new, d):
            break
        d = new
    return d


def _deviation_tables(w: np.ndarray,
                      d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per (u, t, level): the unique (next hop NH, sub-level SR)
    decomposition, from a stable argsort of the candidate multiset (ties
    split deterministically by (v, j) index — the same tie order at
    every level, so distinct levels always decompose into distinct
    walks)."""
    n, _, kp = d.shape
    m = (w[:, :, None, None] + d[None, :, :, :])
    m = m.transpose(0, 2, 1, 3).reshape(n, n, n * kp)
    order = np.argsort(m, axis=-1, kind="stable")[:, :, :kp]
    nh = (order // kp).astype(np.int32)
    sr = (order % kp).astype(np.int32)
    # u == t: level 0 is the empty walk; level j >= 1 is candidate j - 1
    idx = np.arange(n)
    nh_d = nh[idx, idx, : kp - 1].copy()
    sr_d = sr[idx, idx, : kp - 1].copy()
    nh[idx, idx, 1:] = nh_d
    sr[idx, idx, 1:] = sr_d
    nh[idx, idx, 0] = idx   # self; level 0 at u == t is never walked
    sr[idx, idx, 0] = 0
    return nh, sr


def k_shortest_paths(cap: np.ndarray, k: int,
                     max_hops: int, *, walk_levels: int | None = None
                     ) -> np.ndarray:
    """k-shortest simple path sets for every ordered pair of ``cap``.

    Returns int32 ``paths[N, N, k, max_hops + 1]``: ``paths[s, t, j]`` is
    the j-th shortest simple path's node sequence (hop metric, <=
    ``max_hops`` hops), padded with -1 past its end; fully -1 when fewer
    than j + 1 simple paths exist within the hop budget (s == t rows are
    always -1).  Per pair, emitted path lengths are non-decreasing in j
    and level 0 is a true shortest path whenever t is reachable from s
    within ``max_hops`` hops.

    ``walk_levels`` (default ``2k + 2``) is how many k-best *walk*
    levels are searched before the simplicity filter; raise it if a
    dense graph interleaves many looping walks among the short simple
    ones.
    """
    cap = np.asarray(cap)
    n = cap.shape[0]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_hops < 1:
        raise ValueError(f"max_hops must be >= 1, got {max_hops}")
    kp = walk_levels if walk_levels is not None else 2 * k + 2
    kp = max(kp, k)
    w = _hop_weights(cap)
    d = _k_best_walks(w, kp, max_hops)
    nh, sr = _deviation_tables(w, d)

    tgrid = np.broadcast_to(np.arange(n)[None, :, None], (n, n, kp)).copy()
    sgrid = np.broadcast_to(np.arange(n)[:, None, None], (n, n, kp)).copy()
    cur = sgrid.copy()
    lev = np.broadcast_to(np.arange(kp)[None, None, :], (n, n, kp)).copy()
    exists = (d[sgrid, tgrid, lev] < _INF / 2) & (sgrid != tgrid)
    walks = np.full((n, n, kp, max_hops + 1), -1, np.int32)
    walks[..., 0] = np.where(exists, sgrid, -1)
    done = ~exists
    for h in range(max_hops):
        done = done | ((cur == tgrid) & (lev == 0))
        step = ~done
        nxt = nh[cur, tgrid, lev]
        nlev = sr[cur, tgrid, lev]
        walks[..., h + 1] = np.where(step, nxt, walks[..., h + 1])
        cur = np.where(step, nxt, cur)
        lev = np.where(step, nlev, lev)
    finished = exists & (cur == tgrid) & (lev == 0)

    # simplicity: no node repeats among the walk's real entries (pad -1
    # entries are remapped to unique sentinels so they never collide)
    pad_ids = n + np.arange(max_hops + 1, dtype=np.int32)
    nodes = np.where(walks >= 0, walks, pad_ids)
    nodes = np.sort(nodes, axis=-1)
    simple = np.all(np.diff(nodes, axis=-1) != 0, axis=-1)
    ok = finished & simple

    # keep the first k valid walks per pair (stable: preserves the
    # non-decreasing length order), blank the rest
    keep = np.argsort(~ok, axis=-1, kind="stable")[:, :, :k]
    out = np.take_along_axis(walks, keep[..., None], axis=2)
    kept_ok = np.take_along_axis(ok, keep, axis=-1)
    return np.where(kept_ok[..., None], out, -1).astype(np.int32)


def path_hops(paths: np.ndarray) -> np.ndarray:
    """Hop count per path (entries - 1), -1 for absent (-1-padded) paths."""
    real = (np.asarray(paths) >= 0).sum(axis=-1)
    return np.where(real > 0, real - 1, -1)


def path_edge_counts(paths: np.ndarray, n: int) -> np.ndarray:
    """Directed edge-use counts ``[n, n]`` summed over every real hop of
    every path — the host-side twin of the solvers' scatter-add (used by
    the path-LP cross-check and tests)."""
    p = np.asarray(paths)
    a, b = p[..., :-1], p[..., 1:]
    m = (a >= 0) & (b >= 0)
    out = np.zeros((n, n), np.int64)
    np.add.at(out, (a[m], b[m]), 1)
    return out
