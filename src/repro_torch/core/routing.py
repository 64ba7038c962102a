"""Routing-restricted throughput: ECMP and k-shortest-path lower bounds
(the port of ``repro.core.routing``).

Every other engine scores a topology by ideal max-concurrent flow.  Real
fabrics route over restricted path sets (Jellyfish, arXiv 1110.1687), and
this module scores that deployable throughput as two certified LOWER
bounds on θ*:

* **ECMP** (``solve_ecmp_batch``): every demand splits equally over its
  equal-cost next hops — the SP-DAG test ``dist[v, t] == 1 + dist[u, t]``
  on unit-hop APSP distances (exact small integers).  The split is a
  linear operator that strictly decreases distance-to-go, so iterating
  ``inflow = dem + split(inflow)`` reaches the exact ECMP loads, and
  ``1 / max_utilization`` is certified by that explicit routing.
* **KSP** (``solve_ksp_batch``): each pair is restricted to its k shortest
  simple paths (``repro_torch.kernels.paths``, a ``[pairs, k, max_hops +
  1]`` tensor enumerated on the host at pack time) and the split is
  optimised by multiplicative weights — softmax logits per (pair, path),
  Adam on a smoothed max utilisation (temperature-scaled logsumexp),
  cosine learning rate, ``check_every``/``tol`` early stop.  Every
  iterate's exact utilisation certifies ``1 / umax``; the bound is floored
  by the ECMP bound from the same masks.

Both run the dual descent (``mcf._descend``) beside them, so every result
carries the ideal upper bound and the lattice ``ecmp <= ksp(k) <=
theta_exact <= dual ub`` holds on every instance.

**How the port computes it.**  Where the reference vmaps over lanes, the
port keeps an explicit [B, N, N] batch and a host loop with per-lane
``done`` masks, as ``mcf`` does.  Every sum below is taken in an order
fixed by the data of its own lane (``_tree_sum``: zero-padding to a power
of two, then pairwise halving), never by an atomic or a reduction
kernel, so a lane's loads do not depend on its batch, its padding or the
device:

* The ECMP split is held in incoming-ELL form, not as the dense
  ``split[v, u, t]`` of the reference: ``share[u, j, t]`` is the share of
  the traffic to ``t`` that predecessor ``idx[u, j]`` sends to ``u``.  A
  hop gathers ``inflow`` at the predecessors and sums over ``j``.  At
  N = 512 and degree 16 that is 16 MiB a lane where the dense split is
  512 MiB, and a hop reads 1/32 of the bytes.  Its values equal the
  reference's einsum up to the order of a few additions (rtol 1e-5).
* The propagation is nilpotent: the inflow of nodes at distance-to-go L
  is final after ``diameter - L`` hops, so the iterate repeats bit for bit
  after ``diameter + 1`` hops.  The port stops there (one host read every
  ``_HOP_CHECK`` hops) instead of running all ``hops`` (default N); the
  result is the one all ``hops`` give, bit for bit.
* The KSP loads are the reference's scatter-add ``zeros(N²).at[eidx]
  .add(contrib)``.  At pack time each edge gets the list of the paths
  that cross it, in (pair, path, hop) order; a step gathers the paths'
  weights and sums each list by ``_tree_sum``.  The gradient is written
  out by hand (softmax, logsumexp, the loads' transpose is a gather), so
  the step launches no atomic either; ``exp`` and ``sqrt`` are taken in
  float64 and rounded, as in ``primal``.

Entry points take ``device`` (default ``"cuda"``) and raise without a card
unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import apsp as apsp_mod
from repro_torch.core import mcf
from repro_torch.core.apsp import _INF, normalize_backend
from repro_torch.core.graphs import Topology, as_cap
from repro_torch.core.mcf import resolve_backend_density
from repro_torch.core.primal import _schedule, _sqrt
from repro_torch.device import resolve_device
from repro_torch.kernels import paths as kpaths

__all__ = ["RoutingResult", "RoutingBatchResult", "solve_ecmp",
           "solve_ecmp_batch", "solve_ksp", "solve_ksp_batch",
           "path_lp_throughput", "DEFAULT_K", "DEFAULT_MAX_HOPS"]

DEFAULT_K = 8          # path-set width: Jellyfish's evaluation sweet spot
DEFAULT_MAX_HOPS = 12  # per-path hop budget for the static path tensor
_MW_BETA = 32.0        # logsumexp sharpness of the smoothed max-utilization
_HOP_CHECK = 4         # ECMP hops between host reads of the fixed-point test


@dataclasses.dataclass(frozen=True)
class RoutingResult:
    """One instance's routing-restricted solve: a certified LOWER bound
    on θ* under the routing restriction plus the ideal dual descent's
    UPPER bound, whose ratio is the certified price of the restriction."""

    throughput_lb: float      # certified routed lower bound
    throughput_ub: float      # ideal dual bound from the fused descent
    final_util: float         # max edge utilization of the final routing
    iterations: int           # MW steps (KSP) or descent steps (ECMP)

    @property
    def gap(self) -> float:
        """Relative ideal-vs-routed gap (ub - lb) / ub."""
        return (self.throughput_ub - self.throughput_lb) / \
            max(self.throughput_ub, 1e-30)


@dataclasses.dataclass(frozen=True)
class RoutingBatchResult:
    """Per-instance outputs of one batched routing solve.  Indexing and
    iteration yield the certified lower bounds; a ``block=False`` solve
    carries device tensors.  ``ecmp_hops`` is the number of ECMP hops
    run, the last of which repeated its input (the split's fixed point)
    unless the ``hops`` cap came first; the same for every lane of a
    batch."""

    throughput_lb: np.ndarray   # [B] certified routed lower bound
    throughput_ub: np.ndarray   # [B] ideal dual bound (free)
    final_util: np.ndarray      # [B] max utilization of the final routing
    iterations: np.ndarray      # [B] optimisation steps per instance
    ecmp_hops: np.ndarray       # [B] ECMP hops run (to the fixed point)

    def __len__(self) -> int:
        return len(self.throughput_lb)

    def __getitem__(self, i):
        return self.throughput_lb[i]

    def __iter__(self):
        return iter(self.throughput_lb)


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by pairwise halving after zero-padding it to a
    power of two.  Trailing zeros only ever add +0.0, so every output is
    the same whatever the padding past its last term: it depends neither
    on the batch, the padded width nor the device."""
    x = x.movedim(dim, 0)
    s = x.shape[0]
    p = 1 << max(0, (s - 1).bit_length())
    if p != s:
        x = torch.cat([x, x.new_zeros((p - s, *x.shape[1:]))])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def _lb_of(umax: torch.Tensor) -> torch.Tensor:
    return torch.where(umax > 0, torch.ones_like(umax)
                       / torch.clamp(umax, min=1e-30), 0.0)


def _masked(caps, dems, n_valid):
    """Padded nodes out of a [B, N, N] batch: (dem, edge_mask, safe_cap)."""
    nmax = caps.shape[-1]
    node = torch.arange(nmax, device=caps.device)[None, :] < n_valid[:, None]
    pair = node[:, :, None] & node[:, None, :]
    cap = torch.where(pair, caps, 0.0)
    dem = torch.where(pair, dems, 0.0)
    edge_mask = (cap > 0) & pair
    return dem, edge_mask, torch.where(edge_mask, cap, 1.0)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, u, j], :]`` for x [B, N, N] and idx [B, N, d]: the
    rows of x at every table slot, [B, N, d, N]."""
    bsz, n, d = idx.shape
    flat = idx.reshape(bsz, n * d, 1).expand(bsz, n * d, x.shape[-1])
    return torch.gather(x, 1, flat).view(bsz, n, d, x.shape[-1])


def _ecmp_split(edge_mask, dist):
    """The equal-split operator in incoming-ELL form: ``idx[b, u, j]`` is
    the j-th predecessor v of u (ascending, pads last pointing at u) and
    ``share[b, u, j, t]`` = split[v, u, t], the reference's ``1 / cnt[v,
    t]`` where u is one of v's ``cnt`` next hops toward t, else 0."""
    w = torch.where(edge_mask, 1.0, _INF)
    degs = torch.stack([edge_mask.sum(1).max(),
                        edge_mask.sum(2).max()]).tolist()
    d_in, d_out = max(1, int(degs[0])), max(1, int(degs[1]))
    idx, wgt = apsp_mod._pack_ell(w, d_in)                  # v -> u
    oidx, owgt = apsp_mod._pack_ell(w.transpose(1, 2), d_out)   # v -> its u
    idx, oidx = idx.long(), oidx.long()

    def next_hop(dist_v, dist_u, valid):
        return (valid[..., None] & (dist_v < _INF / 2)
                & ((dist_v - 1.0 - dist_u).abs() < 0.5))

    # cnt[v, t]: v's next hops toward t, over its outgoing row
    cnt = next_hop(dist[:, :, None, :], _rows(dist, oidx),
                   owgt < _INF / 2).sum(2)
    hop = next_hop(_rows(dist, idx), dist[:, :, None, :], wgt < _INF / 2)
    cnt_v = _rows(cnt, idx).clamp(min=1).to(torch.float32)
    share = torch.where(hop, torch.ones_like(cnt_v) / cnt_v, 0.0)
    return idx, share


def _ecmp_hop(inflow, dem, idx, share):
    """One application of the split: ``dem + Σ_j inflow[idx[u, j], t] ·
    share[u, j, t]``, summed over j by ``_tree_sum``."""
    return dem + _tree_sum(_rows(inflow, idx) * share, 2)


def _ecmp_fixed_point(dem, idx, share, hops):
    """Apply the split up to ``hops`` times from ``inflow = dem``, stopping
    at the first hop whose output equals its input on every lane (every
    later hop would return the same bits).  The host reads the test once
    every ``_HOP_CHECK`` hops.  Returns (inflow, hops run)."""
    inflow = dem
    moved = []
    for h in range(hops):
        new = _ecmp_hop(inflow, dem, idx, share)
        moved.append(torch.ne(new, inflow).any())
        inflow = new
        if len(moved) == _HOP_CHECK or h == hops - 1:
            flags = torch.stack(moved).tolist()
            if not all(flags):
                return inflow, h + 1 - len(flags) + flags.index(False) + 1
            moved = []
    return inflow, hops


def _ecmp_eval(dem, edge_mask, safe_cap, *, backend, d_max, max_rounds,
               hops):
    """Exact ECMP loads at the split's fixed point: per lane (lb, max
    utilisation), and the hops the propagation ran."""
    nmax = edge_mask.shape[-1]
    eye = torch.eye(nmax, dtype=torch.bool, device=dem.device)
    w = torch.where(edge_mask, 1.0, _INF)
    w = torch.where(eye, 0.0, w)
    dist = apsp_mod.apsp(w, backend, d_max, max_rounds)
    routable = ~((dem > 0) & (dist >= _INF / 2)).flatten(1).any(1)
    idx, share = _ecmp_split(edge_mask, dist)
    inflow, ran = _ecmp_fixed_point(dem, idx, share, hops)
    # loads on edge (idx[u, j] -> u): Σ_t inflow[v, t] · share[u, j, t];
    # each edge lands once, pads write 0 to the diagonal
    per_edge = _tree_sum(_rows(inflow, idx) * share, 3)
    loads_t = torch.zeros_like(dem).scatter_(2, idx, per_edge)
    loads = loads_t.transpose(1, 2)
    util = torch.where(edge_mask, loads / safe_cap, 0.0).amax(dim=(1, 2))
    lb = torch.where(routable & (util > 0), _lb_of(util), 0.0)
    return lb, util, ran


def _ideal_ub(caps, dems, n_valid, *, iters, lr, tol, check_every, backend,
              d_max, max_rounds):
    """The shared dual descent's upper bound, min(best, final ratio), and
    its steps."""
    ub, _, it, _ = mcf._descend(caps, dems, n_valid, iters=iters, lr=lr,
                                tol=tol, check_every=check_every,
                                backend=backend, d_max=d_max,
                                max_rounds=max_rounds)
    return ub, it


def _ecmp_batch(caps, dems, n_valid, *, hops, **kw):
    dem, edge_mask, safe_cap = _masked(caps, dems, n_valid)
    with torch.no_grad():
        lb, util, ran = _ecmp_eval(dem, edge_mask, safe_cap,
                                   backend=kw["backend"], d_max=kw["d_max"],
                                   max_rounds=kw["max_rounds"], hops=hops)
    ub, it = _ideal_ub(caps, dems, n_valid, **kw)
    return lb, ub, util, it, torch.full_like(it, ran)


# ---------------------------------------------------------------------------
# k shortest paths: the static path tensor and its edge lists (host, numpy)
# ---------------------------------------------------------------------------

def _paths_tensor(caps: np.ndarray, n_valid: np.ndarray, k: int,
                  max_hops: int) -> np.ndarray:
    """Host-side per-lane path enumeration, deduped across identical
    lanes (plan padding replicates instance 0 into surplus lanes, so
    those are free).  Capacity beyond each lane's ``n_valid`` is zeroed
    first, so no path ever visits a padded node."""
    caps = np.asarray(caps)
    r, nmax = caps.shape[0], caps.shape[1]
    node_ok = np.arange(nmax)[None, :] < np.asarray(n_valid)[:, None]
    masked = np.where(node_ok[:, :, None] & node_ok[:, None, :], caps, 0.0)
    out = np.empty((r, nmax * nmax, k, max_hops + 1), np.int32)
    cache: dict[bytes, np.ndarray] = {}
    for i in range(r):
        key = masked[i].tobytes()
        hit = cache.get(key)
        if hit is None:
            hit = kpaths.k_shortest_paths(masked[i], k, max_hops)
            hit = hit.reshape(nmax * nmax, k, max_hops + 1)
            cache[key] = hit
        out[i] = hit
    return out


@dataclasses.dataclass(frozen=True)
class _PathTables:
    """A batch's path tensor in the layouts one MW step reads.

    ``valid[b, p, k]``: path k of pair p exists.  ``hop_edge[b, p, k, h]``:
    the dense edge id ``a * N + b`` of its hop h, or N² (a zero slot) past
    its end.  ``edge_paths[b, r, m]``: the m-th path (``p * K + k``, or
    P·K, a zero slot) crossing edge ``edge_pos[b, r]`` (or N², a slot
    that is dropped), in (pair, path, hop) order, m padded to a power of
    two."""

    valid: torch.Tensor
    hop_edge: torch.Tensor
    edge_paths: torch.Tensor
    edge_pos: torch.Tensor


def _edge_lists(paths: np.ndarray, nmax: int):
    """One lane's edge lists from its ``[P, K, H + 1]`` path tensor:
    (hop_edge, the edges crossed, and for every (pair, path, hop) entry in
    edge-then-(pair, path, hop) order its row, its place in the row and its
    path ``p * K + k``)."""
    a = paths[:, :, :-1].astype(np.int64)
    b = paths[:, :, 1:].astype(np.int64)
    ok = (a >= 0) & (b >= 0)
    hop_edge = np.where(ok, a * nmax + b, nmax * nmax)
    flat = np.flatnonzero(ok)                  # (pair, path, hop) order
    order = np.argsort(hop_edge.reshape(-1)[flat], kind="stable")
    edges, start, count = np.unique(hop_edge.reshape(-1)[flat[order]],
                                    return_index=True, return_counts=True)
    row = np.repeat(np.arange(len(edges)), count)
    place = np.arange(len(order)) - np.repeat(start, count)
    return hop_edge, edges, row, place, flat[order] // a.shape[2]


def _path_tables(paths: np.ndarray, nmax: int, dev) -> _PathTables:
    bsz, p, k, _ = paths.shape
    cache: dict[bytes, tuple] = {}
    lanes = []
    for i in range(bsz):
        key = paths[i].tobytes()
        if key not in cache:
            cache[key] = _edge_lists(paths[i], nmax)
        lanes.append(cache[key])
    rows = max([1] + [len(ln[1]) for ln in lanes])
    width = max([1] + [int(ln[3].max()) + 1 for ln in lanes if len(ln[3])])
    width = 1 << (width - 1).bit_length()
    edge_paths = np.full((bsz, rows, width), p * k, np.int64)
    edge_pos = np.full((bsz, rows), nmax * nmax, np.int64)
    for i, (_, edges, row, place, src) in enumerate(lanes):
        edge_pos[i, :len(edges)] = edges
        edge_paths[i, row, place] = src
    hop_edge = np.stack([ln[0] for ln in lanes])

    def put(x):
        return torch.as_tensor(x, device=dev)

    return _PathTables(valid=put(paths[:, :, :, 0] >= 0),
                       hop_edge=put(hop_edge), edge_paths=put(edge_paths),
                       edge_pos=put(edge_pos))


def _softmax(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax with ``exp`` in float64, rounded, and its sum by
    ``_tree_sum``: the same bits on every device (all -inf gives 0)."""
    mx = z.amax(dim, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp((z - mx).double()).float()
    return e / torch.clamp(_tree_sum(e, dim), min=1.0).unsqueeze(dim)


def _path_weights(z, tables, demv):
    """Each path's flow ``[B, P, K]`` under logits ``z``: the pair's demand
    split by a softmax over its valid paths; also the split itself."""
    x = _softmax(torch.where(tables.valid, z, -1e9), 2)
    return torch.where(tables.valid, x, 0.0) * demv[:, :, None], x


def _edge_loads(wgt: torch.Tensor, tables: _PathTables) -> torch.Tensor:
    """Dense loads ``[B, N²]`` of path flows ``wgt [B, P, K]``: each edge
    sums the flows of the paths that cross it, in its list's order."""
    bsz = wgt.shape[0]
    flat = torch.cat([wgt.reshape(bsz, -1), wgt.new_zeros(bsz, 1)], 1)
    _, rows, width = tables.edge_paths.shape
    x = torch.gather(flat, 1, tables.edge_paths.view(bsz, rows * width))
    per_edge = _tree_sum(x.view(bsz, rows, width), 2)
    n2 = tables.hop_edge.shape[1]
    out = wgt.new_zeros(bsz, n2 + 1).scatter_(1, tables.edge_pos, per_edge)
    return out[:, :n2]


def _ksp_step(z, tables, demv, emask, scap):
    """(max utilisation, d smoothed-max / d z) per lane at logits ``z``.

    The reference differentiates ``s/β · logsumexp(u · β/s)`` (s = the
    current max, held constant) with jax; the gradient is written out:
    d/du is the softmax of ``u · β/s`` over the edges, the loads'
    transpose gathers it along each path's hops, and the path softmax's
    Jacobian maps it to the logits."""
    bsz = z.shape[0]
    wgt, x = _path_weights(z, tables, demv)
    u = torch.where(emask, _edge_loads(wgt, tables) / scap, 0.0)
    umax = u.amax(1)
    s = torch.clamp(umax, min=1e-30)
    a = torch.where(emask, u * (torch.full_like(s, _MW_BETA) / s)[:, None],
                    -math.inf)
    gu = torch.where(emask, _softmax(a, 1), 0.0)
    gl = torch.cat([gu / scap, gu.new_zeros(bsz, 1)], 1)
    gw = _tree_sum(torch.gather(gl, 1, tables.hop_edge.view(bsz, -1))
                   .view(tables.hop_edge.shape), 3)
    gx = torch.where(tables.valid, gw * demv[:, :, None], 0.0)
    gz = x * (gx - _tree_sum(x * gx, 2)[:, :, None])
    return umax, torch.where(tables.valid, gz, 0.0)


def _mw_descend(tables, demv, emask, scap, *, iters, lr, tol, check_every):
    """Multiplicative weights over the path set, Adam with the cosine
    learning rate: per lane (best certified lb, final umax, steps)."""
    bsz = demv.shape[0]
    dev = demv.device
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.zeros(tables.valid.shape, **f32)   # uniform split at step 0
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    best = torch.zeros(bsz, **f32)
    ref_best = torch.zeros(bsz, **f32)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    sched = torch.tensor([_schedule(i, iters, lr) for i in range(iters)],
                         **f32)
    for i in range(iters):
        if i and i % check_every == 0 and bool(done.all()):
            break
        umax, g = _ksp_step(z, tables, demv, emask, scap)
        live = ~done
        lv = live[:, None, None]
        best = torch.where(live, torch.maximum(best, _lb_of(umax)), best)
        lr_t, bc1, bc2 = sched[i]
        m = torch.where(lv, 0.9 * m + 0.1 * g, m)
        v = torch.where(lv, 0.999 * v + 0.001 * g * g, v)
        z = torch.where(lv, z - lr_t * (m / bc1) / (_sqrt(v / bc2) + 1e-8),
                        z)
        it = it + live.to(torch.int32)
        t = i + 1
        if t % check_every == 0:
            rel_gain = (best - ref_best) / torch.clamp(best, min=1e-30)
            done = done | (live & (rel_gain < tol))
            ref_best = torch.where(live, best, ref_best)
    wgt, _ = _path_weights(z, tables, demv)
    final = torch.where(emask, _edge_loads(wgt, tables) / scap,
                        0.0).amax(1)
    return torch.maximum(best, _lb_of(final)), final, it


def _ksp_batch(caps, dems, n_valid, paths, *, hops, **kw):
    """The ECMP program (its bound is KSP's floor), then MW over the
    lanes' path tables."""
    ecmp_lb, ub, _, _, ran = _ecmp_batch(caps, dems, n_valid, hops=hops,
                                         **kw)
    bsz, nmax, _ = caps.shape
    dem, edge_mask, safe_cap = _masked(caps, dems, n_valid)
    with torch.no_grad():
        tables = _path_tables(paths, nmax, caps.device)
        demv = dem.reshape(bsz, -1)
        routable = ~((demv > 0) & ~tables.valid.any(2)).any(1)
        best, final, it = _mw_descend(
            tables, demv, edge_mask.reshape(bsz, -1),
            safe_cap.reshape(bsz, -1), iters=kw["iters"], lr=kw["lr"],
            tol=kw["tol"], check_every=kw["check_every"])
        lb = torch.maximum(torch.where(routable, best, 0.0), ecmp_lb)
    return lb, ub, final, it, ran


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _resolve_hops(nmax: int, hops: int | None) -> int:
    # the cap on ECMP propagation; nmax always covers the diameter, and
    # depending only on the padded width keeps a bucket's chunks and refill
    # rounds on the same settings
    return int(hops) if hops is not None else int(nmax)


def _resolve_max_hops(nmax: int, max_hops: int | None) -> int:
    return int(max_hops) if max_hops is not None \
        else min(int(nmax) - 1, DEFAULT_MAX_HOPS)


def _prep_batch(caps, dems, n_valid, backend, use_pallas, d_max,
                mean_degree):
    if not isinstance(caps, np.ndarray):
        caps = np.stack([as_cap(c) for c in caps])
    if not isinstance(dems, np.ndarray):
        dems = np.stack([np.asarray(d) for d in dems])
    if n_valid is None:
        n_valid = np.full(caps.shape[0], caps.shape[1], np.int32)
    backend, d_max = resolve_backend_density(
        normalize_backend(backend, use_pallas), caps, n=caps.shape[1],
        d_max=d_max, mean_degree=mean_degree)
    return caps, dems, np.asarray(n_valid, np.int32), backend, d_max


def _empty_batch() -> RoutingBatchResult:
    z = np.zeros(0, np.float32)
    i = np.zeros(0, np.int32)
    return RoutingBatchResult(z, z.copy(), z.copy(), i, i.copy())


def _run(solver, caps, dems, n_valid, *, device, block, hops, use_pallas,
         backend, d_max, mean_degree, extra=None, **kw):
    dev = resolve_device(device)
    if len(caps) != len(dems):
        raise ValueError(f"caps ({len(caps)}) and dems ({len(dems)}) "
                         "must have equal length")
    if len(caps) == 0:
        return _empty_batch()
    caps, dems, n_valid, backend, d_max = _prep_batch(
        caps, dems, n_valid, backend, use_pallas, d_max, mean_degree)
    args = [torch.as_tensor(caps, dtype=torch.float32, device=dev),
            torch.as_tensor(dems, dtype=torch.float32, device=dev),
            torch.as_tensor(n_valid, dtype=torch.int32, device=dev)]
    if extra is not None:
        args.append(extra(caps, n_valid))
    out = solver(*args, hops=_resolve_hops(caps.shape[1], hops),
                 backend=backend, d_max=d_max, **kw)
    if not block:
        return RoutingBatchResult(*out)
    return RoutingBatchResult(*(x.cpu().numpy() for x in out))


def solve_ecmp_batch(caps, dems, *, n_valid=None, iters: int = 800,
                     lr: float = 0.08, tol: float = 0.0,
                     check_every: int = 25, use_pallas: bool = False,
                     backend: str | None = None, block: bool = True,
                     d_max: int | None = None,
                     mean_degree: float | None = None,
                     max_rounds: int | None = None,
                     hops: int | None = None,
                     device: str | torch.device = "cuda"
                     ) -> RoutingBatchResult:
    """Batched ECMP solve over stacked [R, N, N] topologies/demands; the
    call surface mirrors ``mcf.solve_dual_batch`` (``n_valid`` padding
    masks, ``block=False`` for ``BatchPlan``).  ``hops`` caps the
    propagation depth (default N, always enough); the descent knobs only
    steer the free upper bound."""
    return _run(_ecmp_batch, caps, dems, n_valid, device=device,
                block=block, hops=hops, use_pallas=use_pallas,
                backend=backend, d_max=d_max, mean_degree=mean_degree,
                iters=iters, lr=lr, tol=tol, check_every=check_every,
                max_rounds=max_rounds)


def solve_ksp_batch(caps, dems, *, n_valid=None, k: int = DEFAULT_K,
                    max_hops: int | None = None, iters: int = 800,
                    lr: float = 0.08, tol: float = 0.0,
                    check_every: int = 25, use_pallas: bool = False,
                    backend: str | None = None, block: bool = True,
                    d_max: int | None = None,
                    mean_degree: float | None = None,
                    max_rounds: int | None = None,
                    hops: int | None = None,
                    device: str | torch.device = "cuda"
                    ) -> RoutingBatchResult:
    """Batched KSP solve; surface = ``solve_ecmp_batch`` plus ``k`` (paths
    per pair) and ``max_hops`` (per-path hop budget, default min(N - 1,
    DEFAULT_MAX_HOPS), resolved from the padded width).  Path tensors are
    enumerated on the host per lane (deduped across identical lanes)."""
    def paths_of(caps_np, n_valid_np):
        return _paths_tensor(caps_np, n_valid_np, k,
                             _resolve_max_hops(caps_np.shape[1], max_hops))

    return _run(_ksp_batch, caps, dems, n_valid, device=device,
                block=block, hops=hops, use_pallas=use_pallas,
                backend=backend, d_max=d_max, mean_degree=mean_degree,
                extra=paths_of, iters=iters, lr=lr, tol=tol,
                check_every=check_every, max_rounds=max_rounds)


def _single(batch_fn, cap, dem, **kw) -> RoutingResult:
    cap_host = np.asarray(as_cap(cap), np.float32)
    r = batch_fn(cap_host[None], np.asarray(dem, np.float32)[None], **kw)
    return RoutingResult(float(r.throughput_lb[0]), float(r.throughput_ub[0]),
                         float(r.final_util[0]), int(r.iterations[0]))


def solve_ecmp(cap: Topology | np.ndarray, dem: np.ndarray, **kw
               ) -> RoutingResult:
    """Certified ECMP lower bound for one instance, with the ideal dual
    upper bound (a batch of one; knobs as ``solve_ecmp_batch``)."""
    return _single(solve_ecmp_batch, cap, dem, **kw)


def solve_ksp(cap: Topology | np.ndarray, dem: np.ndarray, **kw
              ) -> RoutingResult:
    """Certified k-shortest-path lower bound for one instance: MW over the
    k-path set, floored by ECMP, with the ideal dual upper bound (a batch
    of one; knobs as ``solve_ksp_batch``)."""
    return _single(solve_ksp_batch, cap, dem, **kw)


def path_lp_throughput(cap: Topology | np.ndarray, dem: np.ndarray,
                       paths: np.ndarray) -> float:
    """Exact path-restricted max concurrent flow via scipy ``linprog``
    (HiGHS) — the small-instance cross-check for the MW solver.

    Variables are θ plus one flow per (demanded pair, valid path);
    conservation ties each pair's path flows to θ·dem, and every
    directed edge's summed load is capped.  ``paths`` is a
    ``[N, N, k, H + 1]`` or ``[N², k, H + 1]`` tensor from
    ``repro_torch.kernels.paths``.  Returns 0.0 when any demanded pair has
    no path in the set (the restriction makes the demand unroutable).
    """
    from scipy.optimize import linprog

    cap = as_cap(cap)
    n = cap.shape[0]
    p = np.asarray(paths).reshape(n * n, *np.asarray(paths).shape[-2:])
    demv = np.asarray(dem, np.float64).reshape(-1)
    valid = p[:, :, 0] >= 0
    pairs = np.nonzero(demv > 0)[0]
    if len(pairs) == 0:
        return 0.0
    if not valid[pairs].any(axis=1).all():
        return 0.0
    ei, ej = np.nonzero(cap > 0)
    e_of = {(int(a), int(b)): r for r, (a, b) in enumerate(zip(ei, ej))}
    cols = [(pi, ki) for pi in pairs for ki in np.nonzero(valid[pi])[0]]
    nv = 1 + len(cols)
    a_ub = np.zeros((len(ei), nv))
    for c, (pi, ki) in enumerate(cols):
        seq = p[pi, ki]
        seq = seq[seq >= 0]
        for x, y in zip(seq[:-1], seq[1:]):
            a_ub[e_of[(int(x), int(y))], 1 + c] += 1.0
    a_eq = np.zeros((len(pairs), nv))
    for r, pi in enumerate(pairs):
        a_eq[r, 0] = -demv[pi]
        for c, (pj_, _) in enumerate(cols):
            if pj_ == pi:
                a_eq[r, 1 + c] = 1.0
    c_vec = np.zeros(nv)
    c_vec[0] = -1.0
    res = linprog(c_vec, A_ub=a_ub, b_ub=cap[ei, ej],
                  A_eq=a_eq, b_eq=np.zeros(len(pairs)),
                  bounds=[(0, None)] * nv, method="highs")
    if not res.success:
        raise RuntimeError(f"path LP failed: {res.message}")
    return float(res.x[0])
