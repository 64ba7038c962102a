"""The plain reference: max-concurrent-flow bounds of the same instances,
worked out again in plain PyTorch (float64 by default) from the capacity and
demand arrays alone.

It follows the semantics the engines document, not their code:

* the dual (``get_engine("dual")``): Adam on log edge lengths z, l = exp(z),
  minimising log D(l) - log α(l) with D = Σ c·l and α = Σ dem·dist_l, a
  cosine learning rate from ``lr`` over ``iters`` steps (+1e-3), and the
  certified bound min over the iterates (and the final lengths) of D/α.  A
  lane stops when its best bound gained less than ``tol`` (relative) over
  a window of ``check_every`` steps;
* the subgradient of α is the demand routed on shortest paths, each pair's
  mass split evenly over its tight predecessors (ties within 1e-6
  relative), one hop back a sweep until it drains;
* the primal (``get_engine("certified")``): the same descent driving a
  Frank–Wolfe flow, blended with the shortest-path routing by a 24-round
  ternary search on the maximum utilisation (γ >= 1/(t+1), the first step
  adopts it whole); lb = 1 / max utilisation, and a lane stops when its
  bracket gap narrowed by less than ``tol`` over a window.

Distances come from Bellman–Ford rounds over every source at once (Jacobi,
until nothing changes) on predecessor tables; nothing here imports the
program.  ``dtype=torch.bfloat16`` gives the control: the same reference
computed one precision below the program's float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ITERS, LR, CHECK_EVERY = 800, 0.08, 25   # the engines' documented defaults
LS_ROUNDS = 24
TIE = 1e-6


def _tables(cap: torch.Tensor):
    """Incoming tables of the capacity pattern: idx[b, t, j] = the j-th
    predecessor k of t (k -> t has capacity), pads = t, and their mask."""
    bsz, n, _ = cap.shape
    eye = torch.eye(n, dtype=torch.bool, device=cap.device)
    edge = (cap > 0) & ~eye
    inc = edge.transpose(1, 2)                       # inc[b, t, k]
    d = max(1, int(inc.sum(-1).max()))
    # predecessors first (ascending), then pads
    key = torch.where(inc, torch.arange(n, device=cap.device), n)
    order = torch.sort(key, dim=-1).values[..., :d]
    valid = order < n
    rows = torch.arange(n, device=cap.device)[None, :, None]
    idx = torch.where(valid, order, rows)
    return edge, idx, valid


def _apsp(l: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor):
    """dist[b, s, t] over lengths l[b, k, t] on the tables' edges, and
    each table slot's length wgt[b, t, j] = l[b, idx[b, t, j], t]."""
    bsz, n, d = idx.shape
    wgt = torch.gather(l.transpose(1, 2), 2, idx)
    wgt = torch.where(valid, wgt, torch.inf)
    eye = torch.eye(n, dtype=torch.bool, device=l.device)
    dist = torch.where(eye, 0.0, torch.inf).to(l.dtype).expand(bsz, n, n)
    flat = idx.reshape(bsz, 1, n * d).expand(bsz, n, n * d)
    for _ in range(n):
        via = torch.gather(dist, 2, flat).view(bsz, n, n, d) + wgt[:, None]
        nxt = torch.minimum(dist, via.amin(-1))
        if torch.equal(nxt, dist):
            break
        dist = nxt
    return dist, wgt


def _routed(dist, wgt, idx, valid, mass):
    """Loads [b, k, t] of routing ``mass[b, s, t]`` (the demand of s -> t)
    back along the shortest-path DAG, split evenly over tight
    predecessors."""
    bsz, n, d = idx.shape
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    flat = idx.reshape(bsz, 1, n * d).expand(bsz, n, n * d)
    via = torch.gather(dist, 2, flat).view(bsz, n, n, d) + wgt[:, None]
    tol = TIE * torch.clamp(dist.abs(), min=TIE)
    tight = (via <= (dist + tol)[..., None]) & valid[:, None]
    share = tight.to(dist.dtype)
    share = share / torch.clamp(share.sum(-1, keepdim=True), min=1.0)
    u = torch.where(torch.isfinite(dist) & ~eye, mass, 0.0)
    loads = torch.zeros((bsz, n, d), dtype=dist.dtype, device=dist.device)
    for _ in range(n):
        if not bool((u != 0).any()):
            break
        moved = share * u[..., None]                   # [b, s, t, j]
        loads += moved.sum(1)
        nxt = torch.zeros_like(u)
        nxt.scatter_add_(2, flat, moved.reshape(bsz, n, n * d))
        u = torch.where(eye, 0.0, nxt)
    dense = torch.zeros((bsz, n, n), dtype=dist.dtype, device=dist.device)
    dense.scatter_add_(2, idx, torch.where(valid, loads, 0.0))
    return dense.transpose(1, 2)                       # [b, k, t]


def _line_search(u_cur: torch.Tensor, u_sp: torch.Tensor) -> torch.Tensor:
    lo = torch.zeros(u_cur.shape[0], dtype=u_cur.dtype, device=u_cur.device)
    hi = torch.ones_like(lo)
    for _ in range(LS_ROUNDS):
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        f1 = ((1 - m1)[:, None, None] * u_cur
              + m1[:, None, None] * u_sp).amax(dim=(1, 2))
        f2 = ((1 - m2)[:, None, None] * u_cur
              + m2[:, None, None] * u_sp).amax(dim=(1, 2))
        left = f1 < f2
        lo = torch.where(left, lo, m1)
        hi = torch.where(left, m2, hi)
    return (lo + hi) / 2


def solve(kind: str, caps, dems, *, tol: float, steps=None,
          iters: int = ITERS, lr: float = LR,
          check_every: int = CHECK_EVERY,
          dtype: torch.dtype = torch.float64,
          device: str | torch.device = "cuda") -> dict[str, np.ndarray]:
    """Bounds of a batch of instances of one size: ``kind="dual"`` gives
    ``ub`` and ``iterations`` (where the lane's own stopping rule stopped
    it); ``kind="primal"`` also ``lb``.  With ``steps`` (a step count a
    lane), each lane descends that many steps instead of following its own
    rule and reports the bounds it held then as ``ub_at`` (and ``lb_at``),
    the program's answer after the same number of steps, and
    ``stop_gain``: what the stopping rule read there, the relative gain of
    the best ub (dual) or the narrowing of the gap (primal) over the check
    window that ended at that step (NaN for a lane that ran every step)."""
    if kind not in ("dual", "primal"):
        raise ValueError(f"unknown reference kind {kind!r}")
    cap = torch.as_tensor(np.stack(caps), device=device).to(dtype)
    dem = torch.as_tensor(np.stack(dems), device=device).to(dtype)
    bsz, n, _ = cap.shape
    edge, idx, valid = _tables(cap)
    cap = torch.where(edge, cap, 0.0)
    safe_cap = torch.where(edge, cap, 1.0)
    z = torch.zeros_like(cap)
    m = torch.zeros_like(cap)
    v = torch.zeros_like(cap)
    flow = torch.zeros_like(cap)
    inf = torch.full((bsz,), math.inf, dtype=dtype, device=device)
    best, ref = inf.clone(), inf.clone()
    best_lb = torch.zeros_like(inf)
    dev = torch.device(device)
    want = np.full(bsz, -1) if steps is None else np.asarray(steps, int)
    # the step the lane's own rule stopped it at (not followed with steps)
    own = np.full(bsz, -1 if steps is None else 0)
    snap = {k: np.full(bsz, np.nan)
            for k in ("ub", "lb", "ub_at", "lb_at", "now", "prev")}
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)   # own rule
    if kind == "primal":
        ones = torch.where(edge, 1.0, 0.0).to(dtype)
        dist1, _ = _apsp(ones, idx, valid)
        routable = ~((dem > 0) & ~torch.isfinite(dist1)).any((1, 2))

    def window_end(t: int, value: torch.Tensor) -> None:
        """The stopping rule's reading at check ``t`` of the lanes that
        stop at ``t`` (and at the check before, ``check_every`` earlier)."""
        for tag, lanes in (("now", want == t),
                           ("prev", want - check_every == t)):
            if lanes.any():
                snap[tag][lanes] = value.double().cpu().numpy()[lanes]

    def take(lanes: np.ndarray, tag: str) -> None:
        if len(lanes):
            snap["ub" + tag][lanes] = best.double().cpu().numpy()[lanes]
            if kind == "primal":
                lbs = torch.where(routable, best_lb, 0.0)
                snap["lb" + tag][lanes] = lbs.double().cpu().numpy()[lanes]

    for i in range(iters + 1):
        # the lanes whose own rule stopped them after i steps (or that ran
        # out of steps); a lane descends while it has an answer to give
        newly = done.cpu().numpy() & (own < 0)
        own[newly] = i
        if i == iters:
            own[own < 0] = iters
        if kind == "primal":
            # a primal answer after i steps: what steps 0..i-1 held
            take(np.flatnonzero(own == i), "")
            take(np.flatnonzero(want == i), "_at")
        more = (own < 0) | (want > i)
        if kind == "primal" and not more.any():
            break
        t = i + 1
        l = torch.exp(z)
        dist, wgt = _apsp(l, idx, valid)
        fin = torch.isfinite(dist)
        alpha = (dem * torch.where(fin, dist, 0.0)).sum((1, 2))
        total = (cap * l).sum((1, 2))
        ratio = total / alpha
        if kind == "dual":
            # a dual answer after i steps: the best of iterates 0..i (the
            # last is the final lengths')
            need = torch.as_tensor(more | (own == i) | (want == i),
                                   device=dev)
            best = torch.where(need, torch.minimum(best, ratio), best)
            window_end(i + 1, best)
            take(np.flatnonzero(own == i), "")
            take(np.flatnonzero(want == i), "_at")
            if not more.any():
                break
        live = torch.as_tensor(more, device=dev)
        lv = live[:, None, None]
        loads = torch.where(edge, _routed(dist, wgt, idx, valid, dem), 0.0)
        g = l * (cap / total[:, None, None] - loads / alpha[:, None, None])
        g = torch.where(edge, g, 0.0)
        lr_t = lr * 0.5 * (1 + math.cos(math.pi * i / iters)) + 1e-3
        m = torch.where(lv, 0.9 * m + 0.1 * g, m)
        v = torch.where(lv, 0.999 * v + 0.001 * g * g, v)
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        z = torch.where(lv, z - lr_t * mh / (torch.sqrt(vh) + 1e-8), z)
        stopping = torch.as_tensor(own < 0, device=dev)
        if kind == "dual":
            if t % check_every == 0:
                gain = (ref - best) / torch.clamp(best, min=1e-30)
                done = done | (stopping & (gain < tol))
                ref = torch.where(stopping, best, ref)
            continue
        best = torch.where(live, torch.minimum(best, ratio), best)
        u_cur = torch.where(edge, flow / safe_cap, 0.0)
        u_sp = torch.where(edge, loads / safe_cap, 0.0)
        gamma = torch.clamp(_line_search(u_cur, u_sp), min=1.0 / (t + 1.0))
        if i == 0:
            gamma = torch.ones_like(gamma)
        gm = gamma[:, None, None]
        flow = torch.where(lv, (1 - gm) * flow + gm * loads, flow)
        umax = ((1 - gm) * u_cur + gm * u_sp).amax(dim=(1, 2))
        lb = torch.where(umax > 0, 1.0 / torch.clamp(umax, min=1e-30), 0.0)
        best_lb = torch.where(live, torch.maximum(best_lb, lb), best_lb)
        gap = (best - best_lb) / torch.clamp(best, min=1e-30)
        window_end(t, gap)
        if t % check_every == 0:
            done = done | (stopping & (ref - gap < tol))
            ref = torch.where(stopping, gap, ref)
    own = np.where(own < 0, iters, own)
    out = {"iterations": own, "ub": snap["ub"]}
    if kind == "primal":
        out["lb"] = snap["lb"]
    if steps is not None:
        out["ub_at"] = snap["ub_at"]
        if kind == "primal":
            out["lb_at"] = snap["lb_at"]
            gain = snap["prev"] - snap["now"]
        else:
            gain = (snap["prev"] - snap["now"]) / snap["now"]
        out["stop_gain"] = np.where(want < iters, gain, np.nan)
    return out
