"""Primal Frank–Wolfe max-concurrent-flow solver: certified LOWER bounds
(the port of ``repro.core.primal``).

The dual descent (``repro_torch.core.mcf``) certifies an upper bound on
θ*.  This module builds an explicit feasible flow and certifies a lower
bound, closing the bracket at any scale:

* **The linearised subproblem is shortest-path routing.**  Under edge
  lengths ``l`` the Frank–Wolfe oracle sends every demand along its
  l-shortest paths, and those loads are ``sp = dα/dl`` with ``α = Σ dem ·
  dist_l``: one ``torch.autograd.grad`` through ``repro_torch.core.apsp``,
  whose SP-DAG backward (ties split evenly) is the one the dual runs.  Each
  pair's share is a convex combination of its shortest paths, so ``sp``
  routes the FULL demand.
* **The lengths ride the dual descent.**  The iterate's lengths follow the
  dual's Adam-on-log-ratio trajectory, so one APSP forward and backward a
  step give both the dual step and the FW direction: every primal solve
  carries the dual upper bound (``throughput_ub``).
* **FW step with a line search.**  ``loads <- (1-γ) loads + γ sp``, with γ
  from a ternary search (``_LS_STEPS`` rounds) on the max utilisation,
  floored at ``1/(t+1)``.
* **The certificate.**  Every iterate is a convex combination of routings
  of the full demand, so ``loads / max_util`` is feasible at rate ``1 /
  max_util``.  An instance whose demand is not routable reports ``lb = 0``.

As in ``mcf``, the port keeps an explicit [B, N, N] batch and a host loop
where the reference vmaps a ``lax.while_loop``: a lane that meets the
early-stop test freezes every piece of its state (``torch.where`` on a
per-lane ``done`` mask), and the host reads ``done`` once per
``check_every`` window.  The line search runs per lane with ``γ``, ``lo``
and ``hi`` as [B] tensors and never reads the device.  Entry points take
``device`` (default ``"cuda"``).

**The same bits on every device.**  Near-tied shortest paths make the FW
trajectory chaotic: an ulp in the lengths can flip which of two tied paths
the SP-DAG loads, and the lower bound then lands ~1e-3 elsewhere.  So the
descent computes nothing whose bits depend on the device: every tensor op
is an exactly rounded elementwise op, a max, or a sum in an order fixed by
N (``apsp._sum_sources``, as the SP-DAG deposits are), ``exp`` and
``sqrt`` are taken in float64 and rounded (the CPU's float32 ``sqrt`` is
not correctly rounded; the card's is), the schedule's scalars (learning
rate, Adam's bias corrections) are computed on the host, and no tensor is
divided by a host scalar (on a CUDA tensor PyTorch multiplies by the
reciprocal instead).  A card and the CPU then run the same trajectory for
the same APSP backend.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import apsp as apsp_mod
from repro_torch.core.apsp import _INF, _sum_sources, normalize_backend
from repro_torch.core.graphs import Topology, as_cap
from repro_torch.core.mcf import (all_done, jit_cache_size,
                                  resolve_backend_density, run_program)
from repro_torch.device import resolve_device

__all__ = ["PrimalResult", "PrimalBatchResult", "solve_primal",
           "solve_primal_batch", "compile_cache_sizes"]

# the distinct program keys each entry point has run in this process
_PROGRAMS: dict[str, set] = {"solve": set(), "solve_batch": set()}


def compile_cache_sizes() -> dict[str, int]:
    """Programs per primal entry point: the distinct (shapes, dtypes,
    static kwargs) keys each has run in this process (as
    ``mcf.compile_cache_sizes``)."""
    return {k: jit_cache_size(v) for k, v in _PROGRAMS.items()}

_LS_STEPS = 24   # ternary-search rounds: (2/3)^24 ~ 6e-5 gamma resolution


@dataclasses.dataclass(frozen=True)
class PrimalResult:
    """One instance's primal solve: a certified LOWER bound on θ* and the
    driving dual descent's UPPER bound, a bracket ``throughput_lb`` ≤ θ* ≤
    ``throughput_ub``."""

    throughput_lb: float      # certified lower bound (explicit feasible flow)
    throughput_ub: float      # dual bound from the driving descent
    final_util: float         # max edge utilisation of the last averaged flow
    iterations: int           # descent steps actually executed (<= cap)

    @property
    def gap(self) -> float:
        """Relative bracket width (ub - lb) / ub."""
        return (self.throughput_ub - self.throughput_lb) / \
            max(self.throughput_ub, 1e-30)


@dataclasses.dataclass(frozen=True)
class PrimalBatchResult:
    """Per-instance outputs of one batched primal solve; indexing and
    iteration yield the lower bounds.  A ``block=False`` solve carries
    device tensors."""

    throughput_lb: np.ndarray   # [B] certified lower bound per instance
    throughput_ub: np.ndarray   # [B] dual bound of the driving descent
    final_util: np.ndarray      # [B] max utilisation at the last iterate
    iterations: np.ndarray      # [B] descent steps executed per instance

    def __len__(self) -> int:
        return len(self.throughput_lb)

    def __getitem__(self, i):
        return self.throughput_lb[i]

    def __iter__(self):
        return iter(self.throughput_lb)


def _f32(x: float) -> float:
    """A host scalar rounded to float32, so every device gets its bits."""
    return float(np.float32(x))


def _schedule(i: int, iters: int, lr: float) -> tuple[float, float, float]:
    """Step ``i``'s learning rate (cosine from ``lr``) and Adam's two bias
    corrections, computed on the host and rounded to float32."""
    t = i + 1
    return (_f32(lr * 0.5 * (1 + math.cos(math.pi * i / iters)) + 1e-3),
            _f32(1 - 0.9 ** t), _f32(1 - 0.999 ** t))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device."""
    return torch.sqrt(x.double()).float()


def _line_search(u_cur: torch.Tensor, u_sp: torch.Tensor) -> torch.Tensor:
    """Per lane, the γ in [0, 1] minimising max((1-γ) u_cur + γ u_sp) by
    ternary search (the max is convex and piecewise linear in γ).  Both
    probes of a round are one [2, B, N, N] blend."""
    lo = torch.zeros(u_cur.shape[0], dtype=torch.float32,
                     device=u_cur.device)
    hi = torch.ones_like(lo)
    three = torch.full((), 3.0, device=u_cur.device)   # a true division
    for _ in range(_LS_STEPS):
        m1 = lo + (hi - lo) / three
        m2 = hi - (hi - lo) / three
        g = torch.stack([m1, m2])[:, :, None, None]
        f1, f2 = ((1 - g) * u_cur + g * u_sp).amax(dim=(2, 3))
        left = f1 < f2
        lo = torch.where(left, lo, m1)
        hi = torch.where(left, m2, hi)
    return (lo + hi) / 2


def _primal_descend(caps, dems, n_valid, lr, tol, *, iters, check_every,
                    backend, d_max, max_rounds):
    """Masked FW + dual descent over a batch of (possibly padded)
    instances.  Returns (best lb, best ub, final max utilisation,
    iterations) per lane."""
    bsz, nmax, _ = caps.shape
    dev = caps.device
    node_mask = torch.arange(nmax, device=dev)[None, :] < n_valid[:, None]
    pair_mask = node_mask[:, :, None] & node_mask[:, None, :]
    cap = torch.where(pair_mask, caps, 0.0)
    dem = torch.where(pair_mask, dems, 0.0)
    edge_mask = (cap > 0) & pair_mask
    eye = torch.eye(nmax, dtype=torch.bool, device=dev)
    safe_cap = torch.where(edge_mask, cap, 1.0)

    def total(x):
        """Per-lane sum of [B, N, N] in an order fixed by N."""
        return _sum_sources(x.reshape(bsz, nmax * nmax))

    def alpha_of(l):
        w = torch.where(edge_mask, l, _INF)
        w = torch.where(eye, 0.0, w)
        dist = apsp_mod.apsp(w, backend, d_max, max_rounds)
        return total(dem * torch.where(pair_mask, dist, 0.0))

    def util(loads):
        return torch.where(edge_mask, loads / safe_cap, 0.0)

    f32 = dict(dtype=torch.float32, device=dev)
    with torch.no_grad():
        # a demanded pair with no path makes the flow unroutable: θ* = 0
        routable = alpha_of(torch.ones_like(cap)) < _INF / 2
    z = torch.zeros((bsz, nmax, nmax), **f32)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    loads = torch.zeros_like(z)
    best_lb = torch.zeros(bsz, **f32)
    best_ub = torch.full((bsz,), math.inf, **f32)
    ref_gap = torch.full((bsz,), math.inf, **f32)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    # the schedule as device scalars: a CUDA tensor divided by a host
    # scalar is multiplied by its reciprocal, which rounds otherwise
    sched = torch.tensor([_schedule(i, iters, lr) for i in range(iters)],
                         **f32)
    for i in range(iters):
        if i and i % check_every == 0 and all_done(done):
            break
        l = torch.exp(z.double()).float().requires_grad_(True)
        alpha = alpha_of(l)
        g_alpha, = torch.autograd.grad(alpha.sum(), l)
        with torch.no_grad():
            l = l.detach()
            alpha = alpha.detach()
            live = ~done
            lv = live[:, None, None]
            sp = torch.where(edge_mask, g_alpha, 0.0)   # FW direction
            d_val = total(cap * l)
            ub = torch.minimum(best_ub, d_val / alpha)
            # dual Adam step on log D(l) - log α(l); d/dz = l * d/dl
            an, dn = alpha[:, None, None], d_val[:, None, None]
            g = l * (cap / dn - sp / an)
            t = i + 1
            lr_t, bc1, bc2 = sched[i]
            m = torch.where(lv, 0.9 * m + 0.1 * g, m)
            v = torch.where(lv, 0.999 * v + 0.001 * g * g, v)
            mh = m / bc1
            vh = v / bc2
            z = torch.where(lv, z - lr_t * mh / (_sqrt(vh) + 1e-8), z)

            # FW blend with the line search on the max utilisation; the
            # first step adopts sp fully
            u_cur, u_sp = util(loads), util(sp)
            with obs.span("repro_torch.primal.line_search", profiler=True):
                gamma = _line_search(u_cur, u_sp)
            gamma = torch.clamp(gamma, min=1.0 / (t + 1.0))
            if i == 0:
                gamma = torch.ones_like(gamma)
            gm = gamma[:, None, None]
            loads = torch.where(lv, (1 - gm) * loads + gm * sp, loads)
            umax = ((1 - gm) * u_cur + gm * u_sp).amax(dim=(1, 2))
            lb = torch.where(umax > 0, torch.ones_like(umax)
                             / torch.clamp(umax, min=1e-30), 0.0)
            lb = torch.maximum(best_lb, lb)
            best_lb = torch.where(live, lb, best_lb)
            best_ub = torch.where(live, ub, best_ub)
            it = it + live.to(torch.int32)
            if t % check_every == 0:
                gap = (best_ub - best_lb) / torch.clamp(best_ub, min=1e-30)
                done = done | (live & (ref_gap - gap < tol))
                ref_gap = torch.where(live, gap, ref_gap)
    with torch.no_grad():
        best_lb = torch.where(routable, best_lb, 0.0)
        final_util = util(loads).amax(dim=(1, 2))
    return best_lb, best_ub, final_util, it


def _primal_batch(entry, caps, dems, *, n_valid, iters, lr, tol,
                  check_every, use_pallas, backend, d_max, mean_degree,
                  max_rounds, device):
    """Host half of a batched primal solve, run as ``entry``'s program."""
    dev = resolve_device(device)
    backend = normalize_backend(backend, use_pallas)
    if len(caps) != len(dems):
        raise ValueError(f"caps ({len(caps)}) and dems ({len(dems)}) "
                         "must have equal length")
    if len(caps) == 0:
        return None
    if not isinstance(caps, np.ndarray):
        caps = np.stack([as_cap(c) for c in caps])
    if not isinstance(dems, np.ndarray):
        dems = np.stack([np.asarray(d) for d in dems])
    if n_valid is None:
        n_valid = np.full(caps.shape[0], caps.shape[1], np.int32)
    backend, d_max = resolve_backend_density(
        backend, caps, n=caps.shape[1], d_max=d_max, mean_degree=mean_degree)
    args = (torch.as_tensor(caps, dtype=torch.float32, device=dev),
            torch.as_tensor(dems, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(n_valid), dtype=torch.int32,
                            device=dev), lr, tol)
    static_kw = dict(iters=iters, check_every=check_every, backend=backend,
                     d_max=d_max, max_rounds=max_rounds)
    return run_program(_PROGRAMS, entry, _primal_descend, args, static_kw)


def solve_primal_batch(caps, dems, *, n_valid=None, iters: int = 800,
                       lr: float = 0.08, tol: float = 0.0,
                       check_every: int = 25, use_pallas: bool = False,
                       backend: str | None = None, block: bool = True,
                       d_max: int | None = None,
                       mean_degree: float | None = None,
                       max_rounds: int | None = None,
                       device: str | torch.device = "cuda"
                       ) -> PrimalBatchResult:
    """Batched primal solve over stacked [R, N, N] topologies/demands (or
    sequences of equal size); the call surface is ``mcf.solve_dual_batch``'s,
    so primal lanes ride the same buckets and chunks.  ``tol > 0`` stops a
    lane once its bracket gap shrank by less than ``tol`` over a
    ``check_every``-step window."""
    out = _primal_batch("solve_batch", caps, dems, n_valid=n_valid,
                        iters=iters, lr=lr, tol=tol, check_every=check_every,
                        use_pallas=use_pallas, backend=backend, d_max=d_max,
                        mean_degree=mean_degree, max_rounds=max_rounds,
                        device=device)
    if out is None:
        z = np.zeros(0, np.float32)
        return PrimalBatchResult(z, z.copy(), z.copy(),
                                 np.zeros(0, np.int32))
    lb, ub, util, it = out
    if not block:
        return PrimalBatchResult(lb, ub, util, it)
    return PrimalBatchResult(lb.cpu().numpy(), ub.cpu().numpy(),
                             util.cpu().numpy(), it.cpu().numpy())


def solve_primal(cap: Topology | np.ndarray, dem: np.ndarray, *,
                 iters: int = 800, lr: float = 0.08, tol: float = 0.0,
                 check_every: int = 25, use_pallas: bool = False,
                 backend: str | None = None, d_max: int | None = None,
                 max_rounds: int | None = None,
                 device: str | torch.device = "cuda") -> PrimalResult:
    """Certified lower bound on max-concurrent-flow throughput of one
    instance from an explicit feasible flow, with the driving dual
    descent's upper bound (a batch of one; see ``solve_primal_batch``).
    ``cap``: a ``Topology`` or symmetric [N, N] capacity matrix; ``dem``:
    [N, N] demand, both in base line-speed units."""
    cap_host = np.asarray(as_cap(cap), np.float32)
    lb, ub, util, it = _primal_batch(
        "solve", cap_host[None], np.asarray(dem, np.float32)[None],
        n_valid=None, iters=iters, lr=lr, tol=tol, check_every=check_every,
        use_pallas=use_pallas, backend=backend, d_max=d_max,
        mean_degree=None, max_rounds=max_rounds, device=device)
    return PrimalResult(float(lb[0]), float(ub[0]), float(util[0]),
                        int(it[0]))
