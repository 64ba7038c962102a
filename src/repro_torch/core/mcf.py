"""Maximum concurrent flow by dual descent (the port of ``repro.core.mcf``).

LP duality for max concurrent flow: with edge lengths l >= 0,

    theta* = min_l  sum_e c_e l_e  /  sum_{(s,t)} dem(s,t) * dist_l(s, t)

Every iterate certifies an UPPER bound on theta*.  The log-ratio is
minimised with Adam (cosine learning rate) in log-length space; dist_l is
``repro_torch.core.apsp.apsp``, whose shared SP-DAG adjoint gives the
subgradient on every backend.

Where the reference vmaps a ``lax.while_loop`` over lanes, the port keeps
an explicit [B, N, N] batch and a host loop.  A lane that meets the
early-stop test freezes its state (``torch.where`` on a per-lane ``done``
mask) while the others go on, and the host reads ``done`` once per
``check_every`` window.  Adam and the learning rate run in float32, as in
the reference.  The ratio's two sums over the [N, N] pairs run together,
stacked, by pairwise halving in an order fixed by N
(``apsp._sum_sources``), as the SP-DAG deposits do: a lane's bits then do
not depend on its batch, so chunks and shards of a plan give every lane
the same bits on the card too (a CUDA reduction's order depends on the
number of lanes).  Mixed sizes are padded
up to a common size with per-lane ``n_valid``: padded nodes carry zero
capacity and demand and ``_INF`` edges, so they add nothing to the ratio
or its gradient.

``solve_dual_demgrad_batch`` is the same descent that also returns each
lane's Danskin demand gradient at the final lengths l*: the final ratio's
forward already holds dist_l*, so the gradient ``−dist_l*(s, t) / α`` on
valid pairs costs no APSP beyond it and no backward.

Entry points take ``device`` (default ``"cuda"``); without a card they
raise unless the caller asks for ``"cpu"``.  ``compile_cache_sizes``
counts the programs each entry point has run (see there).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import apsp as apsp_mod
from repro_torch.core.apsp import _INF, _sum_sources, normalize_backend
from repro_torch.core.graphs import (Topology, as_cap, connected_components,
                                     degree_stats)
from repro_torch.device import resolve_device

__all__ = ["DualResult", "DualBatchResult", "DualDemgradBatchResult",
           "solve_dual", "solve_dual_batch", "solve_dual_demgrad_batch",
           "aspl", "drop_disconnected", "jit_cache_size",
           "compile_cache_sizes", "resolve_backend_density",
           "resolve_device", "_INF"]

# the distinct program keys each entry point has run in this process
_PROGRAMS: dict[str, set] = {"solve": set(), "solve_batch": set(),
                             "solve_demgrad_batch": set()}


def _abstract(x: Any) -> tuple:
    """(shape, dtype) of one argument, as jax abstracts it: a Python float
    is a float32 scalar, an int an int32 one."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    if isinstance(x, (np.ndarray, np.generic)):
        return tuple(x.shape), str(x.dtype)
    if isinstance(x, int):
        return (), "int32"
    if isinstance(x, float):
        return (), "float32"
    raise TypeError(f"cannot key an argument of type {type(x).__name__}")


def program_key(args: Sequence[Any], static_kw: Mapping[str, Any]) -> tuple:
    """A program's identity: each argument's (shape, dtype) and the repr of
    each static kwarg — what a compiling runtime keys its programs by."""
    return (tuple(_abstract(a) for a in args),
            tuple(sorted((k, repr(v)) for k, v in static_kw.items())))


def run_program(programs: dict[str, set], entry: str, fn, args: tuple,
                static_kw: dict):
    """Run ``fn(*args, **static_kw)`` as ``entry``'s program, noting its
    ``program_key`` in ``programs[entry]``."""
    programs[entry].add(program_key(args, static_kw))
    return fn(*args, **static_kw)


def jit_cache_size(*programs: set) -> int:
    """Total program count of the given entry points' key sets (the
    reference sums its jitted callables' caches).  Never None: the port
    always knows what it ran."""
    return sum(len(p) for p in programs)


def compile_cache_sizes() -> dict[str, int]:
    """Programs per dual entry point.  The port compiles no program per
    shape (its kernels are one library, built once by ``kernels._build``),
    so each entry point counts the distinct (shapes, dtypes, static
    kwargs) keys it has run in this process: the programs a compiling
    runtime would hold (``program_key``).  Benchmarks report deltas of
    this to show "one program per bucket"."""
    return {k: jit_cache_size(v) for k, v in _PROGRAMS.items()}


@dataclasses.dataclass(frozen=True)
class DualResult:
    """One instance's dual solve: a certified UPPER bound on θ*."""

    throughput_ub: float      # best certified dual bound on theta*
    final_ratio: float        # ratio at the last iterate (convergence probe)
    iterations: int           # descent steps actually executed (<= cap)


@dataclasses.dataclass(frozen=True)
class DualBatchResult:
    """Per-instance outputs of one batched solve; indexing and iteration
    yield the bounds.  A ``block=False`` solve carries device tensors."""

    throughput_ub: np.ndarray   # [B] best certified dual bound per instance
    final_ratio: np.ndarray     # [B] ratio at each instance's last iterate
    iterations: np.ndarray      # [B] descent steps executed per instance

    def __len__(self) -> int:
        return len(self.throughput_ub)

    def __getitem__(self, i):
        return self.throughput_ub[i]

    def __iter__(self):
        return iter(self.throughput_ub)


@dataclasses.dataclass(frozen=True)
class DualDemgradBatchResult:
    """A batched dual solve with the demand gradient of each lane's
    converged bound: ``dem_grad[b]`` is d(log D(l*) − log α(l*))/d dem at
    the final lengths l*, ``−dist_l*(s, t) / α`` on valid pairs and 0 on
    padded ones — a Danskin supergradient of log θ*(dem)."""

    throughput_ub: np.ndarray   # [B] best certified dual bound per instance
    final_ratio: np.ndarray     # [B] ratio at each instance's last iterate
    iterations: np.ndarray      # [B] descent steps executed per instance
    dem_grad: np.ndarray        # [B, N, N] d loss / d dem at the final l*

    def __len__(self) -> int:
        return len(self.throughput_ub)


def resolve_backend_density(backend: str, caps, *, n: int,
                            d_max: int | None = None,
                            mean_degree: float | None = None,
                            ) -> tuple[str, int | None]:
    """Host-side density resolution: ``(backend, d_max)`` where ``d_max``
    is None unless the backend resolves to ``"ell-bf"``.  Dense outcomes
    pass ``backend`` through unchanged; ``caps`` is scanned only when the
    caller did not supply the stats."""
    if backend not in ("auto", "ell-bf"):
        return backend, None
    if d_max is None or (backend == "auto" and mean_degree is None):
        stats_d_max, stats_mean = degree_stats(np.asarray(caps))
        if d_max is None:
            d_max = stats_d_max
        if mean_degree is None:
            mean_degree = stats_mean
    resolved = apsp_mod.resolve_backend(backend, n, mean_degree=mean_degree)
    if resolved != "ell-bf":
        return backend, None
    return "ell-bf", max(1, int(d_max))


def aspl(cap: Topology | np.ndarray, dem: np.ndarray | None = None,
         use_pallas: bool = False, on_disconnected: str = "raise", *,
         backend: str | None = None,
         device: str | torch.device = "cuda") -> float:
    """Average shortest-path length in hops (demand-weighted if ``dem`` is
    given); disconnected pairs are excluded.  ``on_disconnected``:
    ``"raise"`` on a demanded disconnected pair, or ``"drop"`` its demand
    (0.0 if nothing routable is left)."""
    if on_disconnected not in ("raise", "drop"):
        raise ValueError(f"on_disconnected must be 'raise' or 'drop', got "
                         f"{on_disconnected!r}")
    dev = resolve_device(device)
    cap_host = np.asarray(as_cap(cap))
    n = cap_host.shape[0]
    bk, d_max = resolve_backend_density(
        normalize_backend(backend, use_pallas), cap_host, n=n)
    capt = torch.as_tensor(cap_host, dtype=torch.float32, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    w = torch.where(capt > 0, 1.0, _INF)
    w = torch.where(eye, 0.0, w)
    d = apsp_mod.apsp(w, bk, d_max)
    reachable = d < _INF / 2
    if dem is None:
        mask = ~eye & reachable
        return float(torch.where(mask, d, 0.0).sum() / mask.sum())
    demt = torch.as_tensor(np.asarray(dem), dtype=torch.float32, device=dev)
    bad = int(((demt > 0) & ~reachable).sum())
    if bad:
        if on_disconnected == "raise":
            raise ValueError(
                f"{bad} demanded (s, t) pair(s) are disconnected; "
                "demand-weighted ASPL is undefined on this topology "
                "(pass on_disconnected='drop' to average over the "
                "routable demand only)")
        demt = torch.where(reachable, demt, 0.0)
        if float(demt.sum()) == 0.0:
            return 0.0
    d = torch.where(reachable, d, 0.0)
    return float((d * demt).sum() / demt.sum())


def drop_disconnected(cap: Topology | np.ndarray,
                      dem: np.ndarray) -> tuple[np.ndarray, float]:
    """Zero the demand of every (s, t) pair with no path in ``cap``;
    returns ``(kept_dem, dropped_fraction)`` (host-side components)."""
    labels = connected_components(cap)
    dem = np.asarray(dem, np.float64)
    total = float(dem.sum())
    if total == 0.0:
        return dem.copy(), 0.0
    keep = labels[:, None] == labels[None, :]
    kept = np.where(keep, dem, 0.0)
    return kept, float((total - kept.sum()) / total)


def _dual_ratio(z, cap, dem, edge_mask, pair_mask, eye, backend, d_max,
                max_rounds):
    """Per lane: (log-ratio loss, certified bound D(l)/alpha(l), the
    distances on valid pairs (0 elsewhere), alpha)."""
    l = torch.exp(z)
    w = torch.where(edge_mask, l, _INF)
    w = torch.where(eye, 0.0, w)
    dist = apsp_mod.apsp(w, backend, d_max, max_rounds)
    pair_dist = torch.where(pair_mask, dist, 0.0)
    bsz, n, _ = l.shape
    # both sums in one halving: [B, N*N, 2] -> [B, 2]
    alpha, d_val = _sum_sources(torch.stack(
        [dem * pair_dist, cap * l * edge_mask], -1).reshape(
            bsz, n * n, 2)).unbind(-1)
    return (torch.log(d_val) - torch.log(alpha), d_val / alpha, pair_dist,
            alpha)


def all_done(done: torch.Tensor) -> bool:
    """A descent's host read a check window: has every lane stopped."""
    with obs.span("repro_torch.descent.check"):
        return bool(done.all())


def _descend(caps, dems, n_valid, lr, tol, *, iters, check_every, backend,
             d_max, max_rounds, demgrad=False):
    """Masked Adam descent over a batch of (possibly padded) instances.
    Returns (best bound, final ratio, iterations, demand gradient) per
    lane; the gradient is None unless ``demgrad``."""
    bsz, nmax, _ = caps.shape
    dev = caps.device
    node_mask = torch.arange(nmax, device=dev)[None, :] < n_valid[:, None]
    pair_mask = node_mask[:, :, None] & node_mask[:, None, :]
    cap = torch.where(pair_mask, caps, 0.0)
    dem = torch.where(pair_mask, dems, 0.0)
    edge_mask = (cap > 0) & pair_mask
    eye = torch.eye(nmax, dtype=torch.bool, device=dev)

    def ratio_of(z):
        return _dual_ratio(z, cap, dem, edge_mask, pair_mask, eye, backend,
                           d_max, max_rounds)

    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.zeros((bsz, nmax, nmax), **f32)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    best = torch.full((bsz,), math.inf, **f32)
    ref_best = torch.full((bsz,), math.inf, **f32)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    b1, b2 = torch.tensor(0.9, **f32), torch.tensor(0.999, **f32)
    for i in range(iters):
        if i and i % check_every == 0 and all_done(done):
            break
        zg = z.detach().requires_grad_(True)
        loss, ratio, _, _ = ratio_of(zg)
        g, = torch.autograd.grad(loss.sum(), zg)
        with torch.no_grad():
            live = ~done
            lv = live[:, None, None]
            best = torch.where(live, torch.minimum(best, ratio), best)
            # Adam with cosine-decayed lr, all in float32
            t = i + 1
            step = torch.tensor(i, **f32)
            lr_t = lr * 0.5 * (1 + torch.cos(math.pi * step / iters)) + 1e-3
            m = torch.where(lv, 0.9 * m + 0.1 * g, m)
            v = torch.where(lv, 0.999 * v + 0.001 * g * g, v)
            mh = m / (1 - b1 ** t)
            vh = v / (1 - b2 ** t)
            z = torch.where(lv, z - lr_t * mh / (torch.sqrt(vh) + 1e-8), z)
            it = it + live.to(torch.int32)
            if t % check_every == 0:
                rel_gain = (ref_best - best) / torch.clamp(best, min=1e-30)
                done = done | (live & (rel_gain < tol))
                ref_best = torch.where(live, best, ref_best)
    with torch.no_grad():
        _, final, pair_dist, alpha = ratio_of(z)
        # d(log D - log alpha)/d dem: D does not depend on the demand
        dem_grad = -pair_dist / alpha[:, None, None] if demgrad else None
    return torch.minimum(best, final), final, it, dem_grad


def _descend_batch(caps, dems, *, n_valid, iters, lr, tol, check_every,
                   use_pallas, backend, d_max, mean_degree, max_rounds,
                   device, demgrad, entry):
    """Host half of a batched solve: stack, resolve the backend and its
    table stats, and run ``_descend`` on ``device`` as ``entry``'s program;
    None when empty."""
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
    return run_program(_PROGRAMS, entry,
                       functools.partial(_descend, demgrad=demgrad),
                       args, static_kw)


def solve_dual_batch(caps, dems, *, n_valid=None, iters: int = 800,
                     lr: float = 0.08, tol: float = 0.0,
                     check_every: int = 25, use_pallas: bool = False,
                     backend: str | None = None, block: bool = True,
                     d_max: int | None = None,
                     mean_degree: float | None = None,
                     max_rounds: int | None = None,
                     device: str | torch.device = "cuda") -> DualBatchResult:
    """Batched solve over stacked [R, N, N] topologies/demands (or
    sequences of equal size).  ``n_valid`` ([R] ints) marks each lane's
    real nodes.  ``block=False`` returns device tensors without the host
    copy (``BatchPlan.execute`` copies once after every chunk)."""
    out = _descend_batch(caps, dems, n_valid=n_valid, iters=iters, lr=lr,
                         tol=tol, check_every=check_every,
                         use_pallas=use_pallas, backend=backend, d_max=d_max,
                         mean_degree=mean_degree, max_rounds=max_rounds,
                         device=device, demgrad=False, entry="solve_batch")
    if out is None:
        return DualBatchResult(np.zeros(0, np.float32),
                               np.zeros(0, np.float32), np.zeros(0, np.int32))
    best, final, it, _ = out
    if not block:
        return DualBatchResult(best, final, it)
    return DualBatchResult(best.cpu().numpy(), final.cpu().numpy(),
                           it.cpu().numpy())


def solve_dual_demgrad_batch(caps, dems, *, n_valid=None, iters: int = 800,
                             lr: float = 0.08, tol: float = 0.0,
                             check_every: int = 25, use_pallas: bool = False,
                             backend: str | None = None, block: bool = True,
                             d_max: int | None = None,
                             mean_degree: float | None = None,
                             max_rounds: int | None = None,
                             device: str | torch.device = "cuda"
                             ) -> DualDemgradBatchResult:
    """``solve_dual_batch`` plus each lane's demand gradient
    ``dem_grad[B, N, N]`` (see ``DualDemgradBatchResult``): the adversarial
    search's inner solve.  The descent is the plain dual's, bit for bit."""
    out = _descend_batch(caps, dems, n_valid=n_valid, iters=iters, lr=lr,
                         tol=tol, check_every=check_every,
                         use_pallas=use_pallas, backend=backend, d_max=d_max,
                         mean_degree=mean_degree, max_rounds=max_rounds,
                         device=device, demgrad=True,
                         entry="solve_demgrad_batch")
    if out is None:
        z = np.zeros(0, np.float32)
        return DualDemgradBatchResult(z, z.copy(), np.zeros(0, np.int32),
                                      np.zeros((0, 0, 0), np.float32))
    best, final, it, g = out
    if not block:
        return DualDemgradBatchResult(best, final, it, g)
    return DualDemgradBatchResult(best.cpu().numpy(), final.cpu().numpy(),
                                  it.cpu().numpy(), g.cpu().numpy())


def solve_dual(cap: Topology | np.ndarray, dem: np.ndarray, *,
               iters: int = 800, lr: float = 0.08, tol: float = 0.0,
               check_every: int = 25, use_pallas: bool = False,
               backend: str | None = None,
               d_max: int | None = None, max_rounds: int | None = None,
               device: str | torch.device = "cuda") -> DualResult:
    """Certified upper bound on max-concurrent-flow throughput of one
    instance (a batch of one; see ``solve_dual_batch``)."""
    cap_host = np.asarray(as_cap(cap), np.float32)
    best, final, it, _ = _descend_batch(
        cap_host[None], np.asarray(dem, np.float32)[None], n_valid=None,
        iters=iters, lr=lr, tol=tol, check_every=check_every,
        use_pallas=use_pallas, backend=backend, d_max=d_max,
        mean_degree=None, max_rounds=max_rounds, device=device,
        demgrad=False, entry="solve")
    return DualResult(float(best[0]), float(final[0]), int(it[0]))
