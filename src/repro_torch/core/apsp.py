"""APSP backend registry and the shared SP-DAG subgradient (the port of
``repro.core.apsp``).

``apsp(w, backend, d_max, max_rounds)`` closes [N, N] or batched [B, N, N]
weight matrices over the tropical semiring.  The backend names are the
reference's:

* ``"squaring"`` / ``"squaring-pallas"`` — repeated (min,+) squaring.  On a
  CUDA tensor both run on the hand-written tropical kernel K1, so the card
  never allocates the [B, N, N, N] broadcast; on the CPU ``"squaring"`` is
  the plain product and ``"squaring-pallas"`` goes through
  ``kernels.ops.minplus_matmul`` as the reference does;
* ``"blocked-fw"`` — blocked Floyd-Warshall on K2 (pivot) + K1 (panels) on
  the card, padded to the 128 tile with ``_INF``; plain Floyd-Warshall on
  the CPU (the reference's off-TPU flavor);
* ``"ell-bf"`` — Jacobi Bellman-Ford rounds over padded-ELL tables of width
  ``d_max`` (K3 on the card);
* ``"auto"`` — ``"blocked-fw"`` for ``n >= AUTO_THRESHOLD`` else
  ``"squaring"``; with a mean degree, large sparse graphs go ``"ell-bf"``.

The platform decides by ``tensor.is_cuda`` where the reference asks
``jax.default_backend() == "tpu"``.

**The subgradient.**  Every backend shares one backward, the reference's
Bellman fixed-point adjoint: each sweep routes every pair's cotangent one
hop back along the shortest-path DAG (ties split evenly under a relative
tolerance), depositing each edge's share, until the mass drains onto the
diagonal.  The port walks the incoming ELL table of ``w`` (as the
reference's ``_sp_dag_grad_ell`` does) for every backend, so the port's
subgradients are bit-identical across its backends by construction.  The
order of additions is pinned with no atomics:

* the cotangent carried back to predecessor ``k`` is added strictly in
  ascending target order, as the reference does: for each ``k`` the masses
  of its successors ``t`` (an outgoing table, ascending) are pulled through
  the slot ``k`` holds in ``t``'s incoming row and added left to right,
  with +0.0 for pads.  These values are bit-equal to the reference's;
* an edge's deposit per sweep is a sum over sources, which the reference
  leaves to an XLA reduction.  The port sums by pairwise halving in an
  order fixed by N alone (``_sum_sources``), so a lane's deposits do not
  depend on the batch, the chunking or the device; the two orders differ,
  so deposits agree with the reference to a few fp32 ulps of the summed
  mass, not bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.kernels import ell as kell
from repro_torch.kernels import fw as kfw
from repro_torch.kernels import minplus as kmin
from repro_torch.kernels import ops as kops

__all__ = ["apsp", "normalize_backend", "resolve_backend", "BACKENDS",
           "AUTO_THRESHOLD", "SPARSE_THRESHOLD", "_INF"]

_INF = 1.0e18   # non-edge sentinel: survives one add in float32 headroom

BACKENDS = ("squaring", "squaring-pallas", "blocked-fw", "ell-bf", "auto")
AUTO_THRESHOLD = 512     # auto: blocked-fw at and above this padded size
SPARSE_THRESHOLD = 32.0  # auto: ell-bf when mean degree is at most this
_BWD_ELEMS = 1 << 27     # element budget of one [B, N, chunk, d] backward slab


def normalize_backend(backend: str | bool | None = None,
                      use_pallas: bool = False) -> str:
    """Map a backend spec (registry name, legacy ``use_pallas`` bool, or
    None) to a registry name.  ``None`` defers to ``use_pallas``: True ->
    "squaring-pallas", False -> "auto"."""
    if backend is None:
        return "squaring-pallas" if use_pallas else "auto"
    if isinstance(backend, bool):   # legacy positional use_pallas slot
        return "squaring-pallas" if backend else "squaring"
    if backend not in BACKENDS:
        raise ValueError(f"unknown APSP backend {backend!r}; "
                         f"known: {BACKENDS}")
    return backend


def resolve_backend(backend: str, n: int, *,
                    mean_degree: float | None = None) -> str:
    """Resolve "auto" against a matrix size and, when known, the graph's
    mean degree (large degree-bounded instances go ``"ell-bf"``)."""
    backend = normalize_backend(backend)
    if backend == "auto":
        if (mean_degree is not None and n >= AUTO_THRESHOLD
                and mean_degree <= SPARSE_THRESHOLD):
            return "ell-bf"
        return "blocked-fw" if n >= AUTO_THRESHOLD else "squaring"
    return backend


def _squaring_steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n - 1, 2))))


def _clamp_d_max(d_max: int, n: int) -> int:
    return max(1, min(int(d_max), max(n - 1, 1)))


def _pack_ell(w: torch.Tensor, d_max: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack dense weights [B, N, N] into incoming padded-ELL tables: row
    ``t`` of ``(idx, wgt)`` lists the predecessors ``k`` with ``wgt[t, j] =
    w[k, t]``, ascending, pads LAST with ``idx = t`` / ``wgt = _INF``.
    ``d_max`` must cover the max in-degree (rows with more finite entries
    would be truncated; host layers validate it)."""
    n = w.shape[-1]
    d_max = _clamp_d_max(d_max, n)
    eye = torch.eye(n, dtype=torch.bool, device=w.device)
    # wt[t, k] = w[k, t]; the diagonal is masked so the zero self-entry
    # never competes with real edges for a table slot
    wt = torch.where(eye, _INF, w.transpose(-1, -2).to(torch.float32))
    neg, cols = torch.topk(-wt, d_max, dim=-1)       # d_max smallest per row
    vals = -neg
    valid = vals < _INF / 2
    rows = torch.arange(n, device=w.device)[:, None]
    order = torch.argsort(torch.where(valid, cols, n), dim=-1, stable=True)
    idx = torch.gather(torch.where(valid, cols, rows), -1, order)
    wgt = torch.gather(torch.where(valid, vals, _INF), -1, order)
    return idx.to(torch.int32), wgt


def _apsp_forward(w: torch.Tensor, backend: str, d_max: int | None,
                  max_rounds: int | None) -> torch.Tensor:
    n = w.shape[-1]
    kind = resolve_backend(backend, n)
    d = w.to(torch.float32)
    if kind == "ell-bf":
        if d_max is None:
            raise ValueError("ell-bf needs d_max (max degree of the packed "
                             "table); compute it host-side, e.g. "
                             "graphs.degree_stats(cap)")
        idx, wgt = _pack_ell(d, d_max)
        dd, _ = kell.ell_bf_apsp(idx, wgt, max_rounds=max_rounds)
        return dd.contiguous()
    if kind == "blocked-fw":
        if not d.is_cuda:
            return kfw.fw_apsp_plain(d)
        pad = (-n) % kfw.FW_TILE
        if pad:
            d = torch.nn.functional.pad(d, (0, pad, 0, pad), value=_INF)
        d = kfw.fw_apsp_blocked(d)
        return d[:, :n, :n].contiguous() if pad else d
    for _ in range(_squaring_steps(n)):
        if d.is_cuda:
            d = kmin.minplus_acc(d, d, d)
        elif kind == "squaring-pallas":
            d = torch.minimum(d, kops.minplus_matmul(d, d, 128))
        else:
            d = kmin.minplus_acc_plain(d, d, d)
    return d


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] + x[:, h:2 * h]
        if x.shape[1] % 2:
            y[:, h - 1:h] += x[:, 2 * h:]
        x = y
    return x[:, 0]


class _SumSourcesFn(torch.autograd.Function):
    # the gradient of a sum is its upstream gradient on every term: each
    # term sits on one path of the halving tree, so this is the bits
    # autograd would give through the halving, without its ~3 launches a
    # level (slices' zeros and copies)
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return _halving_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(1).expand(ctx.shape)


def _sum_sources(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` [B, S, ...] over S by pairwise halving: every output
    element is added in an order fixed by S alone, so the result does not
    depend on the batch size, the chunk width or the device's reduction
    kernel."""
    if x.requires_grad:
        return _SumSourcesFn.apply(x)
    return _halving_sum(x)


_READ = "repro_torch.apsp.backward.read"


def _mass_left(u: torch.Tensor) -> bool:
    """The backward's host read a sweep: is any cotangent still off the
    diagonal."""
    with obs.span(_READ):
        return bool(u.abs().max() > 0.0)


def _sp_dag_grad(w: torch.Tensor, d: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """Backward of the closure of ``w`` [B, N, N]: route the cotangent
    ``g`` on ``D`` back along the shortest-path DAG, one hop per sweep.
    Shared by every backend (see the module docstring for the order of
    additions).  Host reads: the two table widths, and one per sweep."""
    bsz, n, _ = w.shape
    dev = w.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    wf = w.to(torch.float32)
    df = d.to(torch.float32)
    fin = (wf < _INF / 2) & ~eye                        # fin[b, k, t]: edge k -> t
    with obs.span(_READ):
        degs = torch.stack([fin.sum(1).max(), fin.sum(2).max()]).tolist()
    d_in, d_out = max(1, int(degs[0])), max(1, int(degs[1]))
    idx, wgt = _pack_ell(wf, d_in)                      # predecessors of t
    valid = wgt < _INF / 2
    oidx, owgt = _pack_ell(wf.transpose(1, 2), d_out)   # successors of k
    ovalid = owgt < _INF / 2
    oidx = oidx.long()
    # slot of k in t's incoming row = finite predecessors k' < k of t
    fin_i = fin.to(torch.int32)
    rank = torch.cumsum(fin_i, dim=1) - fin_i
    oslot = torch.gather(rank, 2, oidx).long()          # [B, k, d_out]
    idx_l = idx.long()
    u = torch.where((df < _INF / 2) & ~eye, g.to(torch.float32), 0.0)
    dw_ell = torch.zeros((bsz, n, d_in), dtype=torch.float32, device=dev)
    c = max(1, min(n, _BWD_ELEMS // max(1, bsz * n * d_in)))
    it, reads = 0, 1                                    # reads: the widths
    while it < n:
        reads += 1
        if not _mass_left(u):
            break
        un = torch.zeros_like(u)
        for t0 in range(0, n, c):
            t1 = min(n, t0 + c)
            cc = t1 - t0
            wc = wgt[:, t0:t1, :]
            gi = idx_l[:, t0:t1, :].reshape(bsz, 1, cc * d_in)
            # dk[s, tc, j] = D[s, idx[t0 + tc, j]]
            dk = torch.gather(df, 2, gi.expand(bsz, n, cc * d_in))
            s = dk.view(bsz, n, cc, d_in) + wc[:, None]
            dc = df[:, :, t0:t1]
            tol = 1e-6 * torch.clamp(dc.abs(), min=1e-6)
            mask = (s <= (dc + tol)[..., None]) & valid[:, None, t0:t1, :]
            mf = mask.to(torch.float32)
            mf = mf / torch.clamp(mf.sum(dim=3, keepdim=True), min=1.0)
            mf = mf * u[:, :, t0:t1, None]
            dw_ell[:, t0:t1, :] += _sum_sources(mf)
            # cotangent one hop back: for every predecessor k, add the
            # masses of its successors in this chunk left to right over
            # its ascending outgoing slots (+0.0 for the others)
            flat = mf.view(bsz, n, cc * d_in)
            for j in range(d_out):
                tt = oidx[:, :, j]
                inside = ovalid[:, :, j] & (tt >= t0) & (tt < t1)
                pos = ((tt - t0).clamp(0, cc - 1) * d_in
                       + oslot[:, :, j].clamp(max=d_in - 1))
                val = torch.gather(flat, 2, pos[:, None, :].expand(bsz, n, n))
                un = un + torch.where(inside[:, None, :], val, 0.0)
        # mass arriving on the diagonal is a completed path
        u = torch.where(eye, 0.0, un)
        it += 1
    # deposits live in ELL layout dw_ell[t, j]; each lands on its dense
    # edge (k = idx[t, j], t) exactly once; pads write 0 to the diagonal
    dwt = torch.zeros((bsz, n, n), dtype=torch.float32, device=dev)
    dwt.scatter_(2, idx_l, torch.where(valid, dw_ell, 0.0))
    obs.count("sp_dag.backwards")
    obs.count("sp_dag.hops", it)
    obs.count("sp_dag.host_reads", reads)
    return dwt.transpose(1, 2).to(w.dtype)


class _Apsp(torch.autograd.Function):
    # the two spans are profiler ranges too: they name the two halves of a
    # descent step in a torch.profiler trace (chip_smoke.py and the
    # benchmark read their device time); off, they cost what the ranges
    # cost while no profiler runs
    @staticmethod
    def forward(ctx, w, backend, d_max, max_rounds):
        with obs.span("repro_torch.apsp.forward", profiler=True):
            d = _apsp_forward(w, backend, d_max, max_rounds)
        ctx.save_for_backward(w, d)
        return d

    @staticmethod
    def backward(ctx, g):
        w, d = ctx.saved_tensors
        with obs.span("repro_torch.apsp.backward", profiler=True):
            return _sp_dag_grad(w, d, g), None, None, None


def apsp(w: torch.Tensor, backend: str | bool | None = "auto",
         d_max: int | None = None,
         max_rounds: int | None = None) -> torch.Tensor:
    """All-pairs shortest path lengths of dense weighted digraphs ``w``
    ([N, N] or batched [B, N, N]): zero diagonal, ``_INF`` non-edges,
    positive lengths.  ``backend`` is a registry name (or a legacy
    ``use_pallas`` bool); ``d_max`` (required by ``"ell-bf"``) is the ELL
    table width and ``max_rounds`` caps its relaxation rounds (default N).
    Unreachable pairs stay ~``_INF``.  Differentiable on every backend
    through the shared SP-DAG adjoint."""
    backend = normalize_backend(backend)
    if w.dim() == 2:
        return _Apsp.apply(w[None], backend, d_max, max_rounds)[0]
    return _Apsp.apply(w, backend, d_max, max_rounds)
