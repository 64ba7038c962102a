"""Blocked Floyd-Warshall APSP (the port of ``repro.kernels.fw``).

Per pivot tile ``kk`` (the classic 4-phase schedule of the reference):

1. **pivot block**: close ``D[kk, kk]`` in place (K2, ``csrc/fw_pivot.cu``);
2. **row panel**:  ``R' = min(R, P (min,+) R)`` (K1 reading the panel ``R``
   of ``D`` as a strided view, writing a separate buffer);
3. **col panel**:  ``C' = min(C, C (min,+) P)`` (K1, same);
4. **outer update**: ``D = min(D, C' (min,+) R')`` over the whole matrix
   (K1 in place on ``D``, after ``R'``/``C'`` are written back, reading
   the panel buffers as the reference's ``outer_call`` does).

Phases 2-4 applied to the pivot row/col/block itself are idempotent (``P``
has a zero diagonal and is min-plus closed), so no masking is needed.

K2 ``fw_pivot`` replaces the reference's ``_pivot_kernel``; it is bound by
the latency of ``t`` sequential steps over one tile on one SM: the tile
stays in registers, row and column k go through shared memory, one
barrier a pivot (see the note in ``csrc/fw_pivot.cu``).  K2 holds tiles up
to ``FW_TILE``; a wider tile on the card is padded to a multiple of it
with the non-edge sentinel and closed by ``fw_apsp_blocked`` at
``t = FW_TILE`` (K2 + K1, counted as such), so ``fw_apsp_blocked(w, t=)``
takes any ``t``, as the reference's ``fw_apsp_pallas(w, t=)`` does.
``fw_pivot`` and
``minplus_acc`` pick by device: the kernel for CUDA tensors, the plain
version for CPU tensors.

* ``fw_apsp_blocked`` — the tiled driver (what ``"blocked-fw"`` runs on the
  card; on CPU tensors it runs the plain versions of K1/K2, which is how the
  tests hold it against the reference's interpret-mode Pallas path);
* ``fw_apsp_plain`` — plain Floyd-Warshall, N sequential relaxations (the
  counterpart of ``fw_apsp_jnp``; what ``"blocked-fw"`` runs on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minplus import minplus_acc

__all__ = ["fw_tile_closure", "fw_pivot", "fw_apsp_blocked", "fw_apsp_plain",
           "FW_TILE"]

FW_TILE = 128   # pivot tile of fw_apsp_blocked; K2's largest tile on the card
_INF = 1.0e18   # == repro_torch.core.apsp._INF (non-edge sentinel)


def fw_tile_closure(d: torch.Tensor) -> torch.Tensor:
    """In-tile Floyd-Warshall closure of square tiles ``d`` [..., t, t]:
    t sequential relaxations ``d = min(d, d[:, k] + d[k, :])``.  The plain
    version of K2, and (on a whole matrix) plain Floyd-Warshall."""
    t = d.shape[-1]
    for k in range(t):
        d = torch.minimum(d, d[..., :, k:k + 1] + d[..., k:k + 1, :])
    return d


def fw_pivot(d: torch.Tensor) -> torch.Tensor:
    """Close every [t, t] tile of ``d`` [B, t, t] IN PLACE and return it.
    ``d`` may be a strided view (row and lane strides, contiguous last
    axis).  CUDA tensors launch K2 (wider tiles than ``FW_TILE`` go through
    ``_close_wide``), CPU tensors run ``fw_tile_closure``."""
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"fw_pivot: [B, t, t] tiles required, got "
                         f"{tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise ValueError(f"fw_pivot: float32 required, got {d.dtype}")
    if not d.is_cuda:
        d.copy_(fw_tile_closure(d))
        return d
    bsz, t, _ = d.shape
    if t > FW_TILE:
        d.copy_(_close_wide(d))
        return d
    if d.stride(2) != 1:
        raise ValueError("fw_pivot: needs a contiguous last axis")
    lib = _build.load()
    code = lib.fw_pivot(d.data_ptr(), bsz, t, d.stride(0), d.stride(1),
                        _build.stream_ptr(d.device))
    _build.LAUNCHES["fw_pivot"] += 1
    _build.check(code, "fw_pivot")
    return d


def _close_wide(d: torch.Tensor) -> torch.Tensor:
    """The closure of tiles [B, t, t] wider than K2's ``FW_TILE``: padded
    to a multiple of it with ``_INF`` (padded nodes have no edges, so the
    real distances are unchanged) and closed by ``fw_apsp_blocked``."""
    t = d.shape[-1]
    pad = (-t) % FW_TILE
    w = torch.nn.functional.pad(d, (0, pad, 0, pad), value=_INF)
    return fw_apsp_blocked(w, t=FW_TILE)[:, :t, :t]


def fw_apsp_blocked(w: torch.Tensor, *, t: int = FW_TILE) -> torch.Tensor:
    """Blocked Floyd-Warshall closure of float32 ``w`` [B, N, N]; N must be
    a multiple of ``t`` (callers pad with the non-edge sentinel).  Returns
    a new tensor; one pivot step is one K2 and three K1 launches at ``t <=
    FW_TILE`` (a wider pivot tile is itself closed blocked, see
    ``fw_pivot``)."""
    if w.dim() != 3 or w.shape[1] != w.shape[2]:
        raise ValueError(f"fw_apsp_blocked: [B, N, N] required, got "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    if n % t:
        raise ValueError(f"fw_apsp_blocked: n={n} must be a multiple of the "
                         f"tile size t={t} (callers pad)")
    d = w.to(torch.float32).contiguous().clone()
    nb = n // t
    if nb == 1:
        return fw_pivot(d)
    for kk in range(nb):
        lo, hi = kk * t, (kk + 1) * t
        p = fw_pivot(d[:, lo:hi, lo:hi].clone())
        # panels read the pre-step matrix through strided views and land
        # in fresh buffers, exactly as the reference's row/col calls do
        row = minplus_acc(p, d[:, lo:hi, :], d[:, lo:hi, :], site="fw-row")
        col = minplus_acc(d[:, :, lo:hi], p, d[:, :, lo:hi], site="fw-col")
        d[:, lo:hi, :] = row
        d[:, :, lo:hi] = col
        minplus_acc(col, row, d, out=d, site="fw-outer")
    return d


def fw_apsp_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain Floyd-Warshall over [..., N, N]: N sequential O(N^2)
    relaxations, identical distances to the tiled driver."""
    return fw_tile_closure(w.to(torch.float32))
