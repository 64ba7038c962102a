"""ELL-packed Bellman-Ford APSP for degree-bounded graphs (the port of
``repro.kernels.ell``).

Tables are the reference's incoming padded-ELL layout: row ``t`` of
``idx/wgt [B, N, d_max]`` lists the predecessors ``k`` of ``t`` ascending
with ``wgt[t, j] = w(k -> t)``, pads LAST with ``idx = t`` and ``wgt =
_INF``.  The carry is transposed, ``m[t, s] = dist(s -> t)``, and one
round pulls whole predecessor rows::

    m[t, :] = min(m[t, :], min_j wgt[t, j] + m[idx[t, j], :])

Every round here is a Jacobi round (each target reads the pre-round carry),
on both devices: the reference's CPU flavor sweeps tiles Gauss-Seidel, which
reaches the same fixed point in fewer rounds, so round counts are comparable
only against a Jacobi schedule.

K3 ``ell_relax_round`` (``csrc/ell.cu``) replaces the reference's TPU kernel
``_relax_round_kernel``; it is bound by memory (one read and one write of
the carry per round, 2*d_max instructions per element); see the source
note.  On the card it takes one of two routes, picked by ``ell_route``
from the shared memory the shape needs, never by a failure: ``slab`` copies
an (N x SPAN) slab of one lane's carry into shared memory and gathers the
predecessor rows from there (N up to 1,792 at d_max <= 64); ``l2``
gathers them from device memory (L2).  Each launch counts under
``ell_relax_round/route:<route>`` in ``_build.SITE_LAUNCHES``.
``ell_relax_round`` picks by device: the kernel for CUDA tensors,
``ell_relax_round_plain`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["ell_relax_round", "ell_relax_round_plain", "ell_bf_apsp",
           "ell_route", "ROUTES", "TILE", "SPAN"]

_INF = 1.0e18   # == repro_torch.core.apsp._INF (non-edge sentinel)
TILE = 8        # targets per changed flag (a warp's tile of targets)
SPAN = 32       # sources per changed flag (a warp's lanes)
ROUTES = ("slab", "l2")   # K3's routes, in the C entry's numbering
_SLAB_WARPS = 8           # warps per block of route slab
_SLAB_MAX_D = 64          # longest table row route slab takes
_SMEM_MAX = 232448        # shared memory one block may take on sm_90
_ERR_PATCH = -1  # K3's return code when TILE/SPAN differ from the source's
_ERR_ROUTE = -2  # K3's return code when the slab does not fit


def _slab_bytes(n: int, d: int) -> int:
    """Shared memory of route ``slab``: the [N, SPAN] carry slab and each
    warp's table stage of ``g`` target rows padded to 8 slots, a 4-byte
    weight and a 2-byte row offset a slot (``slab_smem`` in
    ``csrc/ell.cu``)."""
    dp = max(8, -(-d // 8) * 8)
    g = min(TILE, 64 // dp)
    return 4 * n * SPAN + 6 * _SLAB_WARPS * g * dp


def ell_route(n: int, d: int) -> str:
    """The route K3 takes on the card for N targets and d_max slots:
    ``slab`` for rows of up to ``_SLAB_MAX_D`` slots where the slab and
    the table stages fit one block's shared memory, else ``l2``."""
    fits = d <= _SLAB_MAX_D and _slab_bytes(n, d) <= _SMEM_MAX
    return "slab" if fits else "l2"


def _check_tables(m: torch.Tensor, idx: torch.Tensor,
                  wgt: torch.Tensor) -> tuple[int, int, int, int]:
    if idx.dim() != 3 or idx.shape != wgt.shape:
        raise ValueError(f"ELL tables must be matching [B, N, d_max] tensors, "
                         f"got idx {tuple(idx.shape)} / wgt {tuple(wgt.shape)}")
    if idx.dtype != torch.int32 or wgt.dtype != torch.float32:
        raise ValueError(f"ELL tables must be int32/float32, got "
                         f"{idx.dtype}/{wgt.dtype}")
    bsz, n, d = idx.shape
    if m.dim() != 3 or m.shape[0] != bsz or m.shape[1] != n:
        raise ValueError(f"carry {tuple(m.shape)} does not match tables "
                         f"{tuple(idx.shape)}")
    if m.dtype != torch.float32:
        raise ValueError(f"carry must be float32, got {m.dtype}")
    return bsz, n, m.shape[2], d


def _block_flags(new: torch.Tensor, old: torch.Tensor,
                 span: int = SPAN) -> torch.Tensor:
    """Changed flags per (lane, TILE targets, ``span`` sources) patch."""
    bsz, n, s = new.shape
    ch = (new < old)
    nt, ns = -(-n // TILE), -(-s // span)
    ch = torch.nn.functional.pad(ch, (0, ns * span - s, 0, nt * TILE - n))
    return ch.reshape(bsz, nt, TILE, ns, span).any(dim=4).any(dim=2)


def ell_relax_round_plain(m: torch.Tensor, idx: torch.Tensor,
                          wgt: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K3: one Jacobi round on carry ``m`` [B, N, S]
    -> ``(new carry, flags [B, ceil(N/TILE), ceil(S/SPAN)] bool)``."""
    bsz, n, s, d = _check_tables(m, idx, wgt)
    acc = m
    for j in range(d):
        rows = idx[:, :, j].long()[:, :, None].expand(bsz, n, s)
        acc = torch.minimum(acc, wgt[:, :, j, None] + torch.gather(m, 1, rows))
    return acc, _block_flags(acc, m)


def ell_relax_round(m: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi relaxation round into a new carry, plus one changed flag
    per (lane, TILE targets, SPAN sources) patch.  CUDA tensors launch K3
    on the route ``ell_route`` picks, CPU tensors run
    ``ell_relax_round_plain``; both give the same bits."""
    if not m.is_cuda:
        return ell_relax_round_plain(m, idx, wgt)
    bsz, n, s, d = _check_tables(m, idx, wgt)
    for x in (m, idx, wgt):
        if not x.is_contiguous():
            raise ValueError("ell_relax_round: contiguous tensors required")
        if x.device != m.device:
            raise ValueError("ell_relax_round: tensors on different devices")
    route = ell_route(n, d)
    lib = _build.load()
    out = torch.empty_like(m)
    flags = torch.empty((bsz, -(-n // TILE), -(-s // SPAN)),
                        dtype=torch.bool, device=m.device)
    code = lib.ell_relax_round(out.data_ptr(), flags.data_ptr(),
                               m.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                               bsz, n, s, d, TILE, SPAN, ROUTES.index(route),
                               _build.stream_ptr(m.device))
    if code in (_ERR_PATCH, _ERR_ROUTE):
        raise RuntimeError("csrc/ell.cu and kernels/ell.py disagree on the "
                           f"flag patch or on route {route!r} at N={n}, "
                           f"d_max={d}")
    _build.LAUNCHES["ell_relax_round"] += 1
    _build.SITE_LAUNCHES[f"ell_relax_round/route:{route}"] += 1
    _build.check(code, "ell_relax_round")
    return out, flags


def _full_init(idx: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Transposed one-hop carry for all sources: m0[t, s] = w(s -> t), 0 on
    the diagonal, _INF elsewhere (pads self-scatter _INF)."""
    bsz, n, _ = idx.shape
    m0 = torch.full((bsz, n, n), _INF, dtype=torch.float32, device=idx.device)
    m0.scatter_reduce_(2, idx.long(), wgt, reduce="amin")
    m0.diagonal(dim1=1, dim2=2).fill_(0.0)
    return m0


def ell_bf_apsp(idx: torch.Tensor, wgt: torch.Tensor, *,
                max_rounds: int | None = None
                ) -> tuple[torch.Tensor, int]:
    """All-pairs shortest paths of ELL-packed graphs [B, N, d_max]:
    ``(d [B, N, N] with d[s, t], rounds)``.  A host loop runs Jacobi rounds
    until no flag is set (one host read per round) or ``max_rounds``
    (default N) is reached; lanes that converge early are fixed points of
    the later rounds.  Unreachable pairs stay ~``_INF``."""
    n = idx.shape[1]
    if max_rounds is None:
        max_rounds = n
    m = _full_init(idx, wgt)
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        m, flags = ell_relax_round(m, idx, wgt)
        rounds += 1
        changed = bool(flags.any())
    return m.transpose(1, 2), rounds
