"""Tropical (min,+) matrix product: the plain torch version and the wrapper
of the hand-written CUDA kernel K1 (``csrc/minplus.cu``).

    C[b] = min(C0[b], A[b] (min,+) B[b]),   (A (min,+) B)[i, j] = min_k A[i, k] + B[k, j]

K1 replaces the reference's TPU kernels ``_minplus_kernel``
(``repro/kernels/minplus.py``) and the Floyd-Warshall row/column/outer
panel kernels (``repro/kernels/fw.py``): all of them are this product on
tiles.  Like the TPU kernel the accumulator starts at ``SENTINEL`` (3e38),
so entries >= 1e38 act as +inf.  It is bound by operations (one fp32 add
and one fp32 min per term, no tensor-core path); see the source note in
``csrc/minplus.cu`` for what its design does about that.

``minplus_acc`` picks by device: the kernel for CUDA tensors, the plain
version for CPU tensors.  There is no fallback between the two.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

__all__ = ["SENTINEL", "TILES", "minplus_tile", "minplus_matmul_ref",
           "minplus_acc_plain", "minplus_acc"]

SENTINEL = 3.0e38        # "+inf" stand-in that survives adds (accumulator init)
_PLAIN_ELEMS = 1 << 26   # element budget of one broadcast slab of the plain version
# K1's two instantiations, in the C entry's numbering: a 128x128 output
# tile at 2 blocks an SM (<= 128 registers) or at 1 block an SM
TILES = ("128x128 2/SM", "128x128 1/SM")


def minplus_tile(batch: int, m: int, n: int, sms: int) -> str:
    """The instantiation K1 takes for a [batch, m, *] x [batch, *, n]
    product on a card with ``sms`` SMs: 2 blocks an SM where the grid has
    more blocks than SMs, else 1 block an SM with more registers (the
    narrow Floyd-Warshall panels: 80 blocks at [20, 128, 512])."""
    blocks = batch * -(-m // 128) * -(-n // 128)
    return TILES[0] if blocks > sms else TILES[1]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[..., i, j] = min_k A[..., i, k] + B[..., k, j]``: the direct
    broadcast, as ``repro.kernels.ref.minplus_matmul_ref``."""
    return torch.amin(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def minplus_acc_plain(a: torch.Tensor, b: torch.Tensor,
                      c0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of K1: ``min(c0, min(SENTINEL, A (min,+) B))``
    over a leading batch axis ([B, M, K] x [B, K, N] -> [B, M, N]).  The
    k axis is taken in slabs under an element budget; min is exact and
    order-free, so the slab width never changes a bit."""
    bsz, m, k = a.shape
    n = b.shape[-1]
    acc = torch.full((bsz, m, n), SENTINEL, dtype=torch.float32,
                     device=a.device)
    step = max(1, min(k, _PLAIN_ELEMS // max(1, bsz * m * n)))
    for k0 in range(0, k, step):
        slab = a[:, :, k0:k0 + step, None] + b[:, None, k0:k0 + step, :]
        acc = torch.minimum(acc, torch.amin(slab, dim=2))
    if c0 is not None:
        acc = torch.minimum(c0, acc)
    return acc


def _check(name: str, x: torch.Tensor, shape: tuple[int, int, int]) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"minplus_acc: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"minplus_acc: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"minplus_acc: {name} needs a contiguous last axis")


def _span(x: torch.Tensor) -> tuple[int, int]:
    """Byte range [first, last) that a strided tensor can touch."""
    last = sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    return x.data_ptr(), x.data_ptr() + (last + 1) * x.element_size()


def _overlap(x: torch.Tensor, y: torch.Tensor) -> bool:
    (x0, x1), (y0, y1) = _span(x), _span(y)
    return x0 < y1 and y0 < x1


def minplus_acc(a: torch.Tensor, b: torch.Tensor,
                c0: torch.Tensor | None = None, *,
                out: torch.Tensor | None = None,
                site: str | None = None) -> torch.Tensor:
    """``min(c0, A (min,+) B)`` for batched float32 ``a`` [B, M, K] and
    ``b`` [B, K, N]; ``c0`` and ``out`` are [B, M, N] and may be strided
    views (row and lane strides, contiguous last axis).  ``out`` may be
    ``c0`` itself; it must not overlap ``a`` or ``b``.  CUDA tensors
    launch K1, CPU tensors run ``minplus_acc_plain``.  ``site`` names the
    caller in ``_build.SITE_LAUNCHES`` (as ``"minplus_acc/<site>"``).
    The build K1 runs is ``minplus_tile``'s choice; both give the same
    bits."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"minplus_acc: batched 3-D operands required, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    bsz, m, k = a.shape
    if b.shape[0] != bsz or b.shape[1] != k:
        raise ValueError(f"minplus_acc: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree on batch or inner size")
    n = b.shape[2]
    if out is not None and (_overlap(out, a) or _overlap(out, b)):
        raise ValueError("minplus_acc: out may alias c0 only, not a or b")
    if not a.is_cuda:
        res = minplus_acc_plain(a, b, c0)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty((bsz, m, n), dtype=torch.float32, device=a.device)
    _check("a", a, (bsz, m, k))
    _check("b", b, (bsz, k, n))
    _check("out", out, (bsz, m, n))
    if c0 is not None:
        _check("c0", c0, (bsz, m, n))
    for x in (b, out) + ((c0,) if c0 is not None else ()):
        if x.device != a.device:
            raise ValueError("minplus_acc: operands on different devices")
    tile = minplus_tile(bsz, m, n, _sms(a.device))
    lib = _build.load()
    code = lib.minplus_acc(
        out.data_ptr(), c0.data_ptr() if c0 is not None else None,
        a.data_ptr(), b.data_ptr(), bsz, m, n, k,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        out.stride(0), out.stride(1),
        c0.stride(0) if c0 is not None else 0,
        c0.stride(1) if c0 is not None else 0, TILES.index(tile),
        _build.stream_ptr(a.device))
    _build.LAUNCHES["minplus_acc"] += 1
    if site is not None:
        _build.SITE_LAUNCHES[f"minplus_acc/{site}"] += 1
    _build.check(code, "minplus_acc")
    return out
