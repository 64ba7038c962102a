"""Public wrappers around the kernels (the port of ``repro.kernels.ops``).

``minplus_matmul`` is the differentiable tropical product:

* On CPU tensors it follows the reference: operands under one block go to
  the broadcast reference, larger ones are padded with ``INF`` to block
  multiples and run through the plain version of K1.
* On CUDA tensors the product always runs on K1, which masks the ragged
  edge itself, so nothing is padded and the path never leaves the kernel.
* The backward is the reference's ``_minplus_bwd`` in plain torch: the
  argmin mask with ties split evenly under a relative tolerance.

``flash_attention`` (K4) and ``wkv_chunked`` (K5) send a CPU tensor to the
plain version and a CUDA tensor to the kernel, or raise.  Unlike the
reference's wrapper, a CUDA tensor never goes to a reference function at
``Lq == 1`` or ``Lk`` under one tile: K4 masks its ragged edges itself, as
K5 does a ragged T, so neither pads.  The model's layers call these two
through this module.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import minplus as _minplus
from repro_torch.kernels import wkv as _wkv
from repro_torch.parallel import sharding as shlib

__all__ = ["minplus_matmul", "flash_attention", "wkv_chunked", "INF"]

INF = 1.0e38   # "infinity" edge weight that survives one add without overflow


def _pad_to(x: torch.Tensor, block: int, val: float) -> torch.Tensor:
    p0 = (-x.shape[-2]) % block
    p1 = (-x.shape[-1]) % block
    if p0 == 0 and p1 == 0:
        return x
    return torch.nn.functional.pad(x, (0, p1, 0, p0), value=val)


def _forward(a: torch.Tensor, b: torch.Tensor, block: int) -> torch.Tensor:
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a.shape[:-2]
    a3 = a.float().reshape(-1, m, k)
    b3 = b.float().reshape(-1, k, n)
    if a.is_cuda:
        out = _minplus.minplus_acc(a3.contiguous(), b3.contiguous())
        return out.reshape(*batch, m, n)
    if min(m, k, n) < block:      # tiny instances: reference is faster
        return _minplus.minplus_matmul_ref(a, b)
    out = _minplus.minplus_acc(_pad_to(a3, block, INF),
                               _pad_to(b3, block, INF))
    return out[:, :m, :n].reshape(*batch, m, n)


class _MinplusMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, block):
        c = _forward(a, b, block)
        ctx.save_for_backward(a, b, c)
        return c

    @staticmethod
    def backward(ctx, g):
        a, b, c = ctx.saved_tensors
        # mask[i, k, j] = 1 where A[i,k] + B[k,j] == C[i,j]; split ties
        # evenly, under a tolerance relative to the path length
        s = a[..., :, :, None] + b[..., None, :, :]
        cc = c[..., :, None, :]
        tol = 1e-6 * torch.clamp(cc.abs(), min=1e-6)
        mask = (s <= cc + tol).to(torch.float32)
        mask = mask / torch.clamp(mask.sum(dim=-2, keepdim=True), min=1.0)
        da = torch.einsum("...ikj,...ij->...ik", mask, g)
        db = torch.einsum("...ikj,...ij->...kj", mask, g)
        return da, db, None


def minplus_matmul(a: torch.Tensor, b: torch.Tensor,
                   block: int = 128) -> torch.Tensor:
    """``C = A (min,+) B`` over the last two axes (leading axes batch).
    Differentiable: the VJP routes cotangents through the argmin terms
    (ties split evenly), the shortest-path-DAG subgradient."""
    return _MinplusMatmul.apply(a, b, block)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    lk_valid: int | None = None, window: int = 0,
                    site: str | None = None) -> torch.Tensor:
    """GQA attention, q [B, Lq, Hq, D] and k, v [B, Lk, Hkv, D], causal
    diagonal aligned to the end of the ``lk_valid`` valid keys, local over
    the last ``window`` positions when ``window > 0`` (K4 on the card; see
    ``repro_torch.kernels.flash_attention``)."""
    _local("flash_attention", q, k, v)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                  lk_valid=lk_valid, window=window,
                                  site=site)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor,
                s0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV-6 over [BH, T, n] or [B, H, T, n] (strided views
    allowed) from state ``s0``: ``(o, s_final)`` (K5 on the card; see
    ``repro_torch.kernels.wkv``)."""
    _local("wkv_chunked", r, k, v, log_w, u, s0)
    return _wkv.wkv_chunked(r, k, v, log_w, u, s0)


def _local(name: str, *xs) -> None:
    """No DTensor goes into a kernel: on a mesh the model hands each rank's
    local heads over (``models.layers.local_heads``, ``rwkv6._wkv_local``)."""
    if any(shlib.is_dtensor(x) for x in xs):
        raise TypeError(f"{name} takes local tensors, not DTensors")
