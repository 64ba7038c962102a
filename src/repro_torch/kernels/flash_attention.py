"""Grouped-query attention with an online softmax: the plain torch version
and the wrapper of the hand-written CUDA kernel K4
(``csrc/flash_attention.cu``).

    out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h // g]) v[b, j, h // g]

over the keys ``j < lk_valid`` that query ``i`` may see.  With ``causal``
the diagonal is aligned to the end of the valid keys, as in the
reference's TPU kernel (``repro/kernels/flash_attention.py:45-52``): key
``j`` is seen by query ``i`` iff ``j < lk_valid`` and
``j <= i + (lk_valid - Lq)``.  A query that sees no key gives 0.  The
softmax runs in float32 and the output is cast to ``q``'s type.

K4 replaces the TPU kernel ``_flash_kernel`` (via ``flash_attention_pallas``);
in the model it takes the place of the reference's blockwise jnp
``layers.attention`` at prefill and of ``transformer._attention_decode`` at
decode (``Lq = 1``, ``lk_valid = pos + 1``).  It is bound by operations at
prefill and by bytes at decode; see the note in its source.

``flash_attention`` picks by device: the kernel for CUDA tensors (it masks
its ragged edges itself, so nothing is padded, whatever ``Lq`` or ``Lk``),
the plain version for CPU tensors.  There is no fallback between the two.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_plain", "flash_attention", "D_MAX"]

D_MAX = 128   # largest head dim K4 takes


def _scale(d: int, scale: float | None) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          lk_valid: int | None = None) -> torch.Tensor:
    """Plain torch version of K4 (the reference's ``flash_attention_ref``
    with the kernel's ``lk_valid`` mask): q [B, Lq, Hq, D], k and v
    [B, Lk, Hkv, D] with ``Hq % Hkv == 0``."""
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    valid = lk if lk_valid is None else lk_valid
    qf = q.float().reshape(b, lq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * _scale(d, scale)
    kpos = torch.arange(lk, device=q.device)
    mask = (kpos < valid)[None, :]
    if causal:
        qpos = torch.arange(lq, device=q.device) + (valid - lq)
        mask = mask & (kpos[None, :] <= qpos[:, None])
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # a row that sees no key
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, 1.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, lq, hq, d).to(q.dtype)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if x.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be [B, L, H, D], got "
                         f"{tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {x.dtype}, q is {dtype}")
    if x.device != device:
        raise ValueError("flash_attention: operands on different devices")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         "axis")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    lk_valid: int | None = None,
                    site: str | None = None) -> torch.Tensor:
    """GQA attention, q [B, Lq, Hq, D] and k, v [B, Lk, Hkv, D], float32
    or bfloat16; the inputs may be strided views with a contiguous last
    axis (a layer's slice of the KV cache goes in as it is).  CUDA tensors
    launch K4, CPU tensors run ``flash_attention_plain``.  ``site`` names
    the caller in ``_build.SITE_LAUNCHES`` (as ``"flash_attention/<site>"``)."""
    b, lq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    lk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} KV "
                         "heads")
    valid = lk if lk_valid is None else int(lk_valid)
    if not 0 <= valid <= lk:
        raise ValueError(f"flash_attention: lk_valid {valid} outside "
                         f"[0, {lk}]")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     lk_valid=valid)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: float32 or bfloat16 required, "
                         f"got {q.dtype}")
    if d > D_MAX:
        raise ValueError(f"flash_attention: head dim {d} > {D_MAX}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.dtype, q.device)
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    code = lib.flash_attention(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if q.dtype == torch.float32 else 1, b, lq, valid, hq, hkv, d,
        int(causal), _scale(d, scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _build.stream_ptr(q.device))
    _build.LAUNCHES["flash_attention"] += 1
    if site is not None:
        _build.SITE_LAUNCHES[f"flash_attention/{site}"] += 1
    _build.check(code, "flash_attention")
    return out
