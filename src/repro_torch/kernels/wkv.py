"""Chunked RWKV-6 WKV with data-dependent decay: the plain torch version
and the wrapper of the hand-written CUDA kernel K5 (``csrc/wkv.cu``).

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

per lane (batch x head) of [BH, T, n] or [B, H, T, n] float32 inputs,
given ``log_w`` and the bonus ``u`` ([n], or one row per lane), starting
from ``s0`` ([..., n, n], zero when None) and returning ``(o, s_final)``
with ``o`` of r's shape.  The inputs may be strided views with a contiguous
last axis: the model hands K5 its [B, T, H, n] projections permuted to
[B, H, T, n], which the kernel reads in place.  The work
runs in chunks of ``CHUNK = 32`` steps: within a chunk a masked quadratic
form with decay weights, across chunks the (n, n) state.  A ragged T is
handled as the reference pads it (``repro/models/rwkv6.py:175-181``): the
steps past T have k = v = 0 and log_w = 0, which leave the state unchanged.

K5 replaces the TPU kernel ``_wkv_kernel`` (via ``wkv_chunked_pallas``,
which it equals when ``s0`` is None); in the model it takes the place of the
reference's jnp ``rwkv6._wkv_chunked`` at prefill.  It is bound by bytes;
see the note in its source.  The plain version is that chunked algebra
step for step.

``wkv_chunked`` picks by device: the kernel for CUDA tensors, the plain
version for CPU tensors.  There is no fallback between the two.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "N_MAX", "wkv_chunked_plain", "wkv_chunked"]

CHUNK = 32
N_MAX = 64   # largest head size K5 takes


def _lanes(x: torch.Tensor) -> tuple[int, ...]:
    """The lane axes of a [BH, T, n] or [B, H, T, n] operand."""
    if x.dim() not in (3, 4):
        raise ValueError(f"wkv_chunked: r must be [BH, T, n] or [B, H, T, n], "
                         f"got {tuple(x.shape)}")
    return tuple(x.shape[:-2])


def _bonus(u: torch.Tensor, lead: tuple[int, ...], n: int) -> torch.Tensor:
    """``u`` as given ([n], or one row per lane: [BH, n], or [H, n] /
    [B, H, n] beside [B, H, T, n] inputs), broadcast to ``lead + (n,)``."""
    shapes = {(n,), lead + (n,)} | ({lead[1:] + (n,)} if len(lead) == 2
                                    else set())
    if tuple(u.shape) not in shapes:
        raise ValueError(f"wkv_chunked: u must be one of "
                         f"{sorted(shapes, key=len)}, got {tuple(u.shape)}")
    return u.float().expand(*lead, n)


def wkv_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor,
                      s0: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K5: the reference's ``_wkv_chunked`` chunk
    body (``repro/models/rwkv6.py:112``) over [BH, T, n] or [B, H, T, n]
    operands (any strides); returns ``o`` of r's shape and the final
    state [..., n, n]."""
    lead, (t, n) = _lanes(r), r.shape[-2:]
    bh = math.prod(lead)
    uu = _bonus(u, lead, n).reshape(bh, 1, n)
    pad = (-t) % CHUNK
    xs = [x.float().reshape(bh, t, n) for x in (r, k, v, log_w)]
    if pad:
        xs = [torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in xs]
    s = (torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().reshape(bh, n, n))
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    outs = []
    for c0 in range(0, t + pad, CHUNK):
        rr, kk, vv, ww = (x[:, c0:c0 + CHUNK] for x in xs)    # [BH, C, n]
        lcw = torch.cumsum(ww, dim=1)                         # inclusive
        r_t = rr * torch.exp(lcw - ww)                        # decay to chunk start
        k_t = kk * torch.exp(-lcw)
        a = torch.einsum("btn,bin->bti", r_t, k_t)
        a = torch.where(tri, a, 0.0)
        diag = torch.einsum("btn,btn->bt", rr * uu, kk)
        o = torch.einsum("bti,bin->btn", a, vv)
        o = o + diag[..., None] * vv
        o = o + torch.einsum("btn,bnm->btm", r_t, s)
        total = lcw[:, -1:]                                   # [BH, 1, n]
        k_s = kk * torch.exp(total - lcw)
        s = s * torch.exp(total[:, 0])[..., None] + \
            torch.einsum("btn,btm->bnm", k_s, vv)
        outs.append(o)
    o = torch.cat(outs, dim=1)[:, :t]
    return o.reshape(*lead, t, n), s.reshape(*lead, n, n)


def _check(name: str, x: torch.Tensor, shape: tuple[int, ...],
           device: torch.device) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"wkv_chunked: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if x.device != device:
        raise ValueError("wkv_chunked: operands on different devices")


def _lane_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, token) element strides; a [BH, T, n] operand is one
    head per batch row."""
    if x.dim() == 3:
        return x.stride(0), 0, x.stride(1)
    return x.stride(0), x.stride(1), x.stride(2)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor,
                s0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over [BH, T, n] or [B, H, T, n] inputs from state ``s0`` ([...,
    n, n], zero when None): returns ``(o, s_final)`` in float32, ``o`` of
    r's shape.  The inputs may be strided views with a contiguous last axis
    (the model passes its [B, T, H, n] projections permuted, no copy); on
    the card ``o`` takes r's memory layout.  ``u`` is [n] or one row per
    lane (see ``_bonus``).  CUDA tensors launch K5, CPU tensors run
    ``wkv_chunked_plain``."""
    lead = _lanes(r)
    t, n = r.shape[-2:]
    for name, x in (("k", k), ("v", v), ("log_w", log_w)):
        _check(name, x, tuple(r.shape), r.device)
    if s0 is not None:
        _check("s0", s0, lead + (n, n), r.device)
    if not r.is_cuda:
        return wkv_chunked_plain(r, k, v, log_w, u, s0)
    if n > N_MAX:
        raise ValueError(f"wkv_chunked: head size {n} > {N_MAX}")
    if u.device != r.device:
        raise ValueError("wkv_chunked: operands on different devices")
    # u broadcast over the lanes: its (batch, head) strides, 0 where shared
    uu = _bonus(u, lead, n)
    if uu.stride(-1) != 1:
        uu = uu.contiguous()
    su = (uu.stride(0), uu.stride(1) if len(lead) == 2 else 0)
    rr, kk, vv, ww = (x.float() if x.stride(-1) == 1 else x.float().contiguous()
                      for x in (r, k, v, log_w))
    s_in = s0.float().contiguous() if s0 is not None else None
    o = torch.empty_like(rr)
    s_out = torch.empty(lead + (n, n), dtype=torch.float32, device=r.device)
    nb, nh = (lead[0], 1) if len(lead) == 1 else lead
    lib = _build.load()
    code = lib.wkv_chunked(
        o.data_ptr(), s_out.data_ptr(), rr.data_ptr(), kk.data_ptr(),
        vv.data_ptr(), ww.data_ptr(), uu.data_ptr(),
        s_in.data_ptr() if s_in is not None else None, nb, nh, t, n,
        *_lane_strides(rr), *_lane_strides(kk), *_lane_strides(vv),
        *_lane_strides(ww), *_lane_strides(o), *su,
        _build.stream_ptr(r.device))
    _build.LAUNCHES["wkv_chunked"] += 1
    _build.check(code, "wkv_chunked")
    return o, s_out
