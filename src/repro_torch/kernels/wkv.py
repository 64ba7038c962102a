"""Chunked RWKV-6 WKV with data-dependent decay: the plain torch version
and the wrapper of the hand-written CUDA kernel K5 (``csrc/wkv.cu``).

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

per lane (batch x head) of [BH, T, n] float32 inputs, given ``log_w`` and
the bonus ``u`` ([n], or [BH, n]), starting from ``s0`` ([BH, n, n], zero
when None) and returning ``(o [BH, T, n], s_final [BH, n, n])``.  The work
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

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "N_MAX", "wkv_chunked_plain", "wkv_chunked"]

CHUNK = 32
N_MAX = 64   # largest head size K5 takes


def _bonus(u: torch.Tensor, bh: int, n: int) -> torch.Tensor:
    if u.shape not in ((n,), (bh, n)):
        raise ValueError(f"wkv_chunked: u must be [{n}] or [{bh}, {n}], got "
                         f"{tuple(u.shape)}")
    return u.float().expand(bh, n)


def wkv_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor,
                      s0: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K5: the reference's ``_wkv_chunked`` chunk
    body (``repro/models/rwkv6.py:112``) over a [BH, T, n] layout."""
    bh, t, n = r.shape
    uu = _bonus(u, bh, n)[:, None, :]
    pad = (-t) % CHUNK
    xs = [x.float() for x in (r, k, v, log_w)]
    if pad:
        xs = [torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in xs]
    s = (torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
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
    return torch.cat(outs, dim=1)[:, :t], s


def _check(name: str, x: torch.Tensor, shape: tuple[int, ...],
           device: torch.device) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"wkv_chunked: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if x.device != device:
        raise ValueError("wkv_chunked: operands on different devices")


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor,
                s0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 over [BH, T, n] inputs from state ``s0`` (zero when None):
    returns ``(o [BH, T, n] float32, s_final [BH, n, n] float32)``.  CUDA
    tensors launch K5, CPU tensors run ``wkv_chunked_plain``."""
    if r.dim() != 3:
        raise ValueError(f"wkv_chunked: r must be [BH, T, n], got "
                         f"{tuple(r.shape)}")
    bh, t, n = r.shape
    for name, x in (("k", k), ("v", v), ("log_w", log_w)):
        _check(name, x, (bh, t, n), r.device)
    if s0 is not None:
        _check("s0", s0, (bh, n, n), r.device)
    if not r.is_cuda:
        return wkv_chunked_plain(r, k, v, log_w, u, s0)
    if n > N_MAX:
        raise ValueError(f"wkv_chunked: head size {n} > {N_MAX}")
    if u.device != r.device:
        raise ValueError("wkv_chunked: operands on different devices")
    uu = _bonus(u, bh, n).contiguous()
    rr, kk, vv, ww = (x.float().contiguous() for x in (r, k, v, log_w))
    s_in = s0.float().contiguous() if s0 is not None else None
    o = torch.empty((bh, t, n), dtype=torch.float32, device=r.device)
    s_out = torch.empty((bh, n, n), dtype=torch.float32, device=r.device)
    lib = _build.load()
    code = lib.wkv_chunked(
        o.data_ptr(), s_out.data_ptr(), rr.data_ptr(), kk.data_ptr(),
        vv.data_ptr(), ww.data_ptr(), uu.data_ptr(), uu.stride(0),
        s_in.data_ptr() if s_in is not None else None, bh, t, n,
        _build.stream_ptr(r.device))
    _build.LAUNCHES["wkv_chunked"] += 1
    _build.check(code, "wkv_chunked")
    return o, s_out
