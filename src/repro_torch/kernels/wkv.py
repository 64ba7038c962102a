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

The backward is K5b (``csrc/wkv_bwd.cu``) and ``wkv_chunked_bwd_plain`` its
torch version.  The reference has no TPU kernel for it: its rwkv6 model
differentiates the jnp ``_wkv_chunked``, which K5 stands in for, through
XLA.  ``wkv_chunked`` is an autograd function when a gradient is to be
taken.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "N_MAX", "wkv_chunked_plain", "wkv_chunked",
           "wkv_chunked_bwd_plain", "wkv_chunked_bwd"]

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


def _check_all(r, k, v, log_w, s0) -> None:
    lead = _lanes(r)
    n = r.shape[-1]
    for name, x in (("k", k), ("v", v), ("log_w", log_w)):
        _check(name, x, tuple(r.shape), r.device)
    if s0 is not None:
        _check("s0", s0, lead + (n, n), r.device)


class _WKV(torch.autograd.Function):
    """K5 forward, K5b backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0):
        o, s = _wkv_forward(r, k, v, log_w, u, s0)
        ctx.save_for_backward(r, k, v, log_w, u, s0)
        ctx.set_materialize_grads(False)
        return o, s

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, log_w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r, dtype=torch.float32)
        return wkv_chunked_bwd(r, k, v, log_w, u, s0, do, ds)


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
    ``wkv_chunked_plain``.

    Differentiable: when a gradient is to be taken through any input, the
    call goes through an autograd function whose backward is
    ``wkv_chunked_bwd`` (K5b on the card, ``wkv_chunked_bwd_plain`` on the
    CPU), which recomputes the chunk-start states from the saved inputs."""
    _check_all(r, k, v, log_w, s0)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (r, k, v, log_w, u, s0)):
        return _WKV.apply(r, k, v, log_w, u, s0)
    return _wkv_forward(r, k, v, log_w, u, s0)


def _wkv_forward(r, k, v, log_w, u, s0):
    lead = _lanes(r)
    t, n = r.shape[-2:]
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


# ---------------------------------------------------------------------------
# K5b: the backward
# ---------------------------------------------------------------------------

def _reduce_bonus(du: torch.Tensor, u: torch.Tensor,
                  lead: tuple[int, ...]) -> torch.Tensor:
    """Per-lane du [*lead, n] summed over the lanes ``u`` is shared by, to
    ``u``'s shape (see ``_bonus``)."""
    n = du.shape[-1]
    if tuple(u.shape) == lead + (n,):
        out = du
    elif len(lead) == 2 and tuple(u.shape) == lead[1:] + (n,):
        out = du.sum(dim=0)
    else:
        out = du.reshape(-1, n).sum(dim=0)
    return out.to(u.dtype)


def _bwd_chunks(r, k, v, log_w, do):
    """The five [BH, T, n] operands as float32 [BH, NC, C, n] chunks (T
    padded with zeros to a multiple of ``CHUNK``, as the forward pads it)
    and each chunk's exponentials: e^(L - log w), e^-L, e^(Λ - L) and e^Λ
    ([BH, NC, n]), L the inclusive cumsum of log w in the chunk and Λ its
    last step."""
    t, n = r.shape[-2:]
    bh = math.prod(_lanes(r))
    pad = (-t) % CHUNK
    xs = [x.float().reshape(bh, t, n) for x in (r, k, v, log_w, do)]
    if pad:
        xs = [torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in xs]
    xs = [x.reshape(bh, -1, CHUNK, n) for x in xs]
    lcw = torch.cumsum(xs[3], dim=2)
    total = lcw[:, :, -1:]
    exps = (torch.exp(lcw - xs[3]), torch.exp(-lcw), torch.exp(total - lcw),
            torch.exp(total[:, :, 0]))
    return xs, exps


def _bwd_state_sweep(k_s: torch.Tensor, vs: torch.Tensor, e_t: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """K5b's first sweep: the state at each chunk's start, [BH, NC, n, n],
    from S_0 = ``s`` by S_{c+1} = diag(e^Λ) S_c + (k e^(Λ-L))^T v."""
    starts = []
    for c in range(k_s.shape[1]):
        starts.append(s)
        s = s * e_t[:, c, :, None] + torch.einsum("btn,btm->bnm", k_s[:, c],
                                                  vs[:, c])
    return torch.stack(starts, 1)


def _bwd_cotangent_sweep(r_t: torch.Tensor, dos: torch.Tensor,
                         e_t: torch.Tensor, ds: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5b's second sweep, from the last chunk to the first: the cotangent
    of each chunk's end state, [BH, NC, n, n], from ``ds`` (the final
    state's) by dS_{c-1} = diag(e^Λ) dS_c + (r e^E)^T dO; and the cotangent
    of the start state, ds0."""
    ends = [None] * r_t.shape[1]
    for c in reversed(range(r_t.shape[1])):
        ends[c] = ds
        ds = ds * e_t[:, c, :, None] + torch.einsum("btn,btm->bnm", r_t[:, c],
                                                    dos[:, c])
    return torch.stack(ends, 1), ds


def _bwd_chunk_pass(xs, exps, uu, sc, dsc):
    """K5b's chunk pass, batched over chunks: from each chunk's operands
    ``xs`` ([BH, NC, C, n]), its exponentials, the bonus ``uu`` ([BH, 1, 1,
    n]), its start state ``sc`` and its end cotangent ``dsc`` ([BH, NC, n,
    n]), the chunk's (dr, dk, dv, dlog w), [BH, NC, C, n] each, and du,
    [BH, n]."""
    rs, ks, vs, _, dos = xs
    e_r, e_k, e_s, e_t = exps
    r_t, k_t, k_s = rs * e_r, ks * e_k, ks * e_s
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=rs.device), diagonal=-1)
    a = torch.where(tri, torch.einsum("bctn,bcin->bcti", r_t, k_t), 0.0)
    diag = torch.einsum("bctn,bctn->bct", rs * uu, ks)
    da = torch.where(tri, torch.einsum("bctm,bcim->bcti", dos, vs), 0.0)
    ddiag = torch.einsum("bctm,bctm->bct", dos, vs)
    dv = torch.einsum("bcti,bctm->bcim", a, dos) + diag[..., None] * dos + \
        torch.einsum("bctn,bcnm->bctm", k_s, dsc)
    dr_t = torch.einsum("bcti,bcin->bctn", da, k_t) + \
        torch.einsum("bctm,bcnm->bctn", dos, sc)
    dk_t = torch.einsum("bcti,bctn->bcin", da, r_t)
    dk_s = torch.einsum("bctm,bcnm->bctn", vs, dsc)
    g_r, g_k, g_s = dr_t * r_t, dk_t * k_t, dk_s * k_s
    dr = dr_t * e_r + ddiag[..., None] * uu * ks
    dk = dk_t * e_k + dk_s * e_s + ddiag[..., None] * uu * rs
    suffix = torch.flip(torch.cumsum(torch.flip(g_r, [2]), 2), [2])
    suffix_k = torch.flip(torch.cumsum(torch.flip(g_k, [2]), 2), [2])
    state = e_t * (sc * dsc).sum(-1)                        # [BH, NC, n]
    dw = (suffix - g_r) - suffix_k + (torch.cumsum(g_s, 2) - g_s) + \
        state[:, :, None]
    du = torch.einsum("bct,bctn->bn", ddiag, rs * ks)
    return dr, dk, dv, dw, du


def wkv_chunked_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_w: torch.Tensor, u: torch.Tensor,
                          s0: torch.Tensor | None, do: torch.Tensor,
                          ds: torch.Tensor | None = None) -> tuple:
    """Plain torch version of K5b: the gradients of ``wkv_chunked_plain``
    at (r, k, v, log_w, u, s0) given the cotangents ``do`` of ``o`` and
    ``ds`` of the final state (zero when None): ``(dr, dk, dv, dlog_w, du,
    ds0)``, ``du`` in u's shape and ``ds0`` None when ``s0`` is.

    The chunk algebra run backward, in K5b's three passes.  With L the
    inclusive cumsum of log w in a chunk, E = L - log w, Λ = L_C, r~ = r
    e^E, k~ = k e^-L, k^ = k e^(Λ-L) and A = r~ k~^T (strictly lower):

    1. a state sweep (``_bwd_state_sweep``), forward: each chunk's start
       state S_c, by S_{c+1} = diag(e^Λ) S_c + k^^T v;
    2. a cotangent sweep (``_bwd_cotangent_sweep``), backward: the
       cotangent dS_c of each chunk's end state, by dS_{c-1} = diag(e^Λ)
       dS_c + r~^T dO from dS_T = ``ds``; what it carries past chunk 0 is
       ds0;
    3. the chunk pass (``_bwd_chunk_pass``), every chunk at once:

        dA = (dO V^T) strictly lower,  dv = A^T dO + diag dO + k^ dS_c
        dr~ = dA k~ + dO S_c^T,  dk~ = dA^T r~,  dk^ = V dS_c^T
        dr = dr~ e^E + (dO.v) u k,  dk = dk~ e^-L + dk^ e^(Λ-L) + (dO.v) u r
        dlog_w_j = sum_{t>j} dr~ r~ - sum_{t>=j} dk~ k~ + sum_{t<j} dk^ k^
                   + e^Λ rowsum(S_c o dS_c)

    and du = sum over every step of (dO.v) r k.  Ragged T is padded as the
    forward pads it; the padded steps have r = k = v = dO = 0 and add
    nothing."""
    lead, (t, n) = _lanes(r), r.shape[-2:]
    bh = math.prod(lead)
    uu = _bonus(u, lead, n).float().reshape(bh, 1, 1, n)
    xs, exps = _bwd_chunks(r, k, v, log_w, do)
    rs, ks, vs, _, dos = xs
    e_r, _, e_s, e_t = exps
    zeros = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    sc = _bwd_state_sweep(ks * e_s, vs, e_t, zeros if s0 is None
                          else s0.float().reshape(bh, n, n))
    dsc, ds0 = _bwd_cotangent_sweep(rs * e_r, dos, e_t, zeros if ds is None
                                    else ds.float().reshape(bh, n, n))
    grads = _bwd_chunk_pass(xs, exps, uu, sc, dsc)

    def out(g, like):
        return g.reshape(bh, -1, n)[:, :t].reshape(like.shape).to(like.dtype)

    dr, dk, dv, dw = (out(g, x) for g, x in zip(grads, (r, k, v, log_w)))
    du = _reduce_bonus(grads[4].reshape(*lead, n), u, lead)
    ds0 = None if s0 is None else ds0.reshape(s0.shape).to(s0.dtype)
    return dr, dk, dv, dw, du, ds0


def wkv_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_w: torch.Tensor, u: torch.Tensor,
                    s0: torch.Tensor | None, do: torch.Tensor,
                    ds: torch.Tensor | None = None) -> tuple:
    """The gradients of ``wkv_chunked``: ``(dr, dk, dv, dlog_w, du, ds0)``
    (see ``wkv_chunked_bwd_plain``).  CUDA tensors launch K5b
    (``csrc/wkv_bwd.cu``, the plain version's three passes: both sweeps at
    once, one block a lane each, writing the chunk-start states and the
    chunk-end cotangents to scratch the wrapper allocates, [lanes, ceil(T /
    32), n, n4] float32 each with n4 = n rounded up to a multiple of 4,
    then one block a (lane, chunk), whose du partials, [lanes, ceil(T /
    32), 64], are added in chunk order; no atomics), CPU tensors run
    ``wkv_chunked_bwd_plain``.  dr, dk, dv and dlog_w take their input's
    layout; du is reduced to u's shape by a sum over the lanes that share
    it.  Every call counts once in ``_build.LAUNCHES["wkv_chunked_bwd"]``."""
    _check_all(r, k, v, log_w, s0)
    _check("do", do, tuple(r.shape), r.device)
    lead = _lanes(r)
    t, n = r.shape[-2:]
    if ds is not None:
        _check("ds", ds, lead + (n, n), r.device)
    if not r.is_cuda:
        return wkv_chunked_bwd_plain(r, k, v, log_w, u, s0, do, ds)
    if n > N_MAX:
        raise ValueError(f"wkv_chunked_bwd: head size {n} > {N_MAX}")
    uu = _bonus(u, lead, n)
    if uu.stride(-1) != 1:
        uu = uu.contiguous()
    su = (uu.stride(0), uu.stride(1) if len(lead) == 2 else 0)
    ins = [x.float() if x.stride(-1) == 1 else x.float().contiguous()
           for x in (r, k, v, log_w, do)]
    outs = [torch.empty_like(x) for x in ins[:4]]
    lanes = math.prod(lead)
    nb, nh = (lead[0], 1) if len(lead) == 1 else lead
    n4 = -(-n // 4) * 4
    scratch = torch.empty(lanes * -(-t // CHUNK) * (2 * n * n4 + N_MAX),
                          dtype=torch.float32, device=r.device)
    du = torch.empty((lanes, n), dtype=torch.float32, device=r.device)
    s_in = s0.float().contiguous() if s0 is not None else None
    ds_in = ds.float().contiguous() if ds is not None else None
    ds0 = (torch.empty(lead + (n, n), dtype=torch.float32, device=r.device)
           if s0 is not None else None)
    strides = (ctypes.c_longlong * 29)(*(
        s for x in (*ins, *outs) for s in _lane_strides(x)), *su)
    lib = _build.load()
    code = lib.wkv_chunked_bwd(
        *(x.data_ptr() for x in outs), du.data_ptr(),
        ds0.data_ptr() if ds0 is not None else None,
        *(x.data_ptr() for x in ins), uu.data_ptr(),
        s_in.data_ptr() if s_in is not None else None,
        ds_in.data_ptr() if ds_in is not None else None, scratch.data_ptr(),
        nb, nh, t, n, strides, _build.stream_ptr(r.device))
    _build.LAUNCHES["wkv_chunked_bwd"] += 1
    _build.check(code, "wkv_chunked_bwd")
    dr, dk, dv, dw = (o.to(x.dtype) for o, x in zip(outs, (r, k, v, log_w)))
    return (dr, dk, dv, dw, _reduce_bonus(du.reshape(*lead, n), u, lead),
            None if ds0 is None else ds0.to(s0.dtype))
