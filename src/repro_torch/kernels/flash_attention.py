"""Grouped-query attention with an online softmax: the plain torch versions
and the wrapper of the hand-written CUDA kernel K4.

    out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h // g]) v[b, j, h // g]

over the keys ``j < lk_valid`` that query ``i`` may see.  Query ``i``
sits at key position ``i + (lk_valid - Lq)``: with ``causal`` the diagonal
is aligned to the end of the valid keys, as in the reference's TPU kernel
(``repro/kernels/flash_attention.py:45-52``), and a ``window > 0`` keeps
only the last ``window`` positions up to the query's own (the reference's
local attention, ``repro/models/layers.py:206``).  Key ``j`` is seen by
query ``i`` iff

    j < lk_valid,
    j <= i + (lk_valid - Lq)            (causal),
    j >  i + (lk_valid - Lq) - window   (window > 0).

A query that sees no key gives 0.  The softmax runs in float32 and the
output is cast to ``q``'s type.

K4 replaces the TPU kernel ``_flash_kernel`` (via ``flash_attention_pallas``);
in the model it takes the place of the reference's blockwise jnp
``layers.attention`` at prefill and of ``transformer._attention_decode`` at
decode (``Lq = 1``, ``lk_valid = pos + 1``).  On the card it has three
routes, picked by ``flash_route`` from the dtype and the number of rows
(query position x group head, ``Lq * Hq / Hkv``) per (batch, KV head):

* ``"decode"`` (at most ``DECODE_ROWS`` = 16 rows, float32 or bf16: every
  decode step): ``csrc/flash_decode.cu``, the keys cut into splits of
  ``DECODE_SPLIT`` across blocks, one partial (acc, m, l) per split merged
  in split order.  ``flash_attention_split_plain`` is its algebra in torch.
* ``"mma"`` (more rows, bf16: prefill): ``csrc/flash_attention_mma.cu``,
  Q.K^T and P.V on the tensor cores.
* ``"f32"`` (more rows, float32): ``csrc/flash_attention.cu``, Q.K^T and
  P.V on the tensor cores as 3xTF32 (each operand split into a TF32 big
  part and the remainder, three products summed in float32), whose
  rounding ``flash_attention_tf32_plain`` repeats in torch.

Prefill is bound by operations and decode by bytes; see the notes in the
sources.  With a window, routes "mma" and "f32" start each block's key
loop at the first key tile its band reaches, so a banded prefill costs
O(L * (window + tile)), as the reference's ``_attention_banded`` does;
route "decode" skips the splits wholly left of the band.  Head dims up to
``D_MAX`` = 256 run on every route.

``flash_attention`` picks by device: a route's kernel for CUDA tensors (it
masks its ragged edges itself, so nothing is padded, whatever ``Lq`` or
``Lk``), the plain version for CPU tensors.  There is no fallback between
them, and the route never depends on a failure.

The backward is K4b, the FlashAttention-2 algebra in three passes (no
atomics), with ``flash_attention_bwd_plain`` its torch version.  It has two
routes, picked by ``flash_bwd_route`` from the dtype alone, both on the
tensor cores by ``mma.sync``: ``"mma"`` (bf16:
``csrc/flash_attention_bwd_mma.cu``, P and dS split into bf16 high and
low parts, whose rounding ``flash_attention_bwd_mma_plain`` repeats in
torch) and ``"f32"`` (float32: ``csrc/flash_attention_bwd.cu``, every
product 3xTF32, whose rounding ``flash_attention_bwd_tf32_plain`` repeats
in torch).  The reference has no TPU kernel for it: its models
differentiate the jnp ``layers.attention`` (``_attention_banded`` for the
window), which K4 stands in for, through XLA.  ``flash_attention`` is an
autograd function when a gradient is to be taken; each row's log-sum-exp
is recomputed in the backward, so the forward kernels write nothing more
than the output.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_plain", "flash_attention", "flash_route",
           "flash_attention_tf32_plain",
           "flash_attention_bwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_mma_plain", "flash_attention_bwd_tf32_plain",
           "flash_bwd_route", "BWD_ROWS",
           "flash_split_partials_plain", "flash_split_combine_plain",
           "flash_attention_split_plain", "D_MAX", "DECODE_ROWS",
           "DECODE_SPLIT", "NEG"]

D_MAX = 256        # largest head dim K4 takes
DECODE_ROWS = 16   # rows per (batch, KV head) up to which route "decode" runs
DECODE_SPLIT = 64  # keys per split of route "decode" (SPLIT in flash_decode.cu)
NEG = -1.0e30      # the kernels' masked score, and m of a split that saw no key
BWD_ROWS = 128     # K4b: lse and D scratch rows padded to (ROWS_PAD)
BWD_SEG_ROWS = 4096  # K4b "f32": pass 2's rows a segment (SEG_ROWS)


def _scale(d: int, scale: float | None) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _mask(lq: int, kpos: torch.Tensor, valid: int, causal: bool,
          window: int) -> torch.Tensor:
    """[Lq, ...kpos] bool: key position ``kpos`` seen by query ``i`` (the
    module docstring's three conditions)."""
    qpos = torch.arange(lq, device=kpos.device) + (valid - lq)
    qpos = qpos.reshape(lq, *(1,) * kpos.dim())
    mask = (kpos < valid).expand(lq, *kpos.shape)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          lk_valid: int | None = None,
                          window: int = 0) -> torch.Tensor:
    """Plain torch version of K4 (the reference's ``flash_attention_ref``
    with the kernel's ``lk_valid`` mask and the model's local ``window``):
    q [B, Lq, Hq, D], k and v [B, Lk, Hkv, D] with ``Hq % Hkv == 0``."""
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    valid = lk if lk_valid is None else lk_valid
    qf = q.float().reshape(b, lq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * _scale(d, scale)
    mask = _mask(lq, torch.arange(lk, device=q.device), valid, causal,
                 window)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # a row that sees no key
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, 1.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, lq, hq, d).to(q.dtype)


def _fwd_algebra(q, k, v, causal, scale, lk_valid, window, mm=None):
    """Route "f32"'s forward in torch: S = Q K^T, the float32 softmax's
    unnormalised P = exp(S - max), O = P V / sum P.  ``mm`` maps a
    product's name (``"s"``, ``"pv"``) to the function ``(equation, a, b)``
    that runs it (``torch.einsum`` for a name it lacks).  float32."""
    mm = mm or {}
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    valid = lk if lk_valid is None else lk_valid
    qf = q.float().reshape(b, lq, hkv, g, d)
    s = mm.get("s", torch.einsum)("bqhgd,bkhd->bhgqk", qf, k.float()) \
        * _scale(d, scale)
    mask = _mask(lq, torch.arange(lk, device=q.device), valid, causal,
                 window)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # a row that sees no key
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    out = mm.get("pv", torch.einsum)("bhgqk,bkhd->bqhgd", p, v.float())
    den = den.permute(0, 3, 1, 2, 4)             # [b, q, h, g, 1]
    out = out / torch.where(den > 0, den, 1.0)
    return out.reshape(b, lq, hq, d)


def flash_attention_tf32_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               scale: float | None = None,
                               lk_valid: int | None = None,
                               window: int = 0) -> torch.Tensor:
    """Route "f32"'s rounding in torch (used by the tests and
    ``chip_smoke.py``, never on a path): ``flash_attention_plain``'s
    function with S = Q K^T and P V as 3xTF32 (``_mm_3xtf32``), as the
    kernel runs them, the softmax in float32.  float32 in and out."""
    return _fwd_algebra(q, k, v, causal, scale, lk_valid, window,
                        mm=dict.fromkeys(("s", "pv"), _mm_3xtf32))


def flash_route(dtype: torch.dtype, lq: int, g: int) -> str:
    """The route K4 takes on the card for ``lq`` queries of ``g`` query heads
    per KV head: ``"decode"``, ``"mma"`` or ``"f32"``."""
    if lq * g <= DECODE_ROWS:
        return "decode"
    return "mma" if dtype == torch.bfloat16 else "f32"


def _nsplit(lk: int) -> int:
    return max(1, -(-lk // DECODE_SPLIT))


def flash_split_partials_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               scale: float | None = None,
                               lk_valid: int | None = None, window: int = 0
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Route "decode"'s split kernel in torch: per split of ``DECODE_SPLIT``
    keys (``ceil(Lk / DECODE_SPLIT)`` of them) and per row ``r = i * g + h``
    of each KV head, ``acc`` [B, Hkv, S, R, D] = sum_j exp(s_j - m) v_j,
    ``m`` [B, Hkv, S, R] the max masked score (``NEG`` where the split holds
    no key the row sees) and ``l`` [B, Hkv, S, R] = sum_j exp(s_j - m), all
    float32."""
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g, ns = hq // hkv, _nsplit(lk)
    valid = lk if lk_valid is None else lk_valid
    rows, pad = lq * g, ns * DECODE_SPLIT - lk
    qf = q.float().reshape(b, lq, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, rows, d)

    def split(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, ns, DECODE_SPLIT, hkv, d).permute(0, 3, 1, 2, 4)

    kf, vf = split(k), split(v)
    s = torch.einsum("bhrd,bhsjd->bhsrj", qf, kf) * _scale(d, scale)
    kpos = torch.arange(ns * DECODE_SPLIT, device=q.device).reshape(ns, -1)
    # [Lq, S, J] per query position, then per row r = i * g + h: [S, R, J]
    mask = _mask(lq, kpos, valid, causal, window).repeat_interleave(g, 0) \
        .transpose(0, 1)
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1)
    base = torch.where(m == NEG, 0.0, m)
    p = torch.where(mask, torch.exp(s - base[..., None]), 0.0)
    return torch.einsum("bhsrj,bhsjd->bhsrd", p, vf), m, p.sum(dim=-1)


def flash_split_combine_plain(acc: torch.Tensor, m: torch.Tensor,
                              l: torch.Tensor) -> torch.Tensor:
    """Route "decode"'s combine kernel in torch: the splits (axis 2) of
    each row merged in ascending order, ``M = max m_s`` over the splits
    with ``l_s > 0``, ``O = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s``,
    0 where no split saw a key.  A split with ``l_s = 0`` does not count,
    whatever its ``acc`` holds (the kernel leaves it unwritten).
    [B, Hkv, R, D] float32."""
    seen = l > 0
    mmax = torch.where(seen, m, NEG).amax(dim=2, keepdim=True)
    w = torch.where(seen, torch.exp(m - mmax), 0.0)
    num = torch.zeros_like(acc[:, :, 0])
    den = torch.zeros_like(l[:, :, 0])
    for s in range(acc.shape[2]):
        num = num + torch.where(seen[:, :, s, :, None],
                                w[:, :, s, :, None] * acc[:, :, s], 0.0)
        den = den + w[:, :, s] * l[:, :, s]
    return torch.where(den[..., None] > 0,
                       num / torch.where(den > 0, den, 1.0)[..., None], 0.0)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                scale: float | None = None,
                                lk_valid: int | None = None,
                                window: int = 0) -> torch.Tensor:
    """Route "decode"'s split-KV algebra in torch (used by the tests): the
    partials of ``flash_split_partials_plain`` merged by
    ``flash_split_combine_plain``, laid out as ``flash_attention_plain``'s
    output and cast to ``q``'s type."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    out = flash_split_combine_plain(*flash_split_partials_plain(
        q, k, v, causal=causal, scale=scale, lk_valid=lk_valid,
        window=window))
    return out.reshape(b, hkv, lq, hq // hkv, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, lq, hq, d).to(q.dtype)


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


def _args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          lk_valid: int | None, window: int) -> tuple[int, int]:
    """Checks the shapes; returns (lk_valid, window) as ints."""
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
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    return valid, window


class _FlashAttention(torch.autograd.Function):
    """K4 forward, K4b backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, valid, window, site):
        o = _flash_forward(q, k, v, causal, scale, valid, window, site)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = dict(causal=causal, scale=scale, lk_valid=valid,
                        window=window, site=site)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    lk_valid: int | None = None, window: int = 0,
                    site: str | None = None) -> torch.Tensor:
    """GQA attention, q [B, Lq, Hq, D] and k, v [B, Lk, Hkv, D], float32
    or bfloat16; the inputs may be strided views with a contiguous last
    axis (a layer's slice of the KV cache goes in as it is).  CUDA tensors
    launch K4 on the route ``flash_route`` picks, CPU tensors run
    ``flash_attention_plain``.  Every launch counts once in
    ``_build.LAUNCHES["flash_attention"]`` and once under
    ``"flash_attention/route:<route>"`` in ``_build.SITE_LAUNCHES``;
    ``site`` names the caller there too (as ``"flash_attention/<site>"``).

    Differentiable: when a gradient is to be taken through q, k or v, the
    call goes through an autograd function whose backward is
    ``flash_attention_bwd`` (K4b on the card, ``flash_attention_bwd_plain``
    on the CPU), from the saved q, k, v and output."""
    valid, window = _args(q, k, v, lk_valid, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, valid, window,
                                     site)
    return _flash_forward(q, k, v, causal, scale, valid, window, site)


def _flash_forward(q, k, v, causal, scale, valid, window, site):
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     lk_valid=valid, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: float32 or bfloat16 required, "
                         f"got {q.dtype}")
    if d > D_MAX:
        raise ValueError(f"flash_attention: head dim {d} > {D_MAX}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.dtype, q.device)
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
    route = flash_route(q.dtype, lq, hq // hkv)
    lib = _build.load()
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    sc = _scale(d, scale)
    stream = _build.stream_ptr(q.device)
    ptrs = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr())
    if route == "decode":
        part = torch.empty(b * hkv * _nsplit(lk) * lq * (hq // hkv) * (d + 2),
                           dtype=torch.float32, device=q.device)
        code = lib.flash_decode(
            *ptrs, part.data_ptr(), 0 if q.dtype == torch.float32 else 1, b,
            lq, lk, valid, hq, hkv, d, int(causal), window, sc, *strides,
            stream)
    elif route == "mma":
        code = lib.flash_attention_mma(*ptrs, b, lq, valid, hq, hkv, d,
                                       int(causal), window, sc, *strides,
                                       stream)
    else:
        code = lib.flash_attention(*ptrs, b, lq, valid, hq, hkv, d,
                                   int(causal), window, sc, *strides, stream)
    _build.LAUNCHES["flash_attention"] += 1
    _build.SITE_LAUNCHES[f"flash_attention/route:{route}"] += 1
    if site is not None:
        _build.SITE_LAUNCHES[f"flash_attention/{site}"] += 1
    _build.check(code, f"flash_attention ({route})")
    return out


# ---------------------------------------------------------------------------
# K4b: the backward
# ---------------------------------------------------------------------------

def _bf16_split(x: torch.Tensor) -> torch.Tensor:
    """``x`` as route "mma" feeds it to the tensor cores: a bf16 high part
    plus the bf16 rounding of what it leaves out (both round to nearest
    even), summed in float32."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10 explicit
    mantissa bits, to nearest, ties away from zero (half an ulp added to
    the magnitude's bits, the 13 low bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: both operands rounded once."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 3xTF32 product as K4's and K4b's routes "f32" run it: each
    operand split into a TF32 big part and the TF32 rounding of what it
    leaves out, and big . big + big . small + small . big summed in float32
    (small . small, ~2^-22 of a term, dropped).  The kernels hand the
    tensor cores the remainder itself, which they read as TF32 (rounded
    here): either way it is within 2^-21 of the operand of the exact
    remainder."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (torch.einsum(eq, ab, bb) + torch.einsum(eq, ab, b_s)
            + torch.einsum(eq, a_s, bb))


def _bwd_algebra(q, k, v, o, do, causal, scale, lk_valid, window,
                 rnd=None, mm=None):
    """``flash_attention_bwd_plain``'s algebra, with P rounded by ``rnd``
    before dV = P^T dO and dS before dQ and dK when ``rnd`` is given.  dV
    depends only on P's rounding, dQ and dK only on dS's.  ``mm`` maps a
    product's name (``"s"``, ``"dp"``, ``"dv"``, ``"dq"``, ``"dk"``) to the
    function ``(equation, a, b)`` that runs it (``torch.einsum`` for a
    name it lacks)."""
    if rnd is None:
        def rnd(x):
            return x
    mm = mm or {}

    def prod(name, eq, a, b):
        return mm.get(name, torch.einsum)(eq, a, b)

    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    valid = lk if lk_valid is None else lk_valid
    sc = _scale(d, scale)
    qf = q.float().reshape(b, lq, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = prod("s", "bqhgd,bkhd->bhgqk", qf, kf) * sc
    mask = _mask(lq, torch.arange(lk, device=q.device), valid, causal,
                 window)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # a row that sees no key
    den = torch.exp(s - m).sum(dim=-1, keepdim=True)
    lse = m + torch.log(torch.where(den > 0, den, 1.0))
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    del s
    dof = do.float().reshape(b, lq, hkv, g, d)
    dsum = (dof * o.float().reshape(b, lq, hkv, g, d)).sum(-1)  # [b,q,h,g]
    dv = prod("dv", "bhgqk,bqhgd->bkhd", rnd(p), dof)
    dp = prod("dp", "bqhgd,bkhd->bhgqk", dof, vf)
    ds = rnd(p * (dp - dsum.permute(0, 2, 3, 1)[..., None]))
    del p, dp
    dq = prod("dq", "bhgqk,bkhd->bqhgd", ds, kf) * sc
    dk = prod("dk", "bhgqk,bqhgd->bkhd", ds, qf) * sc
    return (dq.reshape(b, lq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# route "f32"'s products: every one 3xTF32
TF32_PRODUCTS = ("s", "dp", "dv", "dq", "dk")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              scale: float | None = None,
                              lk_valid: int | None = None, window: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain torch version of K4b: the gradients (dq, dk, dv) of
    ``flash_attention_plain`` at (q, k, v), given its output ``o`` and the
    output's cotangent ``do``, by the FlashAttention-2 algebra: P recomputed
    from each row's log-sum-exp, D_i = rowsum(dO_i o O_i), dS = P o (dP -
    D) with dP = dO V^T, dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO,
    dK and dV summed over the g query heads of each KV head.  Float32
    throughout, each result cast to its input's type; a row that sees no
    key, and a key no row sees, gives zeros."""
    return _bwd_algebra(q, k, v, o, do, causal, scale, lk_valid, window)


def flash_attention_bwd_mma_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  do: torch.Tensor, *, causal: bool = True,
                                  scale: float | None = None,
                                  lk_valid: int | None = None,
                                  window: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """K4b route "mma"'s rounding in torch (used by the tests and
    ``chip_smoke.py``, never by the wrapper): ``flash_attention_bwd_plain``'s
    algebra with P rounded where the kernel rounds it before dV = P^T dO,
    and dS before dQ = scale dS K and dK = scale dS^T Q, each as a bf16 high
    part plus a bf16 low part (``_bf16_split``); q, k, v and dO are bf16
    already, so no other operand is rounded.  A single bf16 rounding of P
    or dS would miss K4b's bf16 tolerance (``tools/k4b_rounding.py``
    measures by how much)."""
    return _bwd_algebra(q, k, v, o, do, causal, scale, lk_valid, window,
                        _bf16_split)


def flash_attention_bwd_tf32_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor, *, causal: bool = True,
                                   scale: float | None = None,
                                   lk_valid: int | None = None,
                                   window: int = 0
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """K4b route "f32"'s rounding in torch (used by the tests and
    ``chip_smoke.py``, never by the wrapper): ``flash_attention_bwd_plain``'s
    algebra with each of its five products (S = Q K^T, dP = dO V^T, dV =
    P^T dO, dQ = dS K, dK = dS^T Q) run as 3xTF32 (``_mm_3xtf32``), as the
    route runs them on the tensor cores.  A single TF32 rounding of the
    operands would miss K4b's float32 tolerance
    (``tools/k4b_rounding.py --float32`` measures by how much)."""
    return _bwd_algebra(q, k, v, o, do, causal, scale, lk_valid, window,
                        mm=dict.fromkeys(TF32_PRODUCTS, _mm_3xtf32))


def flash_bwd_route(dtype: torch.dtype) -> str:
    """The route K4b takes on the card: ``"mma"`` for bf16, ``"f32"`` for
    float32."""
    return "mma" if dtype == torch.bfloat16 else "f32"


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None,
                        lk_valid: int | None = None, window: int = 0,
                        site: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) from its output
    ``o`` and the cotangent ``do``, in q's type.  CUDA tensors launch K4b
    on the route ``flash_bwd_route`` picks (three kernels, one for each
    row's log-sum-exp and D, one over key tiles for dK and dV, one over
    query tiles for dQ; route "f32" sums dK and dV over segments of
    ``BWD_SEG_ROWS`` rows and, when there are several, adds them in a
    fourth; no atomics), CPU tensors run
    ``flash_attention_bwd_plain``.  Every call counts once in
    ``_build.LAUNCHES["flash_attention_bwd"]`` and once under
    ``"flash_attention_bwd/route:<route>"`` in ``_build.SITE_LAUNCHES``
    (and under ``"flash_attention_bwd/<site>"`` when ``site`` is given)."""
    valid, window = _args(q, k, v, lk_valid, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's {tuple(q.shape)}")
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         scale=scale, lk_valid=valid,
                                         window=window)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: float32 or bfloat16 "
                         f"required, got {q.dtype}")
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if d > D_MAX:
        raise ValueError(f"flash_attention_bwd: head dim {d} > {D_MAX}")
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, x, q.dtype, q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    route = flash_bwd_route(q.dtype)
    # each row's log-sum-exp and D, rows (b, KV head, i * g + h), each (b,
    # KV head)'s rows padded to a multiple of BWD_ROWS
    rows = -(-lq * (hq // hkv) // BWD_ROWS) * BWD_ROWS
    lse = torch.empty(b * hkv * rows, dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]))
    lib = _build.load()
    ptrs = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr()]
    geo = [b, lq, lk, valid, hq, hkv, d, int(causal), window]
    if route == "mma":
        entry = lib.flash_attention_bwd_mma
    else:
        # route "f32" sums dK and dV over segments of BWD_SEG_ROWS rows,
        # each segment's partial sums in scratch when there is more than one
        nseg = -(-lq * (hq // hkv) // BWD_SEG_ROWS)
        part = (torch.empty(nseg * 2 * b * hkv * lk * d, dtype=torch.float32,
                            device=q.device) if nseg > 1 else None)
        entry = lib.flash_attention_bwd
        ptrs.append(part.data_ptr() if part is not None else None)
        geo.append(nseg)
    code = entry(*ptrs, *geo, _scale(d, scale), strides,
                 _build.stream_ptr(q.device))
    _build.LAUNCHES["flash_attention_bwd"] += 1
    _build.SITE_LAUNCHES[f"flash_attention_bwd/route:{route}"] += 1
    if site is not None:
        _build.SITE_LAUNCHES[f"flash_attention_bwd/{site}"] += 1
    _build.check(code, f"flash_attention_bwd ({route})")
    return dq, dk, dv
