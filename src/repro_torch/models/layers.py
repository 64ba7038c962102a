"""Core NN layers of the LM substrate (the port of ``repro.models.layers``).

Every layer takes the reference's sharding hook: ``shard(x, name)``
(``parallel.sharding.make_shard_fn``) places an activation by its rule on
a mesh and is ``no_shard`` otherwise, so the same code runs on plain
tensors on one device and on DTensors on a mesh.  Attention goes through
``repro_torch.kernels.ops.flash_attention``: K4 on the card, its plain
version on the CPU, with the local window of the hybrid family
(``window > 0``) inside the kernel.  No DTensor goes into the kernel: on a
mesh, q, k and v are placed over heads and K4 runs on each rank's heads
(``local_heads``).  ``remat`` is the reference's
``jax.checkpoint(..., nothing_saveable)`` around a layer.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.parallel import sharding as shlib

__all__ = ["Shard", "no_shard", "rms_norm", "dense", "split_heads", "swiglu",
           "rope", "m_rope", "apply_rope", "attention", "remat"]

Shard = Callable[[torch.Tensor, str], torch.Tensor]


def no_shard(x: torch.Tensor, name: str) -> torch.Tensor:   # noqa: ARG001
    return x


def remat(fn, *args):
    """``fn(*args)``, rematerialised when a gradient will be taken through
    it (grad mode on and a tensor among ``args``, nested dicts and lists
    included, that requires grad): only ``args`` are kept and ``fn`` runs
    again in the backward (``torch.utils.checkpoint``, non-reentrant).
    Otherwise, as when serving, a plain call."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in tree_lib.leaves(list(args))):
        return torch.utils.checkpoint.checkpoint(
            _in_mesh_context(fn), *args, use_reentrant=False,
            preserve_rng_state=False)
    return fn(*args)


def _in_mesh_context(fn):
    """``fn`` run under DTensor's implicit replication when its arguments
    hold a DTensor: the backward's recomputation runs outside the
    caller's context."""
    def run(*args):
        with shlib.mesh_context(list(args)):
            return fn(*args)
    return run


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back, then scale in ``x``'s type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w`` in ``x``'s type (float32 weights are cast per call, as the
    reference's ``w.astype(x.dtype)``).  On a mesh x's middle dims (the
    sequence) are gathered first (``rows_whole``), and so are those of the
    product's gradient in the backward (``_RowsWholeGrad``)."""
    if shlib.is_dtensor(x):
        y = _RowsWholeGrad.apply(rows_whole(x) @ w.to(x.dtype))
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def rows_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every dim but the first and the last whole on each rank
    (a DTensor's shards there gathered; a plain tensor as it is): the
    all-gather of the sequence before a product, as Megatron's sequence
    parallelism does.  Flattening a sharded batch dim with a sharded
    sequence dim (a matmul's view to 2-D, the MoE's token groups) makes a
    strided shard, whose redistributions DTensor plans by a graph search
    that takes a minute a product on a 3-D mesh."""
    if not shlib.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1 else p
            for p in x.placements]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(y: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, L, H * Dh] projection ``y`` as [B, L, H, Dh] heads.

    On a mesh the projection's last dim is split over "model" (its weight's
    p_df columns), evenly, and DTensor can view that split into heads only
    when ``heads`` divides it.  Where it does not (24 heads over 16 ranks),
    the last dim is gathered first and the view is whole; ``shard(..,
    "heads")`` then splits the heads as ``torch.chunk`` does, and
    ``local_heads`` takes each rank's share.  The output is gathered rather
    than the weight: the weight's columns cannot be split by whole heads
    without the same view in its gradient, and ``local_heads`` gathers k
    and v over the head dims anyway."""
    b, seq, width = y.shape
    if shlib.is_dtensor(y):
        n = 1
        for i, p in enumerate(y.placements):
            if p.is_shard(2):
                n *= y.device_mesh.size(i)
        if heads % n:
            from torch.distributed.tensor import Replicate
            whole = y.redistribute(y.device_mesh, [
                Replicate() if p.is_shard(2) else p for p in y.placements])
            return shlib.grad_as_forward(
                whole.view(b, seq, heads, width // heads))
    return y.view(b, seq, heads, width // heads)


class _RowsWholeGrad(torch.autograd.Function):
    """The identity, whose backward takes the gradient through
    ``rows_whole``: a product's output gradient may come back with its
    sequence sharded (from a residual add with an SP-sharded operand), and
    the product's backward would flatten it with the batch (see
    ``rows_whole``)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rows_whole(g)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, shard: Shard = no_shard) -> torch.Tensor:
    h = F.silu(dense(x, w_gate)) * dense(x, w_up)
    h = shard(h, "ffn_hidden")
    return dense(h, w_down)


def rope(positions: torch.Tensor, head_dim: int,
         theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., L] -> (sin, cos) of shape [..., L, head_dim // 2]."""
    freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=positions.device) / head_dim))
    ang = positions[..., None].float() * freq
    return torch.sin(ang), torch.cos(ang)


def m_rope(positions: torch.Tensor, head_dim: int, sections: tuple[int, ...],
           theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.  positions [B, 3, L] (t, h, w component
    ids); ``sections`` splits the head_dim // 2 frequency slots over the
    three components in order (e.g. (16, 24, 24) for head_dim 128).
    Returns (sin, cos) of shape [B, L, head_dim // 2]."""
    half = head_dim // 2
    if positions.dim() != 3 or positions.shape[1] != len(sections) \
            or sum(sections) != half:
        raise ValueError(f"m_rope: positions {tuple(positions.shape)}, "
                         f"sections {sections}, head_dim {head_dim}")
    freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=positions.device) / head_dim))
    comp = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.tensor(sections, device=positions.device),
        output_size=half)                                       # [half]
    pos = positions.float()[:, comp]                            # [B, half, L]
    ang = pos.transpose(1, 2) * freq                            # [B, L, half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, D]; sin/cos: [L, D/2] or [B, L, D/2] (broadcast over H).
    The rotation runs in float32 and is cast back to ``x``'s type."""
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    if shlib.is_dtensor(x):
        # the tables are the same on every rank: replicated DTensors, so
        # that the backward, outside any implicit replication, takes them
        sin, cos = (shlib.replicate_like(t, x) for t in (sin, cos))
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len: int | None = None,
              window: int = 0, site: str | None = None,
              shard: Shard = no_shard) -> torch.Tensor:
    """GQA attention, q [B, Lq, Hq, D] and k, v [B, Lk, Hkv, D] with
    ``Hq % Hkv == 0``, over the first ``kv_len`` keys (all when None).  The
    causal diagonal is aligned to the end of the valid keys, so query ``i``
    sits at position ``kv_len - Lq + i``: the reference's ``q_offset`` is 0
    for a full sequence and ``pos`` for a decode step over the cache, both
    that alignment.  ``window > 0`` keeps the last ``window`` key positions
    up to each query's own, as the reference's local attention does (both
    of its branches, the masked blockwise one and ``_attention_banded``).
    ``site`` tags the kernel's launch count.

    On a mesh K4 takes whole heads, so q, k and v go in placed over heads
    (where the reference's blockwise jnp attention places its query rows
    by "attn_q_seq" and replicates k and v by "attn_kv_rep") and the
    output comes back so (its "attn_acc_seq"), then by "attn_out"."""
    q = shard(q, "heads")
    k = shard(k, "heads")
    v = shard(v, "heads")
    if shlib.is_dtensor(q):
        out = local_heads(
            lambda ql, kl, vl: ops.flash_attention(
                ql, kl, vl, causal=causal, lk_valid=kv_len, window=window,
                site=site), q, k, v)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, lk_valid=kv_len,
                                  window=window, site=site)
    out = shard(out, "heads")
    return shard(out, "attn_out")


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (a kernel over [B, L, H, D] heads, GQA when k and v
    have fewer) on each rank's own heads of DTensors ``q``, ``k``, ``v``;
    returns the output as a DTensor placed as ``q`` is.  ``q`` may be
    sharded over batch (dim 0) and heads (dim 2) only.

    When k and v hold the heads that this rank's q heads read (each is
    split evenly over the same mesh dims, so the local groups line up), the
    kernel takes the three local tensors as they are.  Otherwise (heads
    that do not divide the model axis, which DTensor splits as
    ``torch.chunk`` does, the last ranks short or empty; or fewer kv heads
    than ranks) k and v are gathered over the head dims, and each local q
    head reads its own kv head (one kv head a q head); their gradients are
    then partial sums over those dims.  A rank with no heads returns an
    empty slice without calling the kernel (k and v then hold no heads
    either: ``idx`` is empty)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = q.device_mesh
    for p in q.placements:
        if p.is_shard() and p.dim not in (0, 2):
            raise ValueError(f"local_heads: q is sharded on dim {p.dim}")
    head_dims = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    n = 1
    for i in head_dims:
        n *= mesh.size(i)
    hq, hkv = q.shape[2], k.shape[2]
    aligned = (k.placements == q.placements == v.placements
               and hq % n == 0 and hkv % n == 0)
    ql = q.to_local()
    if aligned:
        kl, vl = k.to_local(), v.to_local()
    else:
        keep = [Replicate() if i in head_dims else p
                for i, p in enumerate(q.placements)]
        grad = [Partial() if i in head_dims else p
                for i, p in enumerate(keep)]
        kl, vl = (x.redistribute(mesh, keep).to_local(grad_placements=grad)
                  for x in (k, v))
        off = shlib.global_offset(q)[2]
        idx = torch.div(off + torch.arange(ql.shape[2], device=ql.device),
                        hq // hkv, rounding_mode="floor")
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    # a rank with no heads adds the sums of its empty k and v slices to
    # its empty q: an empty output whose backward still reaches k and v,
    # so that every rank runs the collectives of their gradients
    out = fn(ql, kl, vl) if ql.shape[2] else ql + (kl.sum() + vl.sum())
    # contiguous, as the global stride given says (a kernel's plain
    # version may return a permuted view)
    return DTensor.from_local(out.contiguous(), mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())
