"""Core NN layers of the LM substrate (the port of ``repro.models.layers``).

The reference's ``shard`` hooks are dropped: this slice runs on one device.
Attention goes through ``repro_torch.kernels.ops.flash_attention``: K4 on
the card, its plain version on the CPU, with the local window of the hybrid
family (``window > 0``) inside the kernel.  ``remat`` is the reference's
``jax.checkpoint(..., nothing_saveable)`` around a layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops

__all__ = ["rms_norm", "dense", "swiglu", "rope", "m_rope", "apply_rope",
           "attention", "remat"]


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
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back, then scale in ``x``'s type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w`` in ``x``'s type (float32 weights are cast per call, as the
    reference's ``w.astype(x.dtype)``)."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(x, w_gate)) * dense(x, w_up)
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
        torch.tensor(sections, device=positions.device))       # [half]
    pos = positions.float()[:, comp]                            # [B, half, L]
    ang = pos.transpose(1, 2) * freq                            # [B, L, half]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, D]; sin/cos: [L, D/2] or [B, L, D/2] (broadcast over H).
    The rotation runs in float32 and is cast back to ``x``'s type."""
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len: int | None = None,
              window: int = 0, site: str | None = None) -> torch.Tensor:
    """GQA attention, q [B, Lq, Hq, D] and k, v [B, Lk, Hkv, D] with
    ``Hq % Hkv == 0``, over the first ``kv_len`` keys (all when None).  The
    causal diagonal is aligned to the end of the valid keys, so query ``i``
    sits at position ``kv_len - Lq + i``: the reference's ``q_offset`` is 0
    for a full sequence and ``pos`` for a decode step over the cache, both
    that alignment.  ``window > 0`` keeps the last ``window`` key positions
    up to each query's own, as the reference's local attention does (both
    of its branches, the masked blockwise one and ``_attention_banded``).
    ``site`` tags the kernel's launch count."""
    return ops.flash_attention(q, k, v, causal=causal, lk_valid=kv_len,
                               window=window, site=site)
