"""GShard-style mixture-of-experts feed-forward (the port of
``repro.models.moe``).

Routing runs over fixed-size token groups (``cfg.moe_group``, halved until
it divides the token count) with capacity ``C = group * k * factor / E``
slots an expert: the position of a token in its expert's buffer is the
running count of the tokens before it in the group (GShard's iterative
top-k cumsum), and a token past capacity is dropped.  The dispatch and
combine tensors are one-hot [Gn, G, E, C] as in the reference, cast to the
activation type before the einsums, and the expert products are
``torch.einsum`` (the reference leaves them to XLA; no kernel replaces
them).  The router runs in float32; ``torch.argmax`` takes the first of
equal maxima, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = ["init_moe", "apply_moe", "expert_capacity"]


def expert_capacity(cfg: ModelConfig, group: int) -> int:
    c = group * cfg.experts_per_token * cfg.moe_capacity_factor
    c = int(-(-c // cfg.num_experts))
    return max(4, min(c, group))


def init_moe(cfg: ModelConfig, num_layers: int, normal) -> dict:
    """Stacked-on-L expert parameters; ``normal(shape, fan_in)`` draws
    N(0, 1 / fan_in) (``transformer.init_params``'s generator)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": normal((num_layers, d, e), 1.0).mul_(0.02),
        "we_gate": normal((num_layers, e, d, f), d),
        "we_up": normal((num_layers, e, d, f), d),
        "we_down": normal((num_layers, e, f, d), f),
    }


def _top_k_dispatch(probs: torch.Tensor, k: int, capacity: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """probs [Gn, G, E] -> (dispatch [Gn, G, E, C] one-hot, combine
    [Gn, G, E, C] gate-weighted), in ``probs``' type."""
    gn, g, e = probs.shape
    dt = probs.dtype
    remaining = probs
    fill = torch.zeros((gn, e), dtype=torch.int32, device=probs.device)
    dispatch = torch.zeros((gn, g, e, capacity), dtype=dt,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                   # [Gn, G]
        onehot = F.one_hot(idx, e).to(dt)                       # [Gn, G, E]
        gate = (remaining * onehot).sum(-1)                     # [Gn, G]
        # position of each token within its chosen expert's buffer
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos_tok = (pos * onehot).sum(-1).to(torch.int32)        # [Gn, G]
        keep = pos_tok < capacity
        slot = F.one_hot(torch.where(keep, pos_tok, capacity).long(),
                         capacity + 1).to(dt)[..., :capacity]
        sel = onehot[..., None] * slot[:, :, None, :]           # [Gn,G,E,C]
        dispatch = dispatch + sel
        combine = combine + sel * gate[:, :, None, None]
        fill = fill + (onehot * keep[..., None]).sum(dim=1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def _aux_loss(probs: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """Load-balancing loss: E * sum_e mean_prob_e * mean_assigned_frac_e."""
    e = probs.shape[-1]
    mean_prob = probs.mean(dim=(0, 1))                          # [E]
    frac = dispatch.sum(dim=-1).mean(dim=(0, 1))                # [E]
    return e * (mean_prob * frac).sum()


def route(cfg: ModelConfig, x: torch.Tensor, router_w: torch.Tensor
          ) -> tuple[torch.Tensor, int]:
    """The router's probabilities [Gn, G, E] (float32) for x [B, S, D], and
    the group size."""
    b, s, d = x.shape
    t = b * s
    group = min(cfg.moe_group, t)
    while t % group != 0:
        group //= 2
    xg = x.reshape(t // group, group, d)
    logits = xg.float() @ router_w.float()
    return torch.softmax(logits, dim=-1), group


def apply_moe(cfg: ModelConfig, x: torch.Tensor, router_w: torch.Tensor,
              we_gate: torch.Tensor, we_up: torch.Tensor,
              we_down: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss float32 scalar)."""
    b, s, d = x.shape
    probs, group = route(cfg, x, router_w)
    cap = expert_capacity(cfg, group)
    dispatch, combine = _top_k_dispatch(probs, cfg.experts_per_token, cap)
    aux = _aux_loss(probs, dispatch)

    dt = x.dtype
    xg = x.reshape(-1, group, d)
    dispatch, combine = dispatch.to(dt), combine.to(dt)
    # tokens into per-expert buffers [E, Gn, C, D]
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, we_gate.to(dt)))
    h = h * torch.einsum("egcd,edf->egcf", xe, we_up.to(dt))
    ye = torch.einsum("egcf,efd->egcd", h, we_down.to(dt))
    # back to token order with the gate weights
    out = torch.einsum("gtec,egcd->gtd", combine, ye)
    return out.reshape(b, s, d), aux.float()
