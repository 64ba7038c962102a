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

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shlib

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


def _groups(cfg: ModelConfig, x: torch.Tensor,
            shard: layers.Shard = layers.no_shard):
    """x [B, S, D] as token groups [Gn, G, D], and G."""
    b, s, d = x.shape
    t = b * s
    group = min(cfg.moe_group, t)
    while t % group != 0:
        group //= 2
    # on a mesh the sequence is gathered before the [B, S] -> [Gn, G]
    # merge (``layers.rows_whole``)
    xg = shard(layers.rows_whole(x).reshape(t // group, group, d),
               "moe_tokens")
    return xg, group


def route(cfg: ModelConfig, x: torch.Tensor, router_w: torch.Tensor
          ) -> tuple[torch.Tensor, int]:
    """The router's probabilities [Gn, G, E] (float32) for x [B, S, D], and
    the group size."""
    xg, group = _groups(cfg, x)
    return _probs(xg, router_w), group


def _probs(xg: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    return torch.softmax(layers.dense(xg.float(), router_w.float()), dim=-1)


def _dispatch(probs: torch.Tensor, k: int, capacity: int):
    """``_top_k_dispatch``; on a mesh on each rank's own groups (routing
    never crosses a group), the routing ops (argmax, one_hot, cumsum) on
    local tensors, and the two tensors placed back as ``probs`` is."""
    if not shlib.is_dtensor(probs):
        return _top_k_dispatch(probs, k, capacity)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = probs.device_mesh
    keep = [p if p.is_shard(0) else Replicate() for p in probs.placements]
    local = probs.redistribute(mesh, keep).to_local()
    dispatch, combine = _top_k_dispatch(local, k, capacity)
    shape = tuple(probs.shape) + (capacity,)
    return tuple(DTensor.from_local(t, mesh, keep, run_check=False,
                                    shape=shape,
                                    stride=torch.empty(shape,
                                                       device="meta").stride())
                 for t in (dispatch, combine))


def apply_moe(cfg: ModelConfig, x: torch.Tensor, router_w: torch.Tensor,
              we_gate: torch.Tensor, we_up: torch.Tensor,
              we_down: torch.Tensor, shard: layers.Shard = layers.no_shard
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss float32 scalar)."""
    b, s, d = x.shape
    xg, group = _groups(cfg, x, shard)
    probs = _probs(xg, router_w)
    cap = expert_capacity(cfg, group)
    dispatch, combine = _dispatch(probs, cfg.experts_per_token, cap)
    aux = _aux_loss(probs, dispatch)

    dt = x.dtype
    dispatch, combine = dispatch.to(dt), combine.to(dt)
    if shlib.is_dtensor(xg):
        out = _experts_mesh(xg, dispatch, combine, we_gate, we_up, we_down,
                            shard)
        return out.reshape(b, s, d), aux.float()
    # tokens into per-expert buffers [E, Gn, C, D]
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    xe = shard(xe, "moe_experts")
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, we_gate.to(dt)))
    h = h * torch.einsum("egcd,edf->egcf", xe, we_up.to(dt))
    ye = torch.einsum("egcf,efd->egcd", h, we_down.to(dt))
    ye = shard(ye, "moe_experts")
    # back to token order with the gate weights
    out = torch.einsum("gtec,egcd->gtd", combine, ye)
    out = shard(out, "moe_tokens")
    return out.reshape(b, s, d), aux.float()


def _experts_mesh(xg, dispatch, combine, we_gate, we_up, we_down, shard):
    """The expert half of ``apply_moe`` on a mesh: its four products as
    local einsums between the layouts the reference's rules set (tokens by
    "moe_tokens", expert buffers by "moe_experts").  DTensor runs an einsum
    as reshapes and a bmm, and the reshapes of these sharded operands make
    strided shards, whose redistributions take minutes to plan (see
    ``layers.rows_whole``); here every product is local and the layout
    changes are explicit redistributions.

    * dispatch: each rank's token groups into [E, Gn, C, D] buffers, then
      placed by "moe_experts" (experts over "model": EP);
    * the experts' SwiGLU: each rank's experts, with their weights
      gathered but for the expert dim;
    * combine: each rank's groups and experts, a partial sum over the
      expert-sharded mesh dims, placed by "moe_tokens"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, dt = xg.device_mesh, xg.dtype
    tok = [p if p.is_shard(0) else Replicate() for p in xg.placements]
    e, (gn, g, d), cap = dispatch.shape[2], xg.shape, dispatch.shape[3]

    def local(x, pl):
        return x.redistribute(mesh, pl).to_local()

    def glob(x, pl, shape):
        return DTensor.from_local(x, mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    xe = torch.einsum("gtec,gtd->egcd", local(dispatch, tok), local(xg, tok))
    xe = shard(glob(xe, [Shard(1) if p.is_shard(0) else p for p in tok],
                    (e, gn, cap, d)), "moe_experts")
    ex = [p if p.is_shard(0) else Replicate() for p in xe.placements]
    xl = local(xe, ex)
    wg, wu, wd = (local(w.to(dt), ex) for w in (we_gate, we_up, we_down))
    h = F.silu(torch.einsum("egcd,edf->egcf", xl, wg))
    h = h * torch.einsum("egcd,edf->egcf", xl, wu)
    ye = glob(torch.einsum("egcf,efd->egcd", h, wd), ex, (e, gn, cap, d))
    ye = shard(ye, "moe_experts")
    # per mesh dim: split by groups where the tokens are, else by experts
    split = ["tok" if t.is_shard(0) else "exp" if x.is_shard(0) else None
             for t, x in zip(tok, ex)]
    ye_pl = [Shard(1) if k == "tok" else Shard(0) if k == "exp"
             else Replicate() for k in split]
    comb_pl = [Shard(0) if k == "tok" else Shard(2) if k == "exp"
               else Replicate() for k in split]
    out = torch.einsum("gtec,egcd->gtd", local(combine, comb_pl),
                       local(ye, ye_pl))
    out_pl = [Shard(0) if k == "tok" else Partial() if k == "exp"
              else Replicate() for k in split]
    return shard(glob(out, out_pl, (gn, g, d)), "moe_tokens")
