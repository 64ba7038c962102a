"""RWKV-6 "Finch": attention-free time mixing with data-dependent decay (the
port of ``repro.models.rwkv6``).

Time mixing per head (head_dim n): state S in R^{n x n},

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

with w_t = exp(-exp(d_t)) a data-dependent per-channel decay, d_t from a
low-rank projection of the token-shifted input.  Every decay exponent is
clamped to 2.5 a step, so no exp() of a 32-token chunk leaves float32.

Prefill runs the chunked WKV through ``repro_torch.kernels.ops.wkv_chunked``
(K5 on the card, its plain chunked version on the CPU) from a zero state and
keeps the final state for the cache.  Decode is the one-token recurrence
``_wkv_step`` in plain torch, as in the reference, which has no kernel for
it.  The reference's ``scan`` over layers is a Python loop; its ``shard``
hooks stay at the reference's sites (``layers.no_shard`` without a mesh).
On a mesh K5 runs on each rank's heads (``_wkv_local``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers, transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shlib

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache",
           "LOG_W_CLAMP"]

LOG_W_CLAMP = 2.5     # max |log w| per step (see module docstring)
LORA_R = 64


def init_params(cfg: ModelConfig, generator: int | torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from an explicit generator (or a seed), in
    ``cfg.param_dtype``, on ``device`` (the reference's layout: per-layer
    tensors stacked on a leading L dim)."""
    dev = resolve_device(device)
    gen = tfm.generator_for(generator, dev)
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    vp, pdt = cfg.padded_vocab, tfm._pdt(cfg)

    def mat(*shape, fan_in):
        return tfm.normal(gen, shape, fan_in, pdt, dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=pdt, device=dev)

    blocks = {
        "ln1": full((nl, d), 1.0),
        "ln2": full((nl, d), 1.0),
        # token-shift lerp coefficients (static): r, k, v, g, w | k2, r2
        "mu": full((nl, 7, d), 0.5),
        "w_r": mat(nl, d, d, fan_in=d),
        "w_k": mat(nl, d, d, fan_in=d),
        "w_v": mat(nl, d, d, fan_in=d),
        "w_g": mat(nl, d, d, fan_in=d),
        "w_o": mat(nl, d, d, fan_in=d),
        "decay_base": full((nl, d), -0.6),     # exp(-exp(-0.6)) ~ 0.58
        "decay_a": mat(nl, d, LORA_R, fan_in=d),
        "decay_b": full((nl, LORA_R, d), 0.0),
        "bonus": full((nl, d), 0.0),           # u
        "ln_x": full((nl, d), 1.0),            # per-head norm gain
        # channel mixing
        "wk2": mat(nl, d, f, fan_in=d),
        "wv2": mat(nl, f, d, fan_in=f),
        "wr2": mat(nl, d, d, fan_in=d),
    }
    return {
        "emb": mat(vp, d, fan_in=1.0).mul_(0.02),
        "head": mat(d, vp, fan_in=d),
        "final_norm": full((d,), 1.0),
        "blocks": blocks,
    }


# --------------------------------------------------------------------------
# pieces
# --------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} along the seq axis; ``prev`` [B, D] seeds t=0 (decode)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _rkvgw(cfg: ModelConfig, x, x_prev, lw):
    """Projections for time mixing.  Returns r,k,v [B,T,H,n] f32,
    g [B,T,D], log_w [B,T,H,n] f32 (negative)."""
    h, n = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    b, t, _ = x.shape
    mu = lw["mu"]
    xr, xk, xv, xg, xw = (_lerp(x, x_prev, mu[i]) for i in range(5))
    r = layers.split_heads(layers.dense(xr, lw["w_r"]).float(), h)
    k = layers.split_heads(layers.dense(xk, lw["w_k"]).float(), h)
    v = layers.split_heads(layers.dense(xv, lw["w_v"]).float(), h)
    g = F.silu(layers.dense(xg, lw["w_g"]))
    dlow = torch.tanh(layers.dense(xw, lw["decay_a"]).float())
    dd = lw["decay_base"].float() + dlow @ lw["decay_b"].float()
    log_w = layers.split_heads(-torch.clamp(torch.exp(dd), 1e-6, LOG_W_CLAMP),
                               h)
    return r, k, v, g, log_w


def _wkv_chunked(r, k, v, log_w, u, s0):
    """Chunked WKV over the [B, T, H, n] layout: r,k,v,log_w f32; u [H, n];
    s0 [B, H, n, n] or None (zero).  Returns (o [B,T,H,n], s_final).  The
    kernel takes (batch, head) as its lanes: the projections go in as
    [B, H, T, n] views, read in place, and o comes back in the same
    layout."""
    if shlib.is_dtensor(r):
        return _wkv_local(r, k, v, log_w, u, s0)
    o, s = ops.wkv_chunked(*(x.permute(0, 2, 1, 3) for x in (r, k, v, log_w)),
                           u, s0)
    return o.permute(0, 2, 1, 3), s


def _wkv_local(r, k, v, log_w, u, s0, fn=None):
    """``fn`` (``_wkv_chunked``, or ``_wkv_step`` for one token) of
    DTensors on each rank's own heads: k, v and log_w are placed as r is
    (over batch and heads; the reference places r and k only, its jnp WKV
    taking any layout), u [H, n] and s0 [B, H, n, n] over the same heads,
    and K5 runs on the local tensors.  The gradient of u, whole on the
    batch dims, is a partial sum there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, pl = r.device_mesh, list(r.placements)
    for p in pl:
        if p.is_shard() and p.dim not in (0, 2):
            raise ValueError(f"_wkv_local: r is sharded on dim {p.dim}")
    k, v, log_w = (x.redistribute(mesh, pl) for x in (k, v, log_w))
    u_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    u_grad = [Partial() if p.is_shard(0) else q for p, q in zip(pl, u_pl)]
    s_pl = [Shard(1) if p.is_shard(2) else p for p in pl]
    ul = u.redistribute(mesh, u_pl).to_local(grad_placements=u_grad)
    sl = None if s0 is None else s0.redistribute(mesh, s_pl).to_local()
    o, s = (fn or _wkv_chunked)(*(x.to_local() for x in (r, k, v, log_w)),
                                ul, sl)
    b, _, h, n = r.shape
    s_shape = (b, h, n, n)
    # o comes back as a permuted view: made contiguous, as the global
    # stride given says
    return (DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                               shape=r.shape,
                               stride=torch.empty(r.shape,
                                                  device="meta").stride()),
            DTensor.from_local(s, mesh, s_pl, run_check=False, shape=s_shape,
                               stride=torch.empty(s_shape,
                                                  device="meta").stride()))


def _wkv_step(r, k, v, log_w, u, s):
    """One-token WKV.  r,k,v,log_w [B,1,H,n]; s [B,H,n,n]."""
    rr, kk, vv, ww = (x[:, 0] for x in (r, k, v, log_w))   # [B,H,n]
    o = torch.einsum("bhn,bhnm->bhm", rr, s) + \
        torch.einsum("bhn,bhn,bhm->bhm", rr * u, kk, vv)
    s_new = s * torch.exp(ww)[..., None] + \
        torch.einsum("bhn,bhm->bhnm", kk, vv)
    return o[:, None], s_new


def _head_norm(cfg: ModelConfig, o: torch.Tensor,
               gain: torch.Tensor) -> torch.Tensor:
    """Per-head layernorm of the WKV output (RWKV's GroupNorm); the
    variance is the population one, as ``jnp.var``."""
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 1e-5)
    b, t = o.shape[:2]
    return o.reshape(b, t, cfg.d_model) * gain.to(o.dtype)


def _time_mix(cfg, x, lw, shard, prev, s0):
    u = lw["bonus"].float().reshape(cfg.num_rwkv_heads, cfg.rwkv_head_dim)
    x_prev = _shift(x, prev)
    r, k, v, g, log_w = _rkvgw(cfg, x, x_prev, lw)
    r = shard(r, "heads")
    k = shard(k, "heads")
    if x.shape[1] == 1:
        o, s = _wkv_local(r, k, v, log_w, u, s0, _wkv_step) \
            if shlib.is_dtensor(r) else _wkv_step(r, k, v, log_w, u, s0)
    else:
        # ops.wkv_chunked takes a ragged T as the reference pads it here
        # (k = v = 0, log_w = 0 on the steps past T)
        o, s = _wkv_chunked(r, k, v, log_w, u, s0)
    o = shard(o.to(x.dtype), "heads")
    o = _head_norm(cfg, o, lw["ln_x"]) * g
    return shard(layers.dense(o, lw["w_o"]), "act_btd"), x[:, -1], s


def _channel_mix(cfg, x, lw, shard, prev):
    x_prev = _shift(x, prev)
    xk = _lerp(x, x_prev, lw["mu"][5])
    xr = _lerp(x, x_prev, lw["mu"][6])
    kk = torch.square(F.relu(layers.dense(xk, lw["wk2"])))
    kk = shard(kk, "ffn_hidden")
    out = torch.sigmoid(layers.dense(xr, lw["wr2"])) * \
        layers.dense(kk, lw["wv2"])
    return shard(out, "act_btd"), x[:, -1]


def _block(cfg, x, lw, cache, shard=layers.no_shard):
    """One layer; ``cache`` None starts from a zero state (prefill, run as
    ``s0 = None``, which K5 reads as zero)."""
    s0 = cache["s"] if cache else None
    if s0 is None and x.shape[1] == 1:
        s0 = torch.zeros((x.shape[0], cfg.num_rwkv_heads, cfg.rwkv_head_dim,
                          cfg.rwkv_head_dim), dtype=torch.float32,
                         device=x.device)
    prev1 = cache["shift1"] if cache else None
    prev2 = cache["shift2"] if cache else None
    h = layers.rms_norm(x, lw["ln1"], cfg.norm_eps)
    a, last1, s = _time_mix(cfg, h, lw, shard, prev1, s0)
    x = x + a
    h = layers.rms_norm(x, lw["ln2"], cfg.norm_eps)
    c, last2 = _channel_mix(cfg, h, lw, shard, prev2)
    x = x + c
    return x, {"s": s, "shift1": last1, "shift2": last2}


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, batch: dict,
            shard: layers.Shard = layers.no_shard,
            collect_cache: bool = False, unembed: bool = True):
    """Returns (logits [B, S, Vp], aux_loss (0), per-layer caches stacked on
    L | None).  With unembed=False, returns the final-norm hidden states.
    Each layer is rematerialised when a gradient is taken
    (``layers.remat``)."""
    x = tfm._embed(cfg, params, batch, shard)
    caches = []
    for lw in tfm.layers_of(params):
        x, c = layers.remat(_block, cfg, x, lw, None, shard)
        if collect_cache:
            caches.append(c)
    stacked = ({key: torch.stack([c[key] for c in caches])
                for key in ("s", "shift1", "shift2")}
               if collect_cache else None)
    if not unembed:
        return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), \
            tfm._zero(x), stacked
    return tfm._unembed(cfg, params, x, shard), tfm._zero(x), stacked


_STATE = ("s", "shift1", "shift2")     # a layer's cache entries


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    del max_len              # O(1) state
    dev = resolve_device(device)
    h, n, nl, d = (cfg.num_rwkv_heads, cfg.rwkv_head_dim, cfg.num_layers,
                   cfg.d_model)
    dt = tfm._dt(cfg)
    return {
        "s": torch.zeros((nl, batch_size, h, n, n), dtype=torch.float32,
                         device=dev),
        "shift1": torch.zeros((nl, batch_size, d), dtype=dt, device=dev),
        "shift2": torch.zeros((nl, batch_size, d), dtype=dt, device=dev),
        "pos": 0,
    }


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int,
            shard: layers.Shard = layers.no_shard):
    """(logits of the last position [B, Vp], cache).  On a mesh the
    cache's leaves are the layers' states stacked (DTensors, placed by the
    reference's cache rules when the caller places them)."""
    x = tfm._embed(cfg, params, batch, shard)
    on_mesh = shlib.is_dtensor(x)
    cache = {} if on_mesh else init_cache(cfg, x.shape[0], max_len, x.device)
    per = {key: [] for key in _STATE}
    for i in range(cfg.num_layers):
        x, c = _block(cfg, x, tfm.layer(params, i), None, shard)
        for key in _STATE:
            if on_mesh:
                per[key].append(c[key])
            else:
                cache[key][i] = c[key]   # in place into the preallocated cache
    if on_mesh:
        cache = {key: torch.stack(per[key]) for key in _STATE}
    cache["pos"] = x.shape[1]
    # unembed the last position only (see transformer.prefill)
    return tfm._unembed(cfg, params, x[:, -1:], shard)[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, shard: layers.Shard = layers.no_shard):
    """tokens [B, 1] -> (logits [B, Vp], cache).  The returned cache holds
    the same state buffers, updated in place, and ``pos + 1`` (on a mesh,
    new DTensors)."""
    x = tfm._embed(cfg, params, {"tokens": tokens}, shard)
    on_mesh = shlib.is_dtensor(cache["s"])
    per = {key: [] for key in _STATE}
    for i in range(cfg.num_layers):
        x, c = _block(cfg, x, tfm.layer(params, i),
                      {key: cache[key][i] for key in _STATE}, shard)
        for key in _STATE:
            if on_mesh:
                per[key].append(c[key])
            else:
                cache[key][i] = c[key]
    logits = tfm._unembed(cfg, params, x, shard)
    if on_mesh:
        cache = dict(cache, **{key: torch.stack(per[key]) for key in _STATE})
    return logits[:, -1], dict(cache, pos=int(cache["pos"]) + 1)
