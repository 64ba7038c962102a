"""Griffin-style hybrid: RG-LRU recurrent blocks and local attention (the
port of ``repro.models.rglru``; RecurrentGemma-2B, block pattern
rec, rec, attn).

The RG-LRU recurrence

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * r_t * softplus(lambda))  in (0, 1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is a per-channel linear recurrence: prefill runs it as a log-depth
(Hillis-Steele) scan over time in float32, decode as the one-step update.
The reference has no kernel for it, nor for the causal convolution, so both
are plain torch.  The attention layers are local over ``cfg.local_window``
keys: prefill runs K4 with the window (route "mma" in bf16 on the card);
decode keeps a ring-buffer cache of the window, slot ``p % window`` for
position ``p``, and runs K4's decode route over its first
``min(pos + 1, window)`` slots, which are exactly the positions the
reference's ring mask (``kpos >= 0``) keeps.

Parameters keep the reference's layout: ``blocks`` is a list of per-layer
dicts of two kinds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer as tfm
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache"]

_C = 8.0   # RG-LRU decay sharpness constant (Griffin paper)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_rec_layer(cfg: ModelConfig, mat, vec) -> dict:
    d, dr, w = cfg.d_model, cfg.d_rnn_, cfg.conv_width
    return {
        "ln1": vec(d, 1.0),
        "ln2": vec(d, 1.0),
        "w_gate_in": mat(d, dr),       # GeLU gate branch
        "w_rnn_in": mat(d, dr),        # conv -> RG-LRU branch
        "w_out": mat(dr, d),
        "conv_w": mat(w, dr, fan_in=100.0),    # N(0, 0.1^2)
        "conv_b": vec(dr, 0.0),
        "w_a": mat(dr, dr),
        "b_a": vec(dr, 0.0),
        "w_x": mat(dr, dr),
        "b_x": vec(dr, 0.0),
        # lambda so that a^c is ~U(0.9, 0.999) at r = 1 (Griffin appendix)
        "lam": vec(dr, 0.7),
        "wg": mat(d, cfg.d_ff),
        "wu": mat(d, cfg.d_ff),
        "wd": mat(cfg.d_ff, d),
    }


def _init_attn_layer(cfg: ModelConfig, mat, vec) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    return {
        "ln1": vec(d, 1.0),
        "ln2": vec(d, 1.0),
        "wq": mat(d, hq * hd),
        "wk": mat(d, hkv * hd),
        "wv": mat(d, hkv * hd),
        "wo": mat(hq * hd, d),
        "wg": mat(d, f),
        "wu": mat(d, f),
        "wd": mat(f, d),
    }


def init_params(cfg: ModelConfig, generator: int | torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from an explicit generator (or a seed), in
    ``cfg.param_dtype``, on ``device``; the reference's tree and shapes."""
    dev = resolve_device(device)
    gen = tfm.generator_for(generator, dev)
    pdt = tfm._pdt(cfg)

    def mat(i, o, fan_in=None):
        return tfm.normal(gen, (i, o), i if fan_in is None else fan_in, pdt,
                          dev)

    def vec(n, value):
        return torch.full((n,), value, dtype=pdt, device=dev)

    blocks = [(_init_rec_layer if kind == "rec" else _init_attn_layer)(
        cfg, mat, vec) for kind in cfg.layer_kinds]
    vp, d = cfg.padded_vocab, cfg.d_model
    return {
        "emb": mat(vp, d, fan_in=1.0).mul_(0.02),
        "head": mat(d, vp),
        "final_norm": vec(d, 1.0),
        "blocks": blocks,
    }


# --------------------------------------------------------------------------
# RG-LRU + conv primitives
# --------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Per-channel causal conv.  x [B, T, D]; w [W, D].  Returns (y,
    new_state), the state being the last W - 1 inputs.  The W terms are
    added in the reference's order."""
    width, t = w.shape[0], x.shape[1]
    if state is None:
        hist = F.pad(x, (0, 0, width - 1, 0))
    else:
        hist = torch.cat([state.to(x.dtype), x], dim=1)
    y = hist[:, 0:t] * w[width - 1].to(x.dtype)
    for i in range(1, width):
        y = y + hist[:, i:i + t] * w[width - 1 - i].to(x.dtype)
    return y + b.to(x.dtype), hist[:, hist.shape[1] - (width - 1):]


def _rglru_gates(lw: dict, x: torch.Tensor):
    """(a, beta * i * x) in float32."""
    r = torch.sigmoid(layers.dense(x, lw["w_a"], lw["b_a"]).float())
    i = torch.sigmoid(layers.dense(x, lw["w_x"], lw["b_x"]).float())
    log_a = -_C * r * F.softplus(lw["lam"].float())
    a = torch.exp(log_a)
    gated = i * x.float()
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along axis 1, by log2(T)
    doubling steps (Hillis-Steele): after the step of span s, (a_t, b_t)
    composes the 2s steps ending at t."""
    t, span = a.shape[1], 1
    while span < t:
        b = torch.cat([b[:, :span], a[:, span:] * b[:, :-span] + b[:, span:]],
                      dim=1)
        a = torch.cat([a[:, :span], a[:, span:] * a[:, :-span]], dim=1)
        span *= 2
    return b


def _rglru_scan(lw: dict, x: torch.Tensor, h0: torch.Tensor | None):
    """Full-sequence RG-LRU.  x [B, T, D] -> (h in x's type, h_T float32)."""
    a, b = _rglru_gates(lw, x)                      # [B, T, D] float32
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = _linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def _rglru_step(lw: dict, x: torch.Tensor, h: torch.Tensor):
    """One step.  x [B, 1, D]; h [B, D] float32."""
    a, b = _rglru_gates(lw, x)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x.dtype)[:, None], h_new


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _rec_block(cfg: ModelConfig, x: torch.Tensor, lw: dict,
               cache: dict | None, shard: layers.Shard = layers.no_shard):
    """Griffin recurrent block.  Returns (out, new_cache)."""
    h = layers.rms_norm(x, lw["ln1"], cfg.norm_eps)
    gate = F.gelu(layers.dense(h, lw["w_gate_in"]), approximate="tanh")
    u = layers.dense(h, lw["w_rnn_in"])
    u = shard(u, "ffn_hidden")
    # the range names the convolution and the recurrence in a profile
    with obs.span("repro_torch.rglru", profiler=True):
        if cache is None:
            u, conv_state = _causal_conv(u, lw["conv_w"], lw["conv_b"])
            y, h_last = _rglru_scan(lw, u, None)
        else:
            u, conv_state = _causal_conv(u, lw["conv_w"], lw["conv_b"],
                                         cache["conv"])
            y, h_last = _rglru_step(lw, u, cache["h"])
    out = layers.dense(gate * y, lw["w_out"])
    return shard(out, "act_btd"), {"h": h_last, "conv": conv_state}


def _attn_block_ring(cfg: ModelConfig, x: torch.Tensor, lw: dict,
                     cache: dict, pos: int,
                     shard: layers.Shard = layers.no_shard):
    """Decode-time local attention over the ring cache: the new k/v go to
    slot ``pos % window`` IN PLACE, then K4 over the slots that hold
    positions ``<= pos`` (all of them once the ring has wrapped)."""
    hd, hq, hkv, w = (cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads,
                      cfg.local_window)
    b = x.shape[0]
    h = layers.rms_norm(x, lw["ln1"], cfg.norm_eps)
    q = layers.split_heads(layers.dense(h, lw["wq"]), hq)
    k = layers.split_heads(layers.dense(h, lw["wk"]), hkv)
    v = layers.split_heads(layers.dense(h, lw["wv"]), hkv)
    sin, cos = layers.rope(torch.tensor([pos], device=x.device), hd,
                           cfg.rope_theta)
    q, k = layers.apply_rope(q, sin, cos), layers.apply_rope(k, sin, cos)
    q = shard(q, "heads")
    slot = pos % w
    cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
    cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
    # softmax over a set of keys: the ring's order does not matter
    out = layers.attention(q, cache["k"], cache["v"], causal=True,
                           kv_len=min(pos + 1, w), site="decode",
                           shard=shard)
    out = layers.dense(out.reshape(b, 1, hq * hd), lw["wo"])
    return shard(out, "act_btd"), cache


def _mlp(cfg: ModelConfig, x: torch.Tensor, lw: dict,
         shard: layers.Shard = layers.no_shard) -> torch.Tensor:
    h = layers.rms_norm(x, lw["ln2"], cfg.norm_eps)
    return layers.swiglu(h, lw["wg"], lw["wu"], lw["wd"], shard)


# --------------------------------------------------------------------------
# public API (mirrors models.transformer)
# --------------------------------------------------------------------------

def _layers(cfg: ModelConfig, params: dict, batch: dict, on_layer=None,
            shard: layers.Shard = layers.no_shard):
    """The embedded sequence through every block; ``on_layer(i, kind,
    cache)`` receives each block's cache (rec: h, conv; attn: (k, v)).
    Each layer is rematerialised when a gradient is taken
    (``layers.remat``, the reference's per-layer ``jax.checkpoint``)."""
    x = tfm._embed(cfg, params, batch, shard)
    sin, cos = layers.rope(torch.arange(x.shape[1], device=x.device),
                           cfg.head_dim_, cfg.rope_theta)
    for i, (kind, lw) in enumerate(zip(cfg.layer_kinds, params["blocks"])):
        x, c = layers.remat(_layer, cfg, kind, x, lw, sin, cos, shard)
        if on_layer is not None:
            on_layer(i, kind, c)
    return x


def _layer(cfg: ModelConfig, kind: str, x: torch.Tensor, lw: dict,
           sin: torch.Tensor, cos: torch.Tensor,
           shard: layers.Shard = layers.no_shard):
    if kind == "rec":
        a, c = _rec_block(cfg, x, lw, None, shard)
    else:
        a, c = tfm._attn_block(cfg, x, lw, sin, cos, shard)
    x = x + a
    return x + _mlp(cfg, x, lw, shard), c


def forward(cfg: ModelConfig, params: dict, batch: dict,
            shard: layers.Shard = layers.no_shard,
            collect_cache: bool = False, unembed: bool = True):
    """Returns (logits [B, S, Vp], 0.0, per-layer caches | None); with
    unembed=False the final-norm hidden states instead of logits."""
    caches = []
    x = _layers(cfg, params, batch,
                (lambda i, kind, c: caches.append(c)) if collect_cache
                else None, shard)
    out = caches if collect_cache else None
    if not unembed:
        return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), \
            tfm._zero(x), out
    return tfm._unembed(cfg, params, x, shard), tfm._zero(x), out


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    del max_len   # the hybrid's state is O(window), not O(seq)
    dev = resolve_device(device)
    w, hd, hkv, dr = (cfg.local_window, cfg.head_dim_, cfg.num_kv_heads,
                      cfg.d_rnn_)
    dt = tfm._dt(cfg)
    out = []
    for kind in cfg.layer_kinds:
        if kind == "rec":
            out.append({
                "h": torch.zeros((batch_size, dr), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((batch_size, cfg.conv_width - 1, dr),
                                    dtype=dt, device=dev)})
        else:
            out.append({
                "k": torch.zeros((batch_size, w, hkv, hd), dtype=dt,
                                 device=dev),
                "v": torch.zeros((batch_size, w, hkv, hd), dtype=dt,
                                 device=dev)})
    return {"layers": out, "pos": 0}


def _ring(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, S, ...] keys or values of positions 0..S-1 -> the [B, w, ...]
    ring: position p at slot p % w for the last min(S, w) positions, zeros
    in the slots not reached yet."""
    s = x.shape[1]
    if s >= w:
        return torch.roll(x[:, s - w:], s % w, dims=1)
    return F.pad(x, (0, 0, 0, 0, 0, w - s))


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int,
            shard: layers.Shard = layers.no_shard):
    """Run the prompt through the model (K4 with the local window in every
    attention layer), build the ring and recurrent caches, return the
    logits of the last position: (logits [B, Vp], cache)."""
    w, dt = cfg.local_window, tfm._dt(cfg)
    out = [None] * cfg.num_layers

    def keep(i, kind, c):
        if kind == "rec":
            out[i] = {"h": c["h"].float(), "conv": c["conv"]}
        else:
            out[i] = {"k": _ring(c[0], w).to(dt), "v": _ring(c[1], w).to(dt)}

    x = _layers(cfg, params, batch, keep, shard)
    seq = x.shape[1]
    # unembed the last position only (the reference's logits[:, -1])
    return tfm._unembed(cfg, params, x[:, -1:], shard)[:, 0], \
        {"layers": out, "pos": seq}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, shard: layers.Shard = layers.no_shard):
    """One token for every sequence: tokens [B, 1] -> (logits [B, Vp],
    cache); the ring caches are written in place."""
    pos = int(cache["pos"])
    x = tfm._embed(cfg, params, {"tokens": tokens}, shard)
    new = []
    for kind, lw, c in zip(cfg.layer_kinds, params["blocks"],
                           cache["layers"]):
        if kind == "rec":
            a, nc = _rec_block(cfg, x, lw, c, shard)
        else:
            a, nc = _attn_block_ring(cfg, x, lw, c, pos, shard)
        x = x + a
        x = x + _mlp(cfg, x, lw, shard)
        new.append(nc)
    logits = tfm._unembed(cfg, params, x, shard)
    return logits[:, -1], {"layers": new, "pos": pos + 1}
