"""Dense / MoE / VLM / audio decoder-only transformer (the port of
``repro.models.transformer``).

The parameters keep the reference's layout: one dict whose per-layer
tensors are stacked on a leading L dim, attention weights flat
([D, H*Dh]).  The reference's ``scan`` over layers becomes a Python loop
over that dim; its ``shard`` hooks stay at the reference's sites
(``layers.no_shard`` without a mesh, where every tensor is a plain one and
the paths are as they were before the hooks came back).  Attention
runs K4 (``repro_torch.kernels.ops.flash_attention``) at prefill and at
every decode step.  The moe family's feed-forward is ``models.moe``; the
vlm family fuses ``batch["patch_embeds"]`` as a prefix through ``w_patch``
and rotates by M-RoPE when ``batch["positions"]`` ([B, 3, L]) is given.  A
decode step rotates at the cache position with standard RoPE, as the
reference does (``repro/models/transformer.py:272``; ROADMAP R6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers, moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shlib

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache"]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def generator_for(seed_or_gen: int | torch.Generator,
                  device: torch.device) -> torch.Generator:
    """An explicit generator on ``device``: a seed makes a new one."""
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != device.type:
            raise ValueError(f"generator on {seed_or_gen.device}, parameters "
                             f"on {device}")
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


def normal(gen: torch.Generator, shape: tuple[int, ...], fan_in: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, 1 / fan_in) draws (scaled in place: the embedding and head of
    the large configs are gigabytes)."""
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.div_(math.sqrt(fan_in))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: int | torch.Generator,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from an explicit generator (or a seed), in
    ``cfg.param_dtype``, on ``device``.  The draws differ from the
    reference's ``jax.random``; ``model.load_reference_params`` carries the
    reference's own parameters across."""
    dev = resolve_device(device)
    gen = generator_for(generator, dev)
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv, f, nl = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers
    vp, pdt = cfg.padded_vocab, _pdt(cfg)

    def mat(*shape, fan_in):
        return normal(gen, shape, fan_in, pdt, dev)

    def norm(*shape):
        return torch.ones(shape, dtype=pdt, device=dev)

    blocks = {
        "ln1": norm(nl, d),
        "ln2": norm(nl, d),
        "wq": mat(nl, d, hq * hd, fan_in=d),
        "wk": mat(nl, d, hkv * hd, fan_in=d),
        "wv": mat(nl, d, hkv * hd, fan_in=d),
        "wo": mat(nl, hq * hd, d, fan_in=hq * hd),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            blocks[name] = torch.zeros((nl, width * hd), dtype=pdt,
                                       device=dev)
    if cfg.num_experts:
        blocks.update(moe_lib.init_moe(
            cfg, nl, lambda shape, fan_in: mat(*shape, fan_in=fan_in)))
    else:
        blocks["wg"] = mat(nl, d, f, fan_in=d)
        blocks["wu"] = mat(nl, d, f, fan_in=d)
        blocks["wd"] = mat(nl, f, d, fan_in=f)
    params = {
        "emb": mat(vp, d, fan_in=1.0).mul_(0.02),
        "head": mat(d, vp, fan_in=d),
        "final_norm": norm(d),
        "blocks": blocks,
    }
    if cfg.frontend == "patch":
        params["w_patch"] = mat(cfg.frontend_dim, d, fan_in=cfg.frontend_dim)
    return params


def layer(params: dict, i: int) -> dict:
    """Layer ``i``'s weights: views into the stacked tensors."""
    return {k: w[i] for k, w in params["blocks"].items()}


# --------------------------------------------------------------------------
# shared block body
# --------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, x: torch.Tensor, lw: dict,
                sin: torch.Tensor, cos: torch.Tensor,
                shard: layers.Shard = layers.no_shard, *,
                kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                pos: int = 0) -> tuple[torch.Tensor, tuple]:
    """Attention sub-block.  Full sequence when ``kv_cache`` is None
    (returns the fresh k/v); decode when ``kv_cache = (k_all, v_all)``, a
    layer's [B, max_len, Hkv, Dh] cache, which this writes at ``pos`` IN
    PLACE (slice assignment: the cache is the largest tensor of a decode
    step, and the reference's ``dynamic_update_slice`` is in place too).
    On a mesh the cache is a DTensor whose sequence is sharded, and the
    write is a ``torch.where`` at ``pos`` into a new one."""
    hd, hq, hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    b, seq, _ = x.shape
    h = layers.rms_norm(x, lw["ln1"], cfg.norm_eps)
    h = shard(h, "act_btd_full")
    q = layers.split_heads(layers.dense(h, lw["wq"], lw.get("bq")), hq)
    k = layers.split_heads(layers.dense(h, lw["wk"], lw.get("bk")), hkv)
    v = layers.split_heads(layers.dense(h, lw["wv"], lw.get("bv")), hkv)
    q, k = layers.apply_rope(q, sin, cos), layers.apply_rope(k, sin, cos)
    q = shard(q, "heads")

    if kv_cache is None:
        k = shard(k, "heads")
        out = layers.attention(q, k, v, causal=True, window=cfg.local_window,
                               site="full", shard=shard)
        new_kv = (k, v)
    else:
        k_all, v_all = kv_cache
        if shlib.is_dtensor(k_all):
            at = (torch.arange(k_all.shape[1], device=x.device)
                  - pos)[None, :, None, None]
            k_all = torch.where((at >= 0) & (at < seq), k.to(k_all.dtype),
                                k_all)
            v_all = torch.where((at >= 0) & (at < seq), v.to(v_all.dtype),
                                v_all)
        else:
            k_all[:, pos:pos + seq] = k.to(k_all.dtype)
            v_all[:, pos:pos + seq] = v.to(v_all.dtype)
        k_all = shard(k_all, "cache_kv")
        v_all = shard(v_all, "cache_kv")
        out = _attention_decode(q, k_all, v_all, kv_len=pos + seq,
                                window=cfg.local_window, shard=shard)
        new_kv = (k_all, v_all)
    out = layers.dense(out.reshape(b, seq, hq * hd), lw["wo"])
    return shard(out, "act_btd"), new_kv


def _attention_decode(q, k, v, *, kv_len, window=0, shard=layers.no_shard):
    """Attention of the new position(s) over the first ``kv_len`` cache
    positions: K4 with ``Lq = 1`` and ``lk_valid = pos + 1`` in a decode
    step, the reference's softmax over the valid cache positions."""
    return layers.attention(q, k, v, causal=True, kv_len=kv_len,
                            window=window, site="decode", shard=shard)


def _ffn_block(cfg: ModelConfig, x: torch.Tensor, lw: dict,
               shard: layers.Shard = layers.no_shard
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, aux): the MoE feed-forward and its load-balancing loss, or
    SwiGLU and 0."""
    h = layers.rms_norm(x, lw["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        out, aux = moe_lib.apply_moe(cfg, h, lw["router"], lw["we_gate"],
                                     lw["we_up"], lw["we_down"], shard)
    else:
        out, aux = layers.swiglu(h, lw["wg"], lw["wu"], lw["wd"],
                                 shard), _zero(x)
    return shard(out, "act_btd"), aux


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: dict, batch: dict,
           shard: layers.Shard = layers.no_shard) -> torch.Tensor:
    # gather the rows, then cast: the same values as casting the table
    # first, without a compute-type copy of the whole table
    emb = params["emb"]
    dev = emb.device
    if shlib.is_dtensor(emb):
        x = _lookup_local(emb, batch["tokens"]).to(_dt(cfg))
    else:
        x = emb[batch["tokens"].to(dev, torch.long)].to(_dt(cfg))
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        patches = batch["patch_embeds"].to(dev, _dt(cfg))
        x = torch.cat([layers.dense(patches, params["w_patch"]), x], dim=1)
    return shard(x, "act_btd")


def _lookup_local(emb, tokens):
    """``emb[tokens]`` on a mesh, as a lookup of local tensors (the same op
    and backward as on one device): the table is gathered over the mesh
    dims that split the tokens' batch (and keeps its columns' split on
    the others), each rank takes its rows, and the output is placed by
    both (batch from the tokens, columns from the table).  The table's
    gradient is then a partial sum over the batch dims.  (DTensor's
    indexing of a sharded table gave the wrong shape; its embedding op
    sums the backward in another order than indexing does.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = emb.device_mesh
    if shlib.is_dtensor(tokens):
        tok = [p if p.is_shard(0) else Replicate() for p in tokens.placements]
        tl = tokens.redistribute(mesh, tok).to_local()
    else:
        tok, tl = [Replicate()] * mesh.ndim, tokens
    tab = [Replicate() if t.is_shard() or not p.is_shard(1) else p
           for t, p in zip(tok, emb.placements)]
    grad = [Partial() if t.is_shard() else p for t, p in zip(tok, tab)]
    el = emb.redistribute(mesh, tab).to_local(grad_placements=grad)
    out = el[tl.to(el.device, torch.long)]
    pl = [Shard(0) if t.is_shard() else Shard(tl.dim()) if p.is_shard()
          else Replicate() for t, p in zip(tok, tab)]
    shape = tuple(tokens.shape) + (emb.shape[1],)
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor,
             shard: layers.Shard = layers.no_shard) -> torch.Tensor:
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return shard(x @ params["head"].to(x.dtype), "logits")


def _rope_for(cfg: ModelConfig, batch: dict, seq_len: int,
              device: torch.device, offset: int = 0):
    # M-RoPE when per-component positions are given; a decode step passes
    # tokens only and rotates at the cache position (reduces to RoPE when
    # the three components are equal)
    if cfg.mrope_sections is not None and "positions" in batch:
        return layers.m_rope(batch["positions"].to(device), cfg.head_dim_,
                             cfg.mrope_sections, cfg.rope_theta)
    pos = offset + torch.arange(seq_len, device=device)
    return layers.rope(pos, cfg.head_dim_, cfg.rope_theta)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def layers_of(params: dict) -> list[dict]:
    """Every layer's weights, from one ``unbind`` of each stacked tensor: in
    the backward each stacked gradient is then assembled once, where
    per-layer slices would each build a full-size zero tensor."""
    per = {k: torch.unbind(w) for k, w in params["blocks"].items()}
    return [{k: w[i] for k, w in per.items()}
            for i in range(len(next(iter(per.values()))))]


# --------------------------------------------------------------------------
# full-sequence forward (training and prefill)
# --------------------------------------------------------------------------

def _block(cfg: ModelConfig, x: torch.Tensor, lw: dict, sin: torch.Tensor,
           cos: torch.Tensor, shard: layers.Shard = layers.no_shard):
    a, kv = _attn_block(cfg, x, lw, sin, cos, shard)
    x = x + a
    f, aux = _ffn_block(cfg, x, lw, shard)
    return x + f, aux, kv


def forward(cfg: ModelConfig, params: dict, batch: dict,
            shard: layers.Shard = layers.no_shard,
            collect_kv: bool = False, unembed: bool = True):
    """Returns (logits [B, S, Vp], aux_loss, (k, v) [L,B,S,Hkv,Dh] | None).
    With unembed=False, returns the final-norm hidden states instead of
    logits.  Each layer is rematerialised when a gradient is taken
    (``layers.remat``, the reference's ``jax.checkpoint`` of its scan
    body)."""
    x = _embed(cfg, params, batch, shard)
    sin, cos = _rope_for(cfg, batch, x.shape[1], x.device)
    ks, vs = [], []
    aux = _zero(x)
    for lw in layers_of(params):
        x, aux_i, (k, v) = layers.remat(_block, cfg, x, lw, sin, cos, shard)
        aux = aux + aux_i
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    if not unembed:
        return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), \
            aux, kvs
    return _unembed(cfg, params, x, shard), aux, kvs


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=dev),
            "pos": 0}


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int,
            shard: layers.Shard = layers.no_shard):
    """Run the prompt through the model, build the cache, return the logits
    of the last position: (logits [B, Vp], cache).  On a mesh the cache's
    k and v are stacked and padded to ``max_len`` (DTensors, placed by the
    reference's cache rules when the caller places them)."""
    x = _embed(cfg, params, batch, shard)
    b, s, _ = x.shape
    on_mesh = shlib.is_dtensor(x)
    cache = {} if on_mesh else init_cache(cfg, b, max_len, x.device)
    ks, vs = [], []
    sin, cos = _rope_for(cfg, batch, s, x.device)
    for i in range(cfg.num_layers):
        lw = layer(params, i)
        a, (k, v) = _attn_block(cfg, x, lw, sin, cos, shard)
        if on_mesh:
            ks.append(k)
            vs.append(v)
        else:
            cache["k"][i, :, :s] = k  # in place into the preallocated cache
            cache["v"][i, :, :s] = v
        x = x + a
        x = x + _ffn_block(cfg, x, lw, shard)[0]
    if on_mesh:
        for key, xs in (("k", ks), ("v", vs)):
            cache[key] = _pad_positions(torch.stack(xs).to(_dt(cfg)),
                                        max_len)
    cache["pos"] = s
    # unembed the last position only: the same values as the reference's
    # logits[:, -1] (norm and head act per position) without a
    # [B, S, Vp] logits slab (8 GB at minitron-4b, 8 x 1000 tokens)
    return _unembed(cfg, params, x[:, -1:], shard)[:, 0], cache


def _pad_positions(x, max_len: int):
    """[L, B, S, Hkv, Dh] DTensor keys or values padded with zero positions
    to ``max_len``.  Their positions are whole on every rank (the batch and
    heads are split), so each rank pads its own shard: DTensor's pad op
    (torch 2.11) fails to plan a tensor whose heads are split unevenly."""
    from torch.distributed.tensor import DTensor
    pad = (0, 0, 0, 0, 0, max_len - x.shape[2])
    if any(p.is_shard(2) for p in x.placements):
        return F.pad(x, pad)
    shape = x.shape[:2] + (max_len,) + x.shape[3:]
    return DTensor.from_local(F.pad(x.to_local(), pad), x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, shard: layers.Shard = layers.no_shard):
    """One token for every sequence: tokens [B, 1] -> (logits [B, Vp],
    cache).  The returned cache holds the same k/v buffers, written at
    ``pos`` in place, and ``pos + 1`` (on a mesh, new DTensors)."""
    pos = int(cache["pos"])
    batch = {"tokens": tokens}
    x = _embed(cfg, params, batch, shard)
    sin, cos = _rope_for(cfg, batch, 1, x.device, offset=pos)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lw = layer(params, i)
        a, (k_i, v_i) = _attn_block(cfg, x, lw, sin, cos, shard,
                                    kv_cache=(cache["k"][i], cache["v"][i]),
                                    pos=pos)
        ks.append(k_i)
        vs.append(v_i)
        x = x + a
        x = x + _ffn_block(cfg, x, lw, shard)[0]
    logits = _unembed(cfg, params, x, shard)
    if shlib.is_dtensor(cache["k"]):
        return logits[:, -1], {"k": torch.stack(ks), "v": torch.stack(vs),
                               "pos": pos + 1}
    return logits[:, -1], {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
