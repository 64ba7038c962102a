"""Architecture registry, loss, and train and serve step factories (the
port of ``repro.models.model``).

Families dispatch to their module (``transformer`` for dense, moe, vlm and
audio, ``rglru`` for the hybrid, ``rwkv6`` for the ssm family), all
exposing init_params / forward / prefill / decode_step / init_cache.
``Model`` binds a config and a device; its functions run eagerly (no jit).
``load_reference_params`` carries the reference's own parameter pytree
across, so that both packages compute the same thing.

Training: ``chunked_cross_entropy`` (the fused unembed + CE over sequence
chunks, each recomputed in the backward), ``make_train_step`` (gradient
accumulation over microbatches, optional int8 error-feedback compression of
per-pod gradients, AdamW) and ``init_ef_error``.  Every layer of the three
model modules is rematerialised when a gradient is taken
(``layers.remat``), as the reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.models import rglru, rwkv6, transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import compress

__all__ = ["Model", "get_model", "cross_entropy", "chunked_cross_entropy",
           "make_train_step", "init_ef_error", "make_prefill_step",
           "make_decode_step", "load_reference_params"]

_MODULES = {"dense": tfm, "moe": tfm, "vlm": tfm, "audio": tfm,
            "hybrid": rglru, "ssm": rwkv6}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[[int | torch.Generator], dict]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[[int, int], dict]


def _module(cfg: ModelConfig):
    if cfg.family not in _MODULES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return _MODULES[cfg.family]


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    """The model of ``cfg`` on ``device`` (the card unless asked for the
    CPU; raises without a card)."""
    mod = _module(cfg)
    dev = resolve_device(device)
    return Model(
        cfg=cfg,
        device=dev,
        init_params=lambda generator: mod.init_params(cfg, generator, dev),
        forward=lambda params, batch, **kw: mod.forward(cfg, params, batch,
                                                        **kw),
        prefill=lambda params, batch, max_len: mod.prefill(cfg, params, batch,
                                                           max_len),
        decode_step=lambda params, cache, tokens: mod.decode_step(
            cfg, params, cache, tokens),
        init_cache=lambda batch_size, max_len: mod.init_cache(
            cfg, batch_size, max_len, dev),
    )


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def _col_ok(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def _ce_terms(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked per-position losses, number of valid positions)
    in float32; padded vocab columns at -1e9, labels < 0 masked."""
    lg = torch.where(_col_ok(cfg, logits.device), logits.float(), -1e9)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, torch.clamp(labels, min=0)[..., None].long()
                      )[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over valid positions (labels < 0 are masked, e.g.
    the vlm's patch-prefix positions): ``(loss, n)``.  Padded vocab columns
    are masked to -1e9 so the padding never changes the distribution."""
    total, n = _ce_terms(cfg, logits, labels)
    n = torch.clamp(n, min=1.0)
    return total / n, n


class _ChunkedCE(torch.autograd.Function):
    """(sum of the masked per-position losses, number of valid positions)
    of the fused unembed + CE over chunks of ``c`` positions.  The forward
    keeps no logits; the backward recomputes each chunk's [B, c, Vp] panel
    and adds the head's gradient in float32 chunk by chunk, in order (the
    reference's ``jax.checkpoint`` of its scan body, whose ``astype``
    backward hands float32 chunk gradients to the scan's sum).  The head is
    cast to the compute type once per pass, not once per chunk, and each
    chunk goes in as a contiguous [B c, D] matrix (a strided [B, c, D] view
    of x sent the same product to a much slower cuBLAS kernel)."""

    @staticmethod
    def forward(ctx, x, head, labels, cfg, c):
        hb = head.to(x.dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[1], c):
            xc = x[:, i:i + c].reshape(-1, x.shape[-1])
            ls, ns = _ce_terms(cfg, xc @ hb, labels[:, i:i + c].reshape(-1))
            loss_sum = loss_sum + ls
            n_sum = n_sum + ns
        ctx.save_for_backward(x, head, labels)
        ctx.cfg, ctx.c = cfg, c
        ctx.mark_non_differentiable(n_sum)
        return loss_sum, n_sum

    @staticmethod
    def backward(ctx, g_loss, _g_n):
        x, head, labels = ctx.saved_tensors
        cfg, c = ctx.cfg, ctx.c
        hb = head.to(x.dtype)
        col_ok = _col_ok(cfg, x.device)
        dx = torch.empty_like(x)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        for i in range(0, x.shape[1], c):
            xc = x[:, i:i + c].reshape(-1, x.shape[-1])
            lc = labels[:, i:i + c].reshape(-1)
            lg = torch.where(col_ok, (xc @ hb).float(), -1e9)
            lse = torch.logsumexp(lg, dim=-1, keepdim=True)
            # d(sum (lse - ll) mask) / d lg = mask (softmax - onehot)
            dlg = torch.exp(lg - lse)
            dlg.scatter_add_(-1, torch.clamp(lc, min=0)[..., None].long(),
                             torch.full(lc.shape + (1,), -1.0,
                                        device=x.device))
            dlg = dlg * ((lc >= 0).float() * g_loss)[..., None]
            dlogits = torch.where(col_ok, dlg, 0.0).to(x.dtype)
            dx[:, i:i + c] = (dlogits @ hb.t()).view(x.shape[0], -1,
                                                      x.shape[-1])
            dhead += (xc.t() @ dlogits).float()
        return dx, dhead.to(head.dtype), None, None, None


def chunked_cross_entropy(cfg: ModelConfig, head: torch.Tensor,
                          x: torch.Tensor, labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """Fused unembed + CE over sequence chunks (``chunk`` halved until it
    divides the length, as the reference does), each chunk recomputed in
    the backward (``_ChunkedCE``), so only one [B, chunk, Vp] panel of
    logits is live: what keeps the 150k-256k vocabularies inside device
    memory.  The chunks' sums are added in order."""
    s = x.shape[1]
    c = min(chunk, s)
    while s % c:
        c //= 2
    loss_sum, n_sum = _ChunkedCE.apply(x, head, labels, cfg, c)
    return loss_sum / torch.clamp(n_sum, min=1.0)


def _loss_fn(cfg: ModelConfig, model: Model, params: dict, batch: dict,
             aux_weight: float = 0.01):
    x, aux, _ = model.forward(params, batch, unembed=False)
    loss = chunked_cross_entropy(cfg, params["head"], x, batch["labels"])
    return loss + aux_weight * aux, {"loss": loss, "aux_loss": aux}


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def _grads(cfg: ModelConfig, model: Model, params, mb: dict):
    """(metrics, float32 gradients of the total loss in ``tree.leaves``'
    order) of one microbatch ``mb`` (device tensors)."""
    ps = [p.detach().requires_grad_(True) for p in tree_lib.leaves(params)]
    with torch.enable_grad():
        total, metrics = _loss_fn(cfg, model, tree_lib.unflatten(params, ps),
                                  mb)
        grads = torch.autograd.grad(total, ps, allow_unused=True)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             if g is None else g.float() for g, p in zip(grads, ps)]
    return {k: v.detach().float() for k, v in metrics.items()}, grads


def _device_batch(batch: dict, device: torch.device) -> dict:
    """A batch's leaves (numpy or torch) as tensors on ``device``: integer
    ids as int64, embeddings as float32."""
    out = {}
    for key, x in batch.items():
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        dt = torch.float32 if t.is_floating_point() else torch.long
        out[key] = t.to(device=device, dtype=dt)
    return out


def make_train_step(cfg: ModelConfig, optimizer, accum: int = 1,
                    pod_compress: bool = False, npod: int = 1,
                    device: str | torch.device = "cuda"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves are [accum, micro_batch, ...] (numpy or
    torch, as ``data.make_batch`` makes them); each microbatch's gradient
    (every layer rematerialised) is added in order to float32 accumulators,
    which are divided by ``accum``, as are the metrics ``loss`` and
    ``aux_loss``; ``grad_norm`` is the global norm of the gradient the
    optimizer sees.  The optimizer updates ``params`` and ``opt_state`` in
    place (``optim.AdamW``) and returns them.

    ``pod_compress``: each microbatch is cut into ``npod`` slices along its
    batch dim, one gradient per pod (the reference's ``vmap`` over its pod
    dim, a loop here), and the pods' gradients go through
    ``optim.compress.ef_compress_mean`` with the ``"ef_error"`` buffer of
    ``opt_state`` (``init_ef_error``); the metrics are the pods' means."""
    model = get_model(cfg, device)
    dev = model.device

    def per_pod_grad(params, mb):
        per = [_grads(cfg, model, params, {k: torch.chunk(x, npod)[i]
                                           for k, x in mb.items()})
               for i in range(npod)]
        metrics = {k: torch.stack([m[k] for m, _ in per]).mean()
                   for k in per[0][0]}
        return metrics, [torch.stack(gs) for gs in zip(*(g for _, g in per))]

    def train_step(params, opt_state, batch):
        batch = _device_batch(batch, dev)
        if any(x.shape[0] != accum for x in batch.values()):
            raise ValueError(f"train_step: batch leaves must lead with "
                             f"accum = {accum}")
        g_acc, m_acc = None, None
        for a in range(accum):
            mb = {k: x[a] for k, x in batch.items()}
            if pod_compress:
                if mb["tokens"].shape[0] % npod:
                    raise ValueError(f"train_step: micro batch "
                                     f"{mb['tokens'].shape[0]} over {npod} "
                                     "pods")
                metrics, g = per_pod_grad(params, mb)
            else:
                metrics, g = _grads(cfg, model, params, mb)
            if g_acc is None:
                g_acc, m_acc = g, metrics
            else:
                g_acc = [x + y for x, y in zip(g_acc, g)]
                m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
            del g
        grads = [g / accum for g in g_acc]
        metrics = {k: v / accum for k, v in m_acc.items()}
        del g_acc
        if pod_compress:
            pod_tree = tree_lib.unflatten(params, grads)
            grads, new_err = compress.ef_compress_mean(
                pod_tree, opt_state["ef_error"], npod)
            grads = tree_lib.leaves(grads)
            opt_state = dict(opt_state, ef_error=new_err)
        grads = tree_lib.unflatten(params, grads)
        gnorm = optimizer.global_norm(grads)
        inner = {k: v for k, v in opt_state.items() if k != "ef_error"}
        params, new_inner = optimizer.update(params, grads, inner)
        if pod_compress:
            opt_state = dict(new_inner, ef_error=opt_state["ef_error"])
        else:
            opt_state = new_inner
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def init_ef_error(params, npod: int):
    """Error-feedback buffer for pod_compress (bf16, one row per pod)."""
    return tree_lib.map_tree(
        lambda p: torch.zeros((npod,) + tuple(p.shape), dtype=torch.bfloat16,
                              device=p.device), params)


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      device: str | torch.device = "cuda"):
    model = get_model(cfg, device)

    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device: str | torch.device = "cuda"):
    model = get_model(cfg, device)

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step


def load_reference_params(cfg: ModelConfig, tree: dict,
                          device: str | torch.device = "cuda") -> dict:
    """The port's parameters from the reference's parameter pytree, given as
    nested dicts (and, for the hybrid, a list) of numpy arrays, as the
    reference's ``init_params`` makes it: ``blocks`` a dict of per-layer
    tensors stacked on a leading L dim, or the hybrid's list of per-layer
    dicts of two kinds (``cfg.layer_kinds``); the vlm's ``w_patch`` beside
    them.  In ``cfg.param_dtype`` on ``device``."""
    _module(cfg)
    dev = resolve_device(device)
    pdt = tfm._pdt(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.tensor(np.asarray(x), dtype=pdt, device=dev)

    params = conv(tree)
    need = ["emb", "head", "final_norm", "blocks"]
    if cfg.frontend == "patch":
        need.append("w_patch")
    for key in need:
        if key not in params:
            raise ValueError(f"load_reference_params: no {key!r} in the tree")
    blocks = params["blocks"]
    if isinstance(blocks, list) != (cfg.family == "hybrid"):
        raise ValueError(f"load_reference_params: {cfg.name} takes blocks as "
                         + ("a list of per-layer dicts" if cfg.family ==
                            "hybrid" else "a dict of stacked tensors"))
    if isinstance(blocks, list):
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"load_reference_params: {len(blocks)} blocks, "
                             f"{cfg.name} has {cfg.num_layers} layers")
        for i, (kind, lw) in enumerate(zip(cfg.layer_kinds, blocks)):
            if ("w_a" in lw) != (kind == "rec"):
                raise ValueError(f"load_reference_params: block {i} is not "
                                 f"a {kind!r} layer")
        return params
    for name, w in blocks.items():
        if w.shape[0] != cfg.num_layers:
            raise ValueError(f"load_reference_params: blocks/{name} has "
                             f"{w.shape[0]} layers, {cfg.name} has "
                             f"{cfg.num_layers}")
    return params
