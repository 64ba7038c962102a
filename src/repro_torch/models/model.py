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

Every entry point takes the reference's ``shard`` hook
(``parallel.sharding.make_shard_fn``; ``layers.no_shard`` by default).  On
a mesh the parameters and optimizer state are DTensors placed by
``parallel.sharding.state_specs``, and the functions here run under
DTensor's implicit replication, so that the model's plain constants (rope
tables, masks, scalars) enter as replicated; with plain tensors nothing
changes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.models import layers, rglru, rwkv6, transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import compress
from repro_torch.parallel import sharding as shlib

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
        forward=lambda params, batch, shard=layers.no_shard, **kw: _on_mesh(
            params, mod.forward, cfg, params, batch, shard, **kw),
        prefill=lambda params, batch, max_len, shard=layers.no_shard:
            _on_mesh(params, mod.prefill, cfg, params, batch, max_len, shard),
        decode_step=lambda params, cache, tokens, shard=layers.no_shard:
            _on_mesh(params, mod.decode_step, cfg, params, cache, tokens,
                     shard),
        init_cache=lambda batch_size, max_len: mod.init_cache(
            cfg, batch_size, max_len, dev),
    )


def _on_mesh(params, fn, *args, **kw):
    """``fn(*args, **kw)``, under DTensor's implicit replication when the
    parameters are DTensors."""
    with shlib.mesh_context(params):
        return fn(*args, **kw)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def _col_ok(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def _ce_terms(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
              shard: layers.Shard = layers.no_shard
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked per-position losses, number of valid positions)
    in float32; padded vocab columns at -1e9, labels < 0 masked."""
    logits = shard(logits, "logits")
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
    def forward(ctx, x, head, labels, cfg, c, shard=layers.no_shard):
        hb = head.to(x.dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[1], c):
            xc = x[:, i:i + c].reshape(-1, x.shape[-1])
            ls, ns = _ce_terms(cfg, xc @ hb, labels[:, i:i + c].reshape(-1),
                               shard)
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
        return dx, dhead.to(head.dtype), None, None, None, None


def chunked_cross_entropy(cfg: ModelConfig, head: torch.Tensor,
                          x: torch.Tensor, labels: torch.Tensor,
                          shard: layers.Shard = layers.no_shard,
                          chunk: int = 512) -> torch.Tensor:
    """Fused unembed + CE over sequence chunks (``chunk`` halved until it
    divides the length, as the reference does), each chunk recomputed in
    the backward (``_ChunkedCE``), so only one [B, chunk, Vp] panel of
    logits is live: what keeps the 150k-256k vocabularies inside device
    memory.  The chunks' sums are added in order.

    On a mesh (``x`` a DTensor) each rank runs ``_ChunkedCE`` on its own
    batch rows with the head gathered: its chunk loop and saved tensors are
    local, so the panel is a plain [B_local, chunk, Vp] tensor, which
    ``shard`` leaves as it is (the reference's "logits" rule splits the
    panel's vocab over "model"); the two sums are partial over the batch
    axes."""
    s = x.shape[1]
    c = min(chunk, s)
    while s % c:
        c //= 2
    if shlib.is_dtensor(x):
        loss_sum, n_sum = _chunked_ce_local(cfg, head, x, labels, c)
    else:
        loss_sum, n_sum = _ChunkedCE.apply(x, head, labels, cfg, c, shard)
    return loss_sum / torch.clamp(n_sum, min=1.0)


def _chunked_ce_local(cfg: ModelConfig, head, x, labels, c: int):
    """``_ChunkedCE`` of DTensors on each rank's batch rows: x and labels
    keep their batch sharding and are gathered on the other mesh dims, the
    head is gathered whole; the two sums come back partial over the batch
    dims, and so does the head's gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in x.placements]
    part = [Partial() if p.is_shard(0) else Replicate() for p in rows]
    xl = x.redistribute(mesh, rows).to_local()
    hl = head.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=part)
    ll = labels.redistribute(mesh, rows).to_local() \
        if shlib.is_dtensor(labels) else labels
    loss_sum, n_sum = _ChunkedCE.apply(xl, hl, ll, cfg, c)
    return (DTensor.from_local(loss_sum, mesh, part, run_check=False),
            DTensor.from_local(n_sum, mesh, part, run_check=False))


def _loss_fn(cfg: ModelConfig, model: Model, params: dict, batch: dict,
             shard: layers.Shard = layers.no_shard,
             aux_weight: float = 0.01):
    x, aux, _ = model.forward(params, batch, shard, unembed=False)
    loss = chunked_cross_entropy(cfg, params["head"], x, batch["labels"],
                                 shard)
    return loss + aux_weight * aux, {"loss": loss, "aux_loss": aux}


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def _grads(cfg: ModelConfig, model: Model, params, mb: dict,
           shard: layers.Shard = layers.no_shard):
    """(metrics, float32 gradients of the total loss in ``tree.leaves``'
    order) of one microbatch ``mb`` (device tensors).  On a mesh each
    gradient is placed as its parameter is (DTensor's backward may leave it
    partial or otherwise placed) and the metrics are gathered whole."""
    ps = [p.detach().requires_grad_(True) for p in tree_lib.leaves(params)]
    with torch.enable_grad():
        total, metrics = _loss_fn(cfg, model, tree_lib.unflatten(params, ps),
                                  mb, shard)
        grads = torch.autograd.grad(total, ps, allow_unused=True)
    grads = [torch.zeros_like(p, dtype=torch.float32)
             if g is None else g.float() for g, p in zip(grads, ps)]
    if shlib.is_dtensor(ps[0]):
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, ps)]
        metrics = {k: _whole(v) for k, v in metrics.items()}
    return {k: v.detach().float() for k, v in metrics.items()}, grads


def _whole(x):
    """A DTensor as the plain tensor it stands for (every rank the same)."""
    return x.full_tensor() if shlib.is_dtensor(x) else x


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


def make_train_step(cfg: ModelConfig, optimizer,
                    shard: layers.Shard = layers.no_shard, accum: int = 1,
                    pod_compress: bool = False, npod: int = 1,
                    unshard_pod=None, device: str | torch.device = "cuda"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves are [accum, micro_batch, ...] (numpy or
    torch, as ``data.make_batch`` makes them); each microbatch's gradient
    (every layer rematerialised) is added in order to float32 accumulators,
    which are divided by ``accum``, as are the metrics ``loss`` and
    ``aux_loss``; ``grad_norm`` is the global norm of the gradient the
    optimizer sees.  The optimizer updates ``params`` and ``opt_state`` in
    place (``optim.AdamW``) and returns them.

    ``pod_compress``: each pod computes its own gradient over its share of
    the microbatch (the microbatch cut [B] -> [npod, B / npod], the
    reference's ``vmap`` over its pod dim), and the pods' gradients go
    through ``optim.compress.ef_compress_mean`` with the ``"ef_error"``
    buffer of ``opt_state`` (``init_ef_error``) and ``unshard_pod``; the
    metrics are the pods' means.  Without a mesh the pods are a loop over
    the ``npod`` slices.

    On a mesh (the parameters DTensors placed by ``state_specs``, ``shard``
    from ``make_shard_fn``) each microbatch is placed by ``batch_spec``;
    with ``pod_compress`` the mesh leads with a ``"pod"`` axis of ``npod``
    ranks (or has none and ``npod`` is 1), and each pod runs its slice on
    its own (data, model) sub-mesh: its gradients are the pod's row of
    [npod, ...] DTensors sharded over "pod" (``state_specs``' ef_error
    placement), and no collective crosses pods until
    ``ef_compress_mean``'s int8 all-gather (``shard`` then built with
    ``dp_axes=("data",)``, as the reference asks)."""
    model = get_model(cfg, device)
    dev = model.device

    def per_pod_grad(params, mb):
        per = [_grads(cfg, model, params, {k: torch.chunk(x, npod)[i]
                                           for k, x in mb.items()}, shard)
               for i in range(npod)]
        metrics = {k: torch.stack([m[k] for m, _ in per]).mean()
                   for k in per[0][0]}
        return metrics, [torch.stack(gs) for gs in zip(*(g for _, g in per))]

    def micro_grads(params, mb, mesh):
        if mesh is None:
            if pod_compress:
                return per_pod_grad(params, mb)
            return _grads(cfg, model, params, mb, shard)
        if pod_compress:
            return _pod_grads(cfg, model, params, mb, mesh, npod, shard)
        sub = _sub_mesh(mesh, ())
        metrics, grads = _grads(cfg, model, _on_mesh_of(params, sub),
                                _place_batch(mb, sub), shard)
        return metrics, [_like(g, p) for g, p in
                         zip(grads, tree_lib.leaves(params))]

    def train_step(params, opt_state, batch):
        mesh = _mesh_of(params)
        with shlib.mesh_context(params):
            return step(params, opt_state, batch, mesh)

    def step(params, opt_state, batch, mesh):
        batch = _device_batch(batch, dev)
        if any(x.shape[0] != accum for x in batch.values()):
            raise ValueError(f"train_step: batch leaves must lead with "
                             f"accum = {accum}")
        g_acc, m_acc = None, None
        for a in range(accum):
            mb = {k: x[a] for k, x in batch.items()}
            if pod_compress and mb["tokens"].shape[0] % npod:
                raise ValueError(f"train_step: micro batch "
                                 f"{mb['tokens'].shape[0]} over {npod} pods")
            metrics, g = micro_grads(params, mb, mesh)
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
                pod_tree, opt_state["ef_error"], npod, unshard_pod)
            grads = tree_lib.leaves(grads)
            if mesh is not None:
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for g, p in zip(grads, tree_lib.leaves(params))]
            opt_state = dict(opt_state, ef_error=new_err)
        grads = tree_lib.unflatten(params, grads)
        gnorm = _whole(optimizer.global_norm(grads))
        inner = {k: v for k, v in opt_state.items() if k != "ef_error"}
        params, new_inner = optimizer.update(params, grads, inner)
        if pod_compress:
            opt_state = dict(new_inner, ef_error=opt_state["ef_error"])
        else:
            opt_state = new_inner
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def _mesh_of(params):
    """The DeviceMesh of the parameters, None when they are plain tensors."""
    first = tree_lib.leaves(params)[0]
    return first.device_mesh if shlib.is_dtensor(first) else None


def _place_batch(mb: dict, mesh) -> dict:
    """A microbatch's leaves (whole on every rank) as DTensors over
    ``mesh``, batch over its (pod, data) axes (``batch_spec``, resolved
    against the batch: an axis that does not divide it is dropped)."""
    def spec(x):
        # the batch over (pod, data) where it divides them
        return shlib._resolve(shlib.batch_spec(mesh, x.dim()), x.shape, mesh,
                              uneven_ok=False)

    return {k: shlib.from_whole(x, mesh, shlib.placements(spec(x), mesh))
            for k, x in mb.items()}


def _sub_mesh(mesh, drop: tuple):
    """``mesh`` without the dims named in ``drop`` and without its dims of
    one rank (they place nothing, and every mesh dim multiplies the
    layouts DTensor weighs at each op: a step's first call on a (1, 2, 2)
    mesh took 5x as long as on its (2, 2) sub-mesh); the last dim stays
    when nothing else would."""
    names = tuple(mesh.mesh_dim_names)
    keep = tuple(n for i, n in enumerate(names)
                 if n not in drop and mesh.size(i) > 1)
    keep = keep or tuple(n for n in names if n not in drop)[-1:]
    if keep == names:
        return mesh
    return mesh[keep] if len(keep) > 1 else mesh[keep[0]]


def _on_mesh_of(params, sub):
    """The parameters as DTensors over sub-mesh ``sub``: the same local
    shards, each placed as on the kept dims (a dropped dim must hold each
    parameter whole)."""
    from torch.distributed.tensor import DTensor

    def one(p):
        names = tuple(p.device_mesh.mesh_dim_names)
        for i, n in enumerate(names):
            if n not in sub.mesh_dim_names and p.device_mesh.size(i) > 1 \
                    and not p.placements[i].is_replicate():
                raise ValueError(f"train_step: a parameter is sharded over "
                                 f"{n}")
        pl = [p.placements[names.index(n)] for n in sub.mesh_dim_names]
        return DTensor.from_local(p.to_local(), sub, pl, run_check=False,
                                  shape=p.shape, stride=p.stride())

    return tree_lib.map_tree(one, params)


def _like(g, p):
    """Gradient ``g`` (over a sub-mesh, placed as ``p`` on the kept dims)
    as a DTensor placed as parameter ``p``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(g.to_local(), p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _pod_grads(cfg: ModelConfig, model: Model, params, mb: dict, mesh,
               npod: int, shard):
    """(metrics, per-pod gradients) of microbatch ``mb`` on a mesh: this
    rank's pod takes its slice of the microbatch (``torch.chunk`` over
    ``npod``, as the loop without a mesh) and runs it on its (data, model)
    sub-mesh, its parameters the same local shards (every parameter is
    whole over "pod"); each gradient comes back as this pod's row of an
    [npod, ...] DTensor sharded over "pod", the metrics as the mean of the
    pods' (gathered over "pod", added in pod order)."""
    from torch.distributed.tensor import DTensor, Shard
    names = tuple(mesh.mesh_dim_names)
    has_pod = "pod" in names
    if (mesh.size(names.index("pod")) if has_pod else 1) != npod:
        raise ValueError(f"train_step: npod {npod} on a mesh {names} of "
                         f"shape {tuple(mesh.shape)}")
    pod = mesh.get_local_rank("pod") if has_pod else 0
    sub = _sub_mesh(mesh, ("pod",))
    part = _place_batch({k: torch.chunk(x, npod)[pod] for k, x in mb.items()},
                        sub)
    metrics, grads = _grads(cfg, model, _on_mesh_of(params, sub), part,
                            shard)

    def stack(g, p):
        pl = [Shard(0) if n == "pod" else _shifted(p.placements[i])
              for i, n in enumerate(names)]
        return DTensor.from_local(g.to_local()[None], mesh, pl,
                                  run_check=False,
                                  shape=(npod,) + tuple(p.shape),
                                  stride=torch.empty((npod,) + tuple(p.shape),
                                                     device="meta").stride())

    grads = [stack(g, p) for g, p in zip(grads, tree_lib.leaves(params))]
    if has_pod and npod > 1:
        group = mesh.get_group("pod")
        out = {}
        for k, v in metrics.items():
            got = [torch.empty_like(v) for _ in range(npod)]
            torch.distributed.all_gather(got, v.contiguous(), group=group)
            out[k] = torch.stack(got).mean()
        metrics = out
    else:
        metrics = {k: torch.stack([v]).mean() for k, v in metrics.items()}
    return metrics, grads


def _shifted(p):
    """A placement of a parameter dim, moved one dim on (a pod dim leads)."""
    from torch.distributed.tensor import Shard
    return Shard(p.dim + 1) if p.is_shard() else p


def init_ef_error(params, npod: int):
    """Error-feedback buffer for pod_compress (bf16, one row per pod)."""
    return tree_lib.map_tree(
        lambda p: torch.zeros((npod,) + tuple(p.shape), dtype=torch.bfloat16,
                              device=p.device), params)


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      device: str | torch.device = "cuda",
                      shard: layers.Shard = layers.no_shard):
    model = get_model(cfg, device)

    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len, shard)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device: str | torch.device = "cuda",
                     shard: layers.Shard = layers.no_shard):
    model = get_model(cfg, device)

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, shard)

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
