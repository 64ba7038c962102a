"""Int8 error-feedback gradient compression for the cross-pod hop (the port
of ``repro.optim.compress``).

Each pod quantises (gradient + error feedback) to int8 with its own
per-tensor scale; the mean over pods of the dequantised values is the
compressed cross-pod gradient, and the quantisation error (kept in bf16)
is carried to the next step.

On one device the per-pod gradients come from a loop over ``npod`` slices
of the microbatch (``models.model.make_train_step``) and ``unshard_pod``
stays None, as in the reference without a multi-pod mesh.  On a mesh with
a ``"pod"`` axis they are [npod, ...] DTensors sharded over it (and over
"data"/"model" within a pod, as ``state_specs`` places ``ef_error``):
each pod's scale is a max over its own shards, and ``unshard_pod``
gathers the pods' int8 ``q`` and float32 scales over "pod", the only
cross-pod collective; every pod then takes the same mean.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding as shlib

__all__ = ["int8_quantize", "int8_dequantize", "ef_compress_mean"]


def int8_quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation; returns (q, scale)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _per_pod(fn, *xs):
    """``fn`` on each pod's slice (the leading axis), results stacked: the
    reference's ``jax.vmap`` over the pod axis."""
    outs = [fn(*(x[i] for x in xs)) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _one_on_mesh(g, e, unshard_pod):
    """One leaf of ``ef_compress_mean`` on a mesh: ``g`` and ``e``
    [npod, ...] DTensors.  Every step is elementwise on the local shards
    but two: each pod's max, a MAX all-reduce over the mesh dims that
    split the pod's row, and ``unshard_pod`` on ``q`` and the scales.  The
    same max, scale, rounding and pod-order mean as without a mesh, so the
    result is the same bits."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = g.device_mesh, list(g.placements)
    ge = g.to_local() + e.redistribute(mesh, pl).to_local().to(torch.float32)
    amax = torch.amax(torch.abs(ge), dim=tuple(range(1, ge.dim())))
    for i, p in enumerate(pl):
        if p.is_shard() and p.dim > 0:
            torch.distributed.all_reduce(
                amax, op=torch.distributed.ReduceOp.MAX,
                group=mesh.get_group(i))
    scale = (torch.clamp(amax, min=1e-12) / 127.0).to(torch.float32)
    scale = scale.reshape((-1,) + (1,) * (ge.dim() - 1))
    q = torch.clamp(torch.round(ge / scale), -127, 127).to(torch.int8)
    new_e = (ge - int8_dequantize(q, scale)).to(torch.bfloat16)

    def glob(x, placements, shape):
        return DTensor.from_local(x, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    new_e = glob(new_e, pl, tuple(e.shape))
    pod_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    q = glob(q, pl, tuple(g.shape))
    scale = glob(scale, pod_pl, (g.shape[0],) + (1,) * (g.dim() - 1))
    if unshard_pod is not None:
        q = unshard_pod(q)          # <- the only cross-pod collective
        scale = unshard_pod(scale)
    if any(p.is_shard(0) for p in q.placements):
        # pods still apart (no unshard_pod): DTensor takes the mean
        return torch.mean(int8_dequantize(q, scale), dim=0), new_e
    out_pl = [Shard(p.dim - 1) if p.is_shard() else Replicate()
              for p in q.placements]
    mean = torch.mean(int8_dequantize(q.to_local(), scale.to_local()), dim=0)
    return glob(mean, out_pl, tuple(g.shape[1:])), new_e


def ef_compress_mean(grads_per_pod, error, npod: int, unshard_pod=None):
    """Compress + cross-pod mean with error feedback.

    grads_per_pod: tree with leading dim [npod, ...] per leaf (float32).
    error:         tree like grads_per_pod (the EF buffer, bf16).
    unshard_pod:   callable that takes a DTensor [npod, ...] from sharded
                   over "pod" to whole over it (the other dims as they
                   are): applied to the int8 ``q`` and the scales, the
                   only cross-pod collective.
    Returns (mean gradients without the pod dim, new error)."""
    def one(g, e):
        if g.shape[0] != npod:
            raise ValueError(f"ef_compress_mean: leading dim {g.shape[0]}, "
                             f"npod {npod}")
        if shlib.is_dtensor(g):
            return _one_on_mesh(g, e, unshard_pod)
        ge = g + e.to(torch.float32)
        q, scale = _per_pod(int8_quantize, ge)
        new_e = (ge - _per_pod(int8_dequantize, q, scale)).to(torch.bfloat16)
        if unshard_pod is not None:
            q = unshard_pod(q)
            scale = unshard_pod(scale)
        mean = torch.mean(_per_pod(int8_dequantize, q, scale), dim=0)
        return mean, new_e

    out = [one(g, e) for g, e in zip(tree_lib.leaves(grads_per_pod),
                                     tree_lib.leaves(error))]
    return (tree_lib.unflatten(grads_per_pod, [m for m, _ in out]),
            tree_lib.unflatten(grads_per_pod, [e for _, e in out]))
