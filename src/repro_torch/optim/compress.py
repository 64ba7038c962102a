"""Int8 error-feedback gradient compression for the cross-pod hop (the port
of ``repro.optim.compress``).

Each pod quantises (gradient + error feedback) to int8 with its own
per-tensor scale; the mean over pods of the dequantised values is the
compressed cross-pod gradient, and the quantisation error (kept in bf16)
is carried to the next step.  On one device there is no pod axis to
all-gather over, so ``unshard_pod`` stays None, as it does in the
reference without a multi-pod mesh; the per-pod gradients come from a loop
over ``npod`` slices of the microbatch (``models.model.make_train_step``).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib

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


def ef_compress_mean(grads_per_pod, error, npod: int, unshard_pod=None):
    """Compress + cross-pod mean with error feedback.

    grads_per_pod: tree with leading dim [npod, ...] per leaf (float32).
    error:         tree like grads_per_pod (the EF buffer, bf16).
    Returns (mean gradients without the pod dim, new error)."""
    if unshard_pod is not None:
        raise ValueError("ef_compress_mean: unshard_pod needs a multi-pod "
                         "mesh, which the port does not have (ROADMAP A8.3)")

    def one(g, e):
        if g.shape[0] != npod:
            raise ValueError(f"ef_compress_mean: leading dim {g.shape[0]}, "
                             f"npod {npod}")
        ge = g + e.to(torch.float32)
        q, scale = _per_pod(int8_quantize, ge)
        new_e = (ge - _per_pod(int8_dequantize, q, scale)).to(torch.bfloat16)
        mean = torch.mean(_per_pod(int8_dequantize, q, scale), dim=0)
        return mean, new_e

    out = [one(g, e) for g, e in zip(tree_lib.leaves(grads_per_pod),
                                     tree_lib.leaves(error))]
    return (tree_lib.unflatten(grads_per_pod, [m for m, _ in out]),
            tree_lib.unflatten(grads_per_pod, [e for _, e in out]))
