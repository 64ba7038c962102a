"""AdamW + cosine schedule + global-norm clipping (the port of
``repro.optim.adamw``), over the port's parameter trees.

The state is ``{"m": tree, "v": tree, "step": int32 scalar}`` with ``m``
and ``v`` in float32, shaped like the parameters.  ``update`` runs leaf by
leaf with the reference's arithmetic in the reference's order (each product
and sum rounded on its own, no fused multiply-add), and writes the
parameters, ``m`` and ``v`` IN PLACE: the reference's jitted step donates
them, and at full width two copies of the optimizer state would not fit
beside the model (16 B a parameter once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import obs
from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding as shlib

__all__ = ["AdamW", "cosine_schedule"]


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``final_frac``
    of it; ``lr(step)`` is a float32 tensor (of ``step``'s device)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1) / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        first = tree_lib.leaves(params)[0]
        return {
            "m": tree_lib.map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params),
            "v": tree_lib.map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device),
        }

    @staticmethod
    def global_norm(tree) -> torch.Tensor:
        """sqrt of the sum over the leaves (in ``jax.tree.leaves``' order)
        of each leaf's sum of squares, in float32.  A DTensor leaf's sum is
        its local shard's, added over the mesh dims that split it (a plain
        tensor, the same on every rank)."""
        total = 0
        for g in tree_lib.leaves(tree):
            if shlib.is_dtensor(g):
                total = total + _sum_squares(g)
                continue
            gf = g.float()
            total = total + torch.sum(gf * gf)
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))

    @torch.no_grad()
    def update(self, params, grads, state) -> tuple:
        """One clipped AdamW step: returns ``(params, state)``, the same
        tensors updated in place, and the new step count.  The profiler
        range ``repro_torch.adamw`` names its kernels in a trace."""
        with obs.span("repro_torch.adamw", profiler=True):
            return self._update(params, grads, state)

    def _update(self, params, grads, state) -> tuple:
        gnorm = self.global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        step = state["step"] + 1
        # a DTensor step (replicated) enters the arithmetic whole
        step_w = step.full_tensor() if shlib.is_dtensor(step) else step
        lr = self.lr(step_w) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        t = step_w.to(torch.float32)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        for p, g, m, v in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                              tree_lib.leaves(state["m"]),
                              tree_lib.leaves(state["v"])):
            if shlib.is_dtensor(p):
                # elementwise on the local shards, written in place
                p, g, m, v = _locals(p, g, m, v)
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            del g
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            pf = p.float()
            u.add_(self.weight_decay * pf)
            p.copy_(pf - lr * u)
            del u, pf
        return params, {"m": state["m"], "v": state["v"], "step": step}


def _sum_squares(g) -> torch.Tensor:
    """A DTensor's sum of squares in float32 as a plain tensor: the local
    shard's, SUM all-reduced over each mesh dim that splits it."""
    gl = g.to_local().float()
    total = torch.sum(gl * gl)
    for i, p in enumerate(g.placements):
        if p.is_shard():
            torch.distributed.all_reduce(total,
                                         group=g.device_mesh.get_group(i))
        elif p.is_partial():
            raise ValueError("global_norm: a partial gradient")
    return total


def _locals(*xs):
    """The local shards of DTensors placed alike (a parameter, its
    gradient and its moments)."""
    pl = xs[0].placements
    for x in xs[1:]:
        if x.placements != pl:
            raise ValueError(f"AdamW: placements {x.placements} beside "
                             f"the parameter's {pl}")
    return tuple(x.to_local() for x in xs)
