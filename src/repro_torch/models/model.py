"""Architecture registry and serve step factories (the port of
``repro.models.model`` for the serving path).

Families dispatch to their module (``transformer`` for dense, moe, vlm and
audio, ``rglru`` for the hybrid, ``rwkv6`` for the ssm family), all
exposing init_params / forward / prefill / decode_step / init_cache.
``Model`` binds a config and a device; its functions run eagerly (no jit).
``load_reference_params`` carries the reference's own parameter pytree
across, so that both packages compute the same thing.  The loss and the
train step come with the training slice (ROADMAP A8.2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import rglru, rwkv6, transformer as tfm
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "get_model", "make_prefill_step", "make_decode_step",
           "load_reference_params"]

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
