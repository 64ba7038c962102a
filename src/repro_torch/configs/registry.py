"""Architecture registry: --arch <id> -> ModelConfig (+ smoke variant)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke", "expert_parallel_ok"]

# assignment id -> module name under repro_torch.configs
ARCH_IDS = {
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-4b": "minitron_4b",
    "granite-20b": "granite_20b",
    "mistral-large-123b": "mistral_large_123b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-7b": "rwkv6_7b",
    "musicgen-medium": "musicgen_medium",
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def expert_parallel_ok(cfg: ModelConfig, model_axis: int) -> bool:
    return cfg.num_experts > 0 and cfg.num_experts % model_axis == 0
