"""Assigned input shapes (same four for every architecture; a copy of
``repro.configs.shapes``)."""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeConfig", "SHAPES", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int            # train/prefill: prompt length; decode: cache size
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(family: str) -> list[str]:
    """long_500k needs sub-quadratic attention: it runs for the hybrid
    (local-window cache) and the SSM (O(1) state); pure full-attention archs
    skip it (DESIGN.md §Arch-applicability)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if family in ("hybrid", "ssm"):
        names.append("long_500k")
    return names
