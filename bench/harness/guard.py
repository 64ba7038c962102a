"""What a run may not load: JAX or the JAX package, compared by the whole
top-level name of each module (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Forbidden(RuntimeError):
    """A run loaded a module it may not."""


def loaded(forbidden: tuple[str, ...] = FORBIDDEN,
           modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of ``forbidden``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in forbidden)
