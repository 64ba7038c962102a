"""Parameter trees: nested dicts and lists of tensors (the port's stand-in
for JAX pytrees).

``leaves`` walks a tree in ``jax.tree.leaves``' order (dict keys sorted,
list items in order), so that sums over the leaves (the global gradient
norm) add in the reference's order, and ``paths`` names each leaf as
``jax.tree_util.keystr`` does (``['params']['blocks']['wq']``, ``[0]`` for
a list item), so that checkpoints carry the same keys in both packages.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "paths", "unflatten", "map_tree"]


def _items(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order."""
    items = _items(tree)
    if items is None:
        return [tree]
    return [x for _, sub in items for x in leaves(sub)]


def paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's key string (``jax.tree_util.keystr``'s format), in
    ``leaves``' order."""
    items = _items(tree)
    if items is None:
        return [prefix]
    return [p for key, sub in items for p in paths(sub, prefix + key)]


def unflatten(tree, new_leaves: list):
    """A tree shaped like ``tree`` holding ``new_leaves`` (in ``leaves``'
    order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map_tree(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the
    same shape), as ``jax.tree.map``."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
