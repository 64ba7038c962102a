"""Shared pieces of the port's mesh tests (``tests/test_torch_sharding.py``
and ``tests/test_torch_multipod.py``).

``gspmd_slices`` is the reference's placement of a spec's rows on a mesh,
written out: a dim split over an axis tuple (major to minor) takes each
device's linear index over those axes, and chunks of ceil(n / size) rows
(the last ones short or empty).  The jax side of the sharding test holds
``NamedSharding.devices_indices_map`` to it, the multi-rank test each
DTensor's local slice.

``SLICE_CASES`` are the specs and shapes both compare, on the two 4-rank
meshes of the multi-rank test.  jax places only dims that divide their
axes (``devices_indices_map`` refuses the others), so the ``UNEVEN_CASES``
(one axis, GSPMD's padded chunks) are held to the rule on DTensor's side
only.
"""
from __future__ import annotations

import math

MESHES = {"pod": ((2, 2, 1), ("pod", "data", "model")),
          "model": ((1, 2, 2), ("pod", "data", "model"))}

SLICE_CASES = [
    ((("pod", "data"), None), (8, 3)),
    ((None, ("data", "model")), (3, 8)),
    (("model", "data"), (4, 6)),
    ((("pod", "data"), "model", None), (4, 6, 5)),
]

UNEVEN_CASES = [
    ((None, "model"), (3, 7)),
    (("data", None), (3, 2)),
    ((None, None, "model", None), (2, 3, 1, 4)),   # one kv head, two ranks
]


def gspmd_slices(spec, shape, mesh_shape, names) -> list:
    """[[(start, stop) per dim] per device, devices in row-major mesh
    order]."""
    out = []
    for dev in range(math.prod(mesh_shape)):
        coord, rest = [], dev
        for size in reversed(mesh_shape):
            coord.append(rest % size)
            rest //= size
        coord = dict(zip(names, reversed(coord)))
        box = []
        for n, entry in zip(shape, list(spec) + [None] * (len(shape)
                                                          - len(spec))):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            size = math.prod(mesh_shape[names.index(a)] for a in axes)
            idx = 0
            for a in axes:
                idx = idx * mesh_shape[names.index(a)] + coord[a]
            chunk = -(-n // size)
            start = min(idx * chunk, n)
            box.append((start, min(start + chunk, n)))
        out.append(box)
    return out


class FakeMesh:
    """A mesh description (the reference's ``tests/test_sharding.py``
    ``FakeMesh``), sized as asked."""

    def __init__(self, shape: tuple, names: tuple):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.size = math.prod(shape)
