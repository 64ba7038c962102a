"""Composable move kernels for the fleet optimizer (a numpy copy of
``repro.design.moves``).

A move kernel is ``move(cand, rng, space) -> Candidate | None``: propose a
neighbour of ``cand`` in ``space``, drawing all randomness from ``rng``
(the optimizer's single seeded generator — determinism and resumability
hang on kernels never touching other entropy).  ``None`` means "not
applicable here" (e.g. a parametric move on a non-parametric space, or an
infeasible parameter point) and the optimizer draws another kernel.

Kernels preserve physical feasibility by construction:

* ``swap_edges`` — double-edge swaps: remove one ``space.link_unit`` of
  capacity from links (u,v) and (x,y), add it to (u,x) and (v,y).  Every
  node's total attached capacity (its port count × line speed) is exactly
  preserved, so any wiring the kernel emits uses the same equipment.
  Swaps never create self-loops and respect ``space.forbidden_pairs`` /
  ``rewirable_mask``; parallel links are fine (capacities sum).
* ``move_servers`` — shift servers between switch classes by perturbing
  the ``servers_on_large`` design parameter and rebuilding from a fresh
  wiring seed (paper §5.1's knob).
* ``perturb_bias`` — multiplicative perturbation of the ``cross_bias``
  parameter (paper §5.2's knob), rebuilt the same way.

``MOVES`` is the registry the optimizer draws from; register custom
kernels by name to extend the search.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graphs import Topology
from repro_torch.design.spaces import Candidate, DesignSpace

__all__ = ["swap_edges", "move_servers", "perturb_bias", "MOVES"]


def swap_edges(cand: Candidate, rng: np.random.Generator,
               space: DesignSpace, swaps: int = 4) -> Candidate | None:
    """Degree-preserving double-edge swaps on the candidate's wiring.

    Attempts up to ``swaps`` successful swaps (each moving one
    ``space.link_unit`` of capacity); gives up on a pick after a bounded
    number of rejections, so the kernel always terminates.  Returns
    ``None`` when the rewirable subgraph has fewer than two links.
    """
    topo = cand.topo
    cap = topo.cap.copy()
    unit = space.link_unit
    rewirable = space.rewirable_mask(topo)
    forbidden = space.forbidden_pairs(topo)
    swappable = space.swappable_links(topo)
    done = 0
    for _ in range(swaps * 8):
        if done >= swaps:
            break
        removable = np.triu(cap, 1) >= unit
        if swappable is not None:
            # budget-constrained spaces: only these links may be removed —
            # the mask moves with the wiring, so recompute it per swap
            removable &= np.triu(swappable, 1)
        iu, iv = np.nonzero(removable)
        ok = rewirable[iu] & rewirable[iv]
        iu, iv = iu[ok], iv[ok]
        if len(iu) < 2:
            break
        a, b = rng.choice(len(iu), size=2, replace=False)
        u, v = int(iu[a]), int(iv[a])
        x, y = int(iu[b]), int(iv[b])
        if rng.random() < 0.5:
            x, y = y, x
        # rewire (u,v)+(x,y) -> (u,x)+(v,y); reject degenerate picks
        if len({u, v, x, y}) < 4:
            continue
        if forbidden is not None and (forbidden[u, x] or forbidden[v, y]):
            continue
        for p, q, s in ((u, v, -unit), (x, y, -unit),
                        (u, x, +unit), (v, y, +unit)):
            cap[p, q] += s
            cap[q, p] += s
        done += 1
    if done == 0:
        return None
    return dataclasses.replace(
        cand, topo=Topology(cap=cap, servers=topo.servers,
                            labels=topo.labels),
        origin="swap")


def _perturb_param(cand: Candidate, rng: np.random.Generator,
                   space: DesignSpace, key: str, new_value,
                   origin: str) -> Candidate | None:
    lo, hi = space.param_bounds.get(key, (-np.inf, np.inf))
    params = {**cand.params, key: np.clip(new_value, lo, hi)}
    seed = int(rng.integers(1 << 31))
    try:
        topo = space.rebuild(params, seed)
    except ValueError:
        return None      # infeasible parameter point: kernel inapplicable
    if topo is None:
        return None
    return Candidate(topo=topo, params=params, seed=seed, origin=origin)


def move_servers(cand: Candidate, rng: np.random.Generator,
                 space: DesignSpace) -> Candidate | None:
    """Shift 1–3 servers between switch classes (perturbs the
    ``servers_on_large`` parameter; rebuilds with a fresh wiring seed)."""
    if "servers_on_large" not in cand.params:
        return None
    delta = int(rng.integers(1, 4)) * int(rng.choice((-1, 1)))
    return _perturb_param(cand, rng, space, "servers_on_large",
                          int(cand.params["servers_on_large"]) + delta,
                          origin="servers")


def perturb_bias(cand: Candidate, rng: np.random.Generator,
                 space: DesignSpace) -> Candidate | None:
    """Multiplicatively perturb the ``cross_bias`` parameter (log-normal
    step, ~±25%; rebuilds with a fresh wiring seed)."""
    if "cross_bias" not in cand.params:
        return None
    factor = float(np.exp(rng.normal(0.0, 0.25)))
    return _perturb_param(cand, rng, space, "cross_bias",
                          float(cand.params["cross_bias"]) * factor,
                          origin="bias")


# name -> kernel; the optimizer's ``moves=`` argument indexes this
MOVES = {"swap": swap_edges, "servers": move_servers, "bias": perturb_bias}
