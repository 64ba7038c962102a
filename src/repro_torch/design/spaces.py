"""Design spaces: what the fleet optimizer searches over (a numpy copy of
``repro.design.spaces`` over the port's ``heterogeneous`` and ``vl2``).

The paper's second half is not a fixed recipe but a *method*: given a
heterogeneous switch pool, search the server distribution and the
interconnect for throughput (the 43% VL2 rewiring gain is one point this
search finds).  A ``DesignSpace`` makes that search space explicit:

* ``initial(seed)`` — a seeded starting ``Candidate``.  Random wirings are
  strong starting points (Jellyfish), so every concrete space seeds from
  its paper-recipe random construction — which also makes the recipe
  itself candidate 0, so the optimizer can never report a wiring worse
  than the recipe it started from.
* ``rebuild(params, seed)`` — re-run the space's constructor with perturbed
  design parameters (the *parametric* move kernels: server re-distribution
  across switch classes, cross-cluster bias).  Non-parametric spaces
  return ``None``.
* ``rewirable_mask(topo)`` / ``forbidden_pairs(topo)`` — which nodes'
  links a degree-preserving edge swap may touch, and which node pairs must
  never be directly linked (e.g. ToR–ToR in VL2).
* ``link_unit`` — capacity quantum one swap moves (1 base-speed link for
  two-class pools, one 10GbE link for VL2 fabric).
* ``param_bounds`` — clipping ranges for the parametric moves.

A ``Candidate`` pairs the concrete ``Topology`` with the design parameters
that produced it (empty for purely-rewired candidates) and its wiring-seed
lineage, so every point the search visits is reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from repro_torch.core import heterogeneous as het
from repro_torch.core import vl2 as vl2_mod
from repro_torch.core.graphs import Topology

__all__ = ["Candidate", "DesignSpace", "TwoClassSpace", "VL2Space"]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a design space: the built topology, the design
    parameters that produced it (``{}`` when the candidate exists only as
    a rewiring), and the wiring seed it was last (re)built from."""

    topo: Topology
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0
    origin: str = "initial"    # move kernel that produced this candidate


class DesignSpace:
    """Base class for search spaces; concrete spaces override ``initial``
    (required) and whichever hooks their move kernels need."""

    link_unit: float = 1.0     # capacity one edge swap moves between pairs

    # clipping bounds per parametric-move key ({} = no parametric moves)
    param_bounds: Mapping[str, tuple[float, float]] = {}

    def initial(self, seed: int) -> Candidate:
        """A seeded starting candidate (the space's paper recipe)."""
        raise NotImplementedError

    def rebuild(self, params: Mapping[str, Any],
                seed: int) -> Topology | None:
        """Re-run the constructor with new ``params``; ``None`` when the
        space has no parametric form.  May raise ``ValueError`` for an
        infeasible parameter point (the move kernel treats that as
        'inapplicable' and the optimizer draws another move)."""
        return None

    def rewirable_mask(self, topo: Topology) -> np.ndarray:
        """[N] bool: nodes whose incident links edge swaps may rewire."""
        return np.ones(topo.n, dtype=bool)

    def forbidden_pairs(self, topo: Topology) -> np.ndarray | None:
        """[N, N] bool (True = this pair must never be directly linked),
        or None when any switch pair may be wired."""
        return None

    def swappable_links(self, topo: Topology) -> np.ndarray | None:
        """[N, N] bool (True = an edge swap may REMOVE a ``link_unit`` from
        this pair), or None when every present link is fair game.  Spaces
        with a recabling budget (the reference's
        ``repro.lifecycle.ExpansionSpace``) restrict removal to links that
        are already deviations from a base wiring — a swap then moves
        changed links around without ever disturbing another original
        link, so the budget can only shrink."""
        return None


class TwoClassSpace(DesignSpace):
    """The §5 two-class pool: search server placement, cross-cluster bias,
    and the wiring itself.  Parametric over ``servers_on_large`` (server
    re-distribution across switch classes) and ``cross_bias``."""

    def __init__(self, spec: het.TwoClassSpec):
        self.spec = spec
        self.param_bounds = {
            "servers_on_large": (0, spec.num_servers),
            "cross_bias": (0.05, 4.0),
        }

    def initial(self, seed: int) -> Candidate:
        params = {"servers_on_large": self.spec.proportional_large_servers,
                  "cross_bias": 1.0}
        return Candidate(topo=self.rebuild(params, seed), params=params,
                         seed=seed)

    def rebuild(self, params, seed: int) -> Topology:
        return het.build_two_class(self.spec,
                                   int(params["servers_on_large"]),
                                   float(params["cross_bias"]), seed)


class VL2Space(DesignSpace):
    """The §7 VL2 equipment pool at a fixed ToR count: candidates are
    degree-preserving rewirings of the paper's proportional random rewiring
    (``vl2.rewired_vl2_topology`` is candidate 0).  All links are 10GbE, so
    one swap moves a whole fabric link; ToR–ToR links are forbidden (a ToR's
    two uplinks must reach the switching fabric)."""

    link_unit = vl2_mod.FABRIC

    def __init__(self, spec: vl2_mod.VL2Spec, n_tor: int):
        self.spec = spec
        self.n_tor = n_tor

    def initial(self, seed: int) -> Candidate:
        topo = vl2_mod.rewired_vl2_topology(self.spec, self.n_tor, seed)
        return Candidate(topo=topo, params={}, seed=seed)

    def forbidden_pairs(self, topo: Topology) -> np.ndarray:
        tor = topo.labels == 0
        return tor[:, None] & tor[None, :]
