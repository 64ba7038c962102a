"""Seeded failure-scenario generation: fleets of degraded topologies (a
numpy copy of ``repro.lifecycle.failures`` over the port's
``Topology.degrade``: the same arguments give the same fleet).

The operational questions about a wiring start where the paper's figures
stop: what happens when links cut, switches die, or a whole shared-risk
group (one VL2 aggregation class, one power feed) goes down together?
This module turns one base ``Topology`` into a deterministic fleet of
degraded variants, one per (failure kind × failure fraction × trial):

* ``fail_links`` — each trial removes ``round(fraction * #links)`` links
  chosen uniformly without replacement (independent link failures).
* ``fail_switches`` — removes ``round(fraction * N)`` switches: their
  rows/columns zero and their servers strand (``Topology.degrade``).
* ``fail_srg`` — correlated failures: removes ``round(fraction *
  #groups)`` whole shared-risk groups.  ``srg_from_labels`` builds the
  default grouping — one group per label class (so on VL2 a single draw
  can take out the entire aggregation layer); unlabeled topologies fall
  back to singleton groups (== switch failures).

Graceful degradation is a contract, not an accident: every scenario keeps
the base node count (rows zero, nodes never disappear), so a whole fleet
of mixed failure kinds lands in ONE ``BatchPlan`` bucket and later rounds
``refill`` the same plan.  Unroutable demand is the solver
layer's job (``mcf.drop_disconnected`` / engines' ``on_disconnected``) —
generation never crashes on a disconnected draw.

Determinism: ``scenario_fleet`` seeds each trial's generator as
``default_rng((seed, kind_id, fraction_index, trial))``, so the same
arguments always reproduce the identical fleet, independent of iteration
order or how many fractions/trials surround a given scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.graphs import Topology

__all__ = ["Scenario", "fail_links", "fail_switches", "fail_srg",
           "srg_from_labels", "scenario_fleet", "FAIL_KINDS"]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One degraded variant of a base topology.

    ``topo`` has the SAME node count as the base (dead switches are zeroed
    rows, not removed) — that is what lets a whole fleet share one
    ``BatchPlan`` bucket.  ``server_fraction`` is the share of the base's
    servers still attached (stranded servers were zeroed by
    ``Topology.degrade``); demand reachability on top of the survivors is
    the solver layer's ``reachable_fraction``.
    """

    topo: Topology
    kind: str                       # FAIL_KINDS key that produced this
    fraction: float                 # requested failure fraction
    trial: int = 0
    seed: int = 0                   # fleet seed (0 for direct fail_* calls)
    failed_links: int = 0           # links removed (direct cuts only)
    dead_switches: tuple[int, ...] = ()
    server_fraction: float = 1.0    # surviving servers / base servers


def _server_fraction(base: Topology, degraded: Topology) -> float:
    total = int(base.servers.sum())
    return 1.0 if total == 0 else float(degraded.servers.sum()) / total


def fail_links(topo: Topology, fraction: float,
               rng: np.random.Generator) -> Scenario:
    """Remove ``round(fraction * #links)`` links uniformly at random
    (parallel-capacity pairs count once; the whole pair capacity cuts)."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    iu, iv = np.nonzero(np.triu(topo.cap, 1) > 0)
    k = int(round(fraction * len(iu)))
    mask = np.ones((topo.n, topo.n), dtype=bool)
    if k:
        pick = rng.choice(len(iu), size=k, replace=False)
        mask[iu[pick], iv[pick]] = False
        mask[iv[pick], iu[pick]] = False
    degraded = topo.degrade(link_mask=mask)
    return Scenario(topo=degraded, kind="links", fraction=fraction,
                    failed_links=k,
                    server_fraction=_server_fraction(topo, degraded))


def fail_switches(topo: Topology, fraction: float,
                  rng: np.random.Generator) -> Scenario:
    """Kill ``round(fraction * N)`` switches uniformly at random: their
    links cut and their servers strand."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    k = int(round(fraction * topo.n))
    dead = (np.sort(rng.choice(topo.n, size=k, replace=False))
            if k else np.zeros(0, np.int64))
    degraded = topo.degrade(dead_switches=dead)
    return Scenario(topo=degraded, kind="switches", fraction=fraction,
                    dead_switches=tuple(int(d) for d in dead),
                    server_fraction=_server_fraction(topo, degraded))


def srg_from_labels(topo: Topology) -> list[np.ndarray]:
    """Default shared-risk grouping: one group per label class (VL2's
    ToR / aggregation / core layers each fail together — the paper's
    heterogeneous pools group by switch class the same way).  Unlabeled
    topologies degrade to singleton groups, i.e. plain switch failures."""
    if topo.labels is None:
        return [np.array([i], np.int64) for i in range(topo.n)]
    return [np.flatnonzero(topo.labels == v)
            for v in np.unique(topo.labels)]


def fail_srg(topo: Topology, fraction: float, rng: np.random.Generator,
             groups: Sequence[np.ndarray] | None = None) -> Scenario:
    """Correlated failure: kill ``round(fraction * #groups)`` whole
    shared-risk ``groups`` at once (default grouping:
    ``srg_from_labels``)."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    groups = srg_from_labels(topo) if groups is None else list(groups)
    if not groups:
        raise ValueError("fail_srg needs at least one shared-risk group")
    k = int(round(fraction * len(groups)))
    dead = np.zeros(0, np.int64)
    if k:
        pick = rng.choice(len(groups), size=k, replace=False)
        dead = np.unique(np.concatenate([np.asarray(groups[g], np.int64)
                                         for g in pick]))
    degraded = topo.degrade(dead_switches=dead)
    return Scenario(topo=degraded, kind="srg", fraction=fraction,
                    dead_switches=tuple(int(d) for d in dead),
                    server_fraction=_server_fraction(topo, degraded))


# kind name -> generator(topo, fraction, rng) -> Scenario; KIND ORDER IS
# PART OF THE SEEDING CONTRACT (scenario_fleet keys its rng streams by the
# kind's position here), so append new kinds — never reorder.
FAIL_KINDS: dict[str, Callable] = {
    "links": fail_links,
    "switches": fail_switches,
    "srg": fail_srg,
}


def scenario_fleet(topo: Topology, kind: str,
                   fractions: Sequence[float], trials: int,
                   seed: int = 0, **kind_kw) -> list[Scenario]:
    """The degraded fleet for one failure ``kind``: ``len(fractions) ×
    trials`` scenarios, fraction-major then trial order.

    Each scenario draws from its own ``default_rng((seed, kind_id,
    fraction_index, trial))`` stream — the same call always reproduces the
    identical fleet, and streams stay independent across kinds, fractions
    and trials.  ``kind_kw`` forwards to the generator (e.g. ``groups=``
    for ``"srg"``).
    """
    if kind not in FAIL_KINDS:
        raise ValueError(f"unknown failure kind {kind!r}; "
                         f"known: {list(FAIL_KINDS)}")
    if trials < 1:
        raise ValueError(f"need trials >= 1, got {trials}")
    kind_id = list(FAIL_KINDS).index(kind)
    fleet = []
    for fi, frac in enumerate(fractions):
        for t in range(trials):
            rng = np.random.default_rng((seed, kind_id, fi, t))
            sc = FAIL_KINDS[kind](topo, float(frac), rng, **kind_kw)
            fleet.append(dataclasses.replace(sc, trial=t, seed=seed))
    return fleet
