"""Incremental expansion: grow a live network with minimal recabling
(the port of ``repro.lifecycle.expansion``).

Jellyfish's observation (arXiv 1110.1687) is that random-graph fabrics
expand incrementally: to add a switch, break a few existing links (u, v)
and wire (u, s), (v, s) through the new switch s.  Every broken link
survives as the two-hop path u–s–v at full capacity, so every flow the
old network carried still embeds in the new one — throughput can only go
up.  This module turns that into a certified planner:

* ``attach_new_switches`` — the Jellyfish attach, budgeted: at most
  ``max_breaks`` existing links are broken (the recabling cost of the
  step); leftover new-switch ports stay spare rather than blow the
  budget.
* ``ExpansionSpace`` — a ``DesignSpace`` over the attached wiring whose
  ``swappable_links`` hook restricts edge swaps to links ADDED relative
  to the pre-expansion base.  A swap can move added links around or put a
  broken base link back, but can never remove another base link — so the
  recabled-link count is non-increasing under search and
  ``max_recabled_links`` is an invariant, not a hope.
* ``plan_expansion`` — the growth loop: per step, attach the step's new
  switches, then run ``design.optimize`` (swap moves only, the attach
  wiring as the un-beatable reference) to spend the recabling budget
  where it buys throughput.  Each step reports a certified (lb, ub)
  bracket; the certified lb is monotone non-decreasing BY CONSTRUCTION:
  the attach preserves the previous step's flows, so the previous
  certified lb is inherited as a valid bound for the attached wiring,
  and a rewired candidate replaces it only when its own measured
  certificate is higher.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.engine import _PlannedEngine
from repro_torch.core.graphs import Topology
from repro_torch.design.optimizer import optimize
from repro_torch.design.spaces import Candidate, DesignSpace

__all__ = ["Attachment", "attach_new_switches", "recabled_links",
           "ExpansionSpace", "ExpansionStep", "ExpansionResult",
           "plan_expansion"]


@dataclasses.dataclass(frozen=True)
class Attachment:
    """One Jellyfish attach: the grown topology (old nodes first, new
    switches appended), how many existing links were broken to wire it
    (== recabled base links), and how many new ports stayed spare."""

    topo: Topology
    broken_links: int
    spare_ports: int


def attach_new_switches(topo: Topology, ports: Sequence[int], *,
                        link_unit: float = 1.0, seed: int = 0,
                        labels: Sequence[int] | None = None,
                        max_breaks: int | None = None,
                        forbidden: np.ndarray | None = None) -> Attachment:
    """Attach new switches Jellyfish-style: for each new switch with ``p``
    ports, break up to ``p // 2`` random existing links (u, v) — both
    endpoints among the ORIGINAL nodes — and wire (u, s), (v, s) at
    ``link_unit`` capacity each.

    Old flows are preserved (each broken link becomes a two-hop path of
    the same capacity through s), so θ* never drops.  ``max_breaks`` caps
    the total recabling; once spent, remaining new ports stay spare.
    ``labels`` assigns label values to the new switches (required iff the
    base topology is labeled); ``forbidden[n, n]`` (post-growth size)
    vetoes breaking a link whose re-wiring would create a forbidden pair.
    New switches host no servers (fabric growth).
    """
    ports = [int(p) for p in ports]
    if any(p < 0 for p in ports):
        raise ValueError(f"ports must be non-negative, got {ports}")
    n0, k = topo.n, len(ports)
    n = n0 + k
    cap = np.zeros((n, n))
    cap[:n0, :n0] = topo.cap
    servers = np.concatenate([topo.servers, np.zeros(k, np.int64)])
    if (topo.labels is None) != (labels is None):
        raise ValueError("labels must be given exactly when the base "
                         "topology is labeled")
    lab = None if topo.labels is None else np.concatenate(
        [topo.labels, np.asarray(list(labels), np.int64)])
    if forbidden is not None and forbidden.shape != (n, n):
        raise ValueError(f"forbidden must be ({n}, {n}) (post-growth), "
                         f"got {forbidden.shape}")
    rng = np.random.default_rng(seed)
    budget = np.inf if max_breaks is None else int(max_breaks)
    breaks = 0
    spare = 0
    for j, p in enumerate(ports):
        s = n0 + j
        wired = 0
        for _ in range(p // 2):
            if breaks >= budget:
                break
            iu, iv = np.nonzero(np.triu(cap[:n0, :n0], 1) >= link_unit)
            if forbidden is not None and len(iu):
                ok = ~(forbidden[iu, s] | forbidden[iv, s])
                iu, iv = iu[ok], iv[ok]
            if not len(iu):
                break
            pick = int(rng.integers(len(iu)))
            u, v = int(iu[pick]), int(iv[pick])
            for a, b, d in ((u, v, -link_unit), (u, s, +link_unit),
                            (v, s, +link_unit)):
                cap[a, b] += d
                cap[b, a] += d
            breaks += 1
            wired += 1
        spare += p - 2 * wired
    out = Topology(cap=cap, servers=servers, labels=lab)
    out.validate()
    return Attachment(topo=out, broken_links=breaks, spare_ports=spare)


def recabled_links(base_cap: np.ndarray, cap: np.ndarray,
                   link_unit: float = 1.0) -> int:
    """How many base links (in ``link_unit`` quanta) are no longer present
    in ``cap`` — the physical recabling cost of going from the base wiring
    to ``cap``.  ``cap`` may be larger than ``base_cap`` (grown network);
    capacity ADDED anywhere is free, only removed base capacity counts."""
    n0 = base_cap.shape[0]
    removed = np.maximum(base_cap - cap[:n0, :n0], 0.0)
    return int(round(np.triu(removed, 1).sum() / link_unit))


class ExpansionSpace(DesignSpace):
    """Search space of one expansion step: rewirings of the attached
    topology whose deviation from the PRE-EXPANSION base wiring never
    grows.  ``swappable_links`` allows removal only where capacity exceeds
    the base (links the attach or an earlier swap added), so base links
    never disappear beyond those the attach already broke — the recabling
    budget is enforced structurally, not by rejection sampling.

    Geometry note: a double-edge swap needs two removable links with four
    DISTINCT endpoints, so a step that attaches a single switch (every
    added link incident to it) admits no swap at all and keeps the attach
    wiring — steps adding two or more switches give the search room."""

    def __init__(self, start: Topology, base_cap: np.ndarray, *,
                 link_unit: float = 1.0,
                 forbidden: np.ndarray | None = None,
                 rewirable: np.ndarray | None = None):
        self.start = start
        n = start.n
        padded = np.zeros((n, n))
        n0 = base_cap.shape[0]
        padded[:n0, :n0] = base_cap
        self.base_cap = padded
        self.link_unit = float(link_unit)
        self._forbidden = forbidden
        self._rewirable = rewirable

    def initial(self, seed: int) -> Candidate:
        return Candidate(topo=self.start, params={}, seed=seed)

    def rewirable_mask(self, topo: Topology) -> np.ndarray:
        if self._rewirable is not None:
            return self._rewirable
        return np.ones(topo.n, dtype=bool)

    def forbidden_pairs(self, topo: Topology) -> np.ndarray | None:
        return self._forbidden

    def swappable_links(self, topo: Topology) -> np.ndarray:
        return (topo.cap - self.base_cap) >= self.link_unit * (1 - 1e-9)


@dataclasses.dataclass(frozen=True)
class ExpansionStep:
    """One point of the growth trajectory.  ``lb`` is a certified lower
    bound on this wiring's throughput under the fixed demand: measured by
    the primal certificate, or inherited from the previous step when the
    step kept the attach wiring (``lb_source``) — inheritance is sound
    because the attach embeds every previous flow."""

    topo: Topology
    new_switches: int
    new_ports: int
    spare_ports: int
    recabled: int           # base links moved this step (<= the budget)
    lb: float
    ub: float
    lb_source: str          # "measured" | "inherited"
    chose: str              # "start" | "attached" | "rewired"


@dataclasses.dataclass(frozen=True)
class ExpansionResult:
    """The certified growth trajectory (steps[0] is the starting network)
    plus search accounting aggregated over the per-step optimizer runs."""

    steps: list[ExpansionStep]
    stats: dict


def plan_expansion(topo: Topology, growth: Sequence[Sequence[int]], *,
                   max_recabled_links: int = 4,
                   engine: _PlannedEngine | None = None,
                   demand_fn: Callable | None = None,
                   new_labels: Sequence[int] | None = None,
                   forbidden_fn: Callable[[Topology], np.ndarray] | None
                   = None,
                   link_unit: float = 1.0,
                   rounds: int = 2, fleet: int = 8, elite: int = 3,
                   runs: int = 2, seed: int = 0) -> ExpansionResult:
    """Plan a multi-step expansion of ``topo`` under a recabling budget.

    ``growth`` is one port-count list per step (e.g. ``[[4], [4], [4]]``
    adds one 4-port switch per step for three steps).  Each step attaches
    the new switches (breaking at most ``max_recabled_links`` existing
    links), then spends ``rounds`` fleet-search rounds of swap moves
    inside an ``ExpansionSpace`` — so the final wiring of every step is
    guaranteed within budget.  ``demand_fn(topo, sample_seed)`` fixes the
    load (default: the optimizer's random server permutation); new
    switches host no servers, so the SAME demand spans all steps and
    certified bounds are comparable along the trajectory.

    The reported per-step ``lb`` is monotone non-decreasing by
    construction: the attach preserves the previous wiring's flows, so
    ``max(previous lb, attached wiring's measured lb)`` certifies the
    attached wiring; a rewired candidate is adopted only when its own
    measured certificate beats that.  ``new_labels`` / ``forbidden_fn``
    carry class structure through growth (e.g. VL2: label new cores 2,
    keep ToR–ToR pairs forbidden).
    """
    if max_recabled_links < 0:
        raise ValueError("max_recabled_links must be >= 0")
    steps: list[ExpansionStep] = []
    executes = 0
    keys: set[tuple[int, int]] = set()

    def certify(space: ExpansionSpace, *, srounds: int, sfleet: int,
                selite: int, step_seed: int):
        nonlocal executes
        res = optimize(space, demand_fn, engine=engine, moves=("swap",),
                       rounds=srounds, fleet=sfleet, elite=selite,
                       runs=runs, seed=step_seed, agg="min")
        executes += res.stats["executes"]
        keys.update(res.stats["compile_keys"])
        return res

    # step 0: certify the starting network (no growth, no recabling).
    # seed is shared by every step's optimize() call ON PURPOSE: the
    # optimizer derives its fixed traffic-sample seeds from it, so all
    # steps are certified against the same demand draws.
    space0 = ExpansionSpace(topo, topo.cap, link_unit=link_unit,
                            forbidden=(forbidden_fn(topo)
                                       if forbidden_fn else None))
    res0 = certify(space0, srounds=0, sfleet=1, selite=1, step_seed=seed)
    prev_lb = res0.best.lb
    steps.append(ExpansionStep(
        topo=topo, new_switches=0, new_ports=0, spare_ports=0, recabled=0,
        lb=prev_lb, ub=res0.best.ub, lb_source="measured", chose="start"))

    current = topo
    for si, ports in enumerate(growth):
        att_seed = int(np.random.default_rng((seed, 13, si))
                       .integers(1 << 31))
        if current.labels is not None:
            if new_labels is None:
                raise ValueError("labeled topology needs new_labels")
            lab_seq = list(new_labels)
            step_labels = [lab_seq[j % len(lab_seq)]
                           for j in range(len(ports))]
        else:
            step_labels = None
        # probe the forbidden structure on the grown node set (attach
        # enforces the same mask internally while wiring)
        forb = None
        if forbidden_fn is not None:
            probe = Topology(
                cap=np.pad(current.cap, (0, len(ports))),
                servers=np.concatenate(
                    [current.servers, np.zeros(len(ports), np.int64)]),
                labels=(None if current.labels is None else np.concatenate(
                    [current.labels,
                     np.asarray(step_labels, np.int64)])))
            forb = forbidden_fn(probe)
        att = attach_new_switches(current, ports, link_unit=link_unit,
                                  seed=att_seed, labels=step_labels,
                                  max_breaks=max_recabled_links,
                                  forbidden=forb)
        space = ExpansionSpace(att.topo, current.cap, link_unit=link_unit,
                               forbidden=forb)
        res = certify(space, srounds=rounds, sfleet=fleet, selite=elite,
                      step_seed=seed)
        # the attach wiring is optimize()'s reference (candidate 0): its
        # measured lb, improved to the inherited bound from the previous
        # step (valid: the attach embeds every previous flow)
        attached_lb = max(res.reference.lb, prev_lb)
        best = res.best
        if best.lb > attached_lb:
            chosen, lb, src, chose = best.cand.topo, best.lb, \
                "measured", "rewired"
            ub = best.ub
        else:
            chosen, lb, chose = att.topo, attached_lb, "attached"
            src = ("measured" if res.reference.lb >= prev_lb
                   else "inherited")
            ub = res.reference.ub
        recabled = recabled_links(current.cap, chosen.cap, link_unit)
        if recabled > max_recabled_links:       # structural invariant
            raise AssertionError(
                f"step {si}: recabled {recabled} exceeds budget "
                f"{max_recabled_links} — ExpansionSpace leaked a removal")
        steps.append(ExpansionStep(
            topo=chosen, new_switches=len(ports),
            new_ports=int(sum(ports)), spare_ports=att.spare_ports,
            recabled=recabled, lb=lb, ub=ub, lb_source=src, chose=chose))
        prev_lb = lb
        current = chosen

    stats = {
        "steps": len(growth),
        "max_recabled_links": max_recabled_links,
        "executes": executes,
        "compile_keys": tuple(sorted(keys)),
        "rounds": rounds, "fleet": fleet, "elite": elite, "runs": runs,
        "final_nodes": current.n,
        "lb_trajectory": tuple(s.lb for s in steps),
    }
    return ExpansionResult(steps=steps, stats=stats)
