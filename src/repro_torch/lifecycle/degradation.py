"""Certified throughput-degradation surfaces through one plan per round
(the port of ``repro.lifecycle.degradation``).

For each topology family and failure kind, sweep failure fraction ×
trials and report what survives: certified (lb, ub) throughput brackets
with quantile bands, plus ``reachable_fraction`` — the share of the
demand still routable after the failure (graceful degradation, never a
crash: unroutable demand is dropped by ``mcf.drop_disconnected`` before
any solver sees it, and a fully-unroutable trial scores a certified
lb = ub = 0 without running a solver at all).

The whole surface is planner-shaped, like ``design.optimize``'s rounds:
every scenario keeps its base node count (``lifecycle.failures``), so the
(families × fractions × trials) pile of one failure kind is shape-
identical to the next kind's pile — the first kind builds ONE
``BatchPlan``, every later kind ``refill``s it and runs the same chunk
shapes.  A surface over three kinds costs three ``BatchPlan.execute``
calls and a single-digit set of compile keys (distinct (padded_n, lanes)
shapes), no matter how many trials ride in each.  Every solve runs on the
engine's ``device``: the default engine's is ``"cuda"``.

Fully-dead trials still occupy their lane (a stand-in solve of the base
topology keeps the pile refill-compatible); their results are overridden
to the certified zero bracket afterwards.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import mcf
from repro_torch.core import traffic as traffic_mod
from repro_torch.core.engine import CertifiedEngine, _PlannedEngine
from repro_torch.core.graphs import Topology
from repro_torch.lifecycle.failures import FAIL_KINDS, scenario_fleet

__all__ = ["DegradationPoint", "DegradationResult", "degradation_surface"]


@dataclasses.dataclass(frozen=True)
class DegradationPoint:
    """One (family, failure kind, failure fraction) cell of the surface,
    aggregated over the trials: certified lower-bound quantile band
    (q10 / median / q90), mean dual upper bound, worst relative bracket
    gap, and the mean routable-demand share (1.0 = nothing unreachable,
    0.0 = every trial fully disconnected)."""

    family: str
    kind: str
    fraction: float
    trials: int
    lb_q10: float
    lb_med: float
    lb_q90: float
    ub_mean: float
    gap_max: float
    reachable_mean: float
    dead_trials: int        # trials whose demand was entirely unroutable


@dataclasses.dataclass(frozen=True)
class DegradationResult:
    """The full surface plus its execution accounting (one execute per
    failure kind, shared compile keys across kinds via ``refill``)."""

    points: list[DegradationPoint]
    stats: dict


def degradation_surface(families: Mapping[str, Topology], *,
                        kinds: Sequence[str] = tuple(FAIL_KINDS),
                        fractions: Sequence[float] = (0.05, 0.1, 0.2, 0.4),
                        trials: int = 20,
                        engine: _PlannedEngine | None = None,
                        traffic: str = "permutation",
                        traffic_kw: Mapping | None = None,
                        seed: int = 0) -> DegradationResult:
    """Certified throughput-vs-failure-fraction curves for every family.

    ``families`` maps a display name to its base ``Topology``.  Demand is
    drawn ONCE per (family, trial) on the ORIGINAL topology (seeded from
    ``seed``), then shared by every fraction and failure kind of that
    trial — degradation is measured against the load the intact network
    was serving, and curves are paired across kinds.  ``engine`` must be
    a planning engine running the primal solver (``CertifiedEngine`` by
    default, ``PrimalEngine`` also works): the curves are certified
    brackets, so a dual-only engine is rejected.

    Execution cost: exactly ``len(kinds)`` ``BatchPlan.execute`` calls of
    ``len(families) * len(fractions) * trials`` lanes each, on the
    engine's ``device``; kinds after the first ``refill`` the first kind's
    plan (identical pile shapes by construction), keeping the compile-key
    set shared.
    """
    eng = CertifiedEngine(iters=300, tol=1e-3) if engine is None else engine
    if not isinstance(eng, _PlannedEngine) or eng.solver != "primal":
        raise ValueError(
            "degradation_surface reports certified brackets: engine must "
            "be a planning engine running the primal solver "
            "(certified/primal), got "
            f"{getattr(eng, 'name', eng)!r}")
    if trials < 1:
        raise ValueError(f"need trials >= 1, got {trials}")
    fam_items = list(families.items())
    if not fam_items:
        raise ValueError("need at least one family")
    unknown = [k for k in kinds if k not in FAIL_KINDS]
    if unknown:
        raise ValueError(f"unknown failure kind(s) {unknown}; "
                         f"known: {list(FAIL_KINDS)}")

    # demand per (family, trial), drawn once on the intact topology
    base_dems: dict[tuple[int, int], np.ndarray] = {}
    for fam_i, (_, base) in enumerate(fam_items):
        for t in range(trials):
            ds = int(np.random.default_rng(
                (seed, 7, fam_i, t)).integers(1 << 31))
            base_dems[fam_i, t] = traffic_mod.make(
                traffic, base.servers, ds, **(traffic_kw or {}))

    plan = None
    executes = 0
    refills = 0
    keys: set[tuple[int, int]] = set()
    points: list[DegradationPoint] = []
    for kind in kinds:
        pile_topos, pile_dems = [], []
        lane_reach: list[float] = []
        lane_dead: list[bool] = []
        for fam_i, (_, base) in enumerate(fam_items):
            for sc in scenario_fleet(base, kind, fractions, trials,
                                     seed=seed):
                dem = base_dems[fam_i, sc.trial]
                kept, dropped = mcf.drop_disconnected(sc.topo.cap, dem)
                dead = dropped >= 1.0
                if dead:
                    # stand-in lane: keeps this kind's pile shape-identical
                    # to the others so refill applies; result overridden to
                    # the certified zero bracket below
                    pile_topos.append(base)
                    pile_dems.append(dem)
                else:
                    pile_topos.append(sc.topo)
                    pile_dems.append(kept)
                lane_reach.append(1.0 - dropped)
                lane_dead.append(dead)
        if plan is None:
            plan = eng.plan(pile_topos, pile_dems)
        else:
            try:
                plan = plan.refill(pile_topos, pile_dems)
                refills += 1
            except ValueError:     # pile shape drifted (shouldn't happen)
                plan = eng.plan(pile_topos, pile_dems)
        executes += 1
        keys.update(plan.stats.compile_keys)
        eng.last_plan = plan.stats
        solved = plan.execute(solver=eng.solver, device=eng.device,
                              **eng._solver_kw())

        idx = 0
        for fam_i, (name, _) in enumerate(fam_items):
            for frac in fractions:
                lbs, ubs, gaps, reach = [], [], [], []
                dead_n = 0
                for _ in range(trials):
                    s = solved[idx]
                    if lane_dead[idx]:
                        lb = ub = 0.0
                        dead_n += 1
                    else:
                        lb, ub = float(s.value), float(s.meta["ub"])
                    lbs.append(lb)
                    ubs.append(ub)
                    gaps.append((ub - lb) / max(ub, 1e-30))
                    reach.append(lane_reach[idx])
                    idx += 1
                q10, med, q90 = np.quantile(lbs, (0.1, 0.5, 0.9))
                points.append(DegradationPoint(
                    family=name, kind=kind, fraction=float(frac),
                    trials=trials, lb_q10=float(q10), lb_med=float(med),
                    lb_q90=float(q90), ub_mean=float(np.mean(ubs)),
                    gap_max=float(max(gaps)),
                    reachable_mean=float(np.mean(reach)),
                    dead_trials=dead_n))

    stats = {
        "executes": executes,
        "refills": refills,
        "compile_keys": tuple(sorted(keys)),
        "instances_per_execute": len(fam_items) * len(fractions) * trials,
        "families": [name for name, _ in fam_items],
        "kinds": tuple(kinds),
        "fractions": tuple(float(f) for f in fractions),
        "trials": trials,
        "engine": getattr(eng, "name", "certified"),
        "last_plan": plan.stats.as_dict() if plan is not None else None,
    }
    return DegradationResult(points=points, stats=stats)
