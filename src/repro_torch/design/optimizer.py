"""Batched stochastic topology optimizer: fleet search through one
``BatchPlan.execute`` per round (the port of ``repro.design.optimizer``).

"Measuring ... Throughput of Network Topologies" (Jyothi et al.) makes the
cost of topology comparison explicit: every candidate needs a
max-concurrent-flow solve over several traffic samples.  That is exactly
the workload the ``BatchPlan`` execution core makes cheap, so the search
loop is built around it:

1. **Seed a fleet** of candidates from the space's paper recipe
   (``space.initial``; candidate 0 is the recipe itself) and evaluate all
   of them — ``fleet × runs`` instances — in ONE ``BatchPlan.execute``.
2. **Each round**, propose ``fleet`` neighbours of the elite set via the
   move kernels (``repro_torch.design.moves``), and evaluate the whole proposal
   fleet in ONE ``BatchPlan.execute``.  Same-size candidates land in one
   bucket/chunk, so every round after the first runs the same
   (padded_n, lanes) shape (``BatchPlan.refill`` reuses the round-one plan
   structure — identical compile keys by construction).
3. **Rank cheaply, certify finally.**  Rounds rank candidates by the
   engine's fast certified bound (dual upper bound by default) aggregated
   pessimistically (min) across the traffic samples.  After the last
   round the elite set PLUS the recipe reference get one certification
   pass (``solver="primal"``: certified lower bound + the free dual upper
   bound), and the reported ``best`` maximises the certified lower bound
   — so the optimizer's claim is a proof, and it can never report a
   wiring certified worse than the recipe it started from.
4. **Seeded and resumable.** All randomness flows through one
   ``numpy.random.Generator``; ``DesignResult.state`` carries its exact
   bit-generator state plus the elite set, and ``optimize(...,
   state=...)`` continues the search as if it had never stopped.

Every solve runs on the engine's ``device`` (the default engine's is
``"cuda"``), the ``robust`` searches too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core import traffic as traffic_mod
from repro_torch.core.adversarial import find_worst_tm
from repro_torch.core.engine import DualEngine, _PlannedEngine, as_engine
from repro_torch.core.plan import BatchPlan
from repro_torch.design.moves import MOVES
from repro_torch.design.spaces import Candidate, DesignSpace

__all__ = ["Evaluated", "DesignState", "DesignResult", "optimize"]


@dataclasses.dataclass(frozen=True)
class Evaluated:
    """A candidate with its fleet-evaluation scores.

    ``score`` is the ranking value used during search rounds — the
    engine's per-instance certified bound, aggregated by ``agg`` (min by
    default) over the ``runs`` traffic samples.  ``lb``/``ub`` are filled
    by the final certification pass: the certified lower bound (an
    explicit feasible flow exists at this rate for EVERY sample) and the
    matching dual upper bound; ``None`` before certification.
    """

    cand: Candidate
    score: float
    values: tuple[float, ...]      # per-traffic-sample ranking values
    lb: float | None = None        # certified min-over-samples lower bound
    ub: float | None = None        # min-over-samples dual upper bound


@dataclasses.dataclass
class DesignState:
    """Everything needed to resume a search exactly where it stopped:
    the RNG's bit-generator state, the current elite set, the recipe
    reference, and the bookkeeping counters.  ``optimize(space, ...,
    state=...)`` continues seamlessly — ``optimize(rounds=a)`` then
    ``optimize(rounds=b, state=...)`` visits the same candidates as one
    ``optimize(rounds=a+b)`` call."""

    rng_state: dict
    elites: list[Evaluated]        # SEARCH (score) order, not lb order —
    #                                resume must see the same parent
    #                                rotation as an uninterrupted run
    reference: Evaluated
    rounds_done: int
    executes: int
    compile_keys: tuple[tuple[int, int], ...]
    eval_seeds: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class DesignResult:
    """Outcome of ``optimize``: the certified-best candidate, the elite
    set, the recipe reference it is guaranteed to match-or-beat, the
    per-round trajectory, plan/compile stats, and the resumable state."""

    best: Evaluated                # argmax certified lb over elites+reference
    elites: list[Evaluated]        # certified, sorted by lb (desc)
    reference: Evaluated           # candidate 0 = the space's paper recipe
    history: list[dict]            # per-round {round, best_score, mean_score}
    stats: dict                    # executes/compile_keys/instances/plan
    state: DesignState


def _aggregate(vals: np.ndarray, agg: str) -> float:
    if agg == "min":
        return float(vals.min())
    if agg == "mean":
        return float(vals.mean())
    raise ValueError(f"unknown agg {agg!r}; expected 'min' or 'mean'")


def optimize(space: DesignSpace,
             demand_fn: Callable[[Any, int], np.ndarray] | None = None,
             *,
             engine: str | _PlannedEngine | None = None,
             moves: Sequence[str] = ("swap", "servers", "bias"),
             rounds: int = 4,
             fleet: int = 12,
             elite: int = 4,
             runs: int = 2,
             seed: int = 0,
             agg: str = "min",
             robust: bool | dict = False,
             state: DesignState | None = None) -> DesignResult:
    """Search ``space`` for a high-throughput wiring.

    ``demand_fn(topo, seed) -> dem[N, N]`` draws one traffic sample
    (default: a random server permutation); every candidate is scored on
    the same ``runs`` fixed seeds so ranking is apples-to-apples across
    rounds.  ``engine`` must be a planning engine (``"dual"`` /
    ``"dual-pallas"`` / ``"primal"`` / ``"certified"`` or a
    ``_PlannedEngine`` instance — the search NEEDS ``BatchPlan``; default:
    a ``DualEngine(iters=250, tol=1e-3)`` tuned for cheap ranking).
    ``moves`` names kernels from ``repro.design.moves.MOVES``.  Kernels
    inapplicable to ``space`` are skipped automatically; if no listed
    kernel applies the proposal falls back to a fresh seeded initial
    candidate (pure random restart).

    Execution cost is exactly ``1 + rounds`` search ``BatchPlan.execute``
    calls of ``fleet × runs`` instances each (round one builds the plan,
    later rounds ``refill`` it — the same shapes) plus ONE final
    certification execute over ``(elite + 1) × runs`` instances.

    ``robust`` re-bases the FINAL ranking on worst-case traffic: after
    the sampled-traffic search rounds, each unique elite (plus the
    reference) gets an adversarial worst-TM search over its hose polytope
    (``repro_torch.core.adversarial.find_worst_tm``, on the engine's
    device), and the reported
    ``lb``/``ub`` become that worst TM's certified bracket — ``best``
    maximises the worst-case lower bound, which is the ranking Jyothi et
    al. show can FLIP relative to sampled traffic.  Pass a dict to
    forward search knobs (``rounds`` / ``candidates`` / ``iters`` / ...);
    ``True`` uses a small default budget.  Search rounds still rank by
    cheap sampled bounds (the execute-count contract above is unchanged);
    ``stats["robust"]`` records the extra adversarial executes.
    """
    if fleet < 1 or rounds < 0 or runs < 1 or elite < 1:
        raise ValueError("need fleet >= 1, rounds >= 0, runs >= 1, "
                         "elite >= 1")
    unknown = [m for m in moves if m not in MOVES]
    if unknown:
        raise ValueError(f"unknown move kernel(s) {unknown}; "
                         f"known: {sorted(MOVES)}")
    if demand_fn is None:
        demand_fn = lambda topo, s: traffic_mod.make(  # noqa: E731
            "permutation", topo.servers, s)
    eng = DualEngine(iters=250, tol=1e-3) if engine is None \
        else as_engine(engine)
    if not isinstance(eng, _PlannedEngine):
        raise ValueError(
            f"engine {getattr(eng, 'name', eng)!r} does not execute through "
            "a BatchPlan; the designer needs one of dual/dual-pallas/"
            "primal/certified (exact LP ranking would solve the fleet "
            "sequentially)")

    executes = 0
    all_keys: set[tuple[int, int]] = set()
    search_plan: BatchPlan | None = None   # refilled round to round

    def evaluate(cands: list[Candidate], eval_seeds, *,
                 solver: str | None = None) -> list[list]:
        """ONE BatchPlan.execute over the cands × eval_seeds fleet;
        returns per-candidate lists of InstanceSolve (sample-major)."""
        nonlocal executes, search_plan
        topos = [c.topo for c in cands for _ in eval_seeds]
        dems = [demand_fn(c.topo, s) for c in cands for s in eval_seeds]
        plan = None
        if solver is None and search_plan is not None:
            try:
                plan = search_plan.refill(topos, dems)
            except ValueError:
                plan = None            # fleet shape drifted: re-plan
        if plan is None:
            plan = eng.plan(topos, dems)
        if solver is None:
            search_plan = plan
        executes += 1
        all_keys.update(plan.stats.compile_keys)
        solved = plan.execute(solver=solver or eng.solver,
                              device=eng.device, **eng._solver_kw())
        k = len(eval_seeds)
        return [solved[i * k:(i + 1) * k] for i in range(len(cands))]

    def score_fleet(cands: list[Candidate], eval_seeds) -> list[Evaluated]:
        out = []
        for cand, solves in zip(cands, evaluate(cands, eval_seeds)):
            vals = np.asarray([s.value for s in solves])
            out.append(Evaluated(cand=cand, score=_aggregate(vals, agg),
                                 values=tuple(float(v) for v in vals)))
        return out

    history: list[dict] = []
    rng = np.random.default_rng(seed)
    if state is not None:
        rng.bit_generator.state = state.rng_state
        elites = list(state.elites)
        reference = state.reference
        eval_seeds = state.eval_seeds
        round0 = state.rounds_done
        executes = state.executes
        all_keys.update(state.compile_keys)
    else:
        # fixed per-search traffic sample seeds: every candidate in every
        # round is scored on the same demands
        eval_seeds = tuple(100003 * (seed + 1) + j for j in range(runs))
        reference_cand = space.initial(seed)
        init = [reference_cand] + \
            [space.initial(int(rng.integers(1 << 31)))
             for _ in range(fleet - 1)]
        scored = score_fleet(init, eval_seeds)
        reference = scored[0]
        elites = sorted(scored, key=lambda e: -e.score)[:elite]
        round0 = 0
        history.append({"round": 0, "best_score": elites[0].score,
                        "mean_score":
                            float(np.mean([e.score for e in scored]))})

    applicable = list(moves)
    for r in range(round0, round0 + rounds):
        proposals: list[Candidate] = []
        for i in range(fleet):
            parent = elites[i % len(elites)].cand
            new = None
            for _ in range(8):
                name = applicable[int(rng.integers(len(applicable)))]
                new = MOVES[name](parent, rng, space)
                if new is not None:
                    break
            if new is None:     # no kernel applies: pure random restart
                new = space.initial(int(rng.integers(1 << 31)))
            proposals.append(new)
        scored = score_fleet(proposals, eval_seeds)
        merged = sorted(elites + scored, key=lambda e: -e.score)
        elites = merged[:elite]
        history.append({"round": r + 1, "best_score": elites[0].score,
                        "mean_score":
                            float(np.mean([e.score for e in scored]))})

    # final certification: the in-loop elites plus the recipe reference,
    # primal solver (certified lower bound; the dual upper bound rides
    # along in meta).  The reference is certified ONCE even when it also
    # survived as an elite (it is candidate 0, so with small fleets it
    # often does) — no duplicate lanes, and identity is preserved so the
    # resumable state keeps elite membership exactly as the search left it.
    unique = list(elites)
    if not any(e is reference for e in unique):
        unique.append(reference)
    certified: dict[int, Evaluated] = {}
    for ev, solves in zip(unique, evaluate([e.cand for e in unique],
                                           eval_seeds, solver="primal")):
        lbs = np.asarray([s.value for s in solves])
        ubs = np.asarray([s.meta["ub"] for s in solves])
        certified[id(ev)] = dataclasses.replace(
            ev, lb=float(lbs.min()), ub=float(ubs.min()))
    robust_stats = None
    if robust:
        # worst-case re-ranking: each unique candidate's lb/ub become the
        # certified bracket of its adversarially-found worst TM (its own
        # BatchPlans — the sampled-traffic execute contract is untouched)
        adv_kw = dict(robust) if isinstance(robust, dict) else {}
        adv_kw.setdefault("rounds", 2)
        adv_kw.setdefault("candidates", 4)
        adv_kw.setdefault("iters", eng.iters)
        adv_kw.setdefault("device", eng.device)
        adv_executes = 0
        for ev in unique:
            res = find_worst_tm(ev.cand.topo, seed=seed, **adv_kw)
            adv_executes += res.stats["executes"]
            certified[id(ev)] = dataclasses.replace(
                certified[id(ev)], lb=res.lb, ub=res.ub)
        robust_stats = {**{k: adv_kw[k]
                           for k in ("rounds", "candidates", "iters")},
                        "executes": adv_executes}
    # state keeps SEARCH (score) order and membership — resuming must pair
    # the rng stream with the same parents as an uninterrupted run; the
    # result's elite list is re-sorted by what the certification proved
    state_elites = [certified[id(e)] for e in elites]
    cert_reference = certified[id(reference)]
    cert_elites = sorted(state_elites, key=lambda e: -e.lb)
    best = max(certified.values(), key=lambda e: e.lb)

    rounds_done = round0 + rounds
    final_state = DesignState(
        rng_state=rng.bit_generator.state, elites=state_elites,
        reference=cert_reference, rounds_done=rounds_done,
        executes=executes, compile_keys=tuple(sorted(all_keys)),
        eval_seeds=tuple(eval_seeds))
    stats = {
        "rounds": rounds_done, "fleet": fleet, "elite": elite,
        "runs": runs, "executes": executes,
        # the init eval + exactly ONE execute per search round; the rest
        # are certification passes (one per optimize() call)
        "search_executes": 1 + rounds_done,
        "certify_executes": executes - (1 + rounds_done),
        "instances_per_round": fleet * runs,
        "compile_keys": tuple(sorted(all_keys)),
        "engine": getattr(eng, "name", "dual"), "agg": agg,
        "robust": robust_stats,
        "last_plan": (search_plan.stats.as_dict()
                      if search_plan is not None else None),
    }
    return DesignResult(best=best, elites=cert_elites,
                        reference=cert_reference, history=history,
                        stats=stats, state=final_state)
