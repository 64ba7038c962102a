"""Throughput engines and the declarative sweep runner (the port of
``repro.core.engine``, main-path engines only).

* ``ExactLPEngine`` — the HiGHS LP oracle (``repro_torch.core.lp``).
* ``DualEngine`` — the dual descent (``repro_torch.core.mcf``), a certified
  upper bound; ``solve_batch`` runs through ``BatchPlan``.
* ``PrimalEngine`` — the Frank–Wolfe primal (``repro_torch.core.primal``),
  a certified lower bound with the driving dual's upper bound in
  ``meta["ub"]``; same planner, same knobs.
* ``CertifiedEngine`` — the same program reported as a bracket:
  ``meta["lb"]`` / ``meta["ub"]`` / ``meta["gap"]``.
* ``EcmpEngine`` / ``KspEngine`` — routing-restricted LOWER bounds
  (``repro_torch.core.routing``): ECMP's equal split, and multiplicative
  weights over each pair's k shortest paths; the ideal upper bound rides
  along in ``meta["ub"]`` and ``meta["ideal_gap_pct"]``.
* ``AutoEngine`` — exact LP for small instances, the dual beyond.
* ``AdversarialEngine`` — the worst-case TM search
  (``repro_torch.core.adversarial``) reported as a bracket.
* ``get_engine("exact" | "dual" | "dual-pallas" | "primal" | "certified" |
  "ecmp" | "ksp" | "auto" | "adversarial")`` and
  ``as_engine``.  The names are the reference's: ``"dual-pallas"`` is the
  dual descent whose APSP is repeated squaring on the hand-written
  tropical kernel (K1).
* ``Sweep`` / ``run_sweep`` / ``run_sweeps`` — (xs × runs) experiments, a
  whole family through one ``solve_batch``; on a bracket engine each
  ``SweepPoint`` carries ``lb_mean`` / ``gap_max``.

The planned engines and the adversarial one take ``device`` (default
``"cuda"``; without a card they raise unless ``device="cpu"`` is asked
for).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core import apsp as apsp_mod
from repro_torch.core import adversarial as adversarial_mod
from repro_torch.core import lp, mcf, primal, routing
from repro_torch.core import traffic as traffic_mod
from repro_torch.core.graphs import Topology, as_cap
from repro_torch.core.plan import BatchPlan, InstanceSolve, bucket_size

__all__ = ["ThroughputResult", "ThroughputEngine", "ExactLPEngine",
           "DualEngine", "PrimalEngine", "CertifiedEngine", "EcmpEngine",
           "KspEngine", "AutoEngine", "AdversarialEngine", "ENGINES",
           "get_engine", "as_engine", "bucket_size", "SweepPoint",
           "Sweep", "run_sweep", "run_sweeps"]


@dataclasses.dataclass(frozen=True)
class ThroughputResult:
    """Throughput θ of one (topology, demand) instance (max concurrent flow
    rate per unit demand).  ``bound``: ``"exact"`` (LP optimum),
    ``"upper"`` / ``"lower"`` (a certified one-sided bound converging to
    θ*) or ``"bracket"`` (an upper bound whose ``meta`` carries ``lb`` /
    ``ub`` / ``gap``)."""

    throughput: float
    is_upper_bound: bool
    engine: str
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    bound: str = ""

    def __post_init__(self):
        if not self.bound:
            object.__setattr__(self, "bound",
                               "upper" if self.is_upper_bound else "exact")


@runtime_checkable
class ThroughputEngine(Protocol):
    """``solve(topo, dem) -> ThroughputResult`` and a positional,
    same-length ``solve_batch``; ``batches`` is True when ``solve_batch``
    is cheaper than per-instance solves."""

    name: str
    batches: bool

    def solve(self, topo: Topology | np.ndarray,
              dem: np.ndarray) -> ThroughputResult: ...

    def solve_batch(self, topos: Sequence[Topology | np.ndarray],
                    dems: Sequence[np.ndarray]) -> list[ThroughputResult]: ...


def _check_batch_lengths(topos, dems) -> None:
    if len(topos) != len(dems):
        raise ValueError(f"topos ({len(topos)}) and dems ({len(dems)}) "
                         "must have equal length")


class ExactLPEngine:
    """Exact max-concurrent-flow via the HiGHS LP (host, sequential)."""

    name = "exact"
    batches = False

    def solve(self, topo, dem) -> ThroughputResult:
        res = lp.max_concurrent_flow(topo, dem, want_flows=False)
        return ThroughputResult(throughput=res.throughput,
                                is_upper_bound=False, engine=self.name,
                                meta={"status": res.status})

    def solve_batch(self, topos, dems) -> list[ThroughputResult]:
        _check_batch_lengths(topos, dems)
        return [self.solve(t, d) for t, d in zip(topos, dems)]


class _PlannedEngine:
    """Shared planner plumbing: ``solve_batch`` builds a ``BatchPlan``
    (``bucket``, ``max_lanes``, ``devices`` = 1) and executes it on
    ``device``.  ``coarsen`` contracts server leaves onto their switches
    first; ``on_disconnected`` (None / ``"raise"`` / ``"drop"``) decides
    what a demanded pair with no path means, as in the reference; ``tol``
    / ``check_every`` stop lanes early; ``backend``, ``d_max`` and
    ``max_rounds`` go to the APSP."""

    batches = True
    solver: str = "dual"

    def __init__(self, use_pallas: bool = False, iters: int = 800,
                 lr: float = 0.08, tol: float = 0.0, check_every: int = 25,
                 bucket: str | int | None = "pow2",
                 devices: int | None = None,
                 max_lanes: int | None = None,
                 on_disconnected: str | None = None,
                 backend: str | None = None,
                 coarsen: bool = True,
                 d_max: int | None = None,
                 max_rounds: int | None = None,
                 device: str | torch.device = "cuda"):
        self.use_pallas = use_pallas
        self.iters = iters
        self.lr = lr
        self.tol = tol
        self.check_every = check_every
        bucket_size(1, bucket)   # fail fast on an unknown bucket mode
        self.bucket = bucket
        self.devices = devices
        self.max_lanes = max_lanes
        if on_disconnected not in (None, "raise", "drop"):
            raise ValueError("on_disconnected must be None, 'raise' or "
                             f"'drop', got {on_disconnected!r}")
        self.on_disconnected = on_disconnected
        self.backend = apsp_mod.normalize_backend(backend, use_pallas)
        self.coarsen = coarsen
        self.d_max = d_max
        self.max_rounds = max_rounds
        self.device = device
        self.last_plan = None    # PlanStats of the most recent solve_batch

    def _solver_kw(self) -> dict:
        kw = dict(iters=self.iters, lr=self.lr, tol=self.tol,
                  check_every=self.check_every, backend=self.backend)
        # pin the ell-bf statics only when set, so the planner's per-chunk
        # density hints stay in charge otherwise
        if self.d_max is not None:
            kw["d_max"] = self.d_max
        if self.max_rounds is not None:
            kw["max_rounds"] = self.max_rounds
        return kw

    def _coarsen_instances(self, topos, dems):
        if not self.coarsen:
            return list(topos), list(dems)
        out_t, out_d = [], []
        for t, d in zip(topos, dems):
            if isinstance(t, Topology) and t.server_nodes is not None:
                t, d = t.coarsen(d)
            out_t.append(t)
            out_d.append(d)
        return out_t, out_d

    def plan(self, topos, dems) -> BatchPlan:
        """The ``BatchPlan`` this engine would execute for these instances."""
        _check_batch_lengths(topos, dems)
        topos, dems = self._coarsen_instances(topos, dems)
        return BatchPlan.build(topos, dems, bucket=self.bucket,
                               max_lanes=self.max_lanes,
                               devices=self.devices)

    def _apply_disconnection_policy(self, topos, dems):
        if self.on_disconnected is None:
            return list(dems), [None] * len(dems)
        kept, dropped = [], []
        for i, (t, d) in enumerate(zip(topos, dems)):
            d2, frac = mcf.drop_disconnected(as_cap(t), d)
            if frac > 0 and self.on_disconnected == "raise":
                raise ValueError(
                    f"instance {i}: {100 * frac:.1f}% of the demand is "
                    "between disconnected switches; use "
                    "on_disconnected='drop' to solve the routable share")
            kept.append(d2)
            dropped.append(frac)
        return kept, dropped

    def _disconnected_result(self) -> ThroughputResult:
        """θ* = 0 on both sides, without running a solver."""
        s = InstanceSolve(value=0.0, iterations=0,
                          meta={"ub": 0.0, "final_ratio": 0.0,
                                "final_util": 0.0, "disconnected": True})
        return self._result(s)

    @staticmethod
    def _with_dropped(r: ThroughputResult,
                      frac: float | None) -> ThroughputResult:
        if frac is None:
            return r
        return dataclasses.replace(
            r, meta={**r.meta, "dropped_demand_fraction": frac})

    def _solve_preprocessed(self, topo, dem):
        """One-instance coarsen + ``on_disconnected`` preamble of ``solve``:
        (topo, kept_dem, dropped_fraction, short_circuit_result_or_None)."""
        (topo,), (dem,) = self._coarsen_instances([topo], [dem])
        (dem,), (frac,) = self._apply_disconnection_policy([topo], [dem])
        if frac is not None and frac >= 1.0:
            return topo, dem, frac, self._with_dropped(
                self._disconnected_result(), frac)
        return topo, dem, frac, None

    def solve_batch(self, topos, dems) -> list[ThroughputResult]:
        _check_batch_lengths(topos, dems)
        topos, dems = self._coarsen_instances(topos, dems)
        dems, dropped = self._apply_disconnection_policy(topos, dems)
        live = [i for i, f in enumerate(dropped) if f is None or f < 1.0]
        plan = self.plan([topos[i] for i in live], [dems[i] for i in live])
        self.last_plan = plan.stats
        solved = plan.execute(solver=self.solver, device=self.device,
                              **self._solver_kw())
        out: list[ThroughputResult] = [self._disconnected_result()
                                       for _ in topos]
        for i, s in zip(live, solved):
            out[i] = self._result(s)
        return [self._with_dropped(r, f) for r, f in zip(out, dropped)]


class DualEngine(_PlannedEngine):
    """Certified dual UPPER bound (``repro_torch.core.mcf``); ``meta``
    carries ``iterations`` and ``final_ratio``."""

    solver = "dual"

    def __init__(self, use_pallas: bool = False, **kw):
        super().__init__(use_pallas=use_pallas, **kw)
        self.name = ("dual-pallas" if self.backend == "squaring-pallas"
                     else "dual")

    def solve(self, topo, dem) -> ThroughputResult:
        topo, dem, frac, short = self._solve_preprocessed(topo, dem)
        if short is not None:
            return short
        res = mcf.solve_dual(topo, dem, device=self.device,
                             **self._solver_kw())
        return self._with_dropped(ThroughputResult(
            throughput=res.throughput_ub, is_upper_bound=True,
            engine=self.name,
            meta={"iterations": res.iterations,
                  "final_ratio": res.final_ratio}), frac)

    def _result(self, s) -> ThroughputResult:
        return ThroughputResult(throughput=s.value, is_upper_bound=True,
                                engine=self.name, meta=s.meta)


class PrimalEngine(_PlannedEngine):
    """Certified primal LOWER bound (``repro_torch.core.primal``):
    ``bound="lower"``, an explicit feasible flow routes every demand at rate
    ``throughput``; the driving dual's upper bound is ``meta["ub"]``."""

    name = "primal"
    solver = "primal"

    def solve(self, topo, dem) -> ThroughputResult:
        topo, dem, frac, short = self._solve_preprocessed(topo, dem)
        if short is not None:
            return short
        res = primal.solve_primal(topo, dem, device=self.device,
                                  **self._solver_kw())
        return self._with_dropped(self._result(InstanceSolve(
            value=res.throughput_lb, iterations=res.iterations,
            meta={"iterations": res.iterations,
                  "final_util": res.final_util,
                  "ub": res.throughput_ub})), frac)

    def _result(self, s) -> ThroughputResult:
        return ThroughputResult(throughput=s.value, is_upper_bound=False,
                                engine=self.name, bound="lower", meta=s.meta)


def _bracket(lb: float, ub: float, meta: Mapping[str, Any],
             engine: str) -> ThroughputResult:
    gap = (ub - lb) / max(ub, 1e-30)
    meta = {k: v for k, v in meta.items() if k != "ub"}
    return ThroughputResult(
        throughput=ub, is_upper_bound=True, engine=engine, bound="bracket",
        meta={"lb": lb, "ub": ub, "gap": gap, **meta})


class CertifiedEngine(PrimalEngine):
    """Certified (lb, ub, gap) brackets from the primal program:
    ``bound="bracket"``, ``throughput`` is the upper bound and ``meta``
    carries ``lb`` / ``ub`` / ``gap`` = (ub − lb) / ub.  Pass/fail
    criteria judge ``meta["lb"]`` (``vl2.supports_full_throughput``)."""

    name = "certified"

    def _result(self, s) -> ThroughputResult:
        return _bracket(s.value, s.meta["ub"], s.meta, self.name)


def _ideal_gap_pct(lb: float, ub: float) -> float:
    """Certified price of a routing restriction, in percent of the ideal
    upper bound (0.0 on degenerate ub <= 0 instances)."""
    return 100.0 * (ub - lb) / ub if ub > 0 else 0.0


class EcmpEngine(_PlannedEngine):
    """Routing-restricted LOWER bound under ECMP (``routing``):
    ``bound="lower"`` — an explicit equal-cost equal-split routing carries
    every demand at rate ``throughput``.  The ideal dual descent's upper
    bound rides along in ``meta["ub"]`` and ``meta["ideal_gap_pct"]`` is
    the certified price of the restriction.  Knobs: the planner's plus
    ``hops`` (the cap on ECMP propagation; default N covers the
    diameter)."""

    name = "ecmp"
    solver = "ecmp"
    _single = staticmethod(routing.solve_ecmp)

    def __init__(self, hops: int | None = None, **kw):
        super().__init__(**kw)
        self.hops = hops

    def _solver_kw(self) -> dict:
        kw = super()._solver_kw()
        if self.hops is not None:
            kw["hops"] = self.hops
        return kw

    def solve(self, topo, dem) -> ThroughputResult:
        topo, dem, frac, short = self._solve_preprocessed(topo, dem)
        if short is not None:
            return short
        res = self._single(topo, dem, device=self.device,
                           **self._solver_kw())
        s = InstanceSolve(value=res.throughput_lb, iterations=res.iterations,
                          meta={"iterations": res.iterations,
                                "final_util": res.final_util,
                                "ub": res.throughput_ub})
        return self._with_dropped(self._result(s), frac)

    def _result(self, s) -> ThroughputResult:
        meta = {**s.meta,
                "ideal_gap_pct": _ideal_gap_pct(s.value, s.meta["ub"])}
        return ThroughputResult(throughput=s.value, is_upper_bound=False,
                                engine=self.name, bound="lower", meta=meta)


class KspEngine(EcmpEngine):
    """Routing-restricted LOWER bound under k-shortest-path multipath
    routing (``routing``): multiplicative weights over each pair's ``k``
    shortest simple paths, floored by ECMP, so ``ecmp <= ksp(k) <= exact``
    holds on every instance.  Knobs: ``k`` (paths per pair, default 8) and
    ``max_hops`` (per-path hop budget; default min(N - 1, 12), from the
    padded width); ``meta`` as ``EcmpEngine``'s."""

    name = "ksp"
    solver = "ksp"
    _single = staticmethod(routing.solve_ksp)

    def __init__(self, k: int = routing.DEFAULT_K,
                 max_hops: int | None = None, **kw):
        super().__init__(**kw)
        self.k = k
        self.max_hops = max_hops

    def _solver_kw(self) -> dict:
        kw = super()._solver_kw()
        kw["k"] = self.k
        if self.max_hops is not None:
            kw["max_hops"] = self.max_hops
        return kw


class AutoEngine:
    """Exact LP up to ``exact_max_nodes``, the dual bound beyond (check the
    per-result ``bound``); ``dual_kw`` goes to the inner ``DualEngine``."""

    name = "auto"
    batches = True

    def __init__(self, exact_max_nodes: int = 64, **dual_kw):
        self.exact_max_nodes = exact_max_nodes
        self._exact = ExactLPEngine()
        self._dual = DualEngine(**dual_kw)

    @property
    def devices(self) -> int | None:
        return self._dual.devices

    @property
    def max_lanes(self) -> int | None:
        return self._dual.max_lanes

    @property
    def last_plan(self):
        return self._dual.last_plan

    def _pick(self, topo) -> ThroughputEngine:
        n = as_cap(topo).shape[0]
        return self._exact if n <= self.exact_max_nodes else self._dual

    def solve(self, topo, dem) -> ThroughputResult:
        return self._pick(topo).solve(topo, dem)

    def solve_batch(self, topos, dems) -> list[ThroughputResult]:
        _check_batch_lengths(topos, dems)
        exact_idx: list[int] = []
        dual_idx: list[int] = []
        for i, t in enumerate(topos):
            (exact_idx if self._pick(t) is self._exact
             else dual_idx).append(i)
        out: list[ThroughputResult | None] = [None] * len(topos)
        for eng, idx in ((self._exact, exact_idx), (self._dual, dual_idx)):
            if idx:
                sub = eng.solve_batch([topos[i] for i in idx],
                                      [dems[i] for i in idx])
                for i, r in zip(idx, sub):
                    out[i] = r
        return out


class AdversarialEngine:
    """Worst-case-traffic evaluation: ``solve(topo, dem)`` searches the hose
    polytope for the demand that minimises the topology's throughput
    (``adversarial.find_worst_tm``), with ``dem`` (when given) as the
    baseline in lane 0 of every round.  ``bound="bracket"``:
    ``throughput`` is the certified upper bound of the worst TM found;
    ``meta`` carries ``lb`` / ``ub`` / ``gap``, the TM (``meta["tm"]``),
    the baseline's bracket, ``uniform_gap_pct`` and the search stats.

    Ctor kwargs go to ``find_worst_tm`` (``rounds``, ``candidates``,
    ``lr_tm``, the inner solver's knobs, ``device``).  ``batches=False``:
    batching happens inside a search (one ``BatchPlan.execute`` over the
    candidates a round), not across topologies."""

    name = "adversarial"
    batches = False

    def __init__(self, **search_kw):
        self.search_kw = search_kw

    def solve(self, topo, dem=None, *, seed: int = 0) -> ThroughputResult:
        res = adversarial_mod.find_worst_tm(
            topo, seed=seed, baseline=dem, **self.search_kw)
        return _bracket(res.lb, res.ub,
                        {"tm": res.tm,
                         "uniform_gap_pct": res.uniform_gap_pct,
                         "baseline_lb": res.baseline_lb,
                         "baseline_ub": res.baseline_ub,
                         **res.stats}, self.name)

    def solve_batch(self, topos, dems) -> list[ThroughputResult]:
        _check_batch_lengths(topos, dems)
        return [self.solve(t, d) for t, d in zip(topos, dems)]


ENGINES: dict[str, Callable[..., ThroughputEngine]] = {
    "exact": ExactLPEngine,
    "dual": DualEngine,
    "dual-pallas": lambda **kw: DualEngine(use_pallas=True, **kw),
    "primal": PrimalEngine,
    "certified": CertifiedEngine,
    "ecmp": EcmpEngine,
    "ksp": KspEngine,
    "auto": AutoEngine,
    "adversarial": AdversarialEngine,
}


def get_engine(name: str, **kw) -> ThroughputEngine:
    """Instantiate a registered engine by name (kwargs go to its ctor)."""
    try:
        factory = ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; known: {sorted(ENGINES)}") from None
    return factory(**kw)


def as_engine(engine: str | ThroughputEngine) -> ThroughputEngine:
    """Accept an engine instance or a registry name."""
    if isinstance(engine, str):
        return get_engine(engine)
    return engine


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One x of a sweep: throughput stats over the seeded runs, and the
    bracket aggregates when every run carries a bracket (``lb_mean``: mean
    certified lower bound; ``gap_max``: worst (ub − lb) / ub; else None);
    ``meta`` carries aggregates requested through
    ``run_sweeps(meta_reduce=...)``."""

    x: float
    mean: float
    std: float
    values: tuple[float, ...]
    lb_mean: float | None = None
    gap_max: float | None = None
    meta: Mapping[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Sweep:
    """Measure throughput at each ``x`` over ``runs`` seeded repetitions
    under a named traffic pattern."""

    xs: tuple[float, ...]
    runs: int = 3
    seed0: int = 0
    traffic: str = "permutation"
    traffic_kw: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def seeds(self) -> list[int]:
        return [self.seed0 + 1000 * rr for rr in range(self.runs)]


def run_sweeps(items: Sequence[tuple[Sweep, Callable[[float, int], Topology]]],
               engine: str | ThroughputEngine = "exact", *,
               meta_reduce: Mapping[str, Callable[[Sequence[float]], float]]
               | None = None) -> list[list[SweepPoint]]:
    """Run a family of sweeps through ONE ``solve_batch`` call
    (``build_fn(x, seed) -> Topology``; traffic drawn with seed
    ``seed + 1``).  Returns one ``list[SweepPoint]`` per item."""
    eng = as_engine(engine)
    topos, dems, spans = [], [], []
    for sweep, build_fn in items:
        start = len(topos)
        for x in sweep.xs:
            for seed in sweep.seeds():
                topo = build_fn(x, seed)
                dems.append(traffic_mod.make(sweep.traffic, topo.servers,
                                             seed + 1, **sweep.traffic_kw))
                topos.append(topo)
        spans.append(start)
    results = eng.solve_batch(topos, dems) if topos else []
    out: list[list[SweepPoint]] = []
    for (sweep, _), start in zip(items, spans):
        points = []
        for pi, x in enumerate(sweep.xs):
            lo = start + pi * sweep.runs
            rs = results[lo:lo + sweep.runs]
            vals = [r.throughput for r in rs]
            v = np.asarray(vals)
            lbs = [r.meta["lb"] for r in rs if "lb" in r.meta]
            gaps = [r.meta["gap"] for r in rs if "gap" in r.meta]
            bracketed = rs and len(lbs) == len(rs) and len(gaps) == len(rs)
            meta: dict[str, float] = {}
            for key, reduce_fn in (meta_reduce or {}).items():
                got = [r.meta[key] for r in rs if key in r.meta]
                if rs and len(got) == len(rs):
                    meta[key] = float(reduce_fn(got))
            points.append(SweepPoint(
                float(x), float(v.mean()), float(v.std()), tuple(vals),
                lb_mean=float(np.mean(lbs)) if bracketed else None,
                gap_max=float(max(gaps)) if bracketed else None,
                meta=meta))
        out.append(points)
    return out


def run_sweep(sweep: Sweep, build_fn: Callable[[float, int], Topology],
              engine: str | ThroughputEngine = "exact", *,
              meta_reduce: Mapping[str, Callable[[Sequence[float]], float]]
              | None = None) -> list[SweepPoint]:
    """``run_sweeps`` with a single item."""
    return run_sweeps([(sweep, build_fn)], engine,
                      meta_reduce=meta_reduce)[0]
