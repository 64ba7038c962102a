"""Adversarial traffic: the worst-case demand search over the hose polytope
(the port of ``repro.core.adversarial``).

Sampled traffic asks how a wiring does on typical demand; rankings of
topologies can flip under near-worst-case demand (Jyothi et al., arXiv
1402.2531).  This module searches for that demand:

* **Hose-feasible by construction.**  A candidate is a free [N, N] logit
  matrix: ``softplus`` makes it positive, rows are scaled to exactly their
  hose cap ``servers[u]``, then columns are clipped down to theirs, and
  the sweep ends on the clip, which only shrinks entries.  Every emitted
  matrix has zero diagonal and row and column sums within the caps.  The
  projection is one batched torch function over [K, N, N] logits, and its
  pullback one ``torch.autograd.grad`` through it (the lanes do not mix).
* **Descent on throughput.**  ``mcf.solve_dual_demgrad_batch`` returns each
  candidate's certified upper bound and its Danskin demand gradient;
  pulled back through the projection, it drives Adam on the logits.
* **One ``BatchPlan.execute`` per round.**  Lane 0 is the fixed baseline
  (a random server permutation), so the running minimum never sits above
  it; round one builds the plan, later rounds ``refill`` it, and the final
  primal certification of the worst TM runs on the same plan: one compile
  key for the whole search.

``find_worst_tm`` is the entry point; ``traffic.make("adversarial", ...,
topo=...)`` and ``engine.get_engine("adversarial")`` wrap it.  The search
runs on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import traffic as traffic_mod
from repro_torch.core.graphs import Topology
from repro_torch.core.plan import BatchPlan
from repro_torch.device import resolve_device

__all__ = ["hose_feasible", "hose_violation", "AdversarialResult",
           "find_worst_tm"]

# independent sub-streams per use, keyed like traffic._STRIDE_REST_KEY
_LOGITS_KEY = int.from_bytes(b"adv-logits", "little")
_BASELINE_KEY = int.from_bytes(b"adv-baseline", "little")


def _fleet_project(logits: torch.Tensor, servers: torch.Tensor,
                   proj_iters: int) -> torch.Tensor:
    """[K, N, N] logits -> [K, N, N] hose-feasible demand matrices.

    ``proj_iters`` rounds of row saturation then column clip, ending on the
    clip: after the last row pass every row sums to its cap, and the column
    pass multiplies columns by min(1, cap / colsum), so entries only
    shrink.  Zero-server rows and columns and the diagonal are exactly 0.
    """
    servers = servers.to(torch.float32)
    n = servers.shape[0]
    live = servers > 0
    eye = torch.eye(n, dtype=torch.bool, device=logits.device)
    mask = (live[:, None] & live[None, :]) & ~eye
    x = torch.nn.functional.softplus(logits) * mask
    one = torch.ones((), dtype=torch.float32, device=logits.device)
    for _ in range(proj_iters):
        x = x * (servers / torch.clamp(x.sum(dim=2), min=1e-30))[:, :, None]
        x = x * torch.minimum(
            one, servers / torch.clamp(x.sum(dim=1), min=1e-30))[:, None, :]
    return x


def _fleet_pullback(logits: torch.Tensor, dem_grads: torch.Tensor,
                    servers: torch.Tensor, proj_iters: int) -> torch.Tensor:
    """Pull per-candidate demand cotangents back through the projection:
    [K, N, N] d loss/d dem -> d loss/d logits."""
    lg = logits.detach().requires_grad_(True)
    with torch.enable_grad():
        x = _fleet_project(lg, servers, proj_iters)
        g, = torch.autograd.grad(x, lg, grad_outputs=dem_grads)
    return g


def hose_feasible(logits: np.ndarray, servers: np.ndarray,
                  proj_iters: int = 8) -> np.ndarray:
    """Host-facing projection (see ``_fleet_project``), computed on the
    CPU: [N, N] free logits -> a float32 demand matrix with zero diagonal,
    row sums ≤ ``servers`` and column sums ≤ ``servers``, for any
    logits."""
    lg = torch.as_tensor(np.asarray(logits), dtype=torch.float32)[None]
    sv = torch.as_tensor(np.asarray(servers), dtype=torch.float32)
    return _fleet_project(lg, sv, proj_iters)[0].numpy()


def hose_violation(dem: np.ndarray, servers: np.ndarray) -> float:
    """Worst hose-cap overshoot of ``dem`` (0.0 = feasible): the max over
    diagonal mass, row-sum excess and column-sum excess, in flow units."""
    dem = np.asarray(dem, np.float64)
    servers = np.asarray(servers, np.float64)
    return float(max(np.abs(np.diag(dem)).max(initial=0.0),
                     (dem.sum(axis=1) - servers).max(initial=0.0),
                     (dem.sum(axis=0) - servers).max(initial=0.0)))


@dataclasses.dataclass(frozen=True)
class AdversarialResult:
    """Outcome of one worst-TM search.

    ``tm`` is the worst hose-feasible demand found (switch level) and
    ``lb``/``ub`` its certified bracket; ``baseline_lb``/``baseline_ub``
    bracket the baseline (lane 0 of every round), and ``uniform_gap_pct``
    = 100·(baseline_ub − ub)/baseline_ub.  ``history`` has one dict a
    round; ``stats`` the execute accounting (``executes ==
    search_executes + certify_executes``, one execute a round and one
    certification) and the plan's compile keys; ``fleet`` every emitted
    candidate when ``keep_fleet=True``, else ().
    """

    tm: np.ndarray
    lb: float
    ub: float
    baseline_lb: float
    baseline_ub: float
    uniform_gap_pct: float
    history: list[dict]
    stats: dict[str, Any]
    fleet: tuple[np.ndarray, ...] = ()


def find_worst_tm(topo: Topology, *, seed: int = 0, rounds: int = 4,
                  candidates: int = 8, lr_tm: float = 0.5,
                  proj_iters: int = 8, baseline: np.ndarray | None = None,
                  iters: int = 300, lr: float = 0.08, tol: float = 1e-3,
                  check_every: int = 25, backend: str | None = None,
                  devices: int | None = None,
                  max_lanes: int | None = None,
                  bucket: str | int | None = "pow2",
                  keep_fleet: bool = False,
                  device: str | torch.device = "cuda") -> AdversarialResult:
    """Search the hose polytope for a demand matrix that minimises the
    topology's max-concurrent-flow throughput.

    ``topo`` must be a ``Topology`` with servers on ≥ 2 switches; a
    server-expanded one is coarsened first.  Each round evaluates
    ``candidates`` TMs in one ``BatchPlan.execute(solver="dual-demgrad")``:
    lane 0 is ``baseline`` (default: the random server permutation of this
    ``seed``), lanes 1.. are logit-parameterised and take an Adam step
    (``lr_tm``) along the pulled-back demand gradient.  The worst TM is
    certified by ``solver="primal"`` on the same plan.  ``iters`` / ``lr``
    / ``tol`` / ``check_every`` / ``backend`` are the inner solver's knobs;
    ``devices`` / ``max_lanes`` / ``bucket`` the plan's (``devices``: each
    chunk's lanes over that many local cards, ``None`` = all of them).
    Seeded and deterministic; a lane's bits do not depend on ``devices``.
    """
    if not isinstance(topo, Topology):
        raise ValueError(
            "find_worst_tm needs a Topology (the hose caps come from its "
            "per-switch server counts); got a bare capacity matrix")
    if rounds < 1 or candidates < 2:
        raise ValueError("need rounds >= 1 and candidates >= 2 (lane 0 is "
                         f"the baseline), got rounds={rounds}, "
                         f"candidates={candidates}")
    dev = resolve_device(device)
    topo = topo.coarsen()
    servers = np.asarray(topo.servers, np.int64)
    n = len(servers)
    if int((servers > 0).sum()) < 2:
        raise ValueError(
            "adversarial search needs servers on >= 2 switches, got "
            f"{int((servers > 0).sum())} (the hose polytope has no "
            "off-diagonal demand otherwise)")
    if baseline is None:
        baseline = traffic_mod.random_permutation(
            servers, (seed, _BASELINE_KEY))
    baseline = np.asarray(baseline, np.float64)
    if baseline.shape != (n, n):
        raise ValueError(f"baseline TM must be [{n}, {n}] (switch-level, "
                         f"post-coarsening), got {baseline.shape}")

    rng = np.random.default_rng((seed, _LOGITS_KEY))
    logits = torch.as_tensor(
        rng.normal(0.0, 1.0, size=(candidates - 1, n, n)),
        dtype=torch.float32, device=dev)
    servers_t = torch.as_tensor(servers, dtype=torch.float32, device=dev)
    adam_m = torch.zeros_like(logits)
    adam_v = torch.zeros_like(logits)

    solver_kw = dict(iters=iters, lr=lr, tol=tol, check_every=check_every,
                     backend=backend)
    plan: BatchPlan | None = None
    executes = 0
    history: list[dict] = []
    fleet: list[np.ndarray] = []
    best_ub = np.inf
    best_tm: np.ndarray | None = None
    baseline_search_ub = np.inf

    for r in range(rounds):
        with torch.no_grad():
            proj = _fleet_project(logits, servers_t, proj_iters).cpu().numpy()
        dems = [baseline] + list(proj)
        if keep_fleet:
            fleet.extend(np.asarray(d, np.float64) for d in dems[1:])
        if plan is None:
            plan = BatchPlan.build([topo] * candidates, dems, bucket=bucket,
                                   max_lanes=max_lanes, devices=devices,
                                   device=dev)
        else:
            plan = plan.refill([topo] * candidates, dems)
        solved = plan.execute(solver="dual-demgrad", device=dev, **solver_kw)
        executes += 1
        ubs = np.asarray([s.value for s in solved])
        baseline_search_ub = min(baseline_search_ub, float(ubs[0]))
        arg = int(ubs.argmin())
        if float(ubs[arg]) < best_ub:
            best_ub = float(ubs[arg])
            best_tm = np.asarray(dems[arg], np.float64)
        history.append({"round": r + 1, "best_ub": best_ub,
                        "round_min_ub": float(ubs.min()),
                        "round_mean_ub": float(ubs.mean()),
                        "baseline_ub": float(ubs[0])})
        if r + 1 == rounds:
            break
        # Adam on the logits along the pulled-back Danskin gradient
        # (descending the log-ratio bound = descending log throughput)
        grads = torch.as_tensor(
            np.stack([s.meta["dem_grad"] for s in solved[1:]]),
            dtype=torch.float32, device=dev)
        g = _fleet_pullback(logits, grads, servers_t, proj_iters)
        t = r + 1
        adam_m = 0.9 * adam_m + 0.1 * g
        adam_v = 0.999 * adam_v + 0.001 * g * g
        mh = adam_m / (1 - 0.9 ** t)
        vh = adam_v / (1 - 0.999 ** t)
        logits = logits - lr_tm * mh / (torch.sqrt(vh) + 1e-8)

    assert best_tm is not None and plan is not None
    # certification on the same plan: lane 0 the worst TM, lane 1 the
    # baseline, surplus lanes repeat the worst TM (same shapes, so the
    # refill keeps round one's compile key)
    cert_dems = [best_tm, baseline] + [best_tm] * (candidates - 2)
    certified = plan.refill([topo] * candidates, cert_dems).execute(
        solver="primal", device=dev, **solver_kw)
    executes += 1
    lb = float(certified[0].value)
    ub = min(best_ub, float(certified[0].meta["ub"]))
    baseline_lb = float(certified[1].value)
    baseline_ub = min(baseline_search_ub, float(certified[1].meta["ub"]))
    stats = {"rounds": rounds, "candidates": candidates,
             "executes": executes, "search_executes": rounds,
             "certify_executes": 1,
             "compile_keys": plan.stats.compile_keys,
             "last_plan": plan.stats.as_dict()}
    return AdversarialResult(
        tm=best_tm, lb=lb, ub=ub, baseline_lb=baseline_lb,
        baseline_ub=baseline_ub,
        uniform_gap_pct=100.0 * (baseline_ub - ub) / max(baseline_ub, 1e-30),
        history=history, stats=stats, fleet=tuple(fleet))
