"""Heterogeneous topology experiments (paper §5, Figs. 3-7; the port
of ``repro.core.heterogeneous``).

Every experiment sweeps one (or two) design parameters of a two-class switch
network, builds the topology per the paper's recipe (servers first, then a
random graph over the remaining ports — biased across clusters if asked),
and measures max-concurrent-flow throughput over several seeded runs.

All sweeps are declarative ``engine.Sweep``s executed by
``engine.run_sweep``/``run_sweeps``: every (point × run) instance goes
through one ``solve_batch`` call, and the grid experiments (``combined_sweep``,
``line_speed_sweep``) route ALL of their member sweeps through a single
``run_sweeps`` call — one ``BatchPlan`` for the whole figure family on a
batching engine (``get_engine("dual")`` / ``"dual-pallas"``), instead of
one small batch per grid cell.  ``cross_cluster_sweep_item`` exposes the
(sweep, build_fn) building block so figure harnesses (e.g. Fig. 7's three
panels) can pool even more sweeps into one plan.  The ``engine`` argument
accepts a registry name or a ``ThroughputEngine`` instance; with a bracket
engine (``get_engine("certified")``) every returned ``SweepPoint`` also
carries ``lb_mean``/``gap_max`` — the certified lower-bound mean and the
worst relative bracket width across the point's runs.

The sweeps replay the paper's *recipes*; ``optimize_spec`` runs the
paper's *method* — a fleet search over the same pool via
``repro_torch.design`` (one ``BatchPlan.execute`` per round).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import engine as engine_mod
from repro_torch.core import graphs
from repro_torch.core.engine import Sweep, SweepPoint, run_sweep, run_sweeps

__all__ = [
    "SweepPoint",
    "TwoClassSpec",
    "throughput",
    "build_two_class",
    "optimize_spec",
    "server_distribution_sweep",
    "power_law_beta_sweep",
    "cross_cluster_sweep",
    "cross_cluster_sweep_item",
    "combined_sweep",
    "line_speed_sweep",
    "line_speed_sweep_items",
]


@dataclasses.dataclass(frozen=True)
class TwoClassSpec:
    """A pool of two switch types (uniform line-speed unless h_* set)."""
    n_large: int
    k_large: int     # ports per large switch
    n_small: int
    k_small: int     # ports per small switch
    num_servers: int
    # optional high-line-speed ports on the LARGE switches (paper §5.2):
    h_links: int = 0        # number of high-speed ports per large switch
    h_speed: float = 1.0    # capacity of each high-speed port (units of base)

    @property
    def total_ports(self) -> int:
        return self.n_large * self.k_large + self.n_small * self.k_small

    @property
    def proportional_large_servers(self) -> int:
        """Expected servers on large switches if spread randomly over ports
        (the paper's x-axis normaliser; == proportional-to-port-count)."""
        return round(self.num_servers * self.n_large * self.k_large
                     / self.total_ports)


def throughput(cap, dem, engine="exact") -> float:
    """Deprecated shim: use ``get_engine(engine).solve(topo, dem)``."""
    return engine_mod.as_engine(engine).solve(cap, dem).throughput


def _spread_evenly(total: int, n: int) -> np.ndarray:
    """Split ``total`` across n switches as evenly as possible."""
    base = total // n
    out = np.full(n, base, dtype=np.int64)
    out[: total - base * n] += 1
    return out


def _even_degree_fixup(deg: np.ndarray) -> np.ndarray:
    """Leave one port unused on the highest-degree switch if the network
    degree sum is odd (the configuration model needs even stub count)."""
    if deg.sum() % 2 != 0:
        deg = deg.copy()
        deg[int(np.argmax(deg))] -= 1
    return deg


def build_two_class(spec: TwoClassSpec, servers_on_large: int,
                    cross_bias: float | None, seed: int,
                    server_nodes: bool = False) -> graphs.Topology:
    """Build the paper's two-class topology:

    * ``servers_on_large`` servers spread evenly over the large switches, the
      rest evenly over the small switches (footnote 4: within a class, even
      spread is optimal);
    * remaining (low-speed) ports wired as a random graph — unbiased if
      ``cross_bias`` is None, else with the cross-cluster edge count scaled
      by ``cross_bias`` relative to the unbiased expectation;
    * if the spec has high-speed ports, they form a random ``h_links``-regular
      graph among the large switches with capacity ``h_speed`` per link.
    """
    servers_on_large = int(np.clip(servers_on_large, 0, spec.num_servers))
    srv_l = _spread_evenly(servers_on_large, spec.n_large)
    srv_s = _spread_evenly(spec.num_servers - servers_on_large, spec.n_small)
    if np.any(srv_l >= spec.k_large + spec.h_links) or \
            np.any(srv_s >= spec.k_small):
        raise ValueError("server split leaves a switch without network ports")
    deg_l = spec.k_large - srv_l
    deg_s = spec.k_small - srv_s

    if cross_bias is None:
        deg = _even_degree_fixup(np.concatenate([deg_l, deg_s]))
        cap = graphs._random_graph_cap(deg, seed)
    else:
        # parity fixup per cluster happens inside via n_cross adjustment;
        # still guard each cluster's stub parity for the intra phase
        cap, _ = graphs._biased_two_cluster_cap(deg_l, deg_s, cross_bias,
                                                seed)

    if spec.h_links > 0 and spec.n_large > 1:
        h = min(spec.h_links, spec.n_large - 1)
        if spec.n_large * h % 2 != 0:
            h -= 1
        if h > 0:
            cap_h = graphs._random_regular_cap(spec.n_large, h, seed + 7,
                                               capacity=spec.h_speed)
            cap[: spec.n_large, : spec.n_large] += cap_h

    labels = np.concatenate([np.ones(spec.n_large, np.int64),
                             np.zeros(spec.n_small, np.int64)])
    topo = graphs.Topology(cap=cap, servers=np.concatenate([srv_l, srv_s]),
                           labels=labels)
    # server_nodes: the server-expanded view (one degree-1 leaf per server);
    # planning engines coarsen it back onto this switch graph by default
    return topo.with_server_nodes() if server_nodes else topo


def optimize_spec(spec: TwoClassSpec, *, engine=None,
                  moves: Sequence[str] = ("swap", "servers", "bias"),
                  rounds: int = 4, fleet: int = 12, elite: int = 4,
                  runs: int = 2, seed: int = 0, demand_fn=None):
    """Search the two-class pool for a high-throughput design instead of
    replaying the paper's recipe: a fleet of candidate wirings per round
    (degree-preserving edge swaps + server re-distribution + cross-bias
    perturbation over ``build_two_class``), each round ONE
    ``BatchPlan.execute``, final elites certified with the primal solver.
    Returns a ``repro_torch.design.DesignResult``: ``best`` (certified-best
    candidate, never below the proportional/bias-1.0 ``reference``),
    ``elites``, per-round ``history``, plan/compile ``stats``, and a
    resumable ``state``.  ``engine`` defaults to the designer's dual engine
    on the card.  The grid sweeps above answer "what does the recipe
    give"; this answers "what does the pool support"."""
    from repro_torch.design import TwoClassSpace, optimize

    return optimize(TwoClassSpace(spec), demand_fn=demand_fn, engine=engine,
                    moves=moves, rounds=rounds, fleet=fleet, elite=elite,
                    runs=runs, seed=seed)


def server_distribution_sweep(spec: TwoClassSpec, xs: Sequence[float],
                              runs: int = 3, seed0: int = 0,
                              engine="exact") -> list[SweepPoint]:
    """Fig. 3: vary the share of servers on large switches.  x is normalised
    so x=1 ⇔ port-count-proportional distribution; interconnect unbiased."""
    prop = spec.proportional_large_servers

    def build(x: float, seed: int) -> graphs.Topology:
        return build_two_class(spec, round(x * prop), None, seed)

    return run_sweep(Sweep(xs=tuple(xs), runs=runs, seed0=seed0),
                     build, engine)


def power_law_beta_sweep(n: int, k_min: int, k_max: int, alpha: float,
                         num_servers: int, betas: Sequence[float],
                         runs: int = 3, seed0: int = 0,
                         engine="exact") -> list[SweepPoint]:
    """Fig. 4: power-law port counts; servers ∝ k_i^β; unbiased interconnect."""

    def build(beta: float, seed: int) -> graphs.Topology:
        ks = graphs.power_law_degrees(n, k_min, k_max, alpha, seed)
        srv = graphs.distribute_servers(ks, num_servers, beta)
        deg = _even_degree_fixup(ks - srv)
        # seed + 2: run_sweep draws the demand from seed + 1, and the graph
        # wiring must come from a distinct RNG stream
        return graphs.random_graph_from_degrees(deg, seed + 2, servers=srv)

    return run_sweep(Sweep(xs=tuple(betas), runs=runs, seed0=seed0),
                     build, engine)


def cross_cluster_sweep_item(spec: TwoClassSpec, biases: Sequence[float],
                             runs: int = 3, seed0: int = 0,
                             servers_on_large: int | None = None
                             ) -> tuple[Sweep, Callable]:
    """The (sweep, build_fn) pair of one cross-cluster bias sweep, for
    pooling several sweeps into one ``run_sweeps`` call (one ``BatchPlan``
    across a whole figure family)."""
    s_l = (spec.proportional_large_servers if servers_on_large is None
           else servers_on_large)

    def build(x: float, seed: int) -> graphs.Topology:
        return build_two_class(spec, s_l, x, seed)

    return Sweep(xs=tuple(biases), runs=runs, seed0=seed0), build


def cross_cluster_sweep(spec: TwoClassSpec, biases: Sequence[float],
                        runs: int = 3, seed0: int = 0,
                        engine="exact",
                        servers_on_large: int | None = None) -> list[SweepPoint]:
    """Fig. 5 (and 7 with h_links set): proportional servers, vary the
    cross-cluster edge count as a multiple of the unbiased expectation."""
    sweep, build = cross_cluster_sweep_item(spec, biases, runs, seed0,
                                            servers_on_large)
    return run_sweep(sweep, build, engine)


def combined_sweep(spec: TwoClassSpec,
                   server_splits: Sequence[tuple[int, int]],
                   biases: Sequence[float], runs: int = 3, seed0: int = 0,
                   engine="exact") -> dict[tuple[int, int], list[SweepPoint]]:
    """Fig. 6 / 7(a): grid over (per-large, per-small) server splits × bias.
    Each split is (servers per large switch, servers per small switch) and
    must sum to spec.num_servers.  The whole grid goes through ONE
    ``run_sweeps`` call — one ``BatchPlan`` on a batching engine."""
    items, keys = [], []
    for (per_l, per_s) in server_splits:
        tot = per_l * spec.n_large + per_s * spec.n_small
        if tot != spec.num_servers:
            raise ValueError(f"split {(per_l, per_s)} gives {tot} servers, "
                             f"spec has {spec.num_servers}")
        items.append(cross_cluster_sweep_item(
            spec, biases, runs, seed0,
            servers_on_large=per_l * spec.n_large))
        keys.append((per_l, per_s))
    return dict(zip(keys, run_sweeps(items, engine)))


def line_speed_sweep_items(spec: TwoClassSpec, biases: Sequence[float],
                           h_speeds: Sequence[float] | None = None,
                           h_counts: Sequence[int] | None = None,
                           runs: int = 3, seed0: int = 0
                           ) -> tuple[list[float | int],
                                      list[tuple[Sweep, Callable]]]:
    """(keys, items) of the Fig. 7(b)/(c) line-speed settings — one
    cross-cluster sweep per ``h_speed``/``h_links`` value — for pooling
    into a ``run_sweeps`` call (figure harnesses add their own panels)."""
    items: list[tuple[Sweep, Callable]] = []
    keys: list[float | int] = []
    for s in (h_speeds if h_speeds is not None else ()):
        sp = dataclasses.replace(spec, h_speed=float(s))
        items.append(cross_cluster_sweep_item(sp, biases, runs, seed0))
        keys.append(float(s))
    for hc in (h_counts if h_counts is not None else ()):
        sp = dataclasses.replace(spec, h_links=int(hc))
        items.append(cross_cluster_sweep_item(sp, biases, runs, seed0))
        keys.append(int(hc))
    return keys, items


def line_speed_sweep(spec: TwoClassSpec, biases: Sequence[float],
                     h_speeds: Sequence[float] | None = None,
                     h_counts: Sequence[int] | None = None,
                     runs: int = 3, seed0: int = 0,
                     engine="exact") -> dict[float | int, list[SweepPoint]]:
    """Fig. 7(b)/(c): vary the line-speed (or count) of the high-speed links
    on the large switches, sweeping cross-cluster bias for each setting.
    All settings pool into ONE ``run_sweeps`` call (one ``BatchPlan``)."""
    keys, items = line_speed_sweep_items(spec, biases, h_speeds, h_counts,
                                         runs, seed0)
    return dict(zip(keys, run_sweeps(items, engine)))
