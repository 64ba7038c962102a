"""Throughput decomposition T = C·U / (f·⟨D⟩·AS)   (paper §6.1, Fig. 8; the
port of ``repro.core.decompose``, on the HiGHS oracle).

The paper writes T = C·U/(⟨D⟩·AS) with the flow count f absorbed into the
normalisation; we keep f explicit so the identity holds exactly:

    Σ_e flow_e  =  U·C            (definition of capacity-weighted utilisation)
    Σ_e flow_e  =  Σ_i x_i·len_i  (flow decomposition; len_i = avg routed hops)
                =  θ·f·⟨D⟩·AS     (concurrent flow: x_i = θ·dem_i; AS = stretch)

    ⇒  θ = C·U / (f·⟨D⟩·AS)

Also provides the per-link-class utilisation breakdown the paper uses to
locate bottlenecks (intra-small / intra-large / cross-cluster).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import lp as _lp
from repro_torch.core.graphs import Topology

__all__ = ["Decomposition", "decompose", "utilization_by_class"]


@dataclasses.dataclass(frozen=True)
class Decomposition:
    throughput: float     # θ (per unit-demand concurrent rate)
    capacity: float       # C: total capacity, both directions
    utilization: float    # U: Σ flow / Σ cap
    aspl: float           # ⟨D⟩: demand-weighted shortest path length (hops)
    stretch: float        # AS: flow-weighted routed hops / ⟨D⟩
    flows: float          # f: Σ dem

    @property
    def reconstructed(self) -> float:
        """C·U/(f·⟨D⟩·AS) — must equal ``throughput`` up to LP tolerance."""
        return self.capacity * self.utilization / (
            self.flows * self.aspl * self.stretch)


def decompose(cap: Topology | np.ndarray, dem: np.ndarray,
              result: _lp.FlowResult | None = None) -> Decomposition:
    """Decompose the throughput of (cap, dem) into the paper's four factors."""
    if result is None:
        result = _lp.max_concurrent_flow(cap, dem, want_flows=True)
    theta = result.throughput
    c = float(result.edge_cap.sum())
    total_flow = float(result.edge_flow.sum())
    u = total_flow / c
    aspl = _lp.aspl_hops(cap, dem)
    f = float(dem.sum())
    delivered = theta * f
    routed_hops = total_flow / delivered if delivered > 0 else float("nan")
    stretch = routed_hops / aspl if aspl > 0 else float("nan")
    return Decomposition(throughput=theta, capacity=c, utilization=u,
                         aspl=aspl, stretch=stretch, flows=f)


def utilization_by_class(result: _lp.FlowResult,
                         labels: np.ndarray) -> dict[tuple[int, int], float]:
    """Average link utilisation per (label_u, label_v) edge class, with the
    class key sorted so (0,1) covers both directions of cross-cluster links."""
    labels = np.asarray(labels)
    out: dict[tuple[int, int], list] = {}
    for (u, v), c, f in zip(result.edges, result.edge_cap, result.edge_flow):
        key = tuple(sorted((int(labels[u]), int(labels[v]))))
        out.setdefault(key, []).append(f / c if c > 0 else 0.0)
    return {k: float(np.mean(v)) for k, v in out.items()}
