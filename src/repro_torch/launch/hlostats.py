"""Collective accounting and roofline arithmetic on H100 constants (the
port of ``repro.launch.hlostats``).

Wire bytes per chip follow the reference's ring-algorithm factors, applied
to each collective's per-shard result bytes (the shape an HLO line
carries):

    all-gather          out_bytes * (g-1)/g
    all-reduce          2 * bytes * (g-1)/g
    reduce-scatter      out_bytes * (g-1)          (out is the scattered part)
    all-to-all          bytes * (g-1)/g
    collective-permute  bytes

and a collective counts as cross-pod (DCN) when two members of its group
are ``pod_stride`` or more ranks apart (pods are the outermost 256-rank
blocks of the 512-rank mesh).  The reference reads these from XLA's HLO
text; the port has no HLO, so ``collective_stats`` reads the records of
the collectives one traced step issued (``launch.dryrun``'s recorder:
the op, its result bytes on this rank, its group's ranks).

``H100`` holds datasheet figures, not measurements: 989 TFLOP/s of dense
bf16 and 3.35 TB/s of HBM3 (the SXM5 part), NVLink 4 at 900 GB/s both
ways (450 GB/s one way) as the in-pod link, and one 400 Gb/s NDR port a
GPU (as in a DGX H100) as the cross-pod link.  The model axis of 16 spans
two 8-GPU NVLink domains, so part of its traffic crosses the network:
the ICI term at NVLink speed is a floor.
"""
from __future__ import annotations

import dataclasses

__all__ = ["H100", "Hardware", "Collective", "CollectiveStats",
           "collective_stats", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    dcn_bw: float              # bytes/s per chip cross-pod


# datasheet values (module docstring)
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                dcn_bw=50e9)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as a traced step issued it on one rank: ``op`` by
    the reference's (HLO) name, ``bytes`` its result on this rank, and
    ``ranks`` its group's global ranks (two, source and target, for a
    ``collective-permute``)."""
    op: str
    bytes: float
    ranks: tuple


@dataclasses.dataclass
class CollectiveStats:
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0
    by_op: dict = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, op: str, wire: float, is_dcn: bool) -> None:
        self.count += 1
        self.by_op[op] = self.by_op.get(op, 0.0) + wire
        if is_dcn:
            self.dcn_bytes += wire
        else:
            self.ici_bytes += wire


def collective_stats(records, pod_stride: int = 256) -> CollectiveStats:
    """Per-chip wire bytes of ``records`` (``Collective``s), by the
    reference's ring factors and cross-pod rule (``parse_collectives``)."""
    stats = CollectiveStats()
    for rec in records:
        members = list(rec.ranks)
        g = max(len(members), 2)
        bytes_, op = rec.bytes, rec.op
        is_dcn = any(abs(a - b) >= pod_stride
                     for a in members for b in members)
        if op == "all-gather":
            wire = bytes_ * (g - 1) / g
        elif op == "all-reduce":
            wire = 2 * bytes_ * (g - 1) / g
        elif op == "reduce-scatter":
            wire = bytes_ * (g - 1)
        elif op == "all-to-all":
            wire = bytes_ * (g - 1) / g
        elif op == "collective-permute":
            wire = bytes_
        else:
            raise ValueError(f"collective_stats: unknown op {op!r}")
        stats.add(op, wire, is_dcn)
    return stats


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll: CollectiveStats, hw: Hardware = H100) -> dict:
    """The three §Roofline terms, in seconds, plus the verdict."""
    t_compute = flops_per_chip / hw.peak_flops
    t_memory = bytes_per_chip / hw.hbm_bw
    t_ici = coll.ici_bytes / hw.ici_bw
    t_dcn = coll.dcn_bytes / hw.dcn_bw
    t_coll = t_ici + t_dcn
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll, "ici_s": t_ici, "dcn_s": t_dcn}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom
    # overlap-free step time bound and the achievable-fraction-of-peak
    terms["step_bound_s"] = max(t_compute, t_memory, t_coll)
    terms["roofline_fraction"] = (
        t_compute / terms["step_bound_s"] if terms["step_bound_s"] > 0 else 0)
    return terms
