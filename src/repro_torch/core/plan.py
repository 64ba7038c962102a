"""BatchPlan — planning and execution of batched solves (the port of
``repro.core.plan``): ``execute(solver="dual")`` runs the dual descent
(``mcf``), ``execute(solver="dual-demgrad")`` the same descent with each
lane's demand gradient, ``execute(solver="primal")`` the Frank–Wolfe
primal (``primal``, a certified lower bound with the dual's upper bound)
over the same buckets and chunks.

1. **Buckets** — instances are grouped by padded node count
   (``bucket_size``) and padded to their bucket's largest member; padded
   nodes carry zero capacity/demand and are masked out of the solve.
2. **Chunks** — each bucket's batch axis is split under ``max_lanes``; all
   chunks of a bucket share one lane count (the trailing chunk is filled
   with lanes that replicate its first instance), so ``compile_keys`` —
   the distinct ``(padded_n, lanes)`` shapes — keeps the reference's
   meaning: one shape per (bucket, chunk-shape).
3. **Device** — the port runs on one card; ``devices`` accepts only 1.
4. **Dispatch** — chunks run in order on the device's stream and results
   stay on the device until every chunk has been queued; then the plan
   copies them to the host once.  (The descent itself reads a convergence
   flag once per check window, so chunks do not overlap on the card.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import mcf, primal
from repro_torch.core.graphs import Topology, as_cap, degree_stats

__all__ = ["bucket_size", "device_count", "Chunk", "PlanStats",
           "InstanceSolve", "SOLVERS", "BatchPlan"]


def bucket_size(n: int, mode: str | int | None) -> int:
    """Padded size for an ``n``-node instance under a bucketing ``mode``:
    ``"pow2"`` (next power of two, floor 8), ``"mult128"`` (next multiple
    of 128), an ``int`` m (next multiple of m), or ``None``/``"none"``/
    ``"exact"`` (group by exact size)."""
    if mode in (None, "none", "exact"):
        return n
    if mode == "pow2":
        return max(8, 1 << (n - 1).bit_length())
    if mode == "mult128":
        mode = 128
    if isinstance(mode, int) and mode > 0:
        return -(-n // mode) * mode
    raise ValueError(f"unknown bucket mode {mode!r}; expected 'pow2', "
                     "'mult128', a positive int, or None")


def device_count(devices: int | None = None) -> int:
    """Resolve a ``devices`` knob: the port drives one card, so ``None``
    and 1 mean 1 and anything else raises."""
    if devices is None:
        return 1
    if devices != 1:
        raise ValueError(f"devices={devices} out of range; the port runs "
                         "on 1 device")
    return 1


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One launch: a slice of a bucket, padded to ``lanes`` rows."""

    bucket: int                # bucket key the members were grouped under
    padded_n: int              # node-dim target (largest member in bucket)
    indices: tuple[int, ...]   # original instance positions (real lanes)
    lanes: int                 # batch rows incl. padding

    @property
    def pad_lanes(self) -> int:
        return self.lanes - len(self.indices)


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """What the planner decided — reported in result ``meta``."""

    instances: int
    buckets: int
    chunks: int
    devices: int
    max_lanes: int | None
    lanes_total: int           # sum of chunk lane counts (incl. padding)
    lanes_padded: int          # replicated lanes added for shape fit
    compile_keys: tuple[tuple[int, int], ...]   # distinct (padded_n, lanes)

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class InstanceSolve:
    """Per-instance solver output of an executed plan: ``value`` is the
    certified bound (an UPPER bound under ``solver="dual"``, a LOWER bound
    under ``solver="primal"``, whose dual upper bound is ``meta["ub"]``);
    the rest of the solver's outputs and the plan placement land in
    ``meta``."""

    value: float
    iterations: int
    meta: Mapping[str, Any]


def _dispatch_dual(capp, demp, n_valid, solver_kw):
    r = mcf.solve_dual_batch(capp, demp, n_valid=n_valid, block=False,
                             **solver_kw)
    return {"value": r.throughput_ub, "final_ratio": r.final_ratio,
            "iterations": r.iterations}


def _dispatch_dual_demgrad(capp, demp, n_valid, solver_kw):
    r = mcf.solve_dual_demgrad_batch(capp, demp, n_valid=n_valid,
                                     block=False, **solver_kw)
    return {"value": r.throughput_ub, "final_ratio": r.final_ratio,
            "iterations": r.iterations, "dem_grad": r.dem_grad}


def _dispatch_primal(capp, demp, n_valid, solver_kw):
    r = primal.solve_primal_batch(capp, demp, n_valid=n_valid, block=False,
                                  **solver_kw)
    return {"value": r.throughput_lb, "ub": r.throughput_ub,
            "final_util": r.final_util, "iterations": r.iterations}


# chunk dispatchers by solver name: (capp, demp, n_valid, solver_kw) ->
# dict of per-lane device tensors; "value" is the headline bound, every
# other key is copied into the per-instance meta
SOLVERS = {"dual": _dispatch_dual, "primal": _dispatch_primal,
           "dual-demgrad": _dispatch_dual_demgrad}


class BatchPlan:
    """An executable plan over one pile of (topology, demand) instances."""

    def __init__(self, caps: list[np.ndarray], dems: list[np.ndarray],
                 chunks: list[Chunk], devices: int,
                 max_lanes: int | None, bucket_mode: str | int | None):
        self.caps = caps
        self.dems = dems
        self.chunks = chunks
        self.devices = devices
        self.max_lanes = max_lanes
        self.bucket_mode = bucket_mode
        self.stats = PlanStats(
            instances=len(caps), buckets=len({c.bucket for c in chunks}),
            chunks=len(chunks), devices=devices, max_lanes=max_lanes,
            lanes_total=sum(c.lanes for c in chunks),
            lanes_padded=sum(c.pad_lanes for c in chunks),
            compile_keys=tuple(sorted({(c.padded_n, c.lanes)
                                       for c in chunks})))

    @classmethod
    def build(cls, topos: Sequence[Topology | np.ndarray],
              dems: Sequence[np.ndarray], *,
              bucket: str | int | None = "pow2",
              max_lanes: int | None = None,
              devices: int | None = None) -> "BatchPlan":
        """Plan ``len(topos)`` instances: bucket by padded size and chunk
        each bucket under ``max_lanes`` rows per launch."""
        if len(topos) != len(dems):
            raise ValueError(f"topos ({len(topos)}) and dems ({len(dems)}) "
                             "must have equal length")
        if max_lanes is not None and max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        caps = [np.asarray(as_cap(t), np.float32) for t in topos]
        demsl = [np.asarray(d, np.float32) for d in dems]
        ndev = device_count(devices)
        by_bucket: dict[int, list[int]] = {}
        for i, c in enumerate(caps):
            by_bucket.setdefault(bucket_size(c.shape[0], bucket),
                                 []).append(i)
        chunks: list[Chunk] = []
        for bkt, idx in sorted(by_bucket.items()):
            # pad to the largest member, not the bucket ceiling
            size = max(caps[i].shape[0] for i in idx)
            lanes = len(idx) if max_lanes is None else min(max_lanes,
                                                           len(idx))
            for lo in range(0, len(idx), lanes):
                chunks.append(Chunk(bucket=bkt, padded_n=size,
                                    indices=tuple(idx[lo:lo + lanes]),
                                    lanes=lanes))
        return cls(caps, demsl, chunks, ndev, max_lanes, bucket)

    def refill(self, topos: Sequence[Topology | np.ndarray],
               dems: Sequence[np.ndarray]) -> "BatchPlan":
        """A new plan over fresh instances that reuses this plan's chunk
        structure; instance ``i`` must keep its node count (``ValueError``
        otherwise — rebuild the plan)."""
        if len(topos) != len(self.caps):
            raise ValueError(f"refill needs {len(self.caps)} instances "
                             f"(the planned count), got {len(topos)}")
        caps = [np.asarray(as_cap(t), np.float32) for t in topos]
        for i, (old, new) in enumerate(zip(self.caps, caps)):
            if old.shape != new.shape:
                raise ValueError(
                    f"refill instance {i} is {new.shape[0]} nodes, planned "
                    f"for {old.shape[0]}; rebuild the plan for a new size "
                    "profile")
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.caps = caps
        clone.dems = [np.asarray(d, np.float32) for d in dems]
        return clone

    def _pack(self, chunk: Chunk):
        """One chunk's padded [lanes, n, n] arrays.  Surplus lanes
        replicate the chunk's first instance (a zero instance would make a
        0/0 ratio) and are dropped on unpack."""
        s = chunk.padded_n
        capp = np.zeros((chunk.lanes, s, s), np.float32)
        demp = np.zeros((chunk.lanes, s, s), np.float32)
        n_valid = np.empty(chunk.lanes, np.int32)
        rows = list(chunk.indices) + [chunk.indices[0]] * chunk.pad_lanes
        for lane, i in enumerate(rows):
            n = self.caps[i].shape[0]
            capp[lane, :n, :n] = self.caps[i]
            demp[lane, :n, :n] = self.dems[i]
            n_valid[lane] = n
        return capp, demp, n_valid

    def _density_hints(self, chunk: Chunk) -> dict[str, Any]:
        """Per-chunk sparsity stats from the unpadded members: the widest
        member's max degree and the densest member's mean degree."""
        d_max, mean = 0, 0.0
        for i in chunk.indices:
            dm, md = degree_stats(self.caps[i])
            d_max = max(d_max, dm)
            mean = max(mean, md)
        return {"d_max": max(1, d_max), "mean_degree": mean}

    def execute(self, solver: str = "dual", *,
                device: str | torch.device = "cuda",
                **solver_kw) -> list[InstanceSolve]:
        """Run every chunk on ``device``, copy the results to the host
        once, and scatter them back into input order.  ``solver`` names a
        ``SOLVERS`` entry ("dual", "dual-demgrad": ``meta["dem_grad"]`` is
        each lane's demand gradient, or "primal").  ``solver_kw`` goes
        to the solver (iters/lr/tol/check_every/use_pallas/backend/d_max/
        max_rounds); where the backend can land on ``"ell-bf"`` and no
        table stats were given, each chunk gets its own density hints."""
        try:
            dispatch = SOLVERS[solver]
        except KeyError:
            raise ValueError(f"unknown plan solver {solver!r}; "
                             f"known: {sorted(SOLVERS)}") from None
        dev = mcf.resolve_device(device)
        want_hints = (solver_kw.get("backend") in (None, "auto", "ell-bf")
                      and not solver_kw.get("use_pallas")
                      and "d_max" not in solver_kw
                      and "mean_degree" not in solver_kw)
        pending = []
        for chunk in self.chunks:
            capp, demp, n_valid = self._pack(chunk)
            kw = ({**solver_kw, **self._density_hints(chunk)}
                  if want_hints else solver_kw)
            pending.append(dispatch(capp, demp, n_valid,
                                    {**kw, "device": dev}))
        # ONE host copy for the whole plan
        host = [{k: v.cpu().numpy() for k, v in r.items()} for r in pending]
        stats = self.stats.as_dict()
        out: list[InstanceSolve | None] = [None] * len(self.caps)
        for ci, (chunk, arrs) in enumerate(zip(self.chunks, host)):
            for lane, i in enumerate(chunk.indices):
                # per-lane scalars become floats (iterations: int); a
                # per-lane array (dual-demgrad's [n, n] demand gradient)
                # is cropped to the instance's own node count
                n = int(self.caps[i].shape[0])
                solved = {}
                for k, a in arrs.items():
                    if k == "value":
                        continue
                    if k == "iterations":
                        solved[k] = int(a[lane])
                    elif a[lane].ndim == 0:
                        solved[k] = float(a[lane])
                    else:
                        solved[k] = a[lane][(slice(n),) * a[lane].ndim]
                out[i] = InstanceSolve(
                    value=float(arrs["value"][lane]),
                    iterations=int(arrs["iterations"][lane]),
                    meta={**solved,
                          "bucket": chunk.bucket,
                          "padded_n": chunk.padded_n,
                          "nodes": n,
                          "batch_size": len(chunk.indices),
                          "chunk": ci, "chunks": len(self.chunks),
                          "devices": self.devices, "plan": dict(stats)})
        return out  # type: ignore[return-value]
