"""BatchPlan — planning and execution of batched solves (the port of
``repro.core.plan``): ``execute(solver="dual")`` runs the dual descent
(``mcf``), ``execute(solver="dual-demgrad")`` the same descent with each
lane's demand gradient, ``execute(solver="primal")`` the Frank–Wolfe
primal (``primal``, a certified lower bound with the dual's upper bound)
over the same buckets and chunks, and ``execute(solver="ecmp" | "ksp")``
the routing-restricted lower bounds (``routing``) with the ideal upper
bound beside them.

1. **Buckets** — instances are grouped by padded node count
   (``bucket_size``) and padded to their bucket's largest member; padded
   nodes carry zero capacity/demand and are masked out of the solve.
2. **Chunks** — each bucket's batch axis is split under ``max_lanes``; all
   chunks of a bucket share one lane count (the trailing chunk is filled
   with lanes that replicate its first instance), so ``compile_keys`` —
   the distinct ``(padded_n, lanes)`` shapes — keeps the reference's
   meaning: one shape per (bucket, chunk-shape).
3. **Devices** — each chunk's lanes are split into ``devices`` equal
   shards (its lane count is always a multiple of ``devices``; surplus
   lanes replicate its first instance and are dropped on unpack).  On CUDA
   shard ``j`` runs on ``cuda:j``, each card from a host thread of its own,
   so a card never waits on another's convergence reads; on the CPU the
   shards run one after another (the sharded path without cards).  A
   lane's bits do not depend on its batch (lanes freeze by ``torch.where``;
   sums run in orders fixed by N), so a sharded plan gives every lane the
   bits of ``devices=1``.  Sharding is asked for by number: ``None`` is
   one device (``device_count`` says why).
4. **Dispatch** — results stay on the devices until every shard of every
   chunk has been dispatched; then the plan copies them to the host once.
   (The descent reads a convergence flag once per check window, so chunks
   on one card do not overlap.)

``compile_cache_sizes`` counts the programs each solver entry point has
run, and the kernel library's builds and warm loads (``aot.compiles`` /
``aot.hits``).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import mcf, primal, routing
from repro_torch.core.graphs import Topology, as_cap, degree_stats
from repro_torch.kernels import _build

__all__ = ["bucket_size", "device_count", "compile_cache_sizes", "Chunk",
           "PlanStats", "InstanceSolve", "SOLVERS", "BatchPlan"]


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


def device_count(devices: int | None = None,
                 device: str | torch.device = "cuda") -> int:
    """Resolve a ``devices`` knob for ``device``.  ``None`` means one
    device.  On CUDA an explicit ``k`` must lie in 1..
    ``torch.cuda.device_count()``; on the CPU any ``k >= 1`` splits each
    chunk into ``k`` shards run in turn.

    The reference's ``None`` means every local device, where one launch
    spans them all.  Here each shard launches a whole step's kernels from
    a host thread of its own, and the descent is launch-bound: phase 3's
    pile ran 9.9x slower on four cards than on one (PERF.md, ROADMAP P9).
    So the port shards only when asked."""
    if devices is None:
        return 1
    cuda = torch.device(device).type == "cuda"
    avail = torch.cuda.device_count() if cuda else None
    if devices < 1 or (cuda and devices > avail):
        raise ValueError(f"devices={devices} out of range; "
                         + (f"{avail} local device(s) available" if cuda
                            else "the CPU takes any devices >= 1"))
    return int(devices)


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One launch: a slice of a bucket, padded to ``lanes`` rows."""

    bucket: int                # bucket key the members were grouped under
    padded_n: int              # node-dim target (largest member in bucket)
    indices: tuple[int, ...]   # original instance positions (real lanes)
    lanes: int                 # batch rows incl. padding (devices multiple)

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
    lanes_padded: int          # replicated lanes added for shape/device fit
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


def _dispatch_routing(solve):
    def dispatch(capp, demp, n_valid, solver_kw):
        r = solve(capp, demp, n_valid=n_valid, block=False, **solver_kw)
        return {"value": r.throughput_lb, "ub": r.throughput_ub,
                "final_util": r.final_util, "iterations": r.iterations,
                "ecmp_hops": r.ecmp_hops}
    return dispatch


# chunk dispatchers by solver name: (capp, demp, n_valid, solver_kw) ->
# dict of per-lane device tensors; "value" is the headline bound, every
# other key is copied into the per-instance meta
SOLVERS = {"dual": _dispatch_dual, "primal": _dispatch_primal,
           "dual-demgrad": _dispatch_dual_demgrad,
           "ecmp": _dispatch_routing(routing.solve_ecmp_batch),
           "ksp": _dispatch_routing(routing.solve_ksp_batch)}


def compile_cache_sizes() -> dict[str, int]:
    """Program counts per (solver backend, entry point) — e.g.
    ``{"dual.solve_batch": 3, "primal.solve_batch": 1, ...}``, the
    reference's keys: the distinct (shapes, dtypes, static kwargs) keys
    each entry point has run in this process (``mcf.compile_cache_sizes``
    says why a count, not a compile).  Benchmarks report deltas of this to
    show "one program per (bucket, chunk-shape)".  Also carries the port's
    one compile, the kernel library's: ``aot.compiles`` counts its nvcc
    builds in this process and ``aot.hits`` its loads that found it built
    already (``kernels._build`` keeps it across processes, named by a hash
    of its sources), so a warm process shows ``aot.compiles == 0``."""
    out: dict[str, int] = {}
    for name, mod in (("dual", mcf), ("primal", primal),
                      ("routing", routing)):
        for k, v in mod.compile_cache_sizes().items():
            out[f"{name}.{k}"] = v
    out["aot.compiles"], out["aot.hits"] = _build.build_counts()
    return out


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
              devices: int | None = None,
              device: str | torch.device = "cuda") -> "BatchPlan":
        """Plan ``len(topos)`` instances: bucket by padded size, chunk each
        bucket under ``max_lanes`` rows per launch, pad each chunk's batch
        axis to a multiple of ``devices`` (``device_count(devices,
        device)``).  Every launch spans all devices, so one lane per device
        is the floor: a ``max_lanes`` below the device count (or not a
        multiple of it) is rounded to the nearest feasible budget, never
        exceeded beyond that floor."""
        if len(topos) != len(dems):
            raise ValueError(f"topos ({len(topos)}) and dems ({len(dems)}) "
                             "must have equal length")
        if max_lanes is not None and max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        caps = [np.asarray(as_cap(t), np.float32) for t in topos]
        demsl = [np.asarray(d, np.float32) for d in dems]
        ndev = device_count(devices, device)
        by_bucket: dict[int, list[int]] = {}
        for i, c in enumerate(caps):
            by_bucket.setdefault(bucket_size(c.shape[0], bucket),
                                 []).append(i)
        chunks: list[Chunk] = []
        for bkt, idx in sorted(by_bucket.items()):
            # pad to the largest member, not the bucket ceiling
            size = max(caps[i].shape[0] for i in idx)
            need = -(-len(idx) // ndev) * ndev   # device multiple that fits
            if max_lanes is None:
                lanes = need
            else:
                # floor the budget to a device multiple (never below one
                # lane per device), and never pad a small bucket up to it
                lanes = min(max(ndev, max_lanes // ndev * ndev), need)
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

    def _chunk_kw(self, chunk: Chunk, capp: np.ndarray, solver_kw: dict,
                  want_hints: bool) -> dict:
        """One chunk's solver knobs.  With no table stats given, the chunk
        gets density hints from its unpadded members; with one of the two
        given, the other is taken from the whole chunk, so every shard
        resolves the backend as ``devices=1`` would."""
        if want_hints:
            return {**solver_kw, **self._density_hints(chunk)}
        if (self.devices > 1
                and solver_kw.get("backend") in (None, "auto", "ell-bf")
                and not solver_kw.get("use_pallas")
                and ("d_max" in solver_kw) != ("mean_degree" in solver_kw)):
            d_max, mean = degree_stats(capp)
            return {"d_max": d_max, "mean_degree": mean, **solver_kw}
        return solver_kw

    def _shard_devices(self, dev: torch.device) -> list[torch.device]:
        """Where each shard runs: ``cuda:j`` for shard ``j`` of a plan over
        several cards, ``dev`` itself on one device or on the CPU."""
        if dev.type != "cuda":
            return [dev] * self.devices
        if self.devices == 1:
            return [dev]
        avail = torch.cuda.device_count()
        if self.devices > avail:
            raise ValueError(f"devices={self.devices} out of range; "
                             f"{avail} local device(s) available")
        return [torch.device("cuda", j) for j in range(self.devices)]

    def execute(self, solver: str = "dual", *,
                device: str | torch.device = "cuda",
                **solver_kw) -> list[InstanceSolve]:
        """Run every chunk's shards on their devices, copy the results to
        the host once, and scatter them back into input order.  ``solver``
        names a ``SOLVERS`` entry ("dual", "dual-demgrad":
        ``meta["dem_grad"]`` is each lane's demand gradient, "primal",
        "ecmp" or "ksp").  ``solver_kw`` goes to the solver (iters/lr/tol/
        check_every/use_pallas/backend/d_max/max_rounds, and hops/k/
        max_hops for the routing solvers).  Where the backend can
        land on ``"ell-bf"`` and no table stats were given, each chunk gets
        its own density hints.  ``last_shard_seconds`` keeps each shard's
        wall (on a card, to its device's end)."""
        try:
            dispatch = SOLVERS[solver]
        except KeyError:
            raise ValueError(f"unknown plan solver {solver!r}; "
                             f"known: {sorted(SOLVERS)}") from None
        shards = self._shard_devices(mcf.resolve_device(device))
        want_hints = (solver_kw.get("backend") in (None, "auto", "ell-bf")
                      and not solver_kw.get("use_pallas")
                      and "d_max" not in solver_kw
                      and "mean_degree" not in solver_kw)
        jobs = []
        for chunk in self.chunks:
            capp, demp, n_valid = self._pack(chunk)
            jobs.append((capp, demp, n_valid,
                         self._chunk_kw(chunk, capp, solver_kw, want_hints)))
        t0 = time.perf_counter()

        def run_shard(j: int):
            dev = shards[j]
            on_card = dev.type == "cuda" and self.devices > 1
            scope = (torch.cuda.device(dev) if on_card
                     else contextlib.nullcontext())
            with scope:
                out = []
                for capp, demp, n_valid, kw in jobs:
                    w = capp.shape[0] // self.devices
                    rows = slice(j * w, (j + 1) * w)
                    out.append(dispatch(capp[rows], demp[rows],
                                        n_valid[rows], {**kw, "device": dev}))
                if on_card:
                    torch.cuda.synchronize(dev)
            return out, time.perf_counter() - t0

        if len(shards) > 1 and shards[0].type == "cuda":
            # one host thread a card: no card waits on another's flag reads
            with concurrent.futures.ThreadPoolExecutor(len(shards)) as pool:
                done = list(pool.map(run_shard, range(len(shards))))
        else:
            done = [run_shard(j) for j in range(len(shards))]
        self.last_shard_seconds = tuple(s for _, s in done)
        # ONE host copy for the whole plan, shards joined along the lanes
        host = [{k: np.concatenate([done[j][0][ci][k].cpu().numpy()
                                    for j in range(len(shards))])
                 for k in done[0][0][ci]}
                for ci in range(len(self.chunks))]
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
