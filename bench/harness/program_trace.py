"""The program's own spans on the device trace of slice A.

Slice A (``trace.py``) traces the device alone, so nothing in it says what
the host was doing while the device idled.  The program records its own
spans and counters (``repro_torch.obs``) on the clock the profiler stamps
its host events with, so they can be laid on that trace.  ``recorded_slice``
solves the window's first pile once more: it times up to ``UNTRACED_STEPS``
steps before the step before slice A untraced (as ``trace.py`` times its
own ten), turns the program's recording on at the step before the slice
(so the slice's first forward is whole), profiles ``RECORDED_STEPS`` steps
from slice A's first (slice A's and slice B's, where the pile runs that
far) with slice A's device-only activities, then abandons the pile.  The
slices of ``trace.py`` run with the recording off, as does everything the
end-to-end metrics time.

CUPTI adds its cost to every launch, so the traced slice idles several
times as long as the same steps untraced, and by how much follows the
host's speed.  The idle readers therefore split the untraced idle: each
gives its gaps' share of the recorded slice's idle times the idle of the
untraced steps (their wall less the slice's busy time), ms a step.  The
share still leans toward the launches, which CUPTI slows, and away from a
read's drain, which it does not (``tools/recorded_windows.py --witness``
times the backward's per-hop reads untraced).

A program without the recorder gives ``None``, and so does every reader
built on it.  The arithmetic below works on the trace's time axis (µs).
"""
from __future__ import annotations

import bisect
import gc
import importlib
import json
import os
import time

import torch

from harness import spans, sut, trace

FORWARD = "repro_torch.apsp.forward"
BACKWARD = "repro_torch.apsp.backward"
LINE_SEARCH = "repro_torch.primal.line_search"
READS = ("repro_torch.apsp.backward.read", "repro_torch.descent.check")

# more steps than trace.py's ten, so that a few slow ones move a share less
UNTRACED_STEPS, RECORDED_STEPS = 60, 3 * trace.A_STEPS
_memo: tuple | None = None   # (run, its recorded slice): one solve a run


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        return importlib.import_module("repro_torch.obs")
    except ModuleNotFoundError as e:
        if e.name not in ("repro_torch.obs", "repro_torch"):
            raise
        return None


class _Slicer:
    """``on_enter`` for ``SpanWatch``: up to ``UNTRACED_STEPS`` steps
    untraced and timed (from the second step span on), the recording on at
    the step span before slice A, the profile over ``steps`` steps from
    slice A's first, then the call abandoned."""

    def __init__(self, rec, start: int, cuda: bool, steps: int):
        from torch.profiler import ProfilerActivity, profile
        self.rec, self.start, self.cuda, self.steps = rec, start, cuda, steps
        self.seen = 0
        self.path = None
        self.untraced_s = self.window_s = None
        self.untraced_steps = min(UNTRACED_STEPS, start - 3)
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU])

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self, name: str) -> None:
        if name != spans.STEP_SPAN:
            return
        self.seen += 1
        k = self.seen - self.start
        if k == -1 - self.untraced_steps:
            self._sync()
            self.u0 = time.perf_counter()
        elif k == -1:
            self._sync()
            self.untraced_s = time.perf_counter() - self.u0
            self.rec.start()
        elif k == 0:
            self._sync()
            self.prof.start()
            self.t0 = time.perf_counter()
        elif k == self.steps:
            self._sync()
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()
            self.rec.stop()
            self.path = trace._export(self.prof)
            raise spans.Stop("recorded slice done")


def _load(path: str) -> tuple[list[dict], int]:
    """An exported trace's complete events and its time base (ns; the
    file is removed)."""
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    return events, int(data.get("baseTimeNanoseconds", 0))


def slice_of(solve, pile, start: int, obs, cuda: bool = True,
             steps: int = trace.A_STEPS) -> dict:
    """Slice A of ``solve(pile)`` from the ``start``-th step span
    (``start`` >= 4), with ``obs`` recording: its spans as ``(name,
    parent, tid, start_us, end_us)`` on the trace's axis, the counters'
    totals, the device's merged busy intervals (µs), the slice's wall, and
    the wall and count of the untraced steps before it (s)."""
    rec = obs.record()
    slicer = _Slicer(rec, start, cuda, steps)
    watch = spans.SpanWatch(on_enter=slicer)
    try:
        with watch:
            solve(pile)
    except spans.Stop:
        pass
    finally:
        rec.stop()
    if slicer.path is None:
        raise RuntimeError(f"the pile ended after {slicer.seen} step spans, "
                           f"before its recorded slice (steps {start}-"
                           f"{start + steps})")
    events, base = _load(slicer.path)
    return {
        "steps": steps, "clock": rec.clock, "base_ns": base,
        "window_s": slicer.window_s, "untraced_s": slicer.untraced_s,
        "untraced_steps": slicer.untraced_steps,
        "spans": [(s.name, s.parent, s.tid, obs.trace_us(s.start_ns, base),
                   obs.trace_us(s.end_ns, base)) for s in rec.spans],
        "counts": dict(rec.counts),
        "device": trace.merged([(e["ts"], e["ts"] + e["dur"]) for e in events
                                if e.get("cat") in trace.DEVICE_CATS])}


def recorded_slice(run) -> dict | None:
    """``slice_of`` the traced run's pile and slice start, with the program
    built afresh on the card, over ``RECORDED_STEPS`` steps or as many as
    the pile's first chunk runs from there; None in an untraced run or
    where the program has no recorder.  Computed once a run."""
    global _memo
    if _memo is not None and _memo[0] is run:
        return _memo[1]
    obs = recorder() if run.trace else None
    out = None
    if obs is not None:
        start = run.trace["start"]
        first = [a for a in run.window.piles[0].answers if a.chunk == 0]
        steps = min(RECORDED_STEPS,
                    max(a.iterations for a in first) - start)
        program = sut.Program(run.cell.mix)
        try:
            out = slice_of(program.solve, run.piles(0), start, obs,
                           steps=steps)
        finally:
            del program
            gc.collect()
            torch.cuda.empty_cache()
    _memo = (run, out)
    return out


# --- arithmetic on the trace's axis ------------------------------------------

def gaps(device: list) -> list[tuple[float, float]]:
    """The device's idle gaps between its merged busy intervals."""
    return [(a[1], b[0]) for a, b in zip(device, device[1:]) if b[0] > a[1]]


def span_intervals(rec: dict, names) -> list[list[float]]:
    """The union of the spans named in ``names``, on any thread."""
    return trace.merged([(s[3], s[4]) for s in rec["spans"]
                         if s[0] in names])


def clipped_us(gaps_: list, intervals: list) -> float:
    """The part of ``gaps_`` that lies inside ``intervals`` (both sorted,
    each without overlaps)."""
    total, j = 0.0, 0
    for a, b in gaps_:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            total += max(0.0, min(b, intervals[k][1])
                         - max(a, intervals[k][0]))
            k += 1
    return total


def untraced_scale(rec: dict) -> float | None:
    """The untraced steps' idle a step over the slice's: each wall a step
    less the slice's busy time a step (a step's work is the same from step
    to step in a chunk)."""
    busy = 1e-6 * sum(b - a for a, b in rec["device"]) / rec["steps"]
    traced = rec["window_s"] / rec["steps"] - busy
    untraced = rec["untraced_s"] / rec["untraced_steps"] - busy
    return untraced / traced if traced > 0 else None


def _untraced_ms_per_step(rec: dict, traced_us: float) -> float | None:
    scale = untraced_scale(rec)
    if scale is None:
        return None
    return 1e-3 * traced_us * scale / rec["steps"]


def idle_ms_per_step(rec: dict | None, names) -> float | None:
    """Untraced device idle inside the spans ``names``, ms a step: the
    share of the slice's idle clipped to them, of the untraced idle."""
    if rec is None:
        return None
    inside = clipped_us(gaps(rec["device"]), span_intervals(rec, names))
    return _untraced_ms_per_step(rec, inside)


def after_reads_us(rec: dict) -> float:
    """The slice's device gaps that start inside a host read or hold its
    end (the device ran dry while the host waited for the value, and stayed
    dry until its next launch), whole, µs.  Either will do: the profiler
    puts the device's stamps on the host's clock up to tens of µs off, in
    either direction, so a read's end can fall just past its gap, or the
    gap's start just past the read's end."""
    reads = span_intervals(rec, READS)
    starts = [r[0] for r in reads]
    ends = [r[1] for r in reads]
    total = 0.0
    for a, b in gaps(rec["device"]):
        i = bisect.bisect_right(starts, a) - 1    # the last read begun by a
        j = bisect.bisect_left(ends, a)           # the first to end from a on
        if (i >= 0 and ends[i] >= a) or (j < len(ends) and ends[j] <= b):
            total += b - a
    return total


def idle_after_reads_ms_per_step(rec: dict | None) -> float | None:
    """Untraced device idle after the host reads, ms a step: the share of
    the slice's idle in gaps after a read (``after_reads_us``), of the
    untraced idle."""
    if rec is None:
        return None
    return _untraced_ms_per_step(rec, after_reads_us(rec))


def host_reads_per_step(rec: dict | None) -> float | None:
    """The SP-DAG backward's host reads a backward (one a descent step):
    its two table widths, read once, and its per-hop mass checks."""
    if rec is None or not rec["counts"].get("sp_dag.backwards"):
        return None
    c = rec["counts"]
    return c["sp_dag.host_reads"] / c["sp_dag.backwards"]
