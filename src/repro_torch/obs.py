"""The port's span and counter recorder.

``span(name)`` marks a stretch of host time and ``count(name, n)`` adds to
a counter.  Both record only while a recording is on (``record()``); off,
which is the default, a span costs one module-level check and hands back
one shared, preallocated context, and ``count`` does nothing.

``span(name, profiler=True)`` is also a ``torch.profiler.record_function``
range, entered and left through that range's own ``__enter__`` and
``__exit__`` whether or not a recording is on.  Exactly five spans are of
this kind, so a torch profiler trace names the same ranges it always has:
``repro_torch.apsp.forward`` and ``repro_torch.apsp.backward``
(``core/apsp.py``), ``repro_torch.primal.line_search`` (``core/primal.py``),
``repro_torch.adamw`` and ``repro_torch.rglru``.  Every other span is the
recorder's alone and never a profiler range: a trace reader that matches a
kernel launch to the last few ranges opened on its thread would lose
launches behind a run of small ranges, and each range costs a profiler
event in every traced step.  The recorder-only spans are
``repro_torch.apsp.backward.read`` (each host read of the SP-DAG backward)
and ``repro_torch.descent.check`` (a descent's stop read, once a check
window); the counters are ``sp_dag.backwards``, ``sp_dag.hops`` and
``sp_dag.host_reads``, added once a backward.

Spans are stamped with ``time.time_ns()`` (CLOCK_REALTIME), the clock the
torch profiler stamps its host events with; ``trace_us`` puts a stamp on
the time axis of an exported profiler trace.  A solve's spans and counts,
as an operator reads them::

    from repro_torch import obs
    with obs.record() as rec:
        get_engine("dual", tol=1e-4).solve_batch(caps, dems)
    rec.counts["sp_dag.host_reads"] / rec.counts["sp_dag.backwards"]
    [s for s in rec.spans if s.name == "repro_torch.descent.check"]
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

from torch.profiler import record_function

__all__ = ["Span", "Recording", "span", "count", "record", "trace_us",
           "CLOCK"]

CLOCK = "time.time_ns"   # CLOCK_REALTIME: the torch profiler's host clock


class Span(NamedTuple):
    """One span a recording saw close: its name, the name of the span open
    around it on the same thread (None at the top), the thread's native id
    (a profiler trace's ``tid``), and its ends on ``CLOCK``, in ns."""

    name: str
    parent: str | None
    tid: int
    start_ns: int
    end_ns: int


class Recording:
    """The spans and counter totals seen between ``start()`` and
    ``stop()`` (or over a ``with`` block), from every thread.  Read it
    after it stops; a span still open when it stops is not kept."""

    clock = CLOCK

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}

    def start(self) -> "Recording":
        global _rec
        with _lock:
            if _rec is not None:
                raise RuntimeError("obs: a recording is already on")
            _rec = self
        return self

    def stop(self) -> "Recording":
        global _rec
        with _lock:
            if _rec is self:
                _rec = None
        return self

    def __enter__(self) -> "Recording":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _span(self, s: Span) -> None:
        with _lock:
            if _rec is self:
                self.spans.append(s)

    def _count(self, name: str, n: int) -> None:
        with _lock:
            if _rec is self:
                self.counts[name] = self.counts.get(name, 0) + n


_rec: Recording | None = None     # the recording that is on, if any
_lock = threading.Lock()          # guards _rec and the recording's lists
_local = threading.local()        # each thread's stack of open span names


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _On:
    """A span that a recording sees: it stamps its ends around the profiler
    range it may carry, so the range lies inside it."""

    __slots__ = ("rec", "name", "range", "parent", "start_ns", "stack")

    def __init__(self, rec: Recording, name: str, profiler: bool):
        self.rec = rec
        self.name = name
        self.range = record_function(name) if profiler else None

    def __enter__(self) -> None:
        self.start_ns = time.time_ns()
        if self.range is not None:
            # a watcher of profiler ranges may raise here to abandon the
            # call; the span is then never entered
            self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)

    def __exit__(self, *exc) -> None:
        try:
            if self.range is not None:
                self.range.__exit__(*exc)
        finally:
            end = time.time_ns()
            self.stack.pop()
            self.rec._span(Span(self.name, self.parent,
                                threading.get_native_id(), self.start_ns,
                                end))


def span(name: str, *, profiler: bool = False):
    """A context that marks its block as the span ``name``; with
    ``profiler=True`` it is also the profiler range ``name``."""
    rec = _rec
    if rec is None:
        return record_function(name) if profiler else _OFF
    return _On(rec, name, profiler)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recording that is on."""
    rec = _rec
    if rec is not None:
        rec._count(name, n)


def record() -> Recording:
    """A recording, on for the ``with`` block it opens (or from its
    ``start()`` to its ``stop()``)."""
    return Recording()


def trace_us(ns: int, base_ns: int) -> float:
    """A ``CLOCK`` stamp on the time axis of an exported torch profiler
    trace (chrome format): microseconds after the trace's time base, its
    ``baseTimeNanoseconds``."""
    return (ns - base_ns) / 1e3
