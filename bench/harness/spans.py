"""Watching the program's spans from outside it.

The port names the halves of a descent step with
``torch.profiler.record_function`` ranges (``repro_torch.apsp.forward``,
``repro_torch.apsp.backward``, ``repro_torch.primal.line_search``).
``SpanWatch`` sees every range entered and left, by name, through Python's
``sys.monitoring`` on ``record_function.__enter__`` / ``__exit__`` alone,
so it costs nothing elsewhere and changes nothing in the program.  The
harness uses it to close the window on time (the pile in flight is
abandoned at its next step), to start and stop the profiler on step
boundaries, and to time spans on the host.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable

from torch.profiler import record_function

STEP_SPAN = "repro_torch.apsp.forward"   # entered once a descent step

_MON = sys.monitoring
_TOOL = _MON.PROFILER_ID


class Stop(Exception):
    """Raised into the program to abandon the call in flight."""


class SpanWatch:
    """Calls ``on_enter(name)`` for every ``repro_torch.*`` range entered
    while the watch is open (any thread), and sums the host time of the
    ranges named in ``timed`` into ``host_s``."""

    def __init__(self, on_enter: Callable[[str], None] | None = None,
                 timed: tuple[str, ...] = ()):
        self.on_enter = on_enter
        self.timed = timed
        self.host_s: dict[str, float] = {}
        self._open: dict[tuple[int, str], float] = {}
        self._busy = threading.local()

    def _event(self, entering: bool, name: str) -> None:
        if getattr(self._busy, "on", False):
            return
        self._busy.on = True
        try:
            now = time.perf_counter()
            key = (threading.get_ident(), name)
            if entering:
                if name in self.timed:
                    self._open[key] = now
                if self.on_enter is not None:
                    self.on_enter(name)
            elif key in self._open:
                self.host_s[name] = (self.host_s.get(name, 0.0)
                                     + now - self._open.pop(key))
        finally:
            self._busy.on = False

    def __enter__(self) -> "SpanWatch":
        enter_code = record_function.__enter__.__code__
        self._codes = (enter_code, record_function.__exit__.__code__)

        def callback(code, offset):
            # the monitored frame is the caller: record_function's method
            name = getattr(sys._getframe(1).f_locals.get("self"), "name",
                           None)
            if isinstance(name, str) and name.startswith("repro_torch."):
                self._event(code is enter_code, name)
            return None
        _MON.use_tool_id(_TOOL, "bench-spans")
        _MON.register_callback(_TOOL, _MON.events.PY_START, callback)
        for code in self._codes:
            _MON.set_local_events(_TOOL, code, _MON.events.PY_START)
        return self

    def __exit__(self, *exc) -> None:
        for code in self._codes:
            _MON.set_local_events(_TOOL, code, 0)
        _MON.register_callback(_TOOL, _MON.events.PY_START, None)
        _MON.free_tool_id(_TOOL)


def deadline(at: float) -> Callable[[str], None]:
    """An ``on_enter`` that abandons the call in flight at the first step
    that starts after ``at`` (``time.perf_counter`` seconds)."""
    def on_enter(name: str) -> None:
        if name == STEP_SPAN and time.perf_counter() > at:
            raise Stop("window closed")
    return on_enter
