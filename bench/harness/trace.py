"""The traced slice of a pile, and what the device trace says about it.

``--trace 1`` solves the window's first pile once more and profiles two
back-to-back slices of it, on step boundaries counted by the program's
``repro_torch.apsp.forward`` span (``spans.SpanWatch``):

* before it, ``A_STEPS`` steps untraced, timed on the host between two
  synchronisations (``untraced_s``): a step's work is the same from step
  to step within a chunk (frozen lanes are computed all the same), so the
  idle share is slice A's busy time over this wall;
* slice A, ``A_STEPS`` steps with only the device traced (CUPTI, no host
  ops): the device's busy seconds, device time by operation, and the host
  time spent inside each ``repro_torch.*`` span (timed by the watch);
* slice B, the next ``B_STEPS`` steps with host ops traced too: device
  time of the kernels launched inside each ``repro_torch.*`` span, and the
  device's idle gaps by the host operation that was running.

Then the pile is abandoned.  Each slice starts and ends on a synchronised
device; the profiler's export goes to a file under ``TMPDIR`` that is
deleted once read.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import numpy as np
import torch

from harness import spans

A_STEPS, B_STEPS = 10, 10
START_STEP = 102        # the forward span entry the slices start at
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _export(prof) -> str:
    """Write a stopped profile's trace to a file under ``TMPDIR`` (before
    another profile starts: the profiler's buffers are shared)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def _events(path: str) -> list[dict]:
    """The complete events of an exported trace; the file is removed."""
    try:
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]
    finally:
        os.unlink(path)


def merged(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_summary(events: list[dict]) -> dict:
    """Busy seconds (the union of device activity) and seconds by
    operation name, from a trace's events (µs)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    busy = sum(b - a for a, b in merged(
        [(e["ts"], e["ts"] + e["dur"]) for e in dev])) * 1e-6
    return {"busy_s": busy, "ops_s": by_name}


def span_device_s(events: list[dict]) -> tuple[dict, dict]:
    """Device seconds of the kernels launched inside each
    ``repro_torch.*`` span (matched to its launch by correlation id, and
    the launch to the span on the same thread by time), and each span's
    count."""
    spans_by_tid: dict = {}
    count: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("repro_torch."):
            spans_by_tid.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
            count[e["name"]] = count.get(e["name"], 0) + 1
    for lst in spans_by_tid.values():
        lst.sort()
    starts = {tid: [s[0] for s in lst] for tid, lst in spans_by_tid.items()}
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    out: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        where = launch.get(e.get("args", {}).get("correlation"))
        if where is None or where[0] not in spans_by_tid:
            continue
        tid, ts = where
        lst = spans_by_tid[tid]
        i = bisect.bisect_right(starts[tid], ts)
        # spans of a thread barely nest: the enclosing ones are among the
        # last few that started before the launch
        for a, b, name in lst[max(0, i - 4):i]:
            if a <= ts <= b:
                out[name] = out.get(name, 0.0) + e["dur"] * 1e-6
    return out, count


def idle_gaps(events: list[dict], top: int = 10) -> list[list]:
    """The device's idle gaps, summed by the innermost host operation that
    was running at each gap's midpoint; the ``top`` largest, seconds."""
    dev = merged([(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATS])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if len(dev) < 2 or not host:
        return []
    hs = np.array([e["ts"] for e in host])
    he = hs + np.array([e["dur"] for e in host])
    names = [e["name"] for e in host]
    gaps = np.array([[a[1], b[0]] for a, b in zip(dev, dev[1:])])
    mids = gaps.mean(1)
    total: dict[str, float] = {}
    for lo in range(0, len(mids), 256):
        m = mids[lo:lo + 256, None]
        inside = (hs[None] <= m) & (he[None] >= m)
        # innermost = the latest-starting enclosing operation
        key = np.where(inside, hs[None], -np.inf)
        best = key.argmax(1)
        for j, g in enumerate(gaps[lo:lo + 256]):
            name = names[best[j]] if inside[j, best[j]] else "(no host op)"
            total[name] = total.get(name, 0.0) + (g[1] - g[0]) * 1e-6
    return [[k[:96], v] for k, v in sorted(total.items(),
                                           key=lambda kv: -kv[1])[:top]]


class Slices:
    """``on_enter`` for ``SpanWatch``: profiles slices A and B starting at
    the ``start``-th step span, then abandons the call."""

    def __init__(self, watch_host: spans.SpanWatch, start: int = START_STEP):
        from torch.profiler import ProfilerActivity, profile
        self.start = start
        self.watch = watch_host
        self.seen = 0
        self.a = profile(activities=[ProfilerActivity.CUDA])
        self.b = profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
        self.window_s = None
        self.untraced_s = None
        self.host_a: dict[str, float] = {}
        self.steps = 0

    def __call__(self, name: str) -> None:
        if name != spans.STEP_SPAN:
            return
        self.seen += 1
        k = self.seen - self.start
        if k == -A_STEPS:
            torch.cuda.synchronize()
            self.u0 = time.perf_counter()
        elif k == 0:
            torch.cuda.synchronize()
            self.untraced_s = time.perf_counter() - self.u0
            self.host0 = dict(self.watch.host_s)
            self.a.start()
            self.t0 = time.perf_counter()
        elif k == A_STEPS:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self.t0
            self.a.stop()
            self.path_a = _export(self.a)
            self.host_a = {n: s - self.host0.get(n, 0.0)
                           for n, s in self.watch.host_s.items()}
            self.b.start()
        elif k == A_STEPS + B_STEPS:
            torch.cuda.synchronize()
            self.b.stop()
            self.path_b = _export(self.b)
            self.steps = B_STEPS
            raise spans.Stop("slices done")


def traced_slices(solve, pile, start: int = START_STEP) -> dict:
    """Profile slices A and B of ``solve(pile)`` (see the module doc);
    ``start`` (> ``A_STEPS``) is the step span slice A begins at."""
    watch = spans.SpanWatch(timed=("repro_torch.primal.line_search",
                                   "repro_torch.apsp.forward",
                                   "repro_torch.apsp.backward"))
    slicer = Slices(watch, start)
    watch.on_enter = slicer
    try:
        with watch:
            solve(pile)
    except spans.Stop:
        pass
    if slicer.steps == 0:
        raise RuntimeError(
            f"the pile ended after {slicer.seen} step spans, before its "
            f"traced slices (steps {start}-{start + A_STEPS + B_STEPS})")
    ev_a, ev_b = _events(slicer.path_a), _events(slicer.path_b)
    dev = device_summary(ev_a)
    dev_s, count = span_device_s(ev_b)
    return {"start": start, "a_steps": A_STEPS, "b_steps": B_STEPS,
            "window_s": slicer.window_s, "untraced_s": slicer.untraced_s,
            "busy_s": dev["busy_s"],
            "ops_s": dev["ops_s"], "host_span_s": slicer.host_a,
            "span_device_s": dev_s, "span_count": count,
            "idle_gaps": idle_gaps(ev_b)}
