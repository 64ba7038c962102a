"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line."""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import torch

from harness import check, guard, spec, sut, trace, traffic, window


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: spec.Cell
    setup_s: float
    window: window.Window
    piles: "Piles"            # the run's piles of traffic.Instance
    trace: dict | None        # trace.traced_slices, in a --trace 1 run

    def instances(self) -> list:
        """The instances of the window's answers, in the same order."""
        return [i for p in self.window.piles for i in self.piles(p.pile)]


class NoPileReturned(RuntimeError):
    pass


PREPARED = 4   # piles made in set-up; a window that holds more makes them


class Piles:
    """The window's piles of a run: pile k drawn from (seed, k), the first
    ``PREPARED`` made in set-up, any later one when first asked for."""

    def __init__(self, cell: spec.Cell, seed: int):
        self.cell, self.seed = cell, seed
        self.made: dict[int, list] = {}
        for k in range(PREPARED):
            self(k)

    def __call__(self, k: int, stream: int = traffic.WINDOW) -> list:
        key = (stream, k)
        if key not in self.made:
            self.made[key] = traffic.make_pile(
                self.cell.family(), self.cell.config["params"],
                self.cell.mix, self.seed, k, stream)
        return self.made[key]


def _metrics(run: Run, traced: bool) -> dict:
    out = {}
    if not traced:
        w = run.window
        rate = len(w.answers) / w.elapsed
        names = {m["name"] for m in run.cell.end_to_end}
        expected = {"setup_s", run.cell.mix["rate"]}
        if names != expected:
            raise KeyError(f"{run.cell.name} reports {sorted(names)}; the "
                           f"harness measures {sorted(expected)}")
        for m in run.cell.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" else rate
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in run.cell.per_layer:
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", system=sut.Program,
             t_start: float | None = None,
             max_piles: int | None = None) -> dict:
    """Run ``cell`` once and return its result line (a dict).  ``system``
    is the program (``sut.Program``) or what stands in its place
    (``sut.Control``); ``max_piles`` ends the window early."""
    t0 = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    program = system(cell.mix, device)
    marks = {"import": time.perf_counter() - t0}
    built = program.build()
    marks["build"] = time.perf_counter() - t0
    piles = Piles(cell, seed)
    warm = piles(0, traffic.WARM)
    marks["inputs"] = time.perf_counter() - t0
    program.warm(warm)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    marks["warm"] = setup_s
    print(f"setup {cell.name}: seconds from start {marks} {built}",
          file=sys.stderr, flush=True)

    win = window.run(program.solve, piles, seconds, max_piles)
    if not win.piles:
        raise NoPileReturned(f"no pile of {cell.name} returned within "
                             f"{seconds} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sliced = None
    if traced:
        first = [a for a in win.piles[0].answers if a.chunk == 0]
        steps = max(a.iterations for a in first)
        start = max(2 + trace.A_STEPS,
                    min(trace.START_STEP,
                        steps - trace.A_STEPS - trace.B_STEPS))
        sliced = trace.traced_slices(program.solve, piles(0), start)
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(cell, setup_s, win, piles, sliced)
    instances = run.instances()
    checks, wrong = check.judge(cell, instances, win.answers, seed, device)
    found = guard.loaded()
    if found:
        raise guard.Forbidden(f"the run loaded {found}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": check.correct(checks),
              "attempted": len(win.answers), "failed": wrong,
              "metrics": _metrics(run, traced), "device": dev}
    if sliced is not None:
        dev["busy_s"] = sliced["busy_s"]
        dev["window_s"] = sliced["window_s"]
        ops = sorted(sliced["ops_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[k[:96], v] for k, v in ops],
            "idle_gaps": sliced["idle_gaps"]}
    result["checks"] = checks
    return result


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Each number compared beside its limit as the last lines on stderr,
    then the result as the last line on stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
