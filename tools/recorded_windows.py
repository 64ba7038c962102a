"""What the program's recorder costs, where a traced slice's idle goes,
and what the backward's per-hop reads cost untraced.

    python3 tools/recorded_windows.py --workload rrg512-perm-ub --seed 7
    python3 tools/recorded_windows.py --workload rrg512-perm-ub --seed 7 \\
        --rounds 0 --bench 1 --slices 3 --witness 2

One benchmark cell (``BENCHMARK.json``), set up once as ``bench/run.py``
sets it up, then, each part printing JSON lines:

* ``--bench 1`` first: the cell's traced run as ``bench/run.py --trace 1``
  makes it (its window cut to that many piles), and the slice its readers
  recorded (a fresh program, after the reference's check);
* windows of ``--seconds`` each on the same piles of ``--seed``, with the
  recorder off and on in turn (off, on, on, off; that ``--rounds`` times):
  answers a second and host ms a chunk step (``descent.step_ms.ub``'s
  reader);
* ``--slices`` times the recorded slice of the first pile
  (``bench/harness/program_trace.py``) on the set-up program: the new
  per-layer metrics read from it, the counters, the untraced steps' idle,
  and the slice's own (traced) idle in ms a step by the innermost span
  open at each gap's midpoint (forward, the backward less its reads, the
  reads, the line search, the rest of the step);
* ``--witness`` rounds of the steps before the slice untraced, with the
  backward's per-hop mass checks read as the program reads them and
  replayed from a first solve's answers without a read (the same sweeps,
  the same bits): read, replayed, replayed, read.

The card's name and power limit come first.  Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from harness import cell as cell_mod  # noqa: E402
from harness import (program_trace, spans, spec, sut, trace,  # noqa: E402
                     traffic, window)

pt = program_trace
IDLE_CLASSES = ("forward", "backward less its reads", "reads",
                "line search", "rest of the step")
WITNESS_FROM = 12       # the first step span the witness times


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def idle_by_span(rec: dict) -> dict[str, float]:
    """Slice A's own idle, ms a traced step, by the innermost span open at
    each gap's midpoint (the latest-starting one that holds it)."""
    cls = {pt.FORWARD: "forward", pt.BACKWARD: "backward less its reads",
           pt.LINE_SEARCH: "line search", **{r: "reads" for r in pt.READS}}
    out = dict.fromkeys(IDLE_CLASSES, 0.0)
    for a, b in pt.gaps(rec["device"]):
        m = (a + b) / 2
        holding = [s for s in rec["spans"] if s[3] <= m <= s[4]]
        name = max(holding, key=lambda s: s[3])[0] if holding else None
        out[cls.get(name, "rest of the step")] += 1e-3 * (b - a) / rec["steps"]
    return out


def summary(rec: dict, path: str) -> dict:
    """A recorded slice's readings, ms a step."""
    steps = rec["steps"]
    busy = 1e-3 * sum(b - a for a, b in rec["device"]) / steps
    return {
        "path": path, "busy_ms_per_step": busy,
        "traced_idle_ms_per_step": 1e3 * rec["window_s"] / steps - busy,
        "untraced_idle_ms_per_step":
            1e3 * rec["untraced_s"] / rec["untraced_steps"] - busy,
        "traced_idle_by_span_ms_per_step": idle_by_span(rec),
        "traced_after_reads_ms_per_step":
            1e-3 * pt.after_reads_us(rec) / steps,
        "counts": rec["counts"],
        "sp_dag.host_reads_per_step": pt.host_reads_per_step(rec),
        "sp_dag.idle_ms_per_step": pt.idle_ms_per_step(rec, (pt.BACKWARD,)),
        "primal.line_search_idle_ms_per_step": pt.idle_ms_per_step(
            rec, (pt.LINE_SEARCH,)),
        "device.idle_after_reads_ms_per_step":
            pt.idle_after_reads_ms_per_step(rec)}


def untraced_wall(solve, pile, stop: int) -> float:
    """Seconds of the step spans ``WITNESS_FROM`` to ``stop``, untraced,
    between two synchronisations; the pile is abandoned at ``stop``."""
    seen, t = [0], {}

    def on_enter(name: str) -> None:
        if name != spans.STEP_SPAN:
            return
        seen[0] += 1
        if seen[0] in (WITNESS_FROM, stop):
            torch.cuda.synchronize()
            t[seen[0]] = time.perf_counter()
        if seen[0] == stop:
            raise spans.Stop("witness done")
    try:
        with spans.SpanWatch(on_enter=on_enter):
            solve(pile)
    except spans.Stop:
        pass
    return t[stop] - t[WITNESS_FROM]


def witness(solve, pile, stop: int, rounds: int) -> list[dict]:
    """The steps before ``stop`` untraced, with ``apsp._mass_left`` read
    and replayed (read, replayed, replayed, read; ``rounds`` times)."""
    from repro_torch.core import apsp
    real = apsp._mass_left
    answers: list[bool] = []

    def logged(u):
        answers.append(real(u))
        return answers[-1]

    def replayed():
        it = iter(answers)
        return lambda u: next(it)
    apsp._mass_left = logged
    try:
        untraced_wall(solve, pile, stop)
    finally:
        apsp._mass_left = real
    out = []
    for _ in range(rounds):
        for mode in ("read", "replayed", "replayed", "read"):
            apsp._mass_left = real if mode == "read" else replayed()
            try:
                wall = untraced_wall(solve, pile, stop)
            finally:
                apsp._mass_left = real
            out.append({"mode": mode, "checks": len(answers),
                        "ms_per_step": 1e3 * wall / (stop - WITNESS_FROM)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--bench", type=int, default=0, metavar="PILES")
    p.add_argument("--slices", type=int, default=1)
    p.add_argument("--witness", type=int, default=0, metavar="ROUNDS")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("recorded_windows: no CUDA device is available",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    cell = spec.cell(args.workload)
    head = {"workload": cell.name, "seed": args.seed}
    if args.bench:
        res = cell_mod.run_cell(cell, args.seed, args.seconds, True,
                                max_piles=args.bench)
        print(json.dumps({**head, "bench_correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()}}), flush=True)
        rec = pt._memo[1] if pt._memo is not None else None
        if rec is not None:
            print(json.dumps({**head, **summary(
                rec, "bench: fresh program after the reference")}),
                flush=True)
    t0 = time.perf_counter()
    program = sut.Program(cell.mix)
    program.build()
    piles = cell_mod.Piles(cell, args.seed)
    program.warm(piles(0, traffic.WARM))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    obs = pt.recorder()
    step_ms = spec.metric_reader("descent.step_ms.ub")
    win = None
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            rec = obs.record()
            if on:
                rec.start()
            try:
                win = window.run(program.solve, piles, args.seconds)
            finally:
                rec.stop()
            run = cell_mod.Run(cell, setup_s, win, piles, None)
            print(json.dumps({
                **head, "recording": on, "piles": len(win.piles),
                cell.mix["rate"]: len(win.answers) / win.elapsed
                if win.piles else None,
                "descent.step_ms": step_ms.read(run) if win.piles else None,
                "spans": len(rec.spans)}), flush=True)
    # the slice's start as bench/run.py picks it, from a whole first pile
    answers = win.piles[0].answers if win is not None and win.piles \
        else program.solve(piles(0))
    first = [a for a in answers if a.chunk == 0]
    steps = max(a.iterations for a in first)
    start = max(2 + trace.A_STEPS,
                min(trace.START_STEP, steps - trace.A_STEPS - trace.B_STEPS))
    head["slice_start"] = start
    for i in range(args.slices):
        rec = pt.slice_of(program.solve, piles(0), start, obs,
                          steps=min(pt.RECORDED_STEPS, steps - start))
        print(json.dumps({**head, **summary(rec, f"set-up program {i}")}),
              flush=True)
    for row in witness(program.solve, piles(0), start, args.witness) \
            if args.witness else ():
        print(json.dumps({**head, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
