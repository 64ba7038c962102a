"""The readings the limits of ``correct`` are set from, on the card, in one
process: the program on many seeds (the lower readings) and the control, the
plain reference computed in bfloat16 in the program's place, on a few (the
upper readings), and faults planted in the program on a few.  Each seed
solves one pile at the cell's own size, as the window's first pile, and is
judged as a run judges its answers.

    python3 bench/control.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults ls4,gamma --fault-seeds 4,5,6] \\
        [--out chiprun_out/control.jsonl]

Faults (of the bracket's line search, ``core/primal.py``): ``ls4`` cuts the
ternary search to 4 rounds; ``gamma`` replaces it by the step 1/(t+1).

Prints one JSON line a seed: which system, the seed, and every number
compared (the limits in ``bench/limits/<workload>.json`` are not applied
here)."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import run as bench_run


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for as long as the block runs."""
    import torch
    src = str(bench_run.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import primal
    name, value = {"ls4": ("_LS_STEPS", 4),
                   "gamma": ("_line_search",
                             lambda u_cur, u_sp: torch.zeros(
                                 u_cur.shape[0], dtype=torch.float32,
                                 device=u_cur.device))}[fault]
    kept = getattr(primal, name)
    setattr(primal, name, value)
    try:
        yield
    finally:
        setattr(primal, name, kept)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    bench_run._caches()
    from harness import cell as cell_mod
    from harness import spec, sut

    cell = spec.cell(args.workload)
    # every number reported, none judged here
    cell = spec.Cell(**{**cell.__dict__,
                        "limits": dict.fromkeys(cell.limits, float("inf"))})
    out = open(args.out, "a") if args.out else None
    seeds = [s for s in args.seeds.split(",") if s]
    jobs = [("program", sut.Program, s, None) for s in seeds]
    jobs += [("control", sut.Control, s, None)
             for s in args.control_seeds.split(",") if s]
    jobs += [(f"fault:{f}", sut.Program, s, f)
             for f in args.faults.split(",") if f
             for s in args.fault_seeds.split(",") if s]
    for who, system, seed, fault in jobs:
        t0 = time.perf_counter()
        with planted(fault) if fault else contextlib.nullcontext():
            res = cell_mod.run_cell(cell, int(seed), 3600.0, False,
                                    system=system, max_piles=1)
        line = {"workload": cell.name, "system": who, "seed": int(seed),
                "seconds": time.perf_counter() - t0,
                "checks": {k: c["value"] for k, c in res["checks"].items()}}
        rate = res["metrics"].get(cell.mix["rate"], {}).get("value")
        line["pile_s"] = cell.mix["pile"] / rate if rate else None
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            print(text, file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
