"""Lanes across every local card: a sharded ``BatchPlan`` against one card.

    python3 tools/multicard_plan.py          # every local card (two or more)
    python3 tools/multicard_plan.py --iters 100   # the same, phase 3's pile
                                                  # capped at 100 steps
    python3 tools/multicard_plan.py --cpu    # 4 CPU shards, small piles
    python3 tools/multicard_plan.py --chunks [SRC]   # one card

``chip_smoke.py``'s phase-3 pile, 20 seeds of RRG(512, 16) with 8 servers a
switch under permutation traffic, goes through the dual engine at tol 1e-4
("auto" resolves to "ell-bf": K3) as one plan with ``devices=1`` and as one
with ``devices=k``, k the card count (shard j on ``cuda:j``, each card
driven from a host thread of its own).  Per-lane bounds and iterations
must be bit-equal; each plan's wall and each shard's wall
(``BatchPlan.last_shard_seconds``, to its card's end) are printed.  Then
every other planned solver ("dual-demgrad", "primal", "ecmp", "ksp") on 8
RRG(64, 8) at 100 steps, bit-equal across the two.  One JSON line a case,
the card's name and power limit first; exits non-zero on any mismatch.

``--chunks`` needs one card: the same phase-3 pile through the dual engine
whole and in chunks of 5 lanes (``max_lanes=5``), which must give every
lane the same bits for the same reason shards must; then a small,
launch-bound pile (8 × RRG(20, 4), 300 steps, whole and in chunks of 2),
the size of phases 12-14's inner solves.  ``SRC`` is the ``src`` directory
of the tree to import (default this checkout's), so an earlier checkout
unpacked under ``build/`` is measured in the same call (run parent,
change, change, parent to compare their walls); it prints, a pile,
whether the bits are equal, how many lanes differ, and both walls.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def run(eng, solver: str, topos, dems, device: str) -> dict:
    """One plan of ``eng`` over the pile: its values, iterations, meta
    extras, wall and shard walls."""
    plan = eng.plan(topos, dems)
    kw = eng._solver_kw()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan.execute(solver=solver, device=device, **kw)
    wall = time.perf_counter() - t0
    extra = {k: [np.asarray(r.meta[k]).tobytes().hex() for r in res]
             for k in ("ub", "dem_grad") if k in res[0].meta}
    return {"values": [r.value for r in res],
            "iterations": [r.iterations for r in res], "extra": extra,
            "wall_s": wall, "shard_s": list(plan.last_shard_seconds),
            "devices": plan.devices, "chunks": plan.stats.chunks,
            "compile_keys": plan.stats.compile_keys}


def compare(name: str, solver: str, make, topos, dems, k: int,
            device: str) -> None:
    one = run(make(1), solver, topos, dems, device)
    many = run(make(k), solver, topos, dems, device)
    equal = (one["values"] == many["values"]
             and one["iterations"] == many["iterations"]
             and one["extra"] == many["extra"])
    print(json.dumps({
        "case": name, "solver": solver, "lanes": len(topos),
        "bits_equal": equal, "devices": [one["devices"], many["devices"]],
        "wall_s": [one["wall_s"], many["wall_s"]],
        "shard_s": many["shard_s"], "one_device_s": one["shard_s"],
        "iterations_max": max(one["iterations"]),
        "compile_keys": [one["compile_keys"], many["compile_keys"]],
        "value_mean": float(np.mean(one["values"]))}), flush=True)
    if not equal:
        raise SystemExit(f"multicard_plan: {name} {solver}: devices={k} "
                         "is not bit-equal to devices=1")


def chunks_main(src: str) -> None:
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    from repro_torch.core import get_engine, graphs, traffic
    from repro_torch.kernels import _build
    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("multicard_plan: no CUDA device is available")
    print(cs.card_line(), flush=True)
    _build.load()   # the tree's own library, built before anything is timed
    for name, n, deg, servers, lanes, chunk, kw in (
            ("RRG(512,16) x20 tol 1e-4", 512, 16, 8, 20, 5,
             dict(tol=1e-4)),
            ("RRG(20,4) x8 300 steps", 20, 4, 3, 8, 2, dict(iters=300))):
        topos, dems = cs.instances(graphs, traffic, n, deg, servers,
                                   range(lanes))
        get_engine("dual", iters=2, devices=1).solve_batch(topos[:2],
                                                           dems[:2])
        got = {}
        for budget in (None, chunk):
            eng = get_engine("dual", max_lanes=budget, devices=1, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.solve_batch(topos, dems)
            torch.cuda.synchronize()
            got[budget] = ([r.throughput for r in res],
                           [r.meta["iterations"] for r in res],
                           time.perf_counter() - t0)
        print(json.dumps({
            "case": f"{name}, whole vs chunks of {chunk}",
            "package": str(pathlib.Path(repro_torch.__file__).parent),
            "bits_equal": got[None][:2] == got[chunk][:2],
            "lanes_differing": sum(a != b for a, b in zip(got[None][0],
                                                          got[chunk][0])),
            "wall_s": [got[None][2], got[chunk][2]],
            "iterations_max": max(got[None][1])}), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--chunks"]:
        return chunks_main(sys.argv[2] if len(sys.argv) > 2
                           else str(ROOT / "src"))
    from repro_torch.core import get_engine, graphs, traffic
    from repro_torch.kernels import _build
    args = sys.argv[1:]
    on_cpu = "--cpu" in args
    cap = int(args[args.index("--iters") + 1]) if "--iters" in args else None
    device = "cpu" if on_cpu else "cuda"
    if on_cpu:
        k = 4
        big = dict(n=24, deg=4, servers=2, seeds=range(6), iters=60)
        small = dict(n=16, deg=4, servers=2, seeds=range(5), iters=30)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("multicard_plan: no CUDA device is available")
        k = torch.cuda.device_count()
        if k < 2:
            raise SystemExit(f"multicard_plan: needs two cards or more, "
                             f"found {k}")
        print(cs.card_line(), flush=True)
        _build.load()
        big = dict(n=512, deg=16, servers=8, seeds=range(20),
                   iters=cap or 800)
        small = dict(n=64, deg=8, servers=4, seeds=range(8), iters=100)
    topos, dems = cs.instances(graphs, traffic, big["n"], big["deg"],
                               big["servers"], big["seeds"])
    # warm every card (the library's module loads on each device's first
    # launch) before anything is timed
    for d in (1, k):
        run(get_engine("dual", iters=2, devices=d, device=device), "dual",
            topos[:k], dems[:k], device)
    compare(f"RRG({big['n']},{big['deg']}) x{len(topos)} tol 1e-4",
            "dual", lambda d: get_engine("dual", iters=big["iters"],
                                         tol=1e-4, devices=d, device=device),
            topos, dems, k, device)
    topos, dems = cs.instances(graphs, traffic, small["n"], small["deg"],
                               small["servers"], small["seeds"])
    for solver, engine in (("dual-demgrad", "dual"), ("primal", "primal"),
                           ("ecmp", "ecmp"), ("ksp", "ksp")):
        compare(f"RRG({small['n']},{small['deg']}) x{len(topos)}", solver,
                lambda d, e=engine: get_engine(e, iters=small["iters"],
                                               devices=d, device=device),
                topos, dems, k, device)


if __name__ == "__main__":
    main()
