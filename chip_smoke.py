#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and continues):

1. setup — the card's name and power limit (nvidia-smi), the kernels'
   nvcc build and its seconds;
2. kernels — K1 ``minplus_acc``, K2 ``fw_pivot`` and K3 ``ell_relax_round``
   against their plain torch versions on the card at main-path shapes, on
   integer weights 1-16 over random-regular patterns with 1e18 non-edges:
   every result must match exactly; device times per call beside the
   bound (``time_ms``: CUDA events around 30 calls queued behind a device
   sleep, so the host's launching is not timed; median of 3 batches), and
   for K1 the instantiation the wrapper picked at each shape; K2 at t = 128
   and a ragged t = 100 and in place in a strided view, beside its
   one-SM-a-lane floor (``lane_bound_ms``); K3 on route "slab" at
   [20, 512, 512] and route "l2" at [2, 2048, 2048], flags too, each also
   timed over 3 distinct carries in turn (``cold_ms``: more than the L2
   holds, so the carry comes from device memory);
3. main path, sparse — 20 seeds of RRG(512, 16) with 8 servers per switch
   (4,096 servers) under permutation traffic through
   ``get_engine("dual", tol=1e-4).solve_batch`` ("auto" resolves to
   "ell-bf", so K3; every launch must take route "slab"); bounds finite and
   positive, beside Theorem 1;
4. main path, dense — 4 seeds of RRG(512, 48) with 16 servers per switch
   ("auto" resolves to "blocked-fw": K1 + K2, 4 K2 launches a step; 10
   profiled steps), then
   ``"dual-pallas"`` (K1) against ``backend="ell-bf"`` (K3, route "slab") on
   4 phase-3 instances, within rel 1e-3;
5. oracle — 3 seeds of RRG(40, 10) with 5 servers per switch: the HiGHS
   optimum <= dual ub <= 1.05 x optimum at 800 iterations, and the card's
   ub within rel 1e-3 of the same solve on the CPU (plain versions);
6. LM kernels — K4 ``flash_attention`` on each of its routes (prefill
   B=8, L=1000, 24/8 heads, D=128, bf16: route "mma"; decode Lq=1,
   lk_valid=1001 over a cache of 1016, bf16: route "decode"; aligned
   L=1024 bf16: "mma"; the float32 prefill: route "f32") and K5
   ``wkv_chunked`` (BH=512, n=64, T=1000 and 1024, with and without s0,
   and the model's [8, 1000, 64, 64] projections as [B, H, T, n] views)
   against their plain versions on the card, within stated tolerances;
   device times beside the bound and, for K4, beside
   ``scaled_dot_product_attention`` (timed here only, as a yardstick),
   beside the earlier CUDA-core kernel on the same bf16 inputs and beside
   the time of one call with its launching (``call_ms``); the decode row
   takes 4 input sets in turn, so its cache comes from device memory;
7. minitron-4b served at full width and depth (32 layers, float32
   parameters, bf16 compute) through ``repro_torch.launch.serve.generate``:
   8 prompts of 1000 tokens, 16 greedy tokens; every picked token's logits
   against the plain path (plain attention, same weights, one teacher-forced
   forward) and against the float32 plain path, which the kernel path must
   be no further from than the bf16 plain path is; then the same at full
   width, 4 layers, float32 with TF32 off, under a tight tolerance that a
   bf16 attention is shown to fail; then a profiled prefill and four
   profiled decode steps (device time by kernel group, idle share);
8. rwkv6-7b, the same (K5 at prefill, the plain one-token step at decode);
9. the certified path — (a) phase 5's Fig. 1 point through
   ``get_engine("certified", iters=800)`` (K1): lb <= HiGHS optimum <= ub,
   gap < 5%, and the card's lb and ub within rel 1e-3 of the same solve on
   the CPU; (b) phase 3's 20 instances through ``get_engine("certified",
   tol=1e-4).solve_batch`` (K3, every launch on route "slab"): 0 < lb <=
   ub <= Theorem 1 on every lane, each lane's gap and iterations, ms a
   step, instances/s, K3 launches a step; then 10 profiled steps (device
   ms of the APSP forward, the SP-DAG backward, the FW line search and the
   rest, idle share);
10. the figure layer — ``repro_torch.launch.figures.fig5`` at paper scale
   at 5 runs a point, the paper's 10 halved so that phases 11-13 fit (3
   configurations x 6 biases x 5 runs = 90 instances of 40-60 switches,
   one BatchPlan, certified engine at tol 1e-4: K1 squaring); the first
   run of every point (18 instances) held against HiGHS (lb <= θ <= ub),
   whose LPs run in 4 worker processes beside phases 11-13 and are
   checked after them; then 10 profiled steps of the same plan, split as
   in 9b;
11. the scale probe — ``kernels.ell.ell_bf_apsp_streamed`` (K3, route
   "l2"): (a) at N = 2048 equal bit for bit to the full ``ell_bf_apsp``
   with the same rounds; (b) ``benchmarks/scale_bench.py``'s probe,
   ``random_regular_ell(16384, 16, seed=0)`` in blocks of 1024 sources:
   wall, rounds, K3 launches by route (every one "l2"), peak device
   memory (``max_memory_allocated``), and 32 sources within rtol 1e-6 of
   scipy's Dijkstra; (c) K3 "l2" timed at the streamed shape
   [1, 16384, 1024] against its plain version (exact), beside its bound;
12. adversarial traffic — ``core.adversarial.find_worst_tm`` at
   ``benchmarks/adversarial_bench.py``'s paper budget (4 rounds, 8
   candidates, 300 iterations) on (a) its two-cluster family (20
   switches, K1 squaring): lb <= HiGHS θ of the worst TM <= ub and ub
   below the baseline's; (b) phase 3's first RRG(512, 16) (auto ->
   ell-bf, every K3 launch on route "slab"): lb <= ub <= the baseline's
   ub.  Both: every candidate within 1e-4 of the hose caps, 5 executes,
   one compile key; wall, instances/s and the device's idle share over
   one profiled round;
13. the design layer — (a) ``design.optimize`` at
   ``benchmarks/design_bench.py``'s paper budget (3 rounds, fleet 8,
   elite 3, 2 runs, ``DualEngine(iters=250, tol=1e-3)``, K1) on
   ``VL2Space(VL2Spec(6, 6, 20))`` and the two-class pool (10 x 18 + 20
   x 6 ports, 90 servers, ``robust=True``): best lb >= the recipe's, 1 +
   rounds search executes on one compile key; (b)
   ``launch.figures.fig11`` at d_a = d_i = 10, 5 runs, HiGHS as the
   criterion (its LPs in worker processes), then the designer's search
   at the recipe's ToR count again: its pick's certified lb >= the
   recipe's, and designed ToRs >= rewired ToRs exactly when the pick
   holds the figure's 5 held-out permutations under HiGHS;
14. summary — one JSON line with every kernel, then the device line last.

Phase 2 also closes K2 tiles wider than 128 (t = 129, 200, 256: padded
and closed blocked) and ``fw_apsp_blocked(w, t=256)``, bit-equal to plain
Floyd-Warshall.

Launch counts are reset just before each path's run (phase 3's, each of
phase 4's three, each ``generate`` of phases 7-8, phase 9a's and 9b's card
solves, phase 10's figure, phase 11's two streamed closures, each search
of phases 12-13 and phase 13's figure) and read just after it; a kernel
of a path that was not launched fails the run.  The summary reports every
path's own counts, never a sum over runs: ``launches`` of a kernel is from the first path
that needs it (phase 3 for K3, the blocked-fw run for K1 and K2), and
``paths`` lists each run that launched it, with K1's launches in the
blocked-fw run split by panel (row, column, outer) and K4's split into
the full-sequence (prefill) and decode sites and by route.  K4's
``launches`` are from minitron-4b's full-depth generate, K5's from
rwkv6-7b's; every K4 launch of the bf16 prefill must take route "mma" and
every one of a decode step route "decode".
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FP32_INSTR_PER_S = 33.5e12   # 67 TFLOP/s fp32 peak (H100 SXM) as instructions
FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores (H100 SXM)
BF16_FLOP_PER_S = 989e12     # bf16 tensor cores, dense (H100 SXM)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
TIMING_RUNS = 30
# Fig. 5 runs a point in phase 10: the paper's 10 halved, so that phases
# 11-13 fit the script's time; and the processes its HiGHS LPs take
FIG5_RUNS = 5
LP_WORKERS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn) -> float:
    """Median milliseconds between CUDA events around one call, after
    warm-up: the device's time or, for a call whose launching takes longer
    than its kernels, the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms(fn) -> float:
    """Device milliseconds of one call: after warm-up, TIMING_RUNS calls
    are queued behind a device sleep that outlasts their launching, so the
    CUDA events around them time the device alone (median of 3 batches).
    ``fn`` may be a list of calls, taken in turn (inputs that must come
    from device memory, not from the L2 cache)."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMING_RUNS):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2e9 cycles a second is above the card's clock: the sleep errs long
    cycles = int(1.5 * host_s * 2e9) + 1_000_000
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for i in range(TIMING_RUNS):
            fns[i % len(fns)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / TIMING_RUNS)
    return statistics.median(times)


def bound_ms(terms: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work: each min-plus term is 2 fp32 instructions;
    each input byte read once and each output byte written once."""
    ops = 2.0 * terms / FP32_INSTR_PER_S * 1e3
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def quantized_weights(n: int, deg: int, lanes: int, seed: int,
                      graphs) -> np.ndarray:
    """[lanes, n, n] float32: integer lengths 1-16 on RRG(n, deg) edges,
    1e18 on non-edges, 0 on the diagonal."""
    rng = np.random.default_rng(seed)
    out = np.empty((lanes, n, n), np.float32)
    for b in range(lanes):
        cap = graphs.random_regular_graph(n, deg, seed=seed + b).cap
        w = rng.integers(1, 17, (n, n)).astype(np.float32)
        w = np.where(cap > 0, w, 1.0e18)
        np.fill_diagonal(w, 0.0)
        out[b] = w
    return out


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    if not torch.equal(got, want):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version (max abs diff {err})")
    return err


def phase_kernels(graphs, kmin, kfw, kell, apsp_mod) -> dict[str, dict]:
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = torch.tensor(quantized_weights(512, 16, 20, 100, graphs), device=dev)

    def k1_case(label, a, b, c0):
        got = kmin.minplus_acc(a, b, c0)
        want = kmin.minplus_acc_plain(a, b, c0)
        err = compare(f"K1 {label}", got, want)
        bsz, m, k = a.shape
        n = b.shape[-1]
        terms = bsz * m * n * k
        nbytes = 4 * (bsz * m * k + bsz * k * n
                      + (2 if c0 is not None else 1) * bsz * m * n)
        bnd, kind = bound_ms(terms, nbytes)
        row = {"kernel": "minplus_acc", "shape": label,
               "tile": kmin.minplus_tile(bsz, m, n, sms),
               "ms": time_ms(lambda: kmin.minplus_acc(a, b, c0)),
               "plain_ms": time_ms(lambda: kmin.minplus_acc_plain(a, b, c0)),
               "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err,
               "exact": True}
        log(json.dumps(row))
        return row

    square = k1_case("[20,512,512] x [20,512,512] (+C0)", w, w, w)
    piv = w[:, :128, :128]
    k1_case("row panel [20,128,128] x [20,128,512] (+C0)",
            piv, w[:, :128, :], w[:, :128, :])
    k1_case("col panel [20,512,128] x [20,128,128] (+C0)",
            w[:, :, :128], piv, w[:, :, :128])
    k1_case("outer [20,512,128] x [20,128,512] (+C0)",
            w[:, :, :128], w[:, :128, :], w)
    wr = w[:, :200, :200].contiguous()
    k1_case("ragged [20,200,200] x [20,200,200]", wr, wr, None)

    # K2: pivot tiles at blocked Floyd-Warshall's t = 128 and a ragged t = 100
    # (masked micro-tiles), and one closed in place in a strided view
    for t in (128, 100):
        got = kfw.fw_pivot(w[:, :t, :t].clone())
        err = compare(f"K2 fw_pivot t={t}", got, kfw.fw_tile_closure(
            w[:, :t, :t]))
        if t == 128:
            err2 = err
    d = w.clone()
    kfw.fw_pivot(d[:, 128:256, 128:256])
    compare("K2 fw_pivot in place", d[:, 128:256, 128:256],
            kfw.fw_tile_closure(w[:, 128:256, 128:256]))
    # tiles wider than K2's 128: padded to 256 and closed blocked (K2 + K1)
    for t in (129, 200, 256):
        compare(f"K2 fw_pivot wide t={t}", kfw.fw_pivot(w[:, :t, :t].clone()),
                kfw.fw_apsp_plain(w[:, :t, :t]))
    compare("blocked-fw t=256 closure vs Floyd-Warshall",
            kfw.fw_apsp_blocked(w, t=256), kfw.fw_apsp_plain(w))
    log("K2 wide tiles t=129/200/256 and blocked-fw t=256 == plain "
        "Floyd-Warshall")
    tile = w[:, :128, :128].clone()
    bnd, kind = bound_ms(20 * 128 ** 3, 4 * 2 * 20 * 128 * 128)
    k2 = {"kernel": "fw_pivot", "shape": "[20,128,128]",
          "ms": time_ms(lambda: kfw.fw_pivot(tile)),
          "plain_ms": time_ms(lambda: kfw.fw_tile_closure(tile)),
          "bound_ms": bnd, "bound_kind": kind,
          # one SM a lane: 2 t^3 instructions at one SM's share of the rate
          "lane_bound_ms": 2.0 * 128 ** 3 * -(-20 // sms)
          / (FP32_INSTR_PER_S / sms) * 1e3,
          "ms_t100": time_ms(lambda: kfw.fw_pivot(tile[:, :100, :100])),
          "max_abs_err": err2, "exact": True}
    log(json.dumps(k2))

    # K3: one Jacobi round on the all-source carry, d_max = 16, on the route
    # the shape picks (slab) and, at an N whose slab does not fit, route l2
    from repro_torch.kernels import _build
    k3 = {}
    for key, n, lanes, wn in (("slab", 512, 20, w), ("l2", 2048, 2, None)):
        if wn is None:
            wn = torch.tensor(quantized_weights(n, 16, lanes, 200, graphs),
                              device=dev)
        idx, wgt = apsp_mod._pack_ell(wn, 16)
        m = kell._full_init(idx, wgt)
        route = kell.ell_route(n, 16)
        before = _build.SITE_LAUNCHES[f"ell_relax_round/route:{key}"]
        got_m, got_f = kell.ell_relax_round(m, idx, wgt)
        if route != key or _build.SITE_LAUNCHES[
                f"ell_relax_round/route:{key}"] != before + 1:
            raise SystemExit(f"chip_smoke: K3 at N={n} did not take route "
                             f"{key}")
        want_m, want_f = kell.ell_relax_round_plain(m, idx, wgt)
        err3 = compare(f"K3 ell_relax_round route {key}", got_m, want_m)
        compare(f"K3 flags route {key}", got_f, want_f)
        bnd, kind = bound_ms(lanes * n * n * 16,
                             4 * 2 * lanes * n * n + 8 * lanes * n * 16)
        # 3 distinct carries in turn (3 x 21 MB at N = 512, more than the
        # 50 MB L2 holds), so each round reads its carry from device memory
        carries = [m] + [m.clone() for _ in range(2)]
        k3[key] = {
            "kernel": "ell_relax_round", "route": key,
            "shape": f"[{lanes},{n},{n}] d_max=16",
            "ms": time_ms(lambda: kell.ell_relax_round(m, idx, wgt)),
            "cold_ms": time_ms([functools.partial(kell.ell_relax_round, x,
                                                  idx, wgt)
                                for x in carries]),
            "plain_ms": time_ms(lambda: kell.ell_relax_round_plain(m, idx,
                                                                   wgt)),
            "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err3,
            "exact": True}
        log(json.dumps(k3[key]))
        del carries, got_m, want_m
    idx, wgt = apsp_mod._pack_ell(w, 16)
    # and the whole closure on the card against plain Floyd-Warshall
    d_ell, rounds = kell.ell_bf_apsp(idx, wgt)
    compare("ell-bf closure vs Floyd-Warshall", d_ell.contiguous(),
            kfw.fw_apsp_plain(w))
    compare("blocked-fw closure vs Floyd-Warshall",
            kfw.fw_apsp_blocked(w), kfw.fw_apsp_plain(w))
    log(f"closures: ell-bf ({rounds} Jacobi rounds) == blocked-fw == plain "
        "Floyd-Warshall on [20,512,512]")
    return {"minplus_acc": square, "fw_pivot": k2,
            "ell_relax_round": dict(k3["slab"], shapes=k3)}


def instances(graphs, traffic, n, deg, servers, seeds):
    topos, dems = [], []
    for s in seeds:
        t = graphs.random_regular_graph(n, deg, seed=s, servers=servers)
        topos.append(t)
        dems.append(traffic.make("permutation", t.servers, seed=s + 1))
    return topos, dems


def record_path(name: str, runs: list, need, steps=None) -> dict:
    """Append the launch counts read just after a path's run (reset just
    before it) to ``runs``; fails unless every kernel in ``need`` ran."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
    for k in need:
        if counts[k] == 0:
            raise SystemExit(f"chip_smoke: {name} did not launch {k}: "
                             f"{counts}")
    runs.append({"path": name, "launches": counts, "sites": sites,
                 "steps": steps})
    return runs[-1]


def run_path(name, engine, topos, dems, runs, need):
    """Solve one pile with the counts reset just before and read just
    after; append the path's own record to ``runs``."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = engine.solve_batch(topos, dems)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    its = [r.meta["iterations"] for r in res]
    # descent steps plus the final forward, per batched chunk
    steps = sum(max(r.meta["iterations"] for r in res
                    if r.meta["chunk"] == c) + 1
                for c in range(res[0].meta["chunks"]))
    run = record_path(name, runs, need, steps)
    run.update(wall_s=wall, results=res)
    counts, sites = run["launches"], run["sites"]
    ubs = np.array([r.throughput for r in res])
    if not np.all(np.isfinite(ubs) & (ubs > 0)):
        raise SystemExit(f"chip_smoke: {name} bounds not finite/positive: "
                         f"{ubs}")
    log(json.dumps({"path": name, "instances": len(res),
                    "ub_mean": float(ubs.mean()),
                    "iterations_max": int(max(its)),
                    "iterations_mean": float(np.mean(its)),
                    "wall_s": wall, "steps": steps, "launches": counts,
                    "site_launches": sites,
                    "plan": engine.last_plan.as_dict()}))
    return ubs


def all_on_route(run: dict, kernel: str, route: str) -> None:
    """Fail unless every launch of ``kernel`` in ``run`` took ``route``."""
    if run["sites"].get(f"{kernel}/route:{route}", 0) != \
            run["launches"][kernel]:
        raise SystemExit(f"chip_smoke: {run['path']}: not every {kernel} "
                         f"launch took route {route}: {run['sites']}")


# the dual path's kernels by their CUDA names (K3 by route)
PORT_KERNELS = {"K1 minplus_acc": "minplus_acc_kernel",
                "K2 fw_pivot": "fw_pivot_kernel",
                "K3 ell_relax_round slab": "ell_slab_kernel",
                "K3 ell_relax_round l2": "ell_l2_kernel"}


def device_busy(fn) -> dict:
    """The device's kernel time and idle share while ``fn()`` runs: only
    the device is traced, and the trace is read back from the profiler's
    own JSON export (``build/``), which stays cheap for a window of many
    thousand kernels where building the profiler's event objects does
    not."""
    from torch.profiler import ProfilerActivity, profile
    path = ROOT / "build" / "device_trace.json"
    path.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(path))
    by_kernel: dict[str, float] = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + \
                e["dur"] / 1e3
    path.unlink()
    busy = sum(by_kernel.values())
    return {"wall_ms": wall_ms, "kernel_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "top_kernels_ms": [[k[:70], ms] for k, ms in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:6]]}


def profile_steps(engine, topos, dems) -> dict:
    """Device time of a short profiled solve: kernel time by name, kernel
    time inside the two halves of a descent step (the ``repro_torch.apsp``
    ranges), and the device's idle share of the window (host clock around
    the solve, profiler on, so the window is longer than an unprofiled
    one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.solve_batch(topos, dems)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    ranges: dict[str, float] = {}
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            if e.device_type == DeviceType.CPU:
                ranges[e.name] = (ranges.get(e.name, 0.0)
                                  + e.device_time_total / 1e3)
        elif e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_kernel.values())
    steps = max(r.meta["iterations"] for r in res) + 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    ours = {k: sum(ms for name, ms in by_kernel.items() if pat in name)
            / steps for k, pat in PORT_KERNELS.items()}
    return {"steps": steps, "wall_ms": wall_ms,
            "wall_ms_per_step": wall_ms / steps,
            "kernel_ms": busy, "kernel_ms_per_step": busy / steps,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "range_kernel_ms": ranges,
            "port_kernel_ms_per_step": {k: v for k, v in ours.items() if v},
            "top_kernels_ms": [[k[:70], ms] for k, ms in top]}


# ---------------------------------------------------------------------------
# the certified path and the figure layer (phases 9-10)
# ---------------------------------------------------------------------------

def check_brackets(name, res, theta=None) -> tuple[np.ndarray, np.ndarray]:
    """Per-lane (lb, ub) of bracket results; fails unless 0 < lb <= ub and,
    where the LP optimum is given, lb <= θ <= ub (rel 1e-6)."""
    lb = np.array([r.meta["lb"] for r in res])
    ub = np.array([r.meta["ub"] for r in res])
    if not np.all(np.isfinite(ub) & (lb > 0) & (lb <= ub)):
        raise SystemExit(f"chip_smoke: {name}: not 0 < lb <= ub: {lb} {ub}")
    if theta is not None and not np.all(
            (lb <= theta * (1 + 1e-6)) & (theta <= ub * (1 + 1e-6))):
        raise SystemExit(f"chip_smoke: {name}: the bracket misses the LP "
                         f"optimum: lb {lb}, theta {theta}, ub {ub}")
    return lb, ub


def profile_certified(engine, topos, dems) -> dict:
    """``profile_steps`` of a certified solve, with the device ms a step of
    the APSP forward, the SP-DAG backward, the FW line search and the rest
    of the step (line search included)."""
    prof = profile_steps(engine, topos, dems)
    ranges, steps = prof["range_kernel_ms"], prof["steps"]
    fwd = ranges.get("repro_torch.apsp.forward", 0.0)
    bwd = ranges.get("repro_torch.apsp.backward", 0.0)
    return {**prof, "forward_ms_per_step": fwd / steps,
            "backward_ms_per_step": bwd / steps,
            "line_search_ms_per_step":
                ranges.get("repro_torch.primal.line_search", 0.0) / steps,
            "other_ms_per_step": (prof["kernel_ms"] - fwd - bwd) / steps}


def phase_certified(get_engine, bounds, topos, dems, otopos, odems, exact,
                    runs) -> dict:
    """Phase 9: (a) the Fig. 1 point through the certified engine, against
    HiGHS and against the same solve on the CPU; (b) phase 3's 20
    instances at full size (K3 on route slab), then 10 profiled steps."""
    t0 = time.perf_counter()
    run_path("phase 9a certified squaring RRG(40,10) x3",
             get_engine("certified", iters=800), otopos, odems, runs,
             ["minplus_acc"])
    card = runs[-1]["results"]
    cpu = get_engine("certified", iters=800, device="cpu").solve_batch(
        otopos, odems)
    lb, ub = check_brackets("phase 9a", card, exact)
    lb_cpu, ub_cpu = check_brackets("phase 9a on the CPU", cpu, exact)
    gaps = (ub - lb) / ub
    rel = np.concatenate([np.abs(lb / lb_cpu - 1), np.abs(ub / ub_cpu - 1)])
    a = {"theta_exact": exact.tolist(), "lb_card": lb.tolist(),
         "ub_card": ub.tolist(), "lb_cpu": lb_cpu.tolist(),
         "ub_cpu": ub_cpu.tolist(), "gap": gaps.tolist(),
         "card_vs_cpu_rel_max": float(rel.max()),
         "seconds": time.perf_counter() - t0}
    log(json.dumps({"phase": "9a", **a}))
    if not gaps.max() < 0.05:
        raise SystemExit(f"chip_smoke: phase 9a gap >= 5%: {gaps}")
    if not rel.max() <= 1e-3:
        raise SystemExit("chip_smoke: phase 9a card and CPU brackets "
                         f"disagree: {rel}")

    t0 = time.perf_counter()
    name = "phase 9b certified auto->ell-bf RRG(512,16) x20"
    run_path(name, get_engine("certified", tol=1e-4), topos, dems, runs,
             ["ell_relax_round"])
    all_on_route(runs[-1], "ell_relax_round", "slab")
    run = runs[-1]
    res = run["results"]
    flows = float(np.mean([d.sum() for d in dems]))
    thm1 = bounds.throughput_upper_bound(512, 16, flows)
    lb, ub = check_brackets(name, res)
    if not np.all(ub <= thm1):
        raise SystemExit(f"chip_smoke: {name}: ub above Theorem 1 ({thm1}): "
                         f"{ub}")
    b = {"theorem1": thm1, "lb": lb.tolist(), "ub": ub.tolist(),
         "gap": ((ub - lb) / ub).tolist(),
         "iterations": [r.meta["iterations"] for r in res],
         "steps": run["steps"], "wall_s": run["wall_s"],
         "ms_per_step": 1e3 * run["wall_s"] / run["steps"],
         "instances_per_s": len(res) / run["wall_s"],
         "k3_launches_per_step": run["launches"]["ell_relax_round"]
         / run["steps"]}
    b["profile"] = profile_certified(
        get_engine("certified", iters=10), topos, dems)
    b["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": "9b", **b}))
    return {"a": a, "b": b}


def phase_figure(lp, het, figures, CertifiedEngine, runs, pool):
    """Phase 10: Fig. 5 at paper scale on the certified engine (tol 1e-4,
    one BatchPlan, every lane padded to N = 60: K1 squaring) at
    ``FIG5_RUNS`` runs a point; one run of every point held against
    HiGHS.  The LPs go to ``pool`` after the card's run and are read by
    ``check_figure`` once phases 11-13 are done: the longest takes about
    two minutes, and the card's phases need one core of the host.
    Returns (the phase's record, what ``check_figure`` needs)."""
    from repro_torch.core import traffic as traffic_mod
    from repro_torch.kernels import _build

    class Kept(CertifiedEngine):
        def solve_batch(self, topos, dems):
            self.kept = (topos, dems, super().solve_batch(topos, dems))
            return self.kept[2]

    biases = (0.1, 0.3, 0.6, 1.0, 1.4, 1.8)
    seed = 3   # benchmarks/fig5.py's seed of run 0
    specs = figures._fig5_specs("paper")
    held = []
    for spec in specs.values():
        for bias in biases:
            t = het.build_two_class(spec, spec.proportional_large_servers,
                                    bias, seed)
            held.append((t, traffic_mod.make("permutation", t.servers,
                                             seed + 1)))
    eng = Kept(tol=1e-4)
    torch.cuda.synchronize()
    _build.reset_launches()
    t1 = time.perf_counter()
    rows = figures.fig5(scale="paper", engine=eng, biases=biases,
                        runs=FIG5_RUNS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
    lps = [pool.submit(lp.max_concurrent_flow, t.cap, d, False)
           for t, d in held]
    topos, dems, res = eng.kept
    instances = len(specs) * len(biases) * FIG5_RUNS
    name = (f"phase 10 fig5 paper certified ({instances} x 40-60 "
            "switches)")
    if counts["minplus_acc"] == 0:
        raise SystemExit(f"chip_smoke: {name} did not launch minplus_acc: "
                         f"{counts}")
    steps = sum(max(r.meta["iterations"] for r in res
                    if r.meta["chunk"] == c) + 1
                for c in range(res[0].meta["chunks"]))
    runs.append({"path": name, "launches": counts, "sites": sites,
                 "steps": steps})
    if len(res) != instances or len(rows) != 18 or \
            res[0].meta["chunks"] != 1:
        raise SystemExit(f"chip_smoke: {name}: {len(res)} instances, "
                         f"{len(rows)} rows, {res[0].meta['chunks']} chunks")
    idx = [c * len(biases) * FIG5_RUNS + p * FIG5_RUNS
           for c in range(len(specs)) for p in range(len(biases))]
    for i, (t, d) in zip(idx, held):
        if not (np.array_equal(topos[i].cap, t.cap)
                and np.array_equal(dems[i], d)):
            raise SystemExit(f"chip_smoke: {name}: held instance {i} is not "
                             "the one the figure solved")
    check_brackets(name, res)
    if not all(np.isfinite(r["gap"]) and r["gap"] >= 0 for r in rows):
        raise SystemExit(f"chip_smoke: {name}: bad gap column: {rows}")
    out = {"instances": len(res), "runs_per_point": FIG5_RUNS,
           "wall_s": wall, "steps": steps,
           "instances_per_s": len(res) / wall,
           "iterations_max": int(max(r.meta["iterations"] for r in res)),
           "iterations_mean": float(np.mean([r.meta["iterations"]
                                             for r in res])),
           "gap_max_by_config": {c: max(r["gap"] for r in rows
                                        if r["config"] == c) for c in specs},
           "launches": counts, "plan": eng.last_plan.as_dict(),
           "profile": profile_certified(CertifiedEngine(iters=10), topos,
                                        dems),
           "rows": rows}
    log(json.dumps({"phase": "10", **out}))
    return out, (name, [res[i] for i in idx], lps, time.perf_counter())


def check_figure(out: dict, pending) -> None:
    """Phase 10's held runs against their HiGHS optima (lb <= θ <= ub)."""
    name, held_res, lps, t0 = pending
    theta = np.array([f.result().throughput for f in lps])
    lb, ub = check_brackets(f"{name}, held runs", held_res, theta)
    out.update({"held_theta": theta.tolist(), "held_lb": lb.tolist(),
                "held_ub": ub.tolist(),
                "lp_seconds_after_card": time.perf_counter() - t0})
    log(json.dumps({"phase": "10 HiGHS", "held_theta": out["held_theta"],
                    "held_lb": out["held_lb"], "held_ub": out["held_ub"],
                    "lp_seconds_after_card": out["lp_seconds_after_card"]}))


# ---------------------------------------------------------------------------
# the scale probe, adversarial traffic and the design layer (phases 11-13)
# ---------------------------------------------------------------------------

# benchmarks/scale_bench.py's probe graph and block
PROBE_N, PROBE_D, PROBE_BLOCK = 16384, 16, 1024
# benchmarks/adversarial_bench.py's paper budget, and the reference's hose
# tolerance in flow units (tests/test_adversarial.py)
ADV_BUDGET = dict(rounds=4, candidates=8, iters=300)
HOSE_TOL = 1e-4
# benchmarks/design_bench.py's paper budget and ranking engine
DESIGN_BUDGET = dict(rounds=3, fleet=8, elite=3, runs=2)
DESIGN_ITERS = 250
# benchmarks/fig11.py's row keys
FIG11_KEYS = ["figure", "d_a", "d_i", "traffic", "vl2_tors", "rewired_tors",
              "gain_pct", "designed_tors", "designed_gain_pct",
              "vl2_servers", "rewired_servers"]


def dijkstra_rows(idx: np.ndarray, wgt: np.ndarray,
                  sources: np.ndarray) -> np.ndarray:
    """Distances from ``sources`` by scipy's Dijkstra over the graph of the
    incoming ELL tables (row t lists the k with an edge k -> t; pads,
    weight 1e18, dropped)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    n, d = idx.shape
    keep = wgt < 1e17
    tgt = np.repeat(np.arange(n), d).reshape(n, d)
    g = csr_matrix((wgt[keep].astype(np.float64), (idx[keep], tgt[keep])),
                   shape=(n, n))
    return dijkstra(g, directed=True, indices=sources)


def phase_scale_probe(graphs, kell, runs) -> dict:
    """Phase 11: the streamed ELL closure.  (a) At N = 2048, where the full
    closure fits, streamed == full on the card, bit for bit, with the same
    rounds; (b) the probe RRG(16384, 16) in blocks of 1024 sources: wall,
    rounds, K3 launches by route (all ``l2``), peak device memory, and 32
    sources held against scipy's Dijkstra; (c) K3 ``l2`` timed at the
    streamed shape [1, 16384, 1024] against its plain version."""
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    out: dict = {}
    g = graphs.random_regular_ell(2048, PROBE_D, seed=0)
    idx, wgt = (torch.as_tensor(x, device=dev)[None] for x in (g.idx, g.wgt))
    full, full_rounds = kell.ell_bf_apsp(idx, wgt)
    full = full[0].cpu().numpy()
    torch.cuda.synchronize()
    _build.reset_launches()
    d, rounds = kell.ell_bf_apsp_streamed(g.idx, g.wgt, block=PROBE_BLOCK)
    run = record_path("phase 11a streamed closure RRG(2048,16), block 1024",
                      runs, ["ell_relax_round"],
                      steps=_build.LAUNCHES["ell_relax_round"])
    all_on_route(run, "ell_relax_round", "l2")
    if rounds != full_rounds or not np.array_equal(d, full):
        raise SystemExit(f"chip_smoke: phase 11a: streamed closure ({rounds}"
                         f" rounds) differs from the full one ({full_rounds})")
    out["a"] = {"n": 2048, "rounds": rounds, "full_rounds": full_rounds,
                "launches": run["sites"], "equal_bits": True}
    log(json.dumps({"phase": "11a", **out["a"]}))
    del full, d, idx, wgt

    t0 = time.perf_counter()
    g = graphs.random_regular_ell(PROBE_N, PROBE_D, seed=0)
    gen_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    d, rounds = kell.ell_bf_apsp_streamed(g.idx, g.wgt, block=PROBE_BLOCK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _build.LAUNCHES["ell_relax_round"]
    name = (f"phase 11b scale probe RRG({PROBE_N},{PROBE_D}) streamed, "
            f"block {PROBE_BLOCK}")
    run = record_path(name, runs, ["ell_relax_round"], steps=launches)
    all_on_route(run, "ell_relax_round", "l2")
    sources = np.random.default_rng(0).choice(PROBE_N, 32, replace=False)
    t0 = time.perf_counter()
    want = dijkstra_rows(g.idx, g.wgt, sources)
    dijkstra_s = time.perf_counter() - t0
    got = d[sources].astype(np.float64)
    if not (np.all(np.isfinite(want))
            and np.all(np.abs(got - want) <= 1e-6 * want)):
        raise SystemExit(f"chip_smoke: {name}: distances from 32 sources "
                         "disagree with scipy's Dijkstra (max abs diff "
                         f"{np.abs(got - want).max()})")
    blocks = PROBE_N // PROBE_BLOCK
    out["b"] = {"n": PROBE_N, "d_max": g.d_max, "block": PROBE_BLOCK,
                "blocks": blocks, "wall_s": wall, "graph_gen_s": gen_s,
                "rounds_max": rounds, "k3_launches": launches,
                "k3_launches_by_site": run["sites"],
                "rounds_mean": launches / blocks,
                "peak_device_bytes": peak,
                "device_bytes_before": base,
                "peak_device_bytes_of_call": peak - base,
                "carry_bytes": 4 * PROBE_N * PROBE_BLOCK,
                "host_output_bytes": d.nbytes,
                "max_distance": float(d.max()),
                "dijkstra_sources": 32, "dijkstra_s": dijkstra_s}
    log(json.dumps({"phase": "11b", **out["b"]}))
    del d, got

    # K3 route l2 at the streamed shape: one round on a block's carry
    idx, wgt = (torch.as_tensor(x, device=dev)[None] for x in (g.idx, g.wgt))
    m = kell._block_init(idx, wgt, 0, PROBE_BLOCK)
    got_m, got_f = kell.ell_relax_round(m, idx, wgt)
    want_m, want_f = kell.ell_relax_round_plain(m, idx, wgt)
    err = compare("K3 ell_relax_round route l2 [1,16384,1024]", got_m,
                  want_m)
    compare("K3 flags route l2 [1,16384,1024]", got_f, want_f)
    del got_m, want_m
    d_max = idx.shape[2]
    bnd, kind = bound_ms(PROBE_N * PROBE_BLOCK * d_max,
                         4 * 2 * PROBE_N * PROBE_BLOCK + 8 * PROBE_N * d_max)
    # 3 carries in turn (3 x 67 MB > the 50 MB L2): each read from memory
    carries = [kell._block_init(idx, wgt, s0, PROBE_BLOCK)
               for s0 in (0, PROBE_BLOCK, 2 * PROBE_BLOCK)]
    out["k3"] = {
        "kernel": "ell_relax_round", "route": "l2",
        "shape": f"[1,{PROBE_N},{PROBE_BLOCK}] d_max={d_max} "
                 "(a streamed block)",
        "ms": time_ms(lambda: kell.ell_relax_round(m, idx, wgt)),
        "cold_ms": time_ms([functools.partial(kell.ell_relax_round, x, idx,
                                              wgt) for x in carries]),
        "plain_ms": time_ms(lambda: kell.ell_relax_round_plain(m, idx, wgt)),
        "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err,
        "exact": True}
    log(json.dumps(out["k3"]))
    del carries, m, idx, wgt
    gc.collect()
    torch.cuda.empty_cache()
    return out


class PooledLP:
    """The HiGHS oracle as a batching engine: ``solve_batch`` solves its
    LPs in worker processes at once (``vl2.supports_full_throughput``
    then checks every run, with no early exit)."""

    name = "exact"
    batches = True

    def __init__(self, pool, lp, result_cls):
        self.pool, self.lp, self.result_cls = pool, lp, result_cls

    def solve_batch(self, topos, dems):
        futs = [self.pool.submit(self.lp.max_concurrent_flow,
                                 np.asarray(t.cap), d, False)
                for t, d in zip(topos, dems)]
        return [self.result_cls(throughput=f.result().throughput,
                                is_upper_bound=False, engine=self.name)
                for f in futs]


def phase_adversarial(graphs, lp, traffic, topo512, runs) -> dict:
    """Phase 12: ``find_worst_tm`` at the adversarial benchmark's paper
    budget on (a) its two-cluster family (K1 squaring), held against HiGHS
    on the worst TM and strictly below the baseline's ub, and (b) phase
    3's RRG(512, 16), 8 servers a switch (auto -> ell-bf -> K3 slab).
    Every candidate hose-feasible, 5 executes, one compile key; wall,
    instances/s and the device's idle share over one profiled round."""
    from repro_torch.core import adversarial
    from repro_torch.core.plan import BatchPlan
    from repro_torch.kernels import _build
    two_cluster = graphs.biased_two_cluster_graph(
        [8] * 10, [5] * 10, cross_bias=0.5, seed=1, servers=3)
    out = {}
    for key, topo, kernel, route in (
            ("a", two_cluster, "minplus_acc", None),
            ("b", topo512, "ell_relax_round", "slab")):
        name = (f"phase 12{key} adversarial "
                f"{'two_cluster' if key == 'a' else 'RRG'}({topo.n}) "
                f"{ADV_BUDGET['rounds']} rounds x "
                f"{ADV_BUDGET['candidates']} candidates, "
                f"{ADV_BUDGET['iters']} iters")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = adversarial.find_worst_tm(topo, seed=0, keep_fleet=True,
                                        **ADV_BUDGET)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = record_path(name, runs, [kernel])
        if route:
            all_on_route(run, kernel, route)
        s = res.stats
        viol = max(adversarial.hose_violation(d, topo.servers)
                   for d in res.fleet + (res.tm,))
        cands = len(res.fleet)
        if s["executes"] != 1 + ADV_BUDGET["rounds"] or \
                len(s["compile_keys"]) != 1 or \
                cands != ADV_BUDGET["rounds"] * (ADV_BUDGET["candidates"] - 1):
            raise SystemExit(f"chip_smoke: {name}: {s['executes']} executes, "
                             f"compile keys {s['compile_keys']}, {cands} "
                             "candidates")
        if not viol <= HOSE_TOL:
            raise SystemExit(f"chip_smoke: {name}: a candidate breaks the "
                             f"hose caps by {viol}")
        if not (0 < res.lb <= res.ub <= res.baseline_ub):
            raise SystemExit(f"chip_smoke: {name}: not 0 < lb <= ub <= "
                             f"baseline ub: {res.lb} {res.ub} "
                             f"{res.baseline_ub}")
        row = {"n": topo.n, "wall_s": wall,
               "instances": s["executes"] * s["candidates"],
               "instances_per_s": s["executes"] * s["candidates"] / wall,
               "lb": res.lb, "ub": res.ub, "baseline_lb": res.baseline_lb,
               "baseline_ub": res.baseline_ub,
               "uniform_gap_pct": res.uniform_gap_pct,
               "max_hose_violation": viol, "candidates_checked": cands + 1,
               "executes": s["executes"],
               "compile_keys": s["compile_keys"], "history": res.history,
               "launches": run["launches"], "sites": run["sites"]}
        if key == "a":
            t1 = time.perf_counter()
            theta = lp.max_concurrent_flow(topo.cap, res.tm,
                                           want_flows=False).throughput
            row["theta_highs"], row["lp_s"] = theta, time.perf_counter() - t1
            if not (res.lb <= theta * (1 + 1e-6)
                    and theta <= res.ub * (1 + 1e-6)):
                raise SystemExit(f"chip_smoke: {name}: HiGHS {theta} outside "
                                 f"[{res.lb}, {res.ub}]")
            if not res.ub < res.baseline_ub:
                raise SystemExit(f"chip_smoke: {name}: adversarial ub "
                                 f"{res.ub} not below the baseline's "
                                 f"{res.baseline_ub}")
        # one profiled round: round one's candidates through one execute
        baseline = traffic.random_permutation(
            topo.servers, (0, adversarial._BASELINE_KEY))
        dems = [baseline] + list(res.fleet[:ADV_BUDGET["candidates"] - 1])
        plan = BatchPlan.build([topo] * ADV_BUDGET["candidates"], dems)
        row["profiled_round"] = device_busy(lambda: plan.execute(
            solver="dual-demgrad", iters=ADV_BUDGET["iters"], tol=1e-3))
        log(json.dumps({"phase": f"12{key}", **row}))
        out[key] = row
    return out


def phase_design(het, vl2, figures, lp, traffic, engine_mod, runs) -> dict:
    """Phase 13: (a) ``design.optimize`` at the design benchmark's paper
    budget on its two spaces (the two-class one with ``robust=True``):
    best lb >= the recipe's, 1 + rounds search executes, one compile key
    for the search rounds; (b) Fig. 11's designed column at d_a = d_i =
    10, 5 runs, with HiGHS as the criterion (its LPs in worker
    processes), and the designer's search at the recipe's ToR count run
    again: its pick's certified lb >= the recipe's, and the designed
    count >= the recipe's exactly when that pick holds the figure's 5
    held-out permutations (the designer scores on 3 samples of its own,
    so a pick can fail them: ``benchmarks/fig11.py`` says so)."""
    import concurrent.futures
    import multiprocessing
    from repro_torch import design
    from repro_torch.kernels import _build
    out = {}
    spec = vl2.VL2Spec(d_a=6, d_i=6, servers_per_tor=20)
    spaces = (
        ("vl2", design.VL2Space(spec, spec.n_tor_full), ("swap",), False),
        ("two_class", design.TwoClassSpace(het.TwoClassSpec(
            n_large=10, k_large=18, n_small=20, k_small=6, num_servers=90)),
         ("swap", "servers", "bias"), True))
    for label, space, moves, robust in spaces:
        name = (f"phase 13a design {label} {DESIGN_BUDGET['rounds']} "
                f"rounds x fleet {DESIGN_BUDGET['fleet']} x runs "
                f"{DESIGN_BUDGET['runs']}" + (", robust" if robust else ""))
        eng = engine_mod.DualEngine(iters=DESIGN_ITERS, tol=1e-3)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = design.optimize(space, engine=eng, moves=moves, seed=0,
                              robust=robust, **DESIGN_BUDGET)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = record_path(name, runs, ["minplus_acc"])
        s = res.stats
        if not (res.best.lb >= res.reference.lb - 1e-6
                and 0 < res.best.lb <= res.best.ub):
            raise SystemExit(f"chip_smoke: {name}: best lb {res.best.lb} "
                             f"(ub {res.best.ub}) below the recipe's "
                             f"{res.reference.lb}")
        if s["search_executes"] != 1 + DESIGN_BUDGET["rounds"] or \
                len(s["last_plan"]["compile_keys"]) != 1 or \
                (robust and not s["robust"]["executes"]):
            raise SystemExit(f"chip_smoke: {name}: executes or compile keys "
                             f"off: {s}")
        row = {"space": label, "n": res.reference.cand.topo.n,
               "wall_s": wall, "recipe_lb": res.reference.lb,
               "recipe_ub": res.reference.ub, "best_lb": res.best.lb,
               "best_ub": res.best.ub,
               "design_gain_pct": 100.0 * (res.best.lb / res.reference.lb
                                           - 1),
               "executes": s["executes"],
               "search_executes": s["search_executes"],
               "compile_keys": s["compile_keys"],
               "instances_per_round": s["instances_per_round"],
               "robust": s["robust"], "history": res.history,
               "launches": run["launches"]}
        log(json.dumps({"phase": "13a", **row}))
        out[label] = row

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 4, mp_context=ctx) as pool:
        highs = PooledLP(pool, lp, engine_mod.ThroughputResult)
        name = "phase 13b fig11 d_a=d_i=10, 5 runs, designed column"
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rows = figures.fig11(sizes=[(10, 10)], runs=5, engine=highs,
                             device="cuda")
        wall = time.perf_counter() - t0
        run = record_path(name, runs, ["minplus_acc"])
        perm, stride = rows
        if list(perm) != FIG11_KEYS or perm["traffic"] != "permutation" or \
                stride["designed_tors"] is not None or \
                not perm["designed_tors"] >= 1:
            raise SystemExit(f"chip_smoke: {name}: bad rows: {rows}")
        # the designer's first probe again (the same search, deterministic
        # on the card): its certified pick never falls below the recipe
        # on its own traffic samples, and the designed count reaches the
        # recipe's exactly when that pick also holds the figure's held-out
        # permutations (the search scores on 3 samples of its own)
        spec = vl2.VL2Spec(d_a=10, d_i=10, servers_per_tor=20)
        n_tor = perm["rewired_tors"]
        t1 = time.perf_counter()
        probe = design.optimize(
            design.VL2Space(spec, n_tor), moves=("swap",), seed=2,
            engine=engine_mod.DualEngine(iters=200, tol=1e-3), rounds=2,
            fleet=6, runs=3)
        held = {}
        for key, topo in (("pick", probe.best.cand.topo),
                          ("recipe", probe.reference.cand.topo)):
            dems = [traffic.random_permutation(topo.servers, 2 + 17 + r)
                    for r in range(5)]
            held[key] = [r.throughput for r in
                         highs.solve_batch([topo] * 5, dems)]
        probe_s = time.perf_counter() - t1
    pick_holds = min(held["pick"]) >= 1 - 1e-6
    reaches = perm["designed_tors"] >= perm["rewired_tors"]
    out["fig11"] = {
        "rows": rows, "wall_s": wall, "launches": run["launches"],
        "designed_at_least_rewired": reaches,
        "probe_at_rewired": {
            "n_tor": n_tor, "pick_lb": probe.best.lb,
            "pick_ub": probe.best.ub, "recipe_lb": probe.reference.lb,
            "recipe_ub": probe.reference.ub,
            "pick_is_recipe": probe.best.cand is probe.reference.cand,
            "heldout_theta_pick": held["pick"],
            "heldout_theta_recipe": held["recipe"], "seconds": probe_s}}
    log(json.dumps({"phase": "13b", **out["fig11"]}))
    if not (probe.best.lb >= probe.reference.lb
            and min(held["recipe"]) >= 1 - 1e-6 and reaches == pick_holds):
        raise SystemExit(f"chip_smoke: {name}: the designed column is not "
                         "what its searches give: "
                         f"{out['fig11']['probe_at_rewired']}")
    return out


# ---------------------------------------------------------------------------
# the LM serving path (phases 6-8)
# ---------------------------------------------------------------------------

# K4's output is bf16 on the main path: kernel and plain version compute in
# float32 and round to bf16, so they may differ by one bf16 ulp (<= |x|/128)
K4_BF16_TOL = (1e-3, 8e-3)
# float32 K4: the same float32 math summed in another order
K4_F32_TOL = (2e-5, 1e-4)
K4_SOURCES = {"mma": "src/repro_torch/csrc/flash_attention_mma.cu",
              "decode": "src/repro_torch/csrc/flash_decode.cu",
              "f32": "src/repro_torch/csrc/flash_attention.cu"}
# K5: the same chunked float32 algebra summed in another order; exponents up
# to +-80 inside a chunk scale the rounding of exp
K5_TOL = (1e-4, 1e-4)
# logits, relative L2 per generated position.  In bf16 (8 mantissa bits)
# the kernel path and the plain path round at other places, and how far
# that drifts through 32 layers depends on the model's conditioning: with
# random weights, on an H100, both bf16 paths of rwkv6-7b land 0.6 from the
# float32 plain path (1.8e-2 apart from each other for minitron-4b, 0.1-0.3
# for rwkv6-7b), so no fixed tolerance holds both.  The bf16 check is therefore relative:
# at every position the kernel path must be no further from the float32
# plain path than the bf16 plain path is, within 10%.  float32 (no TF32) at
# 4 layers is the tight check: the paths differ by the order of additions
# only (~1e-6); an attention or WKV computed in bf16 gives ~1e-3 and must
# fail it (checked below on a bf16-rounding plain path).
SERVE_BF16_MARGIN = 1.1
SERVE_FP32_TOL = 1e-4
PROMPTS, PROMPT_LEN, GEN = 8, 1000, 16


def flop_bound_ms(flops: float, rate: float, nbytes: float) -> tuple[float, str]:
    """Least time: ``flops`` at ``rate`` or ``nbytes`` at the HBM rate."""
    ops = flops / rate * 1e3
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def close(name: str, got: torch.Tensor, want: torch.Tensor,
          tol: tuple[float, float]) -> float:
    """Max abs error; fails unless |got - want| <= atol + rtol |want|."""
    torch.cuda.synchronize()
    atol, rtol = tol
    g, w = got.double(), want.double()
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool(
            (err > atol + rtol * w.abs()).any()):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version (max abs diff {float(err.max())}, atol "
                         f"{atol}, rtol {rtol})")
    return float(err.max())


def sdpa_call(q, k, v, lk_valid):
    """One ``scaled_dot_product_attention`` call on K4's inputs in torch's
    [B, H, L, D] layout (transposed outside the timed call)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lq, lk = q.shape[1], k.shape[1]
    if lk_valid == lk and lq == lk:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    kpos = torch.arange(lk, device=q.device)
    qpos = torch.arange(lq, device=q.device) + (lk_valid - lq)
    mask = (kpos[None, :] < lk_valid) & (kpos[None, :] <= qpos[:, None])
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def earlier_k4(lib, q, k, v, lk_valid):
    """One call of the CUDA-core K4 entry (``csrc/flash_attention.cu``, route
    "f32") on bf16 inputs, as every bf16 call ran before the tensor-core
    and split-KV routes: a timing yardstick only."""
    from repro_torch.kernels import _build
    b, lq, hq, d = q.shape
    out = torch.empty_like(q)
    args = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, b,
            lq, lk_valid, hq, k.shape[2], d, 1, 1.0 / d ** 0.5,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], _build.stream_ptr(q.device))
    return lambda: _build.check(lib.flash_attention(*args),
                                "flash_attention (CUDA cores)")


def phase_lm_kernels(kfa, kwkv) -> dict[str, dict]:
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    out = {}
    b, hq, hkv, d = 8, 24, 8, 128
    lib = _build.load()
    for key, label, lq, lk, valid, dtype, sets in (
            ("prefill", "prefill [8,1000,24/8,128] bf16 causal", 1000, 1000,
             1000, torch.bfloat16, 1),
            ("decode", "decode [8,1,24/8,128] bf16, cache 1016, lk_valid 1001",
             1, 1016, 1001, torch.bfloat16, 4),
            ("aligned", "aligned [8,1024,24/8,128] bf16 causal", 1024, 1024,
             1024, torch.bfloat16, 1),
            ("prefill_f32", "prefill [8,1000,24/8,128] f32 causal", 1000,
             1000, 1000, torch.float32, 1)):
        # decode: 4 input sets taken in turn (4 x 33 MB of cache > the 50 MB
        # L2), so each timed call reads its keys from device memory as a
        # decode step does
        inputs = [(randn(b, lq, hq, d, dtype=dtype),
                   randn(b, lk, hkv, d, dtype=dtype),
                   randn(b, lk, hkv, d, dtype=dtype)) for _ in range(sets)]
        q, k, v = inputs[0]
        route = kfa.flash_route(dtype, lq, hq // hkv)
        tol = K4_BF16_TOL if dtype == torch.bfloat16 else K4_F32_TOL
        before = _build.SITE_LAUNCHES[f"flash_attention/route:{route}"]
        got = kfa.flash_attention(q, k, v, causal=True, lk_valid=valid)
        if _build.SITE_LAUNCHES[f"flash_attention/route:{route}"] != \
                before + 1:
            raise SystemExit(f"chip_smoke: K4 {label} did not take route "
                             f"{route}")
        want = kfa.flash_attention_plain(q, k, v, causal=True,
                                         lk_valid=valid)
        err = close(f"K4 {label} (route {route})", got, want, tol)
        # (query, key) pairs this input needs: causal, aligned to the end
        pairs = sum(min(valid, i + valid - lq + 1) for i in range(lq))
        flops = 4.0 * b * hq * d * pairs
        esize = q.element_size()
        nbytes = esize * (2 * b * lq * hq * d + 2 * b * valid * hkv * d)
        bnd, kind = flop_bound_ms(
            flops, BF16_FLOP_PER_S if dtype == torch.bfloat16
            else FP32_FLOP_PER_S, nbytes)

        def each(call):
            return [functools.partial(call, *x) for x in inputs]

        kernel = functools.partial(kfa.flash_attention, causal=True,
                                   lk_valid=valid)
        plain = functools.partial(kfa.flash_attention_plain, causal=True,
                                  lk_valid=valid)
        row = {"kernel": "flash_attention", "shape": label, "route": route,
               "source": K4_SOURCES[route],
               "ms": time_ms(each(kernel)),
               "call_ms": call_ms(lambda: kernel(q, k, v)),
               "plain_ms": time_ms(each(plain)),
               "library_ms": time_ms([sdpa_call(*x, valid) for x in inputs]),
               "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err,
               "tolerance": tol}
        if dtype == torch.bfloat16:
            # the earlier design (float32 FMA on the CUDA cores, one block
            # per 64 rows), called through its C entry on the same inputs:
            # timed only, never counted and never on the path
            row["cuda_core_ms"] = time_ms(
                [earlier_k4(lib, *x, valid) for x in inputs])
        log(json.dumps(row))
        out[f"flash_attention/{key}"] = row
        del q, k, v, got, want, inputs

    bh, n = 512, 64
    for key, t, with_s0, heads in (
            ("T1000+s0", 1000, True, False), ("T1000", 1000, False, False),
            ("T1024", 1024, False, False), ("T1024+s0", 1024, True, False),
            ("heads T1000", 1000, False, True)):
        if heads:
            # the model's layout: [8, T, 64, 64] projections handed over as
            # [B, H, T, n] views, read in place; a per-head bonus [H, n]
            lead = (8, bh // 8)
            r, k, v = (randn(8, t, bh // 8, n).permute(0, 2, 1, 3)
                       for _ in range(3))
            log_w = -torch.clamp(torch.exp(randn(8, t, bh // 8, n)), 1e-6,
                                 2.5).permute(0, 2, 1, 3)
            u = randn(bh // 8, n) * 0.5
        else:
            lead = (bh,)
            r, k, v = (randn(bh, t, n) for _ in range(3))
            log_w = -torch.clamp(torch.exp(randn(bh, t, n)), 1e-6, 2.5)
            u = randn(bh, n) * 0.5
        s0 = randn(*lead, n, n) * 0.3 if with_s0 else None
        o, s = kwkv.wkv_chunked(r, k, v, log_w, u, s0)
        want_o, want_s = kwkv.wkv_chunked_plain(r, k, v, log_w, u, s0)
        err = max(close(f"K5 o {key}", o, want_o, K5_TOL),
                  close(f"K5 s_final {key}", s, want_s, K5_TOL))
        c = kwkv.CHUNK
        # the chunked algebra on T steps: intra-chunk A and A v, the state
        # read and update, the bonus term and decay bookkeeping
        flops = bh * (t / c) * (2 * c * (c - 1) * n + 4 * c * n * n
                                + n * n + 10 * c * n)
        nbytes = 4.0 * (5 * bh * t * n + u.numel() + bh * n * n
                        * (2 if with_s0 else 1))
        bnd, kind = flop_bound_ms(flops, FP32_FLOP_PER_S, nbytes)
        shape = (f"[8,{t},64,64] f32 as [B,H,T,n] views" if heads
                 else f"[{bh},{t},{n}] f32") + (" + s0" if with_s0 else "")
        row = {"kernel": "wkv_chunked", "shape": shape,
               "ms": time_ms(lambda: kwkv.wkv_chunked(r, k, v, log_w, u, s0)),
               "plain_ms": time_ms(lambda: kwkv.wkv_chunked_plain(
                   r, k, v, log_w, u, s0)),
               "library_ms": None,
               "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err,
               "tolerance": K5_TOL}
        log(json.dumps(row))
        out[f"wkv_chunked/{key}"] = row
        del r, k, v, log_w, u, s0, o, s, want_o, want_s
    return out


@contextlib.contextmanager
def plain_path(kops, kfa, kwkv, bf16_inputs: bool = False):
    """Run the model with K4's and K5's plain versions in place of the
    kernels (``ops`` is where the model looks them up).  With
    ``bf16_inputs`` the plain versions see their inputs rounded to bf16:
    what an attention or WKV that computed in bf16 would give."""
    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype) if bf16_inputs else x

    def attention(q, k, v, *, causal=True, scale=None, lk_valid=None,
                  site=None):
        return kfa.flash_attention_plain(rnd(q), rnd(k), rnd(v),
                                         causal=causal, scale=scale,
                                         lk_valid=lk_valid)

    def wkv(r, k, v, log_w, u, s0=None):
        return kwkv.wkv_chunked_plain(rnd(r), rnd(k), rnd(v), rnd(log_w), u,
                                      s0)

    saved = kops.flash_attention, kops.wkv_chunked
    kops.flash_attention, kops.wkv_chunked = attention, wkv
    try:
        yield
    finally:
        kops.flash_attention, kops.wkv_chunked = saved


def teacher_forced(model, params, toks: np.ndarray) -> torch.Tensor:
    """Logits [B, GEN, Vp] of one full forward over prompt + generated
    tokens, at the positions whose logits picked each generated token."""
    from repro_torch.models import layers
    batch = {"tokens": torch.as_tensor(toks[:, :PROMPT_LEN + GEN - 1],
                                       device="cuda")}
    h, _, _ = model.forward(params, batch, unembed=False)
    return layers.dense(h[:, PROMPT_LEN - 1:], params["head"])


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """||got - want|| / ||want|| at each generated position."""
    g, w = got.float(), want.float()
    num = torch.linalg.vector_norm(g - w, dim=(0, 2))
    den = torch.linalg.vector_norm(w, dim=(0, 2))
    return (num / den).tolist()


def kernel_groups(prof, kernels: dict[str, str]) -> dict:
    """Device time of a profiled window by group: our kernels by name,
    GEMMs, everything else."""
    from torch.autograd import DeviceType
    groups: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name
        group = next((g for g, pat in kernels.items() if pat in name), None)
        if group is None:
            low = name.lower()
            group = ("gemm" if any(w in low for w in (
                "gemm", "cutlass", "xmma", "nvjet", "sm90")) else "other")
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
    return groups


def profile_serving(model, params, prompts, kernels) -> dict:
    """Two profiled windows at full depth: one prefill of the whole prompt
    batch, and four decode steps after it."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(prompts, device="cuda", dtype=torch.long)
    res = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks},
                                      PROMPT_LEN + 8)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = kernel_groups(prof, kernels)
    busy = sum(groups.values())
    res["prefill"] = {"wall_ms": wall, "kernel_ms": busy,
                      "device_idle_share": 1 - busy / wall,
                      "kernel_ms_by_group": groups}
    tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 4
    groups = {g: ms / 4 for g, ms in kernel_groups(prof, kernels).items()}
    busy = sum(groups.values())
    res["decode_step"] = {"wall_ms": wall, "kernel_ms": busy,
                          "device_idle_share": 1 - busy / wall,
                          "kernel_ms_by_group": groups}
    return res


def phase_serve(arch: str, kernel: str, runs: list, seed: int) -> dict:
    """Serve ``arch`` at full width and depth through ``generate`` and
    check its logits against the plain path; then full width at 4 layers
    in float32; then a profile.  Frees the model before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib

    cfg = get_config(arch)
    nl = cfg.num_layers
    model = model_lib.get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (PROMPTS, PROMPT_LEN)).astype(np.int32)
    serve.generate(cfg, params, prompts[:, :64], 2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    rec: dict = {}
    toks = serve.generate(cfg, params, prompts, GEN, record=rec)
    counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
    steps = 1 + rec["decode_steps"]
    name = f"{arch} generate 8x{PROMPT_LEN}+{GEN}, {nl} layers, {cfg.dtype}"
    runs.append({"path": name, "launches": counts, "sites": sites,
                 "steps": steps})
    if counts[kernel] == 0:
        raise SystemExit(f"chip_smoke: {name} did not launch {kernel}")
    if kernel == "flash_attention" and sites != {
            "flash_attention/full": nl,
            "flash_attention/decode": nl * rec["decode_steps"],
            "flash_attention/route:mma": nl,
            "flash_attention/route:decode": nl * rec["decode_steps"]}:
        raise SystemExit(f"chip_smoke: {name}: K4 not in every layer of the "
                         "prefill (route mma) and of every decode step "
                         f"(route decode): {sites}")
    if kernel == "wkv_chunked" and counts[kernel] != nl:
        raise SystemExit(f"chip_smoke: {name}: K5 not in every layer of the "
                         f"prefill: {counts}")
    got = torch.stack(rec["logits"], dim=1)
    vp = cfg.padded_vocab
    if got.shape != (PROMPTS, GEN, vp) or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"chip_smoke: {name}: logits {tuple(got.shape)} or "
                         "not finite")
    if toks.shape != (PROMPTS, PROMPT_LEN + GEN) or toks.max() >= \
            cfg.vocab_size:
        raise SystemExit(f"chip_smoke: {name}: bad tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with plain_path(kops, kfa, kwkv):
        _build.reset_launches()
        plain = teacher_forced(model, params, toks)
        if any(_build.LAUNCHES.values()):
            raise SystemExit("chip_smoke: the plain path launched a kernel")
    rel = rel_l2(got, plain)
    # the float32 plain path at full depth: how far each bf16 path is from it
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with plain_path(kops, kfa, kwkv):
        exact = teacher_forced(model_lib.get_model(cfg32), params, toks)
    rel_kernel, rel_plain = rel_l2(got, exact), rel_l2(plain, exact)
    res = {"arch": arch, "layers": nl, "dtype": cfg.dtype,
           "params_b": sum(x.numel() for x in _leaves(params)) / 1e9,
           "init_s": init_s, "prefill_s": rec["prefill_s"],
           "decode_s": rec["decode_s"], "decode_steps": rec["decode_steps"],
           "prefill_tok_per_s": PROMPTS * PROMPT_LEN / rec["prefill_s"],
           "decode_tok_per_s": PROMPTS * rec["decode_steps"] / rec["decode_s"],
           "peak_gb": peak_gb, "launches": counts, "sites": sites,
           "rel_l2_vs_plain": rel, "rel_l2_kernel_vs_fp32": rel_kernel,
           "rel_l2_plain_vs_fp32": rel_plain, "margin": SERVE_BF16_MARGIN}
    del plain, exact
    log(json.dumps(res))
    if not all(k <= SERVE_BF16_MARGIN * p for k, p in zip(rel_kernel,
                                                           rel_plain)):
        raise SystemExit(f"chip_smoke: {name}: the kernel path is further "
                         "from the float32 plain path than the bf16 plain "
                         f"path: {rel_kernel} vs {rel_plain}")

    # full width, 4 layers, float32 (TF32 off): a tight check
    cfg4 = dataclasses.replace(cfg, num_layers=min(4, nl), dtype="float32")
    params4 = dict(params, blocks={k: w[:cfg4.num_layers] for k, w in
                                   params["blocks"].items()})
    model4 = model_lib.get_model(cfg4)
    _build.reset_launches()
    rec4: dict = {}
    toks4 = serve.generate(cfg4, params4, prompts, GEN, record=rec4)
    name4 = (f"{arch} generate 8x{PROMPT_LEN}+{GEN}, {cfg4.num_layers} "
             "layers, float32")
    runs.append({"path": name4, "launches": dict(_build.LAUNCHES),
                 "sites": dict(_build.SITE_LAUNCHES),
                 "steps": 1 + rec4["decode_steps"]})
    if _build.LAUNCHES[kernel] == 0:
        raise SystemExit(f"chip_smoke: {name4} did not launch {kernel}")
    nl4, steps4 = cfg4.num_layers, rec4["decode_steps"]
    if kernel == "flash_attention" and dict(_build.SITE_LAUNCHES) != {
            "flash_attention/full": nl4, "flash_attention/decode": nl4 * steps4,
            "flash_attention/route:f32": nl4,
            "flash_attention/route:decode": nl4 * steps4}:
        raise SystemExit(f"chip_smoke: {name4}: K4 not on route f32 at the "
                         "prefill and route decode at every step: "
                         f"{dict(_build.SITE_LAUNCHES)}")
    got4 = torch.stack(rec4["logits"], dim=1)
    with plain_path(kops, kfa, kwkv):
        plain4 = teacher_forced(model4, params4, toks4)
    with plain_path(kops, kfa, kwkv, bf16_inputs=True):
        bf16_4 = teacher_forced(model4, params4, toks4)
    rel4, rel_bf16 = rel_l2(got4, plain4), rel_l2(bf16_4, plain4)
    res4 = {"arch": arch, "layers": cfg4.num_layers, "dtype": "float32",
            "rel_l2_vs_plain": rel4, "tolerance": SERVE_FP32_TOL,
            "rel_l2_bf16_rounding_plain_vs_plain": max(rel_bf16),
            "launches": dict(_build.LAUNCHES),
            "sites": dict(_build.SITE_LAUNCHES)}
    log(json.dumps(res4))
    if not max(rel4) <= SERVE_FP32_TOL:
        raise SystemExit(f"chip_smoke: {name4}: logits disagree with the "
                         f"plain path: rel L2 {max(rel4)}")
    if not max(rel_bf16) > SERVE_FP32_TOL:
        raise SystemExit(f"chip_smoke: {name4}: the float32 tolerance does "
                         "not separate a bf16 computation")
    del got4, plain4, bf16_4, params4, model4

    pats = {"K4 mma": "flash_attention_mma_kernel",
            "K4 decode": "flash_decode_",
            "K4 f32": "flash_attention_kernel",
            "K5 wkv_chunked": "wkv_chunked_kernel"}
    prof = profile_serving(model, params, prompts, pats)
    log(json.dumps({"profile": f"{arch} full depth", **prof}))
    res["profile"] = prof
    del params, model, got, rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phases_11_to_13(card, graphs, kell, lp, traffic, het, figures, topo512,
                    timed, runs) -> None:
    """Phases 11-13 in order, each with its wall on the host clock."""
    # phase 11: the streamed ELL closure at scale (K3 route l2)
    t0 = time.perf_counter()
    probe = phase_scale_probe(graphs, kell, runs)
    timed["ell_relax_round"]["shapes"]["l2 streamed"] = probe["k3"]
    log(f"{card}: phase 11 scale probe N={PROBE_N} "
        f"{probe['b']['wall_s']:.2f} s, peak device "
        f"{probe['b']['peak_device_bytes'] / 2**20:.1f} MiB (phase wall "
        f"{time.perf_counter() - t0:.1f} s)")

    # phase 12: adversarial traffic (K1 on two_cluster, K3 slab at N=512)
    t0 = time.perf_counter()
    adv = phase_adversarial(graphs, lp, traffic, topo512, runs)
    log(f"{card}: phase 12 adversarial two_cluster "
        f"{adv['a']['instances_per_s']:.2f} instances/s, RRG(512,16) "
        f"{adv['b']['instances_per_s']:.2f} instances/s (phase wall "
        f"{time.perf_counter() - t0:.1f} s)")

    # phase 13: the design layer and Fig. 11's designed column (K1)
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import vl2
    t0 = time.perf_counter()
    designed = phase_design(het, vl2, figures, lp, traffic, engine_mod, runs)
    log(f"{card}: phase 13 design vl2 {designed['vl2']['wall_s']:.1f} s, "
        f"two_class {designed['two_class']['wall_s']:.1f} s, fig11 "
        f"{designed['fig11']['wall_s']:.1f} s (phase wall "
        f"{time.perf_counter() - t0:.1f} s)")


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from repro_torch.core import bounds, get_engine, graphs, lp, traffic
    from repro_torch.core import apsp as apsp_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell as kell
    from repro_torch.kernels import fw as kfw
    from repro_torch.kernels import minplus as kmin

    # phase 1: setup
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    _build.load()
    log(json.dumps({"build_s": time.perf_counter() - t0,
                    "nvcc_s": _build.build_seconds(),
                    "library": str(_build.BUILD_DIR)}))
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" (CUDA {torch.version.cuda})")

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    timed = phase_kernels(graphs, kmin, kfw, kell, apsp_mod)
    log(f"phase 2 (kernels) wall {time.perf_counter() - t0:.1f} s")

    runs: list[dict] = []   # each path's own launch counts

    # phase 3: main path, sparse, the paper's scale
    topos, dems = instances(graphs, traffic, 512, 16, 8, range(20))
    eng = get_engine("dual", tol=1e-4)
    ubs = run_path("phase 3 dual auto->ell-bf RRG(512,16) x20", eng,
                   topos, dems, runs, ["ell_relax_round"])
    all_on_route(runs[-1], "ell_relax_round", "slab")
    flows = float(np.mean([d.sum() for d in dems]))
    thm1 = bounds.throughput_upper_bound(512, 16, flows)
    log(json.dumps({"ub_mean": float(ubs.mean()), "theorem1": thm1,
                    "ub_over_theorem1": float(ubs.mean() / thm1),
                    "flows_mean": flows}))
    # where a descent step's time goes at this shape (10 profiled steps)
    log(json.dumps({"profile": "phase 3 shape, 10 steps",
                    **profile_steps(get_engine("dual", iters=10), topos,
                                    dems)}))

    # phase 4: dense (blocked-fw) and dual-pallas
    dtopos, ddems = instances(graphs, traffic, 512, 48, 16, range(4))
    run_path("phase 4 dual auto->blocked-fw RRG(512,48) x4",
             get_engine("dual", iters=200), dtopos, ddems, runs,
             ["minplus_acc", "fw_pivot"])
    if runs[-1]["launches"]["fw_pivot"] != 4 * runs[-1]["steps"]:
        raise SystemExit("chip_smoke: blocked-fw at N=512 did not launch K2 "
                         f"4 times a step: {runs[-1]}")
    log(json.dumps({"profile": "phase 4 blocked-fw shape, 10 steps",
                    **profile_steps(get_engine("dual", iters=10), dtopos,
                                    ddems)}))
    pal = run_path("phase 4 dual-pallas RRG(512,16) x4",
                   get_engine("dual-pallas", iters=200), topos[:4],
                   dems[:4], runs, ["minplus_acc"])
    ell = run_path("phase 4 dual ell-bf RRG(512,16) x4",
                   get_engine("dual", iters=200, backend="ell-bf"),
                   topos[:4], dems[:4], runs, ["ell_relax_round"])
    all_on_route(runs[-1], "ell_relax_round", "slab")
    rel = np.abs(pal / ell - 1)
    log(json.dumps({"dual_pallas_vs_ell_bf_rel": rel.tolist()}))
    if not rel.max() <= 1e-3:
        raise SystemExit("chip_smoke: dual-pallas and ell-bf disagree")

    # phase 5: oracle at the Fig. 1 point, and the card against the CPU
    otopos, odems = instances(graphs, traffic, 40, 10, 5, range(3))
    card_ub = np.array([r.throughput for r in get_engine(
        "dual", iters=800).solve_batch(otopos, odems)])
    cpu_ub = np.array([r.throughput for r in get_engine(
        "dual", iters=800, device="cpu").solve_batch(otopos, odems)])
    exact = np.array([lp.max_concurrent_flow(t, d, want_flows=False)
                      .throughput for t, d in zip(otopos, odems)])
    log(json.dumps({"theta_exact": exact.tolist(), "ub_card": card_ub.tolist(),
                    "ub_cpu": cpu_ub.tolist()}))
    if not np.all((exact <= card_ub * (1 + 1e-6))
                  & (card_ub <= 1.05 * exact)):
        raise SystemExit("chip_smoke: dual ub outside [theta, 1.05 theta]")
    if not np.all(np.abs(card_ub / cpu_ub - 1) <= 1e-3):
        raise SystemExit("chip_smoke: card and CPU dual bounds disagree")

    # phases 6-8: float32 products in full float32 (the float32 K4 row, the
    # 4-layer check and the float32 plain path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 6: the LM kernels against their plain versions
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import wkv as kwkv
    t0 = time.perf_counter()
    lm_timed = phase_lm_kernels(kfa, kwkv)
    log(f"phase 6 (LM kernels) wall {time.perf_counter() - t0:.1f} s")

    # phases 7-8: the LM serving path at full width and depth
    served = {}
    for arch, kernel, seed in (("minitron-4b", "flash_attention", 0),
                               ("rwkv6-7b", "wkv_chunked", 1)):
        t0 = time.perf_counter()
        served[arch] = phase_serve(arch, kernel, runs, seed)
        log(f"{card}: {arch} prefill "
            f"{served[arch]['prefill_tok_per_s']:.1f} tok/s, decode "
            f"{served[arch]['decode_tok_per_s']:.1f} tok/s "
            f"(phase wall {time.perf_counter() - t0:.1f} s)")

    # phase 9: the certified path (brackets) at the Fig. 1 point and at
    # phase 3's full size
    t0 = time.perf_counter()
    certified = phase_certified(get_engine, bounds, topos, dems, otopos,
                                odems, exact, runs)
    log(f"phase 9 (certified) wall {time.perf_counter() - t0:.1f} s")

    # phase 10: Fig. 5 at paper scale through the figure layer; its HiGHS
    # LPs run in LP_WORKERS processes beside phases 11-13
    import concurrent.futures
    import multiprocessing
    from repro_torch.core import heterogeneous as het
    from repro_torch.core.engine import CertifiedEngine
    from repro_torch.launch import figures
    lp_pool = concurrent.futures.ProcessPoolExecutor(
        LP_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        fig5, held = phase_figure(lp, het, figures, CertifiedEngine, runs,
                                  lp_pool)
        log(f"{card}: phase 10 fig5 paper {fig5['instances_per_s']:.2f} "
            f"instances/s (phase wall {time.perf_counter() - t0:.1f} s)")
        phases_11_to_13(card, graphs, kell, lp, traffic, het, figures,
                        topos[0], timed, runs)
        t0 = time.perf_counter()
        check_figure(fig5, held)
        log(f"phase 10 HiGHS waited {time.perf_counter() - t0:.1f} s")
    finally:
        lp_pool.shutdown(cancel_futures=True)

    # phase 14: summary
    meta = {
        "minplus_acc": ("src/repro_torch/csrc/minplus.cu",
                        "src/repro/kernels/minplus.py:38 _minplus_kernel "
                        "(+ fw.py:78/82/86 row/col/outer panels)"),
        "fw_pivot": ("src/repro_torch/csrc/fw_pivot.cu",
                     "src/repro/kernels/fw.py:74 _pivot_kernel"),
        "ell_relax_round": ("src/repro_torch/csrc/ell.cu",
                            "src/repro/kernels/ell.py:103 "
                            "_relax_round_kernel"),
    }
    meta.update({
        "flash_attention": (K4_SOURCES["mma"],
                            "src/repro/kernels/flash_attention.py:114 "
                            "flash_attention_pallas (_flash_kernel :32)"),
        "wkv_chunked": ("src/repro_torch/csrc/wkv.cu",
                        "src/repro/kernels/wkv.py:96 wkv_chunked_pallas "
                        "(_wkv_kernel :39)"),
    })
    timed["flash_attention"] = lm_timed["flash_attention/prefill"]
    timed["wkv_chunked"] = lm_timed["wkv_chunked/heads T1000"]
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timed[name]
        paths = []
        for run in runs:
            n = run["launches"][name]
            if n == 0:
                continue
            run_entry = {"path": run["path"], "launches": n,
                         "steps": run["steps"],
                         "launches_per_step": (n / run["steps"]
                                               if run["steps"] else None)}
            by_site = {k.split("/", 1)[1]: v for k, v in run["sites"].items()
                       if k.startswith(name + "/")}
            if by_site:
                run_entry["by_site"] = by_site
            paths.append(run_entry)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[0]["launches"],
            "launches_per_step": paths[0]["launches_per_step"],
            "launches_path": paths[0]["path"], "paths": paths,
            "max_abs_err": t["max_abs_err"], "exact": t.get("exact", False),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_kind"],
            "library_ms": t.get("library_ms"), "shape": t.get("shape"),
            "card": card}
        entry.update({k: t[k] for k in ("lane_bound_ms", "cold_ms") if k in t})
        if name == "ell_relax_round":
            entry["k3_route"] = t["route"]
            entry["shapes"] = t["shapes"]
        if name in ("flash_attention", "wkv_chunked"):
            entry["tolerance"] = t["tolerance"]
            entry["shapes"] = {k.split("/", 1)[1]: {
                f: v for f, v in row.items() if f in (
                    "shape", "route", "source", "ms", "call_ms", "plain_ms",
                    "library_ms", "cuda_core_ms", "bound_ms", "bound_kind",
                    "max_abs_err")}
                for k, row in lm_timed.items() if k.startswith(name + "/")}
        kernels.append(entry)
    log(json.dumps({"serving": {
        arch: {k: r[k] for k in ("prefill_tok_per_s", "decode_tok_per_s",
                                 "prefill_s", "decode_s", "peak_gb")}
        for arch, r in served.items()}, "card": card}))
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
