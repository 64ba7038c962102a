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
   L=1024 bf16: "mma"; the float32 prefill: route "f32"; recurrentgemma-2b's
   shapes at D=256, 10/1 heads: L=3000 with window 2048 ("mma"), decode
   over a 2048 ring ("decode"), float32 L=1000 and L=3000 with the window
   ("f32"); musicgen-medium's 24/24 heads at D=64 (g=1), granite-moe-3b's
   24/8 at D=64 and qwen2-vl-7b's 28/4 at D=128 (g=7), each a prefill
   ("mma") and a decode step ("decode"); and, untimed, the float32 shapes
   of the 4-layer checks of phases 7 and 16 and phase 17's L=1024 shapes
   that the timed rows miss) and K5
   ``wkv_chunked`` (BH=512, n=64, T=1000 and 1024, with and without s0,
   and the model's [8, 1000, 64, 64] projections as [B, H, T, n] views;
   untimed at T=1024, phase 17's)
   against their plain versions on the card, within stated tolerances;
   device times (calls of over 1e10 flops in batches of 10) beside the
   bound and, for K4, beside
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
   at 3 runs a point of the paper's 10, so that phases 11-13 fit (3
   configurations x 6 biases x 3 runs = 54 instances of 40-60 switches,
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
13. the design layer — (a) ``design.optimize`` at a cut of
   ``benchmarks/design_bench.py``'s paper budget (2 rounds of its 3, fleet
   6 of 8, elite 3, 2 runs, ``DualEngine(iters=250, tol=1e-3)``, K1) on
   ``VL2Space(VL2Spec(6, 6, 20))`` and the two-class pool (10 x 18 + 20
   x 6 ports, 90 servers, ``robust`` at 1 adversarial round of 2
   candidates, the default's 2 of 4): best lb >= the recipe's, 1 +
   rounds search executes on one compile key; (b)
   ``launch.figures.fig11`` at d_a = d_i = 4 (``FIG11_D``), 5 runs, HiGHS
   as the criterion (its LPs in worker processes), then the designer's search
   at the recipe's ToR count again: its pick's certified lb >= the
   recipe's, and designed ToRs >= rewired ToRs exactly when the pick
   holds the figure's 5 held-out permutations under HiGHS;
14. routing-restricted throughput — (a) ``benchmarks/routing_bench.py``'s
   families (RRG(24, 4), two-cluster [8]x10 + [5]x10, VL2(6, 6, 10) with
   8 ToRs; 3 permutation runs each, 400 steps) through the certified,
   ``"ecmp"`` and ``"ksp"`` (k = 8) engines, one execute each on equal
   compile keys (K1): ecmp <= ksp <= certified ub on every lane, HiGHS
   between ksp and ub on each family's first run, one KSP lane under its
   own path LP (or the ECMP floor), the gaps printed; (b) ECMP on 8 of
   phase 3's instances at tol 1e-4 (K3, every launch on route "slab"):
   0 < lb <= ub <= Theorem 1, the hop at which the fixed point repeats,
   wall, instances/s, peak device memory; (c) KSP on 4 RRG(128, 8), 4
   servers a switch: the path tensor's host seconds and bytes, the MW
   loop's ms a step, the loads of fixed logits bit-equal to the CPU's;
15. the lifecycle layer — (a) ``degradation_surface`` at
   ``benchmarks/lifecycle_bench.py``'s paper scale (RRG(40, 6) and the
   two-cluster 20 + 20 at r = 6, 3 servers a switch; rewired VL2(6, 4,
   4) with 8 ToRs; 5 fractions x 30 trials x 3 failure kinds; certified
   engine, 300 steps, tol 1e-3: K1): 3 executes, 2 refills, <= 4 compile
   keys, lb <= ub on every trial, lb <= HiGHS θ <= ub on the first trial
   of each family x kind at fraction 0.2 (LPs in phase 10's workers);
   (b) ``plan_expansion`` at the benchmark's block (rewired VL2(4, 2, 4)
   with 4 ToRs, 2 steps of two 4-port switches, budget 3, 2 rounds of 4):
   a monotone certified lb, recabling within the budget at every step;
16. the moe, vlm, audio and hybrid families served at full width and depth
   through the port's entry points, 8 requests and 16 greedy tokens each:
   (a) granite-moe-3b-a800m, 8 x 1000 tokens; (b) qwen2-vl-7b, 256 seeded
   patch embeddings [8, 256, 1176] and 744 text tokens with M-RoPE
   positions, through ``make_prefill_step``/``make_decode_step``; (c)
   musicgen-medium, 8 x 1000; (d) recurrentgemma-2b, 8 x 3000 (past its
   2048-key window).  Every picked token's logits against the plain path
   and the float32 plain path as in phase 7 (the moe family's plain path
   runs the same prefill and steps, since its routing groups depend on
   the call's shape); every attention layer's K4 launch on route "mma" at
   the prefill and "decode" at each step (32, 28, 48 and 8 attention
   layers), no plain attention on the card; the moe family's routings
   that differ from the plain path (printed only; read in an untimed
   replay of the served prefill and steps); the 4-layer float32
   check; a profiled prefill and decode step of the moe and the hybrid;
17. training — (a) K4b ``flash_attention_bwd`` at the train shapes of
   minitron-4b ([8,1024,24/8,128] bf16), musicgen-medium ([8,1024,24/24,64]
   bf16) and recurrentgemma-2b ([8,3000,10/1,256] bf16, window 2048), in
   float32 at minitron-4b's and recurrentgemma-2b's and on a ragged case
   (Lq != Lk, lk_valid < Lk, a window), and untimed on the ragged case in
   bf16 and at a padded head dim (D = 96); bf16 on route "mma", float32 on
   "f32" (by the site counter), each twice with the same bits, each route
   also against the plain version of its own rounding (bf16 hi/lo,
   3xTF32); and K5b ``wkv_chunked_bwd`` at [8, T, 64, 64] float32 as [B,
   H, T, n] views (T = 1024 and 1000, s0 and a final state cotangent),
   twice with the same bits; each against its plain backward on the card
   and timed beside its bound (K4b also beside SDPA's backward); (b)
   musicgen-medium
   trained at full width and depth through
   ``repro_torch.launch.train.main`` (6 steps of 8 x 1024 tokens): finite
   losses and grad norms, every leaf moved, 48 K4 launches a step plus 48
   recomputed under remat, 48 K4b calls a step, no plain attention or
   backward, every K4b call on route "mma", train tokens/s over steps 3-6
   and peak device memory; (c)
   minitron-4b (8 x 1024), rwkv6-7b (8 x 1024) and recurrentgemma-2b (8 x
   3000) at full width and 4 layers: the first step's loss and every leaf's
   gradient against the plain path (plain forward and backward) and the
   float32 plain path (phase 7's relative rule), every leaf non-zero; in
   float32 with TF32 off every leaf within a tight tolerance that a
   bf16-rounding attention or WKV is shown to miss; one profiled train step
   each (device ms of GEMMs, K4/K5, K4b/K5b, the optimizer, the rest; idle
   share);
18. the sharded train step — (a) a one-rank NCCL world and a (1, 1, 1)
   ("pod", "data", "model") ``DeviceMesh`` on the card: musicgen-medium at
   full width, 4 layers, float32, 8 x 1024 (K4 and K4b on route "f32" at
   D = 64), one ``make_train_step`` with the shard function,
   ``state_specs`` placements and ``--pod-compress`` at npod 1, against
   the one-process step on the same parameters (loss, grad norm, every
   leaf and the error-feedback buffer after one AdamW step, the A8.2
   float32 rules; whether the bits are equal is printed); 8 K4 and 4 K4b
   launches, all on route "f32".  (b), two ranks of the one card over
   gloo (NCCL takes one rank a GPU), is left out: gloo's all-gather of
   CUDA tensors through the functional collectives DTensor issues crashes
   the ranks on the card's torch (``tools/gloo_cuda_probe.py``);
19. the dry run on the card — rank 0 of a fake 256-rank world
   (``launch.dryrun.fake_world``: its collectives move no data) with real
   CUDA tensors: minitron-4b ``prefill_32k`` on the (16, 16) production
   mesh at full depth, only rank 0's shards resident; 24 q heads over a
   model axis of 16, so the uneven-heads path runs and K4 takes rank 0's
   2 heads: one launch a layer on route "mma", no plain kernel; no value
   of the step is checked (the collectives move no data, so what they
   gather is whatever memory held), but the first layer's K4 call is run
   again on its own q, k, v refilled with seeded values (same shapes and
   layout) and held against ``flash_attention_plain`` under
   ``K4_BF16_TOL``; device memory after placement and the step's peak beside
   ``analytic_memory``'s total and the CPU dry run's bytes per chip (its
   probes traced here on fake tensors), the step's seconds and
   ``model_flops / chips`` over them as a share of 989 TFLOP/s; and
   ``analytic_memory`` of phase 17b's train shape beside 17b's peak;
20. the planner's last contracts — (a) ``get_engine("dual-pallas",
   iters=100, devices=1)`` twice on 4 of phase 3's instances (K1 at [4,
   512, 512]): the second solve adds no ``dual.*`` program
   (``compile_cache_sizes``) and gives the first's bits, K1 launched in
   both, and this process built the kernel library or found it built
   (``aot.compiles`` + ``aot.hits`` = 1); (b) this script again as a warm
   process (``--aot-warm``) on the same seeded instances: no nvcc
   (``build_seconds()`` None, ``aot.compiles`` 0, ``aot.hits`` 1), bounds
   bit-equal to (a)'s, its wall beside (a)'s; (c) a ``BatchPlan.refill`` of
   (a)'s plan with 4 other phase-3 instances adds no ``dual.*`` program;
   (d) ``devices=None`` is one card (``get_engine("dual")``'s
   ``last_plan``) and an explicit ``devices=torch.cuda.device_count()``
   resolves to the count;
21. summary — one JSON line with every kernel, then the device line last.

Phase 2 also closes K2 tiles wider than 128 (t = 129, 200, 256: padded
and closed blocked) and ``fw_apsp_blocked(w, t=256)``, bit-equal to plain
Floyd-Warshall.

Launch counts are reset just before each path's run (phase 3's, each of
phase 4's three, each ``generate`` of phases 7-8, phase 9a's and 9b's card
solves, phase 10's figure, phase 11's two streamed closures, each search
of phases 12-13, phase 13's figure, each engine's pile of phase 14 and
each call of phase 15, phase 17b's run, each gradient of phase 17c,
phase 18a's sharded step, phase 19's step and each solve of phase 20)
and read just after it; a kernel
of a path that was not launched fails the run.  The summary reports every
path's own counts, never a sum over runs: ``launches`` of a kernel is from the first path
that needs it (phase 3 for K3, the blocked-fw run for K1 and K2), and
``paths`` lists each run that launched it, with K1's launches in the
blocked-fw run split by panel (row, column, outer) and K4's split into
the full-sequence (prefill) and decode sites and by route (phase 16's
four families among them).  K4's
``launches`` are from minitron-4b's full-depth generate, K5's from
rwkv6-7b's; every K4 launch of the bf16 prefill must take route "mma" and
every one of a decode step route "decode".  K4b's ``launches`` are from
phase 17b's musicgen-medium training (one a call, three kernels), K5b's
from phase 17c's rwkv6-7b gradient (one a call, three kernels).
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
TF32_FLOP_PER_S = 495e12     # TF32 tensor cores, dense (H100 SXM)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
TIMING_RUNS = 30
# phase 6 times its calls of over PHASE17_HEAVY_FLOPS (the prefill rows and
# K5 at T = 1000) in batches of 10 (0.2-34 ms a call, so a batch lasts 2 ms
# or more); batches of 30 took the phase from 24.9 s to 52.3 s on an H100
# (tools/smoke_phases.py 6 6:heavy=30; ROADMAP S1)
PHASE6_HEAVY_RUNS = 10
# Fig. 5 runs a point in phase 10: 3 of the paper's 10, so that phases 11-13
# fit the script's time (ROADMAP S1); and the processes its HiGHS LPs take
FIG5_RUNS = 3
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


def time_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Device milliseconds of one call: after warm-up, ``runs`` calls
    are queued behind a device sleep that outlasts their launching, so the
    CUDA events around them time the device alone (median of 3 batches).
    ``fn`` may be a list of calls, taken in turn (inputs that must come
    from device memory, not from the L2 cache)."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(runs):
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
        for i in range(runs):
            fns[i % len(fns)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / runs)
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
# benchmarks/design_bench.py's ranking engine and a cut of its paper budget
# (rounds=3, fleet=8, elite=3, runs=2): 2 rounds of fleet 6, so that the
# script stays inside its time on a slow host (ROADMAP S1)
DESIGN_BUDGET = dict(rounds=2, fleet=6, elite=3, runs=2)
DESIGN_ITERS = 250
# the two-class space's worst-case re-ranking: one adversarial round of 2
# candidates (the optimizer's default: 2 rounds of 4), for the script's time
# (ROADMAP S1)
DESIGN_ROBUST = {"rounds": 1, "candidates": 2}
# Fig. 11's designed column at d_a = d_i = 4, the smallest size of the
# paper's small scale: at d = 10 (its paper scale) the column took 196-221 s,
# at d = 8 118 s and at d = 6 59-96 s on an H100, time that phases 14-17 need
FIG11_D = 4
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
    Every candidate hose-feasible, 1 + rounds executes, one compile key;
    wall, instances/s and the device's idle share over one profiled round."""
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
    budget on its two spaces (the two-class one ``robust``, one
    adversarial round, ``DESIGN_ROBUST``):
    best lb >= the recipe's, 1 + rounds search executes, one compile key
    for the search rounds; (b) Fig. 11's designed column at d_a = d_i =
    FIG11_D, 5 runs, with HiGHS as the criterion (its LPs in worker
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
         ("swap", "servers", "bias"), DESIGN_ROBUST))
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
        name = (f"phase 13b fig11 d_a=d_i={FIG11_D}, 5 runs, designed "
                "column")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rows = figures.fig11(sizes=[(FIG11_D, FIG11_D)], runs=5,
                             engine=highs, device="cuda")
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
        spec = vl2.VL2Spec(d_a=FIG11_D, d_i=FIG11_D, servers_per_tor=20)
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
# routing-restricted throughput and the lifecycle layer (phases 14-15)
# ---------------------------------------------------------------------------

# benchmarks/routing_bench.py's paper budget: runs a family, steps, paths
ROUTING_RUNS, ROUTING_ITERS, ROUTING_K = 3, 400, 8
# benchmarks/lifecycle_bench.py's paper scale
LIFE_FRACTIONS = (0.05, 0.1, 0.2, 0.3, 0.45)
LIFE_TRIALS = 30
LIFE_ITERS, LIFE_TOL = 300, 1e-3
# the lifecycle benchmark's expansion block cut to 2 growth steps (of 3) and
# fleets of 4 (of 6), for the script's time (ROADMAP S1)
GROWTH = dict(growth=[[4, 4]] * 2, max_recabled_links=3, rounds=2, fleet=4,
              elite=2, runs=2, seed=0)


def phase_routing(graphs, traffic, vl2, lp, bounds, get_engine, topos512,
                  dems512, runs) -> dict:
    """Phase 14: (a) ``benchmarks/routing_bench.py``'s families (RRG(24,
    4), two-cluster [8]x10 + [5]x10, VL2(6, 6, 10) with 8 ToRs), 3
    permutation runs each, 400 steps, through the certified, ECMP and
    KSP(8) engines, one execute each on equal compile keys (K1): the
    lattice ecmp <= ksp <= certified ub on every lane, HiGHS between ksp
    and ub on each family's first run, one KSP lane under its own path
    LP; (b) ECMP on 8 of phase 3's RRG(512, 16) at tol 1e-4 (K3, every
    launch ``slab``): 0 < lb <= ub <= Theorem 1, the fixed point's hops,
    wall, instances/s and peak device memory; (c) KSP(8) on 4 RRG(128, 8),
    4 servers a switch: the path tensor's host seconds and bytes, the MW
    loop's ms a step, and the loads of fixed logits bit-equal to the
    CPU's."""
    from repro_torch.core import routing
    from repro_torch.kernels import paths as kpaths
    out = {}
    fams = {
        "rrg": graphs.random_regular_graph(24, 4, seed=0, servers=4),
        "two_cluster": graphs.biased_two_cluster_graph(
            [8] * 10, [5] * 10, cross_bias=0.5, seed=1, servers=3),
        "vl2": vl2.vl2_topology(
            vl2.VL2Spec(d_a=6, d_i=6, servers_per_tor=10), n_tor=8)}
    topos, dems = [], []
    for fi, topo in enumerate(fams.values()):
        for r in range(ROUTING_RUNS):
            topos.append(topo)
            dems.append(traffic.make("permutation", topo.servers,
                                     seed=100 * fi + r))
    engines = {"certified": get_engine("certified", iters=ROUTING_ITERS),
               "ecmp": get_engine("ecmp", iters=ROUTING_ITERS),
               "ksp": get_engine("ksp", iters=ROUTING_ITERS, k=ROUTING_K)}
    res, walls = {}, {}
    for key, eng in engines.items():
        t0 = time.perf_counter()
        run_path(f"phase 14a {key} routing families x{len(topos)}", eng,
                 topos, dems, runs, ["minplus_acc"])
        walls[key] = time.perf_counter() - t0
        res[key] = runs[-1]["results"]
    keys = {k: e.last_plan.compile_keys for k, e in engines.items()}
    if len(set(keys.values())) != 1 or \
            any(e.last_plan.chunks != 1 for e in engines.values()):
        raise SystemExit(f"chip_smoke: phase 14a plans differ: {keys}")
    ecmp = np.array([r.throughput for r in res["ecmp"]])
    ksp = np.array([r.throughput for r in res["ksp"]])
    lb = np.array([r.meta["lb"] for r in res["certified"]])
    ub = np.array([r.meta["ub"] for r in res["certified"]])
    if not np.all((0 < ecmp) & (ecmp <= ksp) & (ksp <= ub * (1 + 1e-6))
                  & (lb <= ub)):
        raise SystemExit(f"chip_smoke: phase 14a lattice broken: ecmp "
                         f"{ecmp}, ksp {ksp}, ub {ub}")
    first = [fi * ROUTING_RUNS for fi in range(len(fams))]
    theta = np.array([lp.max_concurrent_flow(topos[i].cap, dems[i],
                                             want_flows=False).throughput
                      for i in first])
    if not np.all((ksp[first] <= theta * (1 + 1e-6))
                  & (theta <= ub[first] * (1 + 1e-6))):
        raise SystemExit(f"chip_smoke: phase 14a HiGHS {theta} outside "
                         f"[ksp {ksp[first]}, ub {ub[first]}]")
    max_hops = routing._resolve_max_hops(
        res["ksp"][0].meta["padded_n"], None)
    path_lp = routing.path_lp_throughput(
        topos[0].cap, dems[0],
        kpaths.k_shortest_paths(topos[0].cap, ROUTING_K, max_hops))
    # MW never beats its own path LP; the ECMP floor may
    if not ksp[0] <= max(path_lp, ecmp[0]) * (1 + 2e-3):
        raise SystemExit(f"chip_smoke: phase 14a ksp {ksp[0]} above its "
                         f"path LP {path_lp}")
    gaps = {}
    for fi, name in enumerate(fams):
        lanes = slice(fi * ROUTING_RUNS, (fi + 1) * ROUTING_RUNS)
        gaps[name] = {
            "ecmp_gap_pct": max(r.meta["ideal_gap_pct"]
                                for r in res["ecmp"][lanes]),
            "ksp_gap_pct": max(r.meta["ideal_gap_pct"]
                               for r in res["ksp"][lanes]),
            "ecmp_lb": ecmp[lanes].tolist(), "ksp_lb": ksp[lanes].tolist(),
            "certified_ub": ub[lanes].tolist(),
            "theta_run0": float(theta[fi])}
    out["a"] = {"instances": len(topos), "walls_s": walls,
                "compile_keys": keys["ksp"], "families": gaps,
                "path_lp_lane0": path_lp, "ksp_lane0": float(ksp[0]),
                "ecmp_hops": [int(r.meta["ecmp_hops"])
                              for r in res["ecmp"]]}
    log(json.dumps({"phase": "14a", **out["a"]}, default=str))

    # (b) ECMP at the paper's scale: K3 slab for the unit-hop APSP
    topos, dems = topos512[:8], dems512[:8]
    eng = get_engine("ecmp", tol=1e-4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_path("phase 14b ecmp auto->ell-bf RRG(512,16) x8", eng, topos, dems,
             runs, ["ell_relax_round"])
    wall = time.perf_counter() - t0
    all_on_route(runs[-1], "ell_relax_round", "slab")
    res_b = runs[-1]["results"]
    lbs = np.array([r.throughput for r in res_b])
    ubs = np.array([r.meta["ub"] for r in res_b])
    thm1 = np.array([bounds.throughput_upper_bound(512, 16, float(d.sum()))
                     for d in dems])
    if not np.all((0 < lbs) & (lbs <= ubs) & (ubs <= thm1 * (1 + 1e-6))):
        raise SystemExit(f"chip_smoke: phase 14b not 0 < ecmp lb <= ub <= "
                         f"Theorem 1: {lbs} {ubs} {thm1}")
    out["b"] = {"instances": len(topos), "wall_s": wall,
                "instances_per_s": len(topos) / wall,
                "ecmp_hops": sorted({int(r.meta["ecmp_hops"])
                                     for r in res_b}),
                "lb": lbs.tolist(), "ub": ubs.tolist(),
                "ideal_gap_pct": [r.meta["ideal_gap_pct"] for r in res_b],
                "theorem1": thm1.tolist(),
                "descent_iterations_max": int(max(r.meta["iterations"]
                                                  for r in res_b)),
                "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log(json.dumps({"phase": "14b", **out["b"]}))

    # (c) KSP at N = 128: the host's path tensor, the MW loop, the loads
    topos, dems = instances(graphs, traffic, 128, 8, 4, range(4))
    caps = np.stack([t.cap for t in topos]).astype(np.float32)
    dem_np = np.stack(dems).astype(np.float32)
    nv = np.full(4, 128, np.int32)
    t0 = time.perf_counter()
    paths = routing._paths_tensor(caps, nv, ROUTING_K,
                                  routing._resolve_max_hops(128, None))
    paths_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = routing._path_tables(paths, 128, "cuda")
    tables_s = time.perf_counter() - t0
    run_path("phase 14c ksp RRG(128,8) x4", get_engine(
        "ksp", iters=ROUTING_ITERS, k=ROUTING_K), topos, dems, runs,
        ["minplus_acc"])
    res_c = runs[-1]["results"]
    demv = torch.as_tensor(dem_np.reshape(4, -1), device="cuda")
    emask = torch.as_tensor(caps.reshape(4, -1) > 0, device="cuda")
    scap = torch.where(emask, torch.as_tensor(caps.reshape(4, -1),
                                              device="cuda"), 1.0)
    steps = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    routing._mw_descend(tables, demv, emask, scap, iters=steps, lr=0.08,
                        tol=0.0, check_every=25)
    torch.cuda.synchronize()
    mw_ms = (time.perf_counter() - t0) * 1e3 / steps
    z = torch.from_numpy(np.random.default_rng(0).normal(
        0, 2, paths.shape[:3]).astype(np.float32))
    loads = {}
    for dev in ("cuda", "cpu"):
        tb = tables if dev == "cuda" else routing._path_tables(paths, 128,
                                                                "cpu")
        wgt, _ = routing._path_weights(z.to(dev), tb, demv.to(dev))
        loads[dev] = routing._edge_loads(wgt, tb).cpu()
    if not torch.equal(loads["cuda"], loads["cpu"]):
        diff = float((loads["cuda"] - loads["cpu"]).abs().max())
        raise SystemExit("chip_smoke: phase 14c KSP loads differ from the "
                         f"CPU's: max abs {diff}")
    lbs = np.array([r.throughput for r in res_c])
    ubs = np.array([r.meta["ub"] for r in res_c])
    if not np.all((0 < lbs) & (lbs <= ubs)):
        raise SystemExit(f"chip_smoke: phase 14c not 0 < lb <= ub: {lbs} "
                         f"{ubs}")
    out["c"] = {"instances": 4, "paths_host_s": paths_s,
                "tables_s": tables_s,
                "paths_bytes": int(paths.nbytes),
                "tables_bytes": int(sum(
                    t.numel() * t.element_size() for t in (
                        tables.valid, tables.hop_edge, tables.edge_paths,
                        tables.edge_pos))),
                "edge_list_width": int(tables.edge_paths.shape[2]),
                "mw_ms_per_step": mw_ms, "wall_s": runs[-1]["wall_s"],
                "lb": lbs.tolist(), "ub": ubs.tolist(),
                "ideal_gap_pct": [r.meta["ideal_gap_pct"] for r in res_c],
                "loads_equal_cpu": True}
    log(json.dumps({"phase": "14c", **out["c"]}))
    return out


def phase_lifecycle(graphs, vl2, lp, CertifiedEngine, runs, pool) -> dict:
    """Phase 15: (a) ``degradation_surface`` at
    ``benchmarks/lifecycle_bench.py``'s paper scale (RRG(40, 6) and the
    two-cluster 20 + 20 at r = 6, 3 servers a switch; rewired VL2(6, 4, 4)
    with 8 ToRs; 5 fractions x 30 trials x 3 kinds; certified engine, 300
    steps, tol 1e-3: K1): 3 executes, 2 refills, <= 4 compile keys, lb <=
    ub on every trial, lb <= HiGHS θ <= ub on each family x kind's first
    trial at fraction 0.2 (LPs in ``pool``); (b) ``plan_expansion`` at
    the benchmark's block (rewired VL2(4, 2, 4) with 4 ToRs, 2 steps of
    two 4-port switches, budget 3): a monotone lb, recabling within the
    budget at every step."""
    from repro_torch import lifecycle
    from repro_torch.core.plan import BatchPlan
    from repro_torch.kernels import _build

    class KeptPlan(BatchPlan):
        def execute(self, *args, **kw):
            solved = super().execute(*args, **kw)
            self.kept.append((self.caps, self.dems, solved))
            return solved

    class Kept(CertifiedEngine):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.kept = []     # (caps, dems, results) of every execute

        def plan(self, topos, dems):
            plan = KeptPlan.__new__(KeptPlan)
            plan.__dict__.update(super().plan(topos, dems).__dict__)
            plan.kept = self.kept
            return plan

    out = {}
    n, r, sp = 40, 6, 3
    fams = {"rrg": graphs.random_regular_graph(n, r, seed=0, servers=sp),
            "two_cluster": graphs.biased_two_cluster_graph(
                [r] * (n // 2), [r] * (n // 2), cross_bias=0.5, seed=0,
                servers=sp),
            "vl2": vl2.rewired_vl2_topology(
                vl2.VL2Spec(d_a=6, d_i=4, servers_per_tor=4), 8, seed=0)}
    eng = Kept(iters=LIFE_ITERS, tol=LIFE_TOL)
    name = (f"phase 15a degradation {len(fams)} families x 3 kinds x "
            f"{len(LIFE_FRACTIONS)} fractions x {LIFE_TRIALS} trials")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    surf = lifecycle.degradation_surface(
        fams, fractions=LIFE_FRACTIONS, trials=LIFE_TRIALS, engine=eng,
        seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    record_path(name, runs, ["minplus_acc"])
    s = surf.stats
    per_kind = len(fams) * len(LIFE_FRACTIONS) * LIFE_TRIALS
    if s["executes"] != 3 or s["refills"] != 2 or \
            len(s["compile_keys"]) > 4 or len(eng.kept) != 3:
        raise SystemExit(f"chip_smoke: {name}: {s['executes']} executes, "
                         f"{s['refills']} refills, compile keys "
                         f"{s['compile_keys']}")
    lbs = np.array([x.value for _, _, solved in eng.kept for x in solved])
    ubs = np.array([x.meta["ub"] for _, _, solved in eng.kept
                    for x in solved])
    if len(lbs) != 3 * per_kind or not np.all(
            np.isfinite(ubs) & (lbs >= 0) & (lbs <= ubs)):
        raise SystemExit(f"chip_smoke: {name}: lb <= ub fails on a trial")
    sample = [fi * len(LIFE_FRACTIONS) * LIFE_TRIALS
              + LIFE_FRACTIONS.index(0.2) * LIFE_TRIALS
              for fi in range(len(fams))]
    held = [(k, i, caps[i], dems[i], solved[i])
            for k, (caps, dems, solved) in enumerate(eng.kept)
            for i in sample]
    lps = [pool.submit(lp.max_concurrent_flow, c, d, False)
           for _, _, c, d, _ in held]
    theta = np.array([f.result().throughput for f in lps])
    hlb = np.array([h[4].value for h in held])
    hub = np.array([h[4].meta["ub"] for h in held])
    if not np.all((hlb <= theta * (1 + 1e-6))
                  & (theta <= hub * (1 + 1e-6))):
        raise SystemExit(f"chip_smoke: {name}: HiGHS {theta} outside "
                         f"[{hlb}, {hub}]")
    out["a"] = {"instances": 3 * per_kind, "wall_s": wall,
                "instances_per_s": 3 * per_kind / wall,
                "executes": s["executes"], "refills": s["refills"],
                "compile_keys": s["compile_keys"],
                "iterations_max": int(max(x.iterations for _, _, sv in
                                          eng.kept for x in sv)),
                "held_theta": theta.tolist(), "held_lb": hlb.tolist(),
                "held_ub": hub.tolist(),
                "points": [dataclasses.asdict(p) for p in surf.points
                           if p.fraction in (0.05, 0.45)]}
    log(json.dumps({"phase": "15a", **out["a"]}))

    start = vl2.rewired_vl2_topology(
        vl2.VL2Spec(d_a=4, d_i=2, servers_per_tor=4), n_tor=4, seed=0)

    def forbid(t):
        tor = t.labels == 0
        return tor[:, None] & tor[None, :]

    steps = len(GROWTH["growth"])
    name = f"phase 15b expansion VL2(4,2,4) {steps} steps, budget 3"
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    grown = lifecycle.plan_expansion(
        start, engine=CertifiedEngine(iters=LIFE_ITERS, tol=LIFE_TOL),
        new_labels=[2], forbidden_fn=forbid, link_unit=vl2.FABRIC, **GROWTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    record_path(name, runs, ["minplus_acc"])
    lbs = [st.lb for st in grown.steps]
    budget = GROWTH["max_recabled_links"]
    if len(lbs) != steps + 1 or \
            not all(b >= a for a, b in zip(lbs, lbs[1:])) or \
            not all(st.recabled <= budget for st in grown.steps) or \
            not all(0 < st.lb <= st.ub for st in grown.steps):
        raise SystemExit(f"chip_smoke: {name}: lbs {lbs}, recabled "
                         f"{[st.recabled for st in grown.steps]}")
    out["b"] = {"wall_s": wall, "lb": lbs,
                "ub": [st.ub for st in grown.steps],
                "recabled": [st.recabled for st in grown.steps],
                "chose": [st.chose for st in grown.steps],
                "nodes": [st.topo.n for st in grown.steps],
                "growth_gain_pct": 100.0 * (lbs[-1] / lbs[0] - 1),
                "executes": grown.stats["executes"],
                "compile_keys": grown.stats["compile_keys"]}
    log(json.dumps({"phase": "15b", **out["b"]}))
    return out


# ---------------------------------------------------------------------------
# the LM serving path (phases 6-8)
# ---------------------------------------------------------------------------

# K4's output is bf16 on the main path: kernel and plain version compute in
# float32 and round to bf16, so they may differ by one bf16 ulp (<= |x|/128)
K4_BF16_TOL = (1e-3, 8e-3)
# float32 K4 (route "f32"): S = Q K^T and P V on the tensor cores as 3xTF32
# (each operand split into a TF32 big part and the remainder, ~21 bits kept,
# the tensor cores' sums truncating), the softmax in float32; one TF32
# rounding of either product misses this by ~20x, 3xTF32 sits at <= 0.06 of
# it (tests/test_torch_flash_f32.py, CPU)
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


def sdpa_mask(lq: int, lk: int, lk_valid: int, window: int,
              device) -> dict:
    """``scaled_dot_product_attention``'s masking for K4's visibility rule:
    ``is_causal`` when it is plain causal attention, else an explicit
    ``attn_mask`` (a local window among it)."""
    if lk_valid == lk and lq == lk and not window:
        return dict(is_causal=True)
    kpos = torch.arange(lk, device=device)
    qpos = torch.arange(lq, device=device) + (lk_valid - lq)
    mask = (kpos[None, :] < lk_valid) & (kpos[None, :] <= qpos[:, None])
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return dict(attn_mask=mask)


def sdpa_call(q, k, v, lk_valid, window=0):
    """One ``scaled_dot_product_attention`` call on K4's inputs in torch's
    [B, H, L, D] layout (transposed outside the timed call)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = sdpa_mask(q.shape[1], k.shape[1], lk_valid, window, q.device)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **kw)


def visible_pairs(lq: int, valid: int, window: int = 0) -> int:
    """(query, key) pairs a causal call sees: query i at key position
    i + valid - lq sees the keys up to its own, the last ``window`` of
    them when ``window > 0``."""
    off, pairs = valid - lq, 0
    for i in range(lq):
        hi = min(valid, i + off + 1)
        lo = max(0, i + off - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return pairs


def ptxas_report(source: str) -> dict[str, dict]:
    """Registers and spill bytes ``ptxas`` reported for each kernel of the
    library's ``source`` (``-Xptxas -v`` in the build log), by mangled
    name."""
    from repro_torch.kernels import _build
    log_text, head = _build.build_log(), f"== {source}\n"
    if head not in log_text:
        return {}
    text = log_text.split(head, 1)[1].split("\n== ")[0]
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name]["spill_bytes"] = nums[1] + nums[2]
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def own_rounding(kfa, route, got, q, k, v, valid, window, label) -> dict:
    """Route "f32" also against its own rounding
    (``flash_attention_tf32_plain``) under K4_F32_TOL; the fields a row
    records, none on the other routes."""
    if route != "f32":
        return {}
    emu = kfa.flash_attention_tf32_plain(q, k, v, causal=True, lk_valid=valid,
                                         window=window)
    err = close(f"K4 {label} (against flash_attention_tf32_plain)", got, emu,
                K4_F32_TOL)
    return {"own_rounding": "flash_attention_tf32_plain",
            "max_abs_err_vs_own_rounding": err}


def tf32_floor_ms(b: int, hq: int, d: int, pairs: int) -> float:
    """Route "f32"'s 3xTF32 floor: 3 x 4 D tensor-core flops a visible
    (query, key) pair and head at the card's TF32 rate."""
    return 3 * 4.0 * d * pairs * b * hq / TF32_FLOP_PER_S * 1e3


def phase_lm_kernels(kfa, kwkv) -> dict[str, dict]:
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    out = {}
    b = 8
    # route "f32"'s kernels, one a padded head dim: none may spill
    regs = ptxas_report("flash_attention.cu")
    log(json.dumps({"k4_f32_ptxas": regs}))
    if not regs or any(r.get("spill_bytes", 1) for r in regs.values()):
        raise SystemExit(f"chip_smoke: K4 route f32 spills or was not "
                         f"reported: {regs}")
    m128, m256, g1 = (24, 8, 128), (10, 1, 256), (24, 24, 64)
    m64, g7 = (24, 8, 64), (28, 4, 128)
    for key, label, lq, lk, valid, dtype, sets, (hq, hkv, d), window in (
            ("prefill", "prefill [8,1000,24/8,128] bf16 causal", 1000, 1000,
             1000, torch.bfloat16, 1, m128, 0),
            ("decode", "decode [8,1,24/8,128] bf16, cache 1016, lk_valid 1001",
             1, 1016, 1001, torch.bfloat16, 4, m128, 0),
            ("aligned", "aligned [8,1024,24/8,128] bf16 causal", 1024, 1024,
             1024, torch.bfloat16, 1, m128, 0),
            ("prefill_f32", "prefill [8,1000,24/8,128] f32 causal", 1000,
             1000, 1000, torch.float32, 1, m128, 0),
            # recurrentgemma-2b: local window, head dim 256, one KV head
            ("prefill_d256_window", "prefill [8,3000,10/1,256] bf16 causal, "
             "window 2048", 3000, 3000, 3000, torch.bfloat16, 1, m256, 2048),
            ("decode_d256_ring", "decode [8,1,10/1,256] bf16, ring 2048, "
             "lk_valid 2048", 1, 2048, 2048, torch.bfloat16, 4, m256, 0),
            ("prefill_f32_d256", "prefill [8,1000,10/1,256] f32 causal", 1000,
             1000, 1000, torch.float32, 1, m256, 0),
            # recurrentgemma-2b's 4-layer float32 check: the band at L = 3000
            ("prefill_f32_d256_window", "prefill [8,3000,10/1,256] f32 "
             "causal, window 2048", 3000, 3000, 3000, torch.float32, 1, m256,
             2048),
            # musicgen-medium: MHA, one query head a KV head
            ("prefill_g1", "prefill [8,1000,24/24,64] bf16 causal", 1000,
             1000, 1000, torch.bfloat16, 1, g1, 0),
            ("decode_g1", "decode [8,1,24/24,64] bf16, cache 1016, lk_valid "
             "1001", 1, 1016, 1001, torch.bfloat16, 4, g1, 0),
            # granite-moe-3b-a800m: head dim 64, g = 3
            ("prefill_d64", "prefill [8,1000,24/8,64] bf16 causal", 1000,
             1000, 1000, torch.bfloat16, 1, m64, 0),
            ("decode_d64", "decode [8,1,24/8,64] bf16, cache 1016, lk_valid "
             "1001", 1, 1016, 1001, torch.bfloat16, 4, m64, 0),
            # qwen2-vl-7b: g = 7
            ("prefill_g7", "prefill [8,1000,28/4,128] bf16 causal", 1000,
             1000, 1000, torch.bfloat16, 1, g7, 0),
            ("decode_g7", "decode [8,1,28/4,128] bf16, cache 1016, lk_valid "
             "1001", 1, 1016, 1001, torch.bfloat16, 4, g7, 0)):
        # decode: 4 input sets taken in turn (4 x 33 MB of cache > the 50 MB
        # L2; 4 x 17 MB of ring at D = 256), so each timed call reads its
        # keys from device memory as a decode step does
        inputs = [(randn(b, lq, hq, d, dtype=dtype),
                   randn(b, lk, hkv, d, dtype=dtype),
                   randn(b, lk, hkv, d, dtype=dtype)) for _ in range(sets)]
        q, k, v = inputs[0]
        route = kfa.flash_route(dtype, lq, hq // hkv)
        tol = K4_BF16_TOL if dtype == torch.bfloat16 else K4_F32_TOL
        before = _build.SITE_LAUNCHES[f"flash_attention/route:{route}"]
        got = kfa.flash_attention(q, k, v, causal=True, lk_valid=valid,
                                  window=window)
        if _build.SITE_LAUNCHES[f"flash_attention/route:{route}"] != \
                before + 1:
            raise SystemExit(f"chip_smoke: K4 {label} did not take route "
                             f"{route}")
        want = kfa.flash_attention_plain(q, k, v, causal=True,
                                         lk_valid=valid, window=window)
        err = close(f"K4 {label} (route {route})", got, want, tol)
        del want
        own = own_rounding(kfa, route, got, q, k, v, valid, window, label)
        # (query, key) pairs this input needs: causal, aligned to the end,
        # inside the band
        pairs = visible_pairs(lq, valid, window)
        flops = 4.0 * b * hq * d * pairs
        esize = q.element_size()
        nbytes = esize * (2 * b * lq * hq * d + 2 * b * valid * hkv * d)
        bnd, kind = flop_bound_ms(
            flops, BF16_FLOP_PER_S if dtype == torch.bfloat16
            else FP32_FLOP_PER_S, nbytes)

        def each(call):
            return [functools.partial(call, *x) for x in inputs]

        kernel = functools.partial(kfa.flash_attention, causal=True,
                                   lk_valid=valid, window=window)
        plain = functools.partial(kfa.flash_attention_plain, causal=True,
                                  lk_valid=valid, window=window)
        runs = (PHASE6_HEAVY_RUNS if flops > PHASE17_HEAVY_FLOPS
                else TIMING_RUNS)
        row = {"kernel": "flash_attention", "shape": label, "route": route,
               "source": K4_SOURCES[route],
               "ms": time_ms(each(kernel), runs),
               "call_ms": call_ms(lambda: kernel(q, k, v)),
               "plain_ms": time_ms(each(plain), runs),
               "library_ms": time_ms([sdpa_call(*x, valid, window)
                                      for x in inputs], runs),
               "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err,
               "tolerance": tol, **own}
        if route == "f32":
            row["tf32_floor_ms"] = tf32_floor_ms(b, hq, d, pairs)
        log(json.dumps(row))
        out[f"flash_attention/{key}"] = row
        del q, k, v, got, inputs

    # the other shapes that the 4-layer float32 checks of phases 7 and 16
    # give K4 (prefill of the new families at L = 1000, every decode step),
    # and the train shapes of phase 17 that the rows above miss (musicgen-
    # medium's bf16 and minitron-4b's float32 forward at L = 1024): held
    # against the plain version on the same inputs, not timed
    f32, bf16 = torch.float32, torch.bfloat16
    for key, label, lq, lk, valid, dtype, (hq, hkv, d) in (
            ("train_g1", "train [8,1024,24/24,64] bf16 causal", 1024, 1024,
             1024, bf16, g1),
            ("train_f32", "train [8,1024,24/8,128] f32 causal", 1024, 1024,
             1024, f32, m128),
            ("decode_f32", "decode [8,1,24/8,128] f32, cache 1016, lk_valid "
             "1001", 1, 1016, 1001, f32, m128),
            ("prefill_f32_d64", "prefill [8,1000,24/8,64] f32 causal", 1000,
             1000, 1000, f32, m64),
            ("decode_f32_d64", "decode [8,1,24/8,64] f32, cache 1016, "
             "lk_valid 1001", 1, 1016, 1001, f32, m64),
            ("prefill_f32_g7", "prefill [8,1000,28/4,128] f32 causal", 1000,
             1000, 1000, f32, g7),
            ("decode_f32_g7", "decode [8,1,28/4,128] f32, cache 1016, "
             "lk_valid 1001", 1, 1016, 1001, f32, g7),
            ("prefill_f32_g1", "prefill [8,1000,24/24,64] f32 causal", 1000,
             1000, 1000, f32, g1),
            ("decode_f32_g1", "decode [8,1,24/24,64] f32, cache 1016, "
             "lk_valid 1001", 1, 1016, 1001, f32, g1),
            ("decode_f32_d256_ring", "decode [8,1,10/1,256] f32, ring 2048, "
             "lk_valid 2048", 1, 2048, 2048, f32, m256)):
        q = randn(b, lq, hq, d, dtype=dtype)
        k = randn(b, lk, hkv, d, dtype=dtype)
        v = randn(b, lk, hkv, d, dtype=dtype)
        route = kfa.flash_route(dtype, lq, hq // hkv)
        tol = K4_BF16_TOL if dtype == bf16 else K4_F32_TOL
        before = _build.SITE_LAUNCHES[f"flash_attention/route:{route}"]
        got = kfa.flash_attention(q, k, v, causal=True, lk_valid=valid)
        if _build.SITE_LAUNCHES[f"flash_attention/route:{route}"] != \
                before + 1:
            raise SystemExit(f"chip_smoke: K4 {label} did not take route "
                             f"{route}")
        want = kfa.flash_attention_plain(q, k, v, causal=True, lk_valid=valid)
        row = {"kernel": "flash_attention", "shape": label, "route": route,
               "source": K4_SOURCES[route], "timed": False,
               "max_abs_err": close(f"K4 {label} (route {route})", got, want,
                                    tol),
               "tolerance": tol,
               **own_rounding(kfa, route, got, q, k, v, valid, 0, label)}
        log(json.dumps(row))
        out[f"flash_attention/{key}"] = row
        del q, k, v, got, want

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
        runs = (PHASE6_HEAVY_RUNS if flops > PHASE17_HEAVY_FLOPS
                else TIMING_RUNS)
        row = {"kernel": "wkv_chunked", "shape": shape,
               "ms": time_ms(lambda: kwkv.wkv_chunked(r, k, v, log_w, u, s0),
                             runs),
               "plain_ms": time_ms(lambda: kwkv.wkv_chunked_plain(
                   r, k, v, log_w, u, s0), runs),
               "library_ms": None,
               "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err,
               "tolerance": K5_TOL}
        log(json.dumps(row))
        out[f"wkv_chunked/{key}"] = row
        del r, k, v, log_w, u, s0, o, s, want_o, want_s

    # rwkv6-7b's train shape in phase 17c (the model's views at T = 1024, no
    # s0): held against the plain version, not timed
    r, k, v = (randn(8, 1024, bh // 8, n).permute(0, 2, 1, 3)
               for _ in range(3))
    log_w = -torch.clamp(torch.exp(randn(8, 1024, bh // 8, n)), 1e-6,
                         2.5).permute(0, 2, 1, 3)
    u = randn(bh // 8, n) * 0.5
    o, s = kwkv.wkv_chunked(r, k, v, log_w, u)
    want_o, want_s = kwkv.wkv_chunked_plain(r, k, v, log_w, u)
    row = {"kernel": "wkv_chunked", "timed": False,
           "shape": "train [8,1024,64,64] f32 as [B,H,T,n] views",
           "max_abs_err": max(close("K5 o heads T1024", o, want_o, K5_TOL),
                              close("K5 s_final heads T1024", s, want_s,
                                    K5_TOL)),
           "tolerance": K5_TOL}
    log(json.dumps(row))
    out["wkv_chunked/heads T1024"] = row
    del r, k, v, log_w, u, o, s, want_o, want_s
    return out


@contextlib.contextmanager
def no_plain_kernels(kfa, kwkv):
    """Fail the block if a plain version of K4, K4b, K5 or K5b ran (the
    wrappers take them only for CPU tensors)."""
    names = {kfa: ("flash_attention_plain", "flash_attention_bwd_plain",
                   "flash_attention_bwd_mma_plain"),
             kwkv: ("wkv_chunked_plain", "wkv_chunked_bwd_plain")}
    saved, calls = [], []
    for mod, fns in names.items():
        for fn in fns:
            plain = getattr(mod, fn)

            def spy(*args, _fn=fn, _plain=plain, **kw):
                calls.append(_fn)
                return _plain(*args, **kw)

            saved.append((mod, fn, plain))
            setattr(mod, fn, spy)
    try:
        yield
    finally:
        for mod, fn, plain in saved:
            setattr(mod, fn, plain)
    if calls:
        raise SystemExit(f"chip_smoke: plain versions ran on the card: "
                         f"{sorted(set(calls))}")


@contextlib.contextmanager
def plain_path(kops, kfa, kwkv, bf16_inputs: bool = False):
    """Run the model with K4/K4b and K5/K5b swapped for autograd functions
    of their plain forwards and plain backwards (``ops`` is where the model
    looks them up): serving runs the plain forwards, training their plain
    backwards too.  With ``bf16_inputs`` every input of those forwards and
    backwards is rounded to bf16 first: an attention or WKV that computes,
    forward and backward, in bf16."""
    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype) if bf16_inputs and \
            x is not None else x

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, kw):
            o = kfa.flash_attention_plain(rnd(q), rnd(k), rnd(v), **kw)
            ctx.save_for_backward(q, k, v, o)
            ctx.kw = kw
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o = ctx.saved_tensors
            return (*kfa.flash_attention_bwd_plain(
                rnd(q), rnd(k), rnd(v), rnd(o), rnd(do), **ctx.kw), None)

    class WKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, log_w, u, s0):
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(r, k, v, log_w, u, s0)
            return kwkv.wkv_chunked_plain(rnd(r), rnd(k), rnd(v), rnd(log_w),
                                          u, s0)

        @staticmethod
        def backward(ctx, do, ds):
            r, k, v, log_w, u, s0 = ctx.saved_tensors
            if do is None:
                do = torch.zeros_like(r)
            return kwkv.wkv_chunked_bwd_plain(rnd(r), rnd(k), rnd(v),
                                              rnd(log_w), u, s0, rnd(do), ds)

    def attention(q, k, v, *, causal=True, scale=None, lk_valid=None,
                  window=0, site=None):
        return Attn.apply(q, k, v, dict(causal=causal, scale=scale,
                                        lk_valid=lk_valid, window=window))

    saved = kops.flash_attention, kops.wkv_chunked
    kops.flash_attention, kops.wkv_chunked = attention, WKV.apply
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


def rel_check(name: str, got, plain, exact) -> dict:
    """The bf16 rule: at every position the kernel path's logits no further
    from the float32 plain path than the bf16 plain path's, within
    SERVE_BF16_MARGIN; fails otherwise.  Returns the distances."""
    rel = rel_l2(got, plain)
    rel_kernel, rel_plain = rel_l2(got, exact), rel_l2(plain, exact)
    if not all(k <= SERVE_BF16_MARGIN * p for k, p in zip(rel_kernel,
                                                           rel_plain)):
        raise SystemExit(f"chip_smoke: {name}: the kernel path is further "
                         "from the float32 plain path than the bf16 plain "
                         f"path: {rel_kernel} vs {rel_plain}")
    return {"rel_l2_vs_plain": rel, "rel_l2_kernel_vs_fp32": rel_kernel,
            "rel_l2_plain_vs_fp32": rel_plain, "margin": SERVE_BF16_MARGIN}


def check_sites(name: str, sites: dict, n_attn: int, steps: int,
                prefill_route: str) -> None:
    """One K4 launch per attention layer at the prefill (on
    ``prefill_route``) and per layer and decode step (route "decode"), and
    no other."""
    want = {"flash_attention/full": n_attn,
            "flash_attention/decode": n_attn * steps,
            f"flash_attention/route:{prefill_route}": n_attn,
            "flash_attention/route:decode": n_attn * steps}
    if sites != want:
        raise SystemExit(f"chip_smoke: {name}: K4 launches {sites}, want "
                         f"{want}")


def kernel_groups(prof, kernels: dict[str, str]) -> dict:
    """Device time of a profiled window by group: our kernels by name,
    GEMMs, everything else.  The device-side spans of the port's
    ``repro_torch.*`` ranges are not kernels and are left out."""
    from torch.autograd import DeviceType
    groups: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(
                "repro_torch."):
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
    if kernel == "flash_attention":
        check_sites(name, sites, nl, rec["decode_steps"], "mma")
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
    # the float32 plain path at full depth: how far each bf16 path is from it
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with plain_path(kops, kfa, kwkv):
        exact = teacher_forced(model_lib.get_model(cfg32), params, toks)
    res = {"arch": arch, "layers": nl, "dtype": cfg.dtype,
           "params_b": sum(x.numel() for x in _leaves(params)) / 1e9,
           "init_s": init_s, "prefill_s": rec["prefill_s"],
           "decode_s": rec["decode_s"], "decode_steps": rec["decode_steps"],
           "prefill_tok_per_s": PROMPTS * PROMPT_LEN / rec["prefill_s"],
           "decode_tok_per_s": PROMPTS * rec["decode_steps"] / rec["decode_s"],
           "peak_gb": peak_gb, "launches": counts, "sites": sites,
           **rel_check(name, got, plain, exact)}
    del plain, exact
    log(json.dumps(res))

    # full width, 4 layers, float32 (TF32 off): a tight check
    cfg4 = dataclasses.replace(cfg, num_layers=min(4, nl), dtype="float32")
    params4 = slice_layers(params, cfg4.num_layers)
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
    if kernel == "flash_attention":
        check_sites(name4, dict(_build.SITE_LAUNCHES), cfg4.num_layers,
                    rec4["decode_steps"], "f32")
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
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# the moe, vlm, audio and hybrid families (phase 16)
# ---------------------------------------------------------------------------

# (phase, architecture, prompt positions, seed): 8 requests each, 16 greedy
# tokens.  The vlm's 1000 positions are 256 patch embeddings and 744 text
# tokens; the hybrid's 3000 tokens are past its 2048-key window, not a
# multiple of the reference's 1024 block, and 3000 % 2048 != 0, so the
# ring's roll and its wrap at decode both run
FAMILIES = (("16a", "granite-moe-3b-a800m", 1000, 2),
            ("16b", "qwen2-vl-7b", 1000, 3),
            ("16c", "musicgen-medium", 1000, 4),
            ("16d", "recurrentgemma-2b", 3000, 5))
PROFILED = {"granite-moe-3b-a800m", "recurrentgemma-2b"}
PATCH_SIDE = 16   # the vlm's 256 patches on a 16 x 16 grid


def family_batch(cfg, positions: int, seed: int) -> dict:
    """The requests of a phase-16 run on the card: [8, P] token ids; for
    the vlm 256 seeded patch embeddings, then the text, with M-RoPE
    positions t = 0, h = i // 16, w = i % 16 for the patches and 16, 17,
    ... in all three components for the text."""
    dev = torch.device("cuda")
    p = cfg.frontend_len if cfg.frontend == "patch" else 0
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (PROMPTS, positions - p))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if p:
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch["patch_embeds"] = torch.randn(
            (PROMPTS, p, cfg.frontend_dim), generator=gen, device=dev)
        i = torch.arange(p, device=dev)
        grid = torch.stack([torch.zeros_like(i), i // PATCH_SIDE,
                            i % PATCH_SIDE])
        text = (PATCH_SIDE + torch.arange(positions - p, device=dev)).expand(
            3, -1)
        batch["positions"] = torch.cat([grid, text], 1).expand(
            PROMPTS, 3, positions)
    return batch


def serve_family(cfg, params, batch: dict, rec: dict) -> torch.Tensor:
    """Greedy serving of ``batch``: ``serve.generate`` for token prompts,
    ``make_prefill_step``/``make_decode_step`` for the vlm's patch prefix
    (``generate`` takes tokens only, as the reference's does).  Returns the
    [8, GEN] generated tokens; ``rec`` as ``generate`` fills it."""
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    if "patch_embeds" not in batch:
        toks = serve.generate(cfg, params, batch["tokens"].cpu().numpy(),
                              GEN, record=rec)
        return torch.as_tensor(toks[:, -GEN:], device="cuda",
                               dtype=torch.long)
    total = batch["tokens"].shape[1] + cfg.frontend_len
    prefill = model_lib.make_prefill_step(cfg, total + GEN)
    decode = model_lib.make_decode_step(cfg)
    col_ok = torch.arange(cfg.padded_vocab, device="cuda") < cfg.vocab_size

    def pick(logits):
        return torch.argmax(torch.where(col_ok, logits.float(), -torch.inf),
                            dim=-1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    rec["prefill_s"] = time.perf_counter() - t0
    kept, out = [logits], []
    t0 = time.perf_counter()
    tok = pick(logits)
    for i in range(GEN):
        out.append(tok[:, None])
        if i == GEN - 1:
            break
        logits, cache = decode(params, cache, tok[:, None])
        kept.append(logits)
        tok = pick(logits)
    torch.cuda.synchronize()
    rec.update(logits=kept, decode_s=time.perf_counter() - t0,
               decode_steps=GEN - 1)
    return torch.cat(out, dim=1)


def forced_logits(model, params, batch: dict, generated: torch.Tensor,
                  stepwise: bool) -> torch.Tensor:
    """Logits [8, GEN, Vp] that picked each generated token, recomputed:
    one teacher-forced forward over the prompt and the generated tokens
    (unembedding only those positions; the vlm's added text positions take
    all three components at the cache position, as a decode step rotates
    them, ROADMAP R6), or, with ``stepwise``, the served run's prefill and
    decode steps fed the generated tokens.  The moe family takes the
    second: a forward over 8 x 1015 tokens routes in other groups (of 8,
    capacity 4) than a prefill of 8 x 1000 (groups of 64) and steps of 8,
    so it computes another function."""
    from repro_torch.models import layers
    total = batch["tokens"].shape[1]
    if "patch_embeds" in batch:
        total += batch["patch_embeds"].shape[1]
    if stepwise:
        logits, cache = model.prefill(params, batch, total + GEN)
        out = [logits]
        for i in range(GEN - 1):
            logits, cache = model.decode_step(params, cache,
                                              generated[:, i:i + 1])
            out.append(logits)
        return torch.stack(out, dim=1)
    forced = dict(batch, tokens=torch.cat([batch["tokens"],
                                           generated[:, :-1]], dim=1))
    if "positions" in batch:
        extra = (total + torch.arange(GEN - 1, device="cuda")).expand(
            PROMPTS, 3, GEN - 1)
        forced["positions"] = torch.cat([batch["positions"], extra], dim=2)
    h, _, _ = model.forward(params, forced, unembed=False)
    return layers.dense(h[:, total - 1:], params["head"])


@contextlib.contextmanager
def moe_routes(moe_lib, routes: list):
    """Record each MoE layer's top-k experts per token (sorted) in
    ``routes`` while the block runs."""
    dispatch = moe_lib._top_k_dispatch

    def spy(probs, k, capacity):
        routes.append(torch.topk(probs, k, dim=-1).indices.sort(-1).values)
        return dispatch(probs, k, capacity)

    moe_lib._top_k_dispatch = spy
    try:
        yield routes
    finally:
        moe_lib._top_k_dispatch = dispatch


def slice_layers(params: dict, n: int) -> dict:
    """The first ``n`` layers' parameters (stacked tensors or the hybrid's
    list of per-layer dicts)."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return dict(params, blocks=blocks[:n])
    return dict(params, blocks={k: w[:n] for k, w in blocks.items()})


def range_kernel_ms(prof, name: str) -> float:
    """Device ms of the kernels that run inside the device-side spans of
    the profiler range ``name`` (one stream, so a kernel inside a span was
    launched inside the range)."""
    import bisect
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == name)
    starts = [a for a, _ in spans]
    total = 0.0
    for e in evs:
        if e.name.startswith("repro_torch."):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            total += e.time_range.elapsed_us() / 1e3
    return total


def profile_family(model, params, batch: dict, max_len: int) -> dict:
    """A profiled prefill and four decode steps: device ms by group (K4 as
    ``attention``, GEMMs, the rest), the ms of the kernels inside the
    ``repro_torch.rglru`` range (the hybrid's convolution and recurrence,
    GEMMs of its gates included: a part of ``gemm`` and ``other``, not a
    group beside them) and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    def window(fn, n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        groups = {g: ms / n for g, ms in kernel_groups(
            prof, {"attention": "flash_"}).items()}
        rglru = range_kernel_ms(prof, "repro_torch.rglru") / n
        busy = sum(groups.values())
        out = {"wall_ms": wall, "kernel_ms": busy,
               "device_idle_share": 1 - busy / wall,
               "kernel_ms_by_group": groups}
        if rglru:
            out["rglru_range_ms"] = rglru
        return res, out

    (logits, cache), pre = window(
        lambda: model.prefill(params, batch, max_len), 1)
    tok = logits.argmax(-1)[:, None]

    def steps():
        c = cache
        for _ in range(4):
            _, c = model.decode_step(params, c, tok)

    _, dec = window(steps, 4)
    return {"prefill": pre, "decode_step": dec}


def phase_family(phase: str, arch: str, positions: int, seed: int,
                 runs: list) -> dict:
    """Serve ``arch`` at full width and depth through the port's entry
    points and hold every picked token's logits against the plain path and
    the float32 plain path; every attention launch K4 (route "mma" at the
    prefill, "decode" at each step), no plain attention on the card; the
    moe family's routing differences from the plain path (printed, not a
    gate); the 4-layer float32 check; a profile for the moe and the
    hybrid.  Frees the model before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib

    cfg = get_config(arch)
    nl, n_attn = cfg.num_layers, cfg.layer_kinds.count("attn")
    stepwise = bool(cfg.num_experts)
    model = model_lib.get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = family_batch(cfg, positions, seed)
    serve.generate(cfg, params, batch["tokens"][:, :64].cpu().numpy(), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    rec: dict = {}
    with no_plain_kernels(kfa, kwkv):
        generated = serve_family(cfg, params, batch, rec)
    counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
    steps = rec["decode_steps"]
    name = (f"phase {phase} {arch} 8x{positions}+{GEN}, {nl} layers, "
            f"{cfg.dtype}")
    runs.append({"path": name, "launches": counts, "sites": sites,
                 "steps": 1 + steps})
    check_sites(name, sites, n_attn, steps, "mma")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = torch.stack(rec["logits"], dim=1)
    if got.shape != (PROMPTS, GEN, cfg.padded_vocab) or not bool(
            torch.isfinite(got).all()) or int(generated.max()) >= \
            cfg.vocab_size:
        raise SystemExit(f"chip_smoke: {name}: logits {tuple(got.shape)} "
                         "not finite, or a padded column picked")
    plain_routes: list = []
    with plain_path(kops, kfa, kwkv), moe_routes(moe_lib, plain_routes):
        _build.reset_launches()
        plain = forced_logits(model, params, batch, generated, stepwise)
        if any(_build.LAUNCHES.values()):
            raise SystemExit("chip_smoke: the plain path launched a kernel")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with plain_path(kops, kfa, kwkv):
        exact = forced_logits(model_lib.get_model(cfg32), params, batch,
                              generated, stepwise)
    res = {"phase": phase, "arch": arch, "layers": nl,
           "attention_layers": n_attn, "dtype": cfg.dtype,
           "params_b": sum(x.numel() for x in _leaves(params)) / 1e9,
           "init_s": init_s, "prefill_s": rec["prefill_s"],
           "decode_s": rec["decode_s"], "decode_steps": steps,
           "prefill_tok_per_s": PROMPTS * positions / rec["prefill_s"],
           "decode_tok_per_s": PROMPTS * steps / rec["decode_s"],
           "peak_gb": peak_gb, "launches": counts, "sites": sites,
           "plain_path": "stepwise" if stepwise else "one forward",
           **rel_check(name, got, plain, exact)}
    if stepwise:
        # token-layer routings whose expert set differs (near-ties flip with
        # one bf16 ulp of attention): informative, not a gate.  The kernel
        # path's routes come from a replay of the served prefill and steps
        # outside the timed run
        routes: list = []
        with no_plain_kernels(kfa, kwkv), moe_routes(moe_lib, routes):
            forced_logits(model, params, batch, generated, stepwise)
        if [r.shape for r in routes] != [r.shape for r in plain_routes]:
            raise SystemExit(f"chip_smoke: {name}: the plain path routed "
                             "other groups")
        res["moe_routings"] = sum(r.numel() // r.shape[-1] for r in routes)
        res["moe_routings_differing_from_plain"] = sum(
            int((a != b).any(-1).sum()) for a, b in zip(routes,
                                                        plain_routes))
        del routes
    del plain, exact, plain_routes
    log(json.dumps(res))

    # full width, 4 layers, float32 (TF32 off): the tight check, and a
    # bf16-rounding plain path must fail it
    cfg4 = dataclasses.replace(cfg, num_layers=min(4, nl), dtype="float32")
    params4 = slice_layers(params, cfg4.num_layers)
    n4 = cfg4.layer_kinds.count("attn")
    _build.reset_launches()
    rec4: dict = {}
    with no_plain_kernels(kfa, kwkv):
        gen4 = serve_family(cfg4, params4, batch, rec4)
    name4 = f"phase {phase} {arch} 8x{positions}+{GEN}, 4 layers, float32"
    runs.append({"path": name4, "launches": dict(_build.LAUNCHES),
                 "sites": dict(_build.SITE_LAUNCHES),
                 "steps": 1 + rec4["decode_steps"]})
    check_sites(name4, dict(_build.SITE_LAUNCHES), n4,
                rec4["decode_steps"], "f32")
    got4 = torch.stack(rec4["logits"], dim=1)
    model4 = model_lib.get_model(cfg4)
    with plain_path(kops, kfa, kwkv):
        plain4 = forced_logits(model4, params4, batch, gen4, stepwise)
    with plain_path(kops, kfa, kwkv, bf16_inputs=True):
        bf16_4 = forced_logits(model4, params4, batch, gen4, stepwise)
    rel4, rel_bf16 = rel_l2(got4, plain4), rel_l2(bf16_4, plain4)
    res["fp32_4_layers"] = {"rel_l2_vs_plain": rel4,
                            "tolerance": SERVE_FP32_TOL,
                            "rel_l2_bf16_rounding_plain_vs_plain":
                                max(rel_bf16),
                            "sites": dict(_build.SITE_LAUNCHES)}
    log(json.dumps({"phase": phase, "arch": arch,
                    **res["fp32_4_layers"]}))
    if not max(rel4) <= SERVE_FP32_TOL:
        raise SystemExit(f"chip_smoke: {name4}: logits disagree with the "
                         f"plain path: rel L2 {max(rel4)}")
    if not max(rel_bf16) > SERVE_FP32_TOL:
        raise SystemExit(f"chip_smoke: {name4}: the float32 tolerance "
                         "does not separate a bf16 computation")
    del got4, plain4, bf16_4, params4, model4

    if arch in PROFILED:
        res["profile"] = profile_family(model, params, batch,
                                        positions + GEN)
        log(json.dumps({"profile": f"phase {phase} {arch} full depth",
                        **res["profile"]}))
    del params, model, got, rec, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# training (phase 17)
# ---------------------------------------------------------------------------

# K4b against its plain backward: (key, label, [b, lq, lk, hq, hkv, d],
# dtype, lk_valid, window, timed).  The timed bf16 rows are the train shapes
# of minitron-4b, musicgen-medium and recurrentgemma-2b (past its window);
# the float32 rows are those of the 4-layer float32 checks and a ragged
# case (Lq != Lk, lk_valid < Lk, a window); untimed, the ragged case in
# bf16 and a head dim that route "mma" pads (96 to 128)
K4B_SHAPES = (
    ("minitron-4b", "[8,1024,24/8,128] bf16 causal",
     (8, 1024, 1024, 24, 8, 128), torch.bfloat16, None, 0, True),
    ("musicgen-medium", "[8,1024,24/24,64] bf16 causal",
     (8, 1024, 1024, 24, 24, 64), torch.bfloat16, None, 0, True),
    ("recurrentgemma-2b", "[8,3000,10/1,256] bf16 causal, window 2048",
     (8, 3000, 3000, 10, 1, 256), torch.bfloat16, None, 2048, True),
    ("minitron-4b f32", "[8,1024,24/8,128] f32 causal",
     (8, 1024, 1024, 24, 8, 128), torch.float32, None, 0, True),
    ("recurrentgemma-2b f32", "[8,3000,10/1,256] f32 causal, window 2048",
     (8, 3000, 3000, 10, 1, 256), torch.float32, None, 2048, True),
    ("ragged f32", "[2,300/400,8/2,128] f32, lk_valid 350, window 100",
     (2, 300, 400, 8, 2, 128), torch.float32, 350, 100, True),
    ("ragged bf16", "[2,300/400,8/2,128] bf16, lk_valid 350, window 100",
     (2, 300, 400, 8, 2, 128), torch.bfloat16, 350, 100, False),
    ("padded-D bf16", "[2,500,12/4,96] bf16 causal",
     (2, 500, 500, 12, 4, 96), torch.bfloat16, None, 0, False),
)
K4B_SOURCES = {"mma": "src/repro_torch/csrc/flash_attention_bwd_mma.cu",
               "f32": "src/repro_torch/csrc/flash_attention_bwd.cu"}
# gradients against the plain backward on the same inputs, atol relative to
# each gradient's own largest entry: float32 is the same algebra summed in
# another order (over up to Lq g rows for dK and dV); bf16 rounds float32
# results to bf16 in both, one bf16 ulp apart at most (|x| / 128)
K4B_TOL = {torch.bfloat16: (1e-3, 8e-3), torch.float32: (1e-4, 1e-4)}
# route "mma" against ``flash_attention_bwd_mma_plain``, which rounds P and
# dS as the kernel does: the float32 results differ in the order of
# additions (and exp2 against exp) only, so the bf16 outputs differ by at
# most one bf16 ulp (<= 2^-7 |x|), plus 1e-4 of the gradient's largest
# entry for the float32 differences (K4B_TOL's atol is 1e-3)
K4B_MMA_TOL = (1e-4, 2.0 ** -7)
# route "f32" against ``flash_attention_bwd_tf32_plain``, which runs every
# product as 3xTF32 as the kernel does: the same split products, summed in
# another order and by the tensor cores' float32 accumulation, which rounds
# otherwise than torch's float32 adds, so K4B_TOL's float32 entry (one TF32
# rounding of any product misses it by 1.3-7.9x, ``tools/k4b_rounding.py
# --float32``)
K4B_TF32_TOL = (1e-4, 1e-4)
# each route's plain version of its own rounding, and that check's tolerance
K4B_OWN = {"mma": ("flash_attention_bwd_mma_plain", K4B_MMA_TOL),
           "f32": ("flash_attention_bwd_tf32_plain", K4B_TF32_TOL)}
# K5b: the chunk algebra in float32 summed in another order; exponents up to
# +-80 in a chunk scale the rounding of exp (K5's tolerance, relative to
# each gradient's largest entry)
K5B_TOL = (1e-4, 1e-4)
K5B_CHUNK = 32
# timed calls a batch (of TIMING_RUNS elsewhere) for the calls of over 1e10
# flops: each takes 1.1-140 ms, so a batch of 5 lasts 5.5 ms or more, far
# above the events' resolution and behind the same device sleep; 30 would
# add about a minute.  Lighter calls (the ragged row, 0.1-0.6 ms with
# SDPA's) take TIMING_RUNS.
PHASE17_RUNS = 5
PHASE17_HEAVY_FLOPS = 1e10
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
# phase 17c: (architecture, sequence length, seed), full width, 4 layers
TRAIN_FAMILIES = (("minitron-4b", 1024, 11), ("rwkv6-7b", 1024, 12),
                  ("recurrentgemma-2b", 3000, 13))
# float32 (TF32 off) gradients of the kernel path against the plain path,
# rel L2 per leaf: the two differ in the order of additions only, which
# moves a leaf by about 1e-3 of what rounding the attention's or WKV's
# inputs to bf16 moves it (2^-24 against 2^-9, amplified alike), and the
# bf16-rounding plain path must miss the tolerance.  For the attention
# families that is 1e-4.  rwkv6-7b at a random init is ill-conditioned:
# bf16-rounded WKV inputs move its leaves by tens of percent (its bf16
# logits land far from float32 too: phase 8), so the same ratio puts its
# float32 differences near 1e-3 (``tools/wkv_grad_split.py`` splits them:
# K5b's own part is ~1e-6 of a leaf, the rest is K5's forward rounding,
# amplified through the model): 1e-2, which the bf16-rounding path still
# misses by far.  bf16: phase 7's relative rule, and a loss within half a
# bf16 ulp (2^-9) of the float32 loss counts as on it
TRAIN_FP32_TOL = {"rwkv6-7b": 1e-2}
TRAIN_FP32_TOL_ATTENTION = 1e-4
TRAIN_LOSS_FLOOR = 2.0 ** -9


def close_scaled(name: str, got, want, tol) -> float:
    """Max abs error of a call's gradients (lists, None skipped); fails
    unless |got - want| <= atol * scale + rtol |want| for each gradient,
    scale that gradient's largest entry in ``want``."""
    torch.cuda.synchronize()
    atol, rtol = tol
    worst = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        g, w = g.double(), w.double()
        scale = float(w.abs().max())
        err = (g - w).abs()
        if not bool(torch.isfinite(g).all()) or bool(
                (err > atol * scale + rtol * w.abs()).any()):
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                             f"backward (max abs diff {float(err.max())}, "
                             f"scale {scale}, atol {atol}, rtol {rtol})")
        worst = max(worst, float(err.max()))
    return worst


def grad_rel_l2(got, want) -> list[float]:
    """||got - want|| / ||want|| of each gradient of a call."""
    return leaf_rel([g for g, w in zip(got, want) if w is not None],
                    [w for w in want if w is not None])


def sdpa_grad_ms(q, k, v, do, lk_valid, window, runs) -> float:
    """SDPA's backward on K4b's inputs: forward plus backward, less the
    forward (a timing yardstick only)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kw = sdpa_mask(q.shape[1], k.shape[1], lk_valid, window, q.device)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        f_ms = time_ms(fwd, runs)
    return time_ms(both, runs) - f_ms


def wkv_bwd_terms(lanes: int, t: int, n: int) -> tuple[float, float]:
    """(flops, bytes) of K5b: per chunk of c <= 32 steps and lane, five
    strictly lower c x c products over n (A, dA, A^T dO, dA k~, dA^T r~:
    5 c(c-1)/2 n multiply-adds) and five c x n x n ones (k^ dS, dO S^T,
    V dS^T, the dS carry, the forward sweep's state: 5 c n^2), summed over
    the chunks of this T (the last one ragged; csrc/wkv_bwd.cu); r, k, v,
    log w, dO read and dr, dk, dv, dlog w written once, s0 and ds0 once."""
    macs = 0
    for c0 in range(0, t, K5B_CHUNK):
        c = min(K5B_CHUNK, t - c0)
        macs += 5 * c * (c - 1) // 2 * n + 5 * c * n * n
    return 2.0 * macs * lanes, 4.0 * (9 * lanes * t * n + 2 * lanes * n * n)


def phase_train_kernels(kfa, kwkv) -> dict[str, dict]:
    """17a: K4b and K5b against their plain backwards on the card, timed
    beside their bounds (and, for K4b, SDPA's backward).  Each twice on the
    same inputs with the same bits; K4b on its route (by the site counter)
    and also against the plain version of its route's own rounding."""
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    out = {}
    for key, label, (b, lq, lk, hq, hkv, d), dtype, valid, window, timed \
            in K4B_SHAPES:
        q, do = randn(b, lq, hq, d, dtype=dtype), randn(b, lq, hq, d,
                                                        dtype=dtype)
        k, v = randn(b, lk, hkv, d, dtype=dtype), randn(b, lk, hkv, d,
                                                        dtype=dtype)
        valid = lk if valid is None else valid
        kw = dict(causal=True, lk_valid=valid, window=window)
        o = kfa.flash_attention(q, k, v, **kw)
        route = kfa.flash_bwd_route(dtype)
        site = f"flash_attention_bwd/route:{route}"
        before = (_build.LAUNCHES["flash_attention_bwd"],
                  _build.SITE_LAUNCHES[site])
        got = kfa.flash_attention_bwd(q, k, v, o, do, **kw)
        if (_build.LAUNCHES["flash_attention_bwd"],
                _build.SITE_LAUNCHES[site]) != (before[0] + 1, before[1] + 1):
            raise SystemExit(f"chip_smoke: K4b {key} did not count its call "
                             f"on route {route}")
        again = kfa.flash_attention_bwd(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise SystemExit(f"chip_smoke: K4b {key}: two calls on the same "
                             "inputs gave different bits")
        del again
        want = kfa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        err = close_scaled(f"K4b {key}", got, want, K4B_TOL[dtype])
        row = {"kernel": "flash_attention_bwd", "shape": label,
               "route": route, "source": K4B_SOURCES[route],
               "max_abs_err": err, "tolerance": K4B_TOL[dtype],
               "rel_l2_dq_dk_dv": grad_rel_l2(got, want), "timed": timed,
               "same_bits_twice": True}
        del want
        own, own_tol = K4B_OWN[route]
        emu = getattr(kfa, own)(q, k, v, o, do, **kw)
        row.update(own_rounding=own, max_abs_err_vs_own_rounding=close_scaled(
            f"K4b {key} (against {own})", got, emu, own_tol),
            tolerance_vs_own_rounding=own_tol)
        del emu
        del got
        if timed:
            es = q.element_size()
            flops = 10.0 * d * visible_pairs(lq, valid, window) * hq * b
            nbytes = es * (4 * q.numel() + 4 * k.numel())
            rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
                FP32_FLOP_PER_S
            bnd, kind = flop_bound_ms(flops, rate, nbytes)
            runs = (PHASE17_RUNS if flops > PHASE17_HEAVY_FLOPS
                    else TIMING_RUNS)
            row.update(
                ms=time_ms(lambda: kfa.flash_attention_bwd(q, k, v, o, do,
                                                           **kw), runs),
                plain_ms=time_ms(lambda: kfa.flash_attention_bwd_plain(
                    q, k, v, o, do, **kw), runs),
                library_ms=sdpa_grad_ms(q, k, v, do, valid, window, runs),
                bound_ms=bnd, bound_kind=kind, flops=flops, runs=runs)
        log(json.dumps(row))
        out[f"flash_attention_bwd/{key}"] = row
        del q, k, v, o, do
    torch.cuda.empty_cache()

    # K5b on the model's layout: [B, T, H, n] projections as [B, H, T, n]
    # views, u per head, a non-zero s0 and a cotangent for the final state
    b, h, n = 8, 64, 64
    for t in (1024, 1000):
        def view(x):
            return x.permute(0, 2, 1, 3)
        r, k, v, dout = (view(randn(b, t, h, n)) for _ in range(4))
        log_w = view(-torch.clamp(torch.exp(randn(b, t, h, n)), 1e-6, 2.5))
        u = randn(h, n) * 0.5
        s0 = randn(b, h, n, n) * 0.3
        ds = randn(b, h, n, n)
        args = (r, k, v, log_w, u, s0, dout, ds)
        before = _build.LAUNCHES["wkv_chunked_bwd"]
        got = kwkv.wkv_chunked_bwd(*args)
        if _build.LAUNCHES["wkv_chunked_bwd"] != before + 1:
            raise SystemExit("chip_smoke: K5b did not count its call")
        again = kwkv.wkv_chunked_bwd(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise SystemExit(f"chip_smoke: K5b T={t}: two calls on the same "
                             "inputs gave different bits")
        del again
        want = kwkv.wkv_chunked_bwd_plain(*args)
        err = close_scaled(f"K5b T={t}", got, want, K5B_TOL)
        rel = grad_rel_l2(got, want)
        del got, want
        flops, nbytes = wkv_bwd_terms(b * h, t, n)
        bnd, kind = flop_bound_ms(flops, FP32_FLOP_PER_S, nbytes)
        row = {"kernel": "wkv_chunked_bwd",
               "shape": f"[{b},{t},{h},{n}] f32 as [B,H,T,n] views, s0, ds",
               "max_abs_err": err, "tolerance": K5B_TOL,
               "rel_l2_dr_dk_dv_dlogw_du_ds0": rel, "timed": True,
               "same_bits_twice": True,
               "ms": time_ms(lambda: kwkv.wkv_chunked_bwd(*args),
                             PHASE17_RUNS),
               "plain_ms": time_ms(lambda: kwkv.wkv_chunked_bwd_plain(*args),
                                   PHASE17_RUNS),
               "library_ms": None, "bound_ms": bnd, "bound_kind": kind,
               "flops": flops}
        log(json.dumps(row))
        out[f"wkv_chunked_bwd/T{t}"] = row
        del r, k, v, dout, log_w, u, s0, ds, args
    torch.cuda.empty_cache()
    return out


def phase_train_entry(runs: list) -> dict:
    """17b: musicgen-medium at full width and depth through
    ``repro_torch.launch.train.main``: 6 steps of 8 x 1024 tokens; finite
    losses and grad norms, every leaf moved, 48 K4 launches a step forward
    and 48 more recomputed under remat (route "mma"), 48 K4b calls a step,
    no plain attention or backward; train tokens/s over steps 3-6 (host
    clock, synchronised) and peak device memory."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import train
    arch, nl, steps = "musicgen-medium", 48, TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    rec: dict = {}
    t0 = time.perf_counter()
    with no_plain_kernels(kfa, kwkv):
        out = train.main(["--arch", arch, "--batch", str(TRAIN_BATCH),
                          "--seq", str(TRAIN_SEQ), "--steps", str(steps),
                          "--warmup", "2", "--log-every", "1"], record=rec)
    wall = time.perf_counter() - t0
    counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
    name = (f"phase 17b {arch} train 8x{TRAIN_SEQ}, {nl} layers, "
            f"{steps} steps")
    runs.append({"path": name, "launches": counts, "sites": sites,
                 "steps": steps})
    fwd, bwd = 2 * nl * steps, nl * steps
    want_sites = {"flash_attention/full": fwd,
                  "flash_attention/route:mma": fwd,
                  "flash_attention_bwd/full": bwd,
                  "flash_attention_bwd/route:mma": bwd}
    if counts["flash_attention"] != fwd or \
            counts["flash_attention_bwd"] != bwd or sites != want_sites:
        raise SystemExit(f"chip_smoke: {name}: launches {counts} {sites}, "
                         f"want K4 {fwd} and K4b {bwd}: {want_sites}")
    losses, gnorms = rec["losses"], rec["grad_norms"]
    if out["steps"] != steps or not np.all(np.isfinite(losses + gnorms)):
        raise SystemExit(f"chip_smoke: {name}: losses {losses}, grad norms "
                         f"{gnorms}")
    first, last = rec["param_sums"]
    still = [i for i, (a, b) in enumerate(zip(first, last)) if a == b]
    if still:
        raise SystemExit(f"chip_smoke: {name}: leaves {still} did not move")
    timed_s = sum(rec["step_s"][2:])
    res = {"phase": "17b", "arch": arch, "layers": nl, "dtype": "bfloat16",
           "steps": steps, "losses": losses, "grad_norms": gnorms,
           "step_s": rec["step_s"],
           "train_tok_per_s": TRAIN_BATCH * TRAIN_SEQ * (steps - 2) / timed_s,
           "step_ms": timed_s / (steps - 2) * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": wall, "launches": counts, "sites": sites}
    log(json.dumps(res))
    gc.collect()
    torch.cuda.empty_cache()
    return res


def leaf_rel(got: list, want: list) -> list[float]:
    """||got - want|| / ||want|| per leaf (0 where want is 0)."""
    out = []
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        den = float(torch.linalg.vector_norm(w))
        num = float(torch.linalg.vector_norm(g - w))
        out.append(num / den if den else num)
    return out


def profile_train_step(step, params, opt_state, batch) -> dict:
    """One profiled train step: device ms by group (GEMMs, K4/K5 forward,
    K4b/K5b, the optimizer, the rest) and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    # K4b's kernels on both routes (bwd_tf32_*, bwd_mma_*) are named
    # "bwd_..." in their source's anonymous namespace, K5b's "wkv_bwd_..."
    # (sweep, chunk, du); first match wins
    groups_of = {"K4b": "::bwd_", "K5b": "wkv_bwd_",
                 "K4": "flash_", "K5": "wkv_chunked_kernel"}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = kernel_groups(prof, groups_of)
    opt = range_kernel_ms(prof, "repro_torch.adamw")
    busy = sum(groups.values())
    groups["optimizer"] = opt
    groups["other"] = groups.get("other", 0.0) - opt   # its kernels are "other"
    return {"wall_ms": wall, "kernel_ms": busy,
            "device_idle_share": 1 - busy / wall,
            "kernel_ms_by_group": groups}


def phase_train_family(arch: str, seq: int, seed: int, runs: list) -> dict:
    """17c: ``arch`` at full width and 4 layers, 8 x ``seq`` tokens, through
    the train step's gradient (``models.model._grads``): in bf16 the loss
    and every leaf's gradient against the plain path (plain forward and
    backward) and the float32 plain path, phase 7's relative rule, every
    leaf non-zero; in float32 (TF32 off) every leaf within the family's
    float32 tolerance (TRAIN_FP32_TOL) of the plain path, which a
    bf16-rounding plain path must miss; then one profiled train step (AdamW
    included)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config(arch), num_layers=4)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ssm = cfg.family == "ssm"
    kernel = "wkv_chunked" if ssm else "flash_attention"
    layers_k = 4 if ssm else cfg.layer_kinds.count("attn")
    model, model32 = model_lib.get_model(cfg), model_lib.get_model(cfg32)
    params = model.init_params(seed)
    if ssm:
        # decay_b is zero at init (the reference's), which makes decay_a's
        # gradient zero by construction: draw it so that every leaf has one
        gen = torch.Generator(device="cuda").manual_seed(seed)
        db = params["blocks"]["decay_b"]
        db.copy_(torch.randn(db.shape, generator=gen, device="cuda") * 0.01)
    names = tree_lib.paths(params)
    batch = make_batch(cfg, TRAIN_BATCH, seq, 0, seed)
    mb = model_lib._device_batch({k: x[0] for k, x in batch.items()},
                                 torch.device("cuda"))
    label = f"phase 17c {arch} 8x{seq}, 4 layers"

    def grads(m, c, tag, want_route):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _build.reset_launches()
        with no_plain_kernels(kfa, kwkv):
            metrics, g = model_lib._grads(c, m, params, mb)
        torch.cuda.synchronize()
        counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
        runs.append({"path": f"{label}, {tag}", "launches": counts,
                     "sites": sites, "steps": 1})
        bwd = kernel + "_bwd"
        # K4 and K4b name their routes alike: "mma" in bf16, "f32" in float32
        if counts[kernel] != 2 * layers_k or counts[bwd] != layers_k or (
                want_route and (
                    sites.get(f"flash_attention/route:{want_route}")
                    != 2 * layers_k or
                    sites.get(f"flash_attention_bwd/route:{want_route}")
                    != layers_k)):
            raise SystemExit(f"chip_smoke: {label}, {tag}: launches "
                             f"{counts} {sites}, want {2 * layers_k} "
                             f"{kernel} and {layers_k} {bwd}")
        return (float(metrics["loss"]), g, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9)

    def plain(m, c, bf16_inputs=False):
        _build.reset_launches()
        with plain_path(kops, kfa, kwkv, bf16_inputs):
            metrics, g = model_lib._grads(c, m, params, mb)
        if any(_build.LAUNCHES.values()):
            raise SystemExit("chip_smoke: the plain path launched a kernel")
        return float(metrics["loss"]), g

    loss_k, g_k, grad_s, grad_peak_gb = grads(model, cfg, "bf16",
                                              None if ssm else "mma")
    loss_p, g_p = plain(model, cfg)
    loss_x, g_x = plain(model32, cfg32)
    rel_k, rel_p = leaf_rel(g_k, g_x), leaf_rel(g_p, g_x)
    zero = [n for n, g in zip(names, g_k) if float(g.abs().max()) == 0]
    worse = [(n, a, b) for n, a, b in zip(names, rel_k, rel_p)
             if not a <= SERVE_BF16_MARGIN * b]
    loss_ok = abs(loss_k - loss_x) <= max(
        SERVE_BF16_MARGIN * abs(loss_p - loss_x),
        TRAIN_LOSS_FLOOR * abs(loss_x))
    res = {"phase": "17c", "arch": arch, "layers": 4, "seq": seq,
           "grad_s_bf16": grad_s, "grad_peak_gb_bf16": grad_peak_gb,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_fp32": loss_x,
           "leaf_rel_l2_kernel_vs_fp32": dict(zip(names, rel_k)),
           "leaf_rel_l2_plain_vs_fp32": dict(zip(names, rel_p)),
           "margin": SERVE_BF16_MARGIN}
    del g_k, g_p
    if zero or worse or not loss_ok:
        log(json.dumps(res))
        raise SystemExit(f"chip_smoke: {label}: zero gradients {zero}, "
                         f"leaves further from float32 than the bf16 plain "
                         f"path {worse}, loss {loss_k} / {loss_p} / {loss_x}")

    # float32, TF32 off: the tight check
    _, g_k32, _, _ = grads(model32, cfg32, "float32",
                           None if ssm else "f32")
    rel32 = leaf_rel(g_k32, g_x)
    del g_k32
    _, g_r = plain(model32, cfg32, bf16_inputs=True)
    rel_r = leaf_rel(g_r, g_x)
    del g_r, g_x
    tol32 = TRAIN_FP32_TOL.get(arch, TRAIN_FP32_TOL_ATTENTION)
    res.update(fp32_leaf_rel_l2_max=max(rel32),
               fp32_worst_leaf=names[rel32.index(max(rel32))],
               fp32_tolerance=tol32,
               bf16_rounding_plain_leaf_rel_l2_max=max(rel_r),
               fp32_leaf_rel_l2=dict(zip(names, rel32)),
               bf16_rounding_plain_leaf_rel_l2=dict(zip(names, rel_r)))
    if not max(rel32) <= tol32:
        log(json.dumps(res))
        raise SystemExit(f"chip_smoke: {label}, float32: gradients off the "
                         f"plain path: {max(rel32)} at {res['fp32_worst_leaf']}")
    if not max(rel_r) > tol32:
        raise SystemExit(f"chip_smoke: {label}: the float32 tolerance does "
                         "not separate a bf16 attention or WKV")

    # one profiled train step (its optimizer included)
    opt = AdamW(lr=1e-4)
    opt_state = opt.init(params)
    step = model_lib.make_train_step(cfg, opt)
    res["profile"] = profile_train_step(step, params, opt_state, batch)
    log(json.dumps(res))
    del params, opt_state, step, model, model32, mb
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the sharded train step (phase 18)
# ---------------------------------------------------------------------------

# musicgen-medium at full width, 4 layers, float32 (TF32 off): K4 and K4b
# on route "f32" at D = 64, 24/24 heads
SHARD_ARCH, SHARD_LAYERS, SHARD_SEQ, SHARD_SEED = "musicgen-medium", 4, 1024, 18
# the A8.2 float32 rules (tests/_torch_train_parity.py): metrics within
# rtol 1e-5; after one AdamW step (lr 1e-3) the parameters within rtol
# 1e-5, atol 1e-6 where the step is insensitive to the gradient's noise
# (here int8-compressed: one quantisation step, 1/127 of the leaf's max,
# the parity file's POD_NOISE_REL), elsewhere within 2 lr; the bf16
# error-feedback buffers within one quantisation step
SHARD_LR, ADAM_B1, ADAM_EPS = 1e-3, 0.9, 1e-8
SHARD_METRIC_RTOL, SHARD_PARAM_RTOL, SHARD_PARAM_ATOL = 1e-5, 1e-5, 1e-6
SHARD_NOISE_REL = 1 / 127
# K4 launches of a step (the forward and its recomputation under remat)
# and K4b launches, per rank, all on route "f32"
SHARD_K4, SHARD_K4B = 2 * SHARD_LAYERS, SHARD_LAYERS


def shard_inputs(device: str = "cuda", smoke: bool = False):
    """(config, parameters on ``device``, batch) of phase 18; ``smoke``
    takes the small config and 32 positions (a rehearsal on the CPU)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import make_batch
    from repro_torch.models import model as model_lib
    cfg = get_smoke(SHARD_ARCH) if smoke else dataclasses.replace(
        get_config(SHARD_ARCH), num_layers=SHARD_LAYERS)
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = model_lib.get_model(cfg, device).init_params(SHARD_SEED)
    return cfg, params, make_batch(cfg, TRAIN_BATCH, 32 if smoke else
                                   SHARD_SEQ, 0, SHARD_SEED)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def one_process_step(cfg, params, batch, npod: int = 1):
    """The one-process ``make_train_step`` with ``--pod-compress`` at
    ``npod`` (in place on ``params``): (parameters, {"m", "ef_error"},
    metrics)."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamW
    from repro_torch import tree as tree_lib
    opt = AdamW(lr=SHARD_LR)
    state = opt.init(params)
    state["ef_error"] = model_lib.init_ef_error(params, npod)
    dev = tree_lib.leaves(params)[0].device
    step = model_lib.make_train_step(cfg, opt, pod_compress=True, npod=npod,
                                     device=dev)
    params, state, metrics = step(params, state, batch)
    return (params, {k: state[k] for k in ("m", "ef_error")},
            {k: float(v) for k, v in metrics.items()})


def sharded_step(cfg, params, batch, mesh, rules, npod: int = 1):
    """One ``make_train_step`` with ``--pod-compress`` at ``npod`` (the
    mesh's "pod" axis, or 1), the parameters and AdamW state placed by
    ``state_specs`` on ``mesh``: (parameters, state, metrics, launches,
    sites, seconds), the trees gathered whole.  On the card no plain
    version may run."""
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamW
    from repro_torch.parallel import sharding as sh
    dev = tree_lib.leaves(params)[0].device
    opt = AdamW(lr=SHARD_LR)
    state = opt.init(params)
    state["ef_error"] = model_lib.init_ef_error(params, npod)
    params = sh.distribute(params, sh.state_specs(params, mesh, "param"),
                           mesh)
    state = sh.distribute(state, sh.state_specs(state, mesh, "opt"), mesh)
    has_pod = "pod" in mesh.mesh_dim_names
    step = model_lib.make_train_step(
        cfg, opt, sh.make_shard_fn(mesh, rules), pod_compress=True, npod=npod,
        unshard_pod=sh.unshard_pod if has_pod else None, device=dev)
    _sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with (no_plain_kernels(kfa, kwkv) if dev.type == "cuda"
          else contextlib.nullcontext()):
        params, state, metrics = step(params, state, batch)
    _sync(dev)
    secs = time.perf_counter() - t0
    counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)

    def whole(tree):
        return tree_lib.map_tree(
            lambda x: x.full_tensor() if sh.is_dtensor(x) else x, tree)

    return (whole(params), whole({k: state[k] for k in ("m", "ef_error")}),
            {k: float(v) for k, v in metrics.items()}, counts, sites, secs)


def check_shard_launches(label: str, counts: dict, sites: dict) -> None:
    want = {"flash_attention/route:f32": SHARD_K4,
            "flash_attention_bwd/route:f32": SHARD_K4B}
    if counts["flash_attention"] != SHARD_K4 or \
            counts["flash_attention_bwd"] != SHARD_K4B or \
            any(sites.get(k) != v for k, v in want.items()):
        raise SystemExit(f"chip_smoke: {label}: launches {counts} {sites}, "
                         f"want K4 {SHARD_K4} and K4b {SHARD_K4B} on route "
                         "f32")


def check_a82(label: str, got: tuple, want: tuple) -> dict:
    """(params, state, metrics) of a sharded step against the one-process
    step's, under the A8.2 float32 rules above; also whether every bit is
    the same."""
    from repro_torch import tree as tree_lib
    gp, gs, gm = got
    wp, ws, wm = want
    bad = [k for k in wm if not abs(gm[k] - wm[k])
           <= 1e-7 + SHARD_METRIC_RTOL * abs(wm[k])]
    worst_sure, worst_any, off = 0.0, 0.0, []
    for name, g, w, m in zip(tree_lib.paths(wp), tree_lib.leaves(gp),
                             tree_lib.leaves(wp), tree_lib.leaves(ws["m"])):
        gr = m.double().abs() / (1 - ADAM_B1)
        noise = SHARD_NOISE_REL * max(float(gr.max()), 1e-30)
        sure = (gr > 10 * noise) & (SHARD_LR * ADAM_EPS * noise / gr ** 2
                                    < SHARD_PARAM_ATOL / 2)
        d = (g.double() - w.double()).abs()
        lim = SHARD_PARAM_ATOL + SHARD_PARAM_RTOL * w.double().abs()
        over = float((d - lim)[sure].max()) if bool(sure.any()) else -1.0
        worst_sure = max(worst_sure, float(d[sure].max())
                         if bool(sure.any()) else 0.0)
        worst_any = max(worst_any, float(d.max()))
        if over > 0 or float(d.max()) > 2 * SHARD_LR * (1 + 1e-3):
            off.append(name)
    ef_off = []
    for name, g, w in zip(tree_lib.paths(ws["ef_error"]),
                          tree_lib.leaves(gs["ef_error"]),
                          tree_lib.leaves(ws["ef_error"])):
        top = float(w.float().abs().max())
        err = (g.float() - w.float()).abs()
        if float(err.max()) > 2.5 * top + 1e-30 or \
                float((err > 2.0 ** -7 * top).float().mean()) >= 0.01:
            ef_off.append(name)
    differ = {}
    for tag, g_tree, w_tree in (("params", gp, wp), ("m", gs["m"], ws["m"]),
                                ("ef_error", gs["ef_error"],
                                 ws["ef_error"])):
        differ[tag] = {
            name: float((g.double() - w.double()).abs().max())
            for name, g, w in zip(tree_lib.paths(w_tree),
                                  tree_lib.leaves(g_tree),
                                  tree_lib.leaves(w_tree))
            if not torch.equal(g, w)}
    res = {"metrics": gm, "metrics_one_process": wm,
           "param_max_abs_diff_sure": worst_sure,
           "param_max_abs_diff": worst_any,
           "bits_equal": gm == wm and not any(differ.values()),
           "leaves_whose_bits_differ": differ}
    if bad or off or ef_off:
        log(json.dumps({label: res}))
        raise SystemExit(f"chip_smoke: {label}: metrics {bad}, leaves "
                         f"{off}, ef_error {ef_off} off the one-process "
                         "step")
    return res


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sharded(card: str, runs: list) -> dict:
    """18a: a one-rank NCCL world and a (1, 1, 1) ("pod", "data",
    "model") mesh on the card: musicgen-medium (full width, 4 layers,
    float32, 8 x 1024) through one ``make_train_step`` with the shard
    function, ``state_specs`` placements and ``--pod-compress`` at npod 1,
    held against the one-process step on the same parameters (A8.2 float32
    rules; whether the bits are equal is reported).  Two ranks on the one
    card (18b) would need gloo, whose all-gather of CUDA tensors through
    the functional collectives that DTensor issues crashes the ranks on
    the card's torch (``tools/gloo_cuda_probe.py``; PERF.md §7): left
    out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tree_lib
    from repro_torch.parallel import sharding as sh

    t0 = time.perf_counter()
    cfg, params, batch = shard_inputs()
    want = one_process_step(cfg, tree_lib.map_tree(torch.clone, params),
                            batch)
    label = (f"phase 18a {SHARD_ARCH} {SHARD_LAYERS} layers float32 "
             f"8x{SHARD_SEQ}, NCCL world 1, mesh (1, 1, 1)")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        gp, gs, gm, counts, sites, secs = sharded_step(
            cfg, params, batch, mesh,
            sh.ShardingRules.default(dp_axes=("data",)))
    finally:
        dist.destroy_process_group()
    del params
    runs.append({"path": label, "launches": counts, "sites": sites,
                 "steps": 1})
    check_shard_launches(label, counts, sites)
    out = {"a": {"label": label, "step_s": secs, "launches": counts,
                 **check_a82(label, (gp, gs, gm), want)}}
    del gp, gs, want
    out["a"]["wall_s"] = time.perf_counter() - t0
    log(json.dumps({"phase": "18a", **out["a"], "card": card}))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the dry run on the card (phase 19)
# ---------------------------------------------------------------------------

# rank 0 of the 256-rank production mesh: minitron-4b's 24 heads over a
# model axis of 16 (rank 0 holds 2 q heads, ``layers.local_heads``)
DRY_ARCH, DRY_SHAPE = "minitron-4b", "prefill_32k"


def plain_by_query_chunks(kfa, q, k, v, causal=True, scale=None,
                          lk_valid=None, window=0, chunk=2048):
    """``flash_attention_plain`` computed ``chunk`` queries at a time (the
    whole [B, H, Lq, Lk] float32 scores of a 32k prefill take 17 GB): a
    causal chunk sees the keys up to its last query's position, with
    ``lk_valid`` cut to that position, so every query keeps its own
    position and window."""
    lq, lk = q.shape[1], k.shape[1]
    valid = lk if lk_valid is None else lk_valid
    if not causal:
        return kfa.flash_attention_plain(q, k, v, causal=False, scale=scale,
                                         lk_valid=valid, window=window)
    outs = []
    for i0 in range(0, lq, chunk):
        i1 = min(lq, i0 + chunk)
        end = i1 + valid - lq
        outs.append(kfa.flash_attention_plain(
            q[:, i0:i1], k[:, :end], v[:, :end], causal=True, scale=scale,
            lk_valid=end, window=window))
    return torch.cat(outs, dim=1)


def phase_dryrun(card: str, runs: list, trained: dict) -> dict:
    """19: rank 0 of a fake 256-rank world (``launch.dryrun.fake_world``,
    collectives that move no data) on the card, with real CUDA tensors:
    minitron-4b ``prefill_32k`` on the (16, 16) mesh at full depth, only
    rank 0's shards resident (each whole leaf made, cut, copied and
    dropped).  The step must complete with one K4 launch a layer on route
    "mma" at rank 0's head count and no plain kernel.  The fake group's
    collectives move no data, so what the step gathered holds whatever
    memory held (NaN at times) and no value of the step is checked;
    instead the first layer's K4 call is held against its plain version
    at its own shapes and layout: its q, k and v (k and v as
    ``local_heads`` gathered them) are refilled in place with seeded
    normal values, K4 runs on them again (on route "mma", outside the
    counted run) and must agree with ``flash_attention_plain`` under
    ``K4_BF16_TOL`` (``plain_by_query_chunks``).  Printed: device memory after placement and the step's peak beside
    ``analytic_memory``'s total and the CPU trace's bytes per chip (its
    probes traced here on fake tensors), the step's seconds (local work
    only: collectives are free here, so a floor) and ``model_flops /
    chips`` over them as a share of ``hlostats.H100.peak_flops``.  Also
    ``analytic_memory`` of phase 17b's one-device musicgen-medium train
    shape beside 17b's measured peak."""
    import types
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.launch import dryrun, hlostats
    from repro_torch.launch.mesh import make_production_mesh
    if dist.is_initialized():
        raise SystemExit("chip_smoke: phase 19 needs no process group")
    cfg, shape = get_config(DRY_ARCH), SHAPES[DRY_SHAPE]
    t0 = time.perf_counter()
    heads: list = []
    mesh = dryrun.fake_world(False, device_type="cuda")
    try:
        cpu_mesh = make_production_mesh(device_type="cpu")
        args_cpu = dryrun.argument_bytes(cfg, shape, cpu_mesh)
        t1 = time.perf_counter()
        costs = dryrun.probe_costs(cfg, shape, cpu_mesh)
        probe_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cell = dryrun.build_cell(cfg, shape, mesh, device="cuda")
        gc.collect()
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - base
        place_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        spied = ops.flash_attention
        kept: dict = {}

        def spy(q, k, v, **kw):
            heads.append(int(q.shape[2]))
            if not kept:
                # the first layer's call, held against the plain version
                # after the step
                kept.update(q=q, k=k, v=v, kw=kw)
            return spied(q, k, v, **kw)

        _build.reset_launches()
        ops.flash_attention = spy
        try:
            t1 = time.perf_counter()
            with no_plain_kernels(kfa, kwkv):
                logits, cache = cell.fn(*cell.args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t1
        finally:
            ops.flash_attention = spied
        step_peak = torch.cuda.max_memory_allocated() - base
        counts, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
        local_logits = tuple(logits.to_local().shape)
        del cell, logits, cache
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    nl = cfg.num_layers
    rank0_heads = -(-cfg.num_heads // 16)
    label = (f"phase 19 {DRY_ARCH} {DRY_SHAPE} rank 0 of 256 (16, 16), "
             f"{nl} layers, bf16")
    runs.append({"path": label, "launches": counts, "sites": sites,
                 "steps": 1})
    want_sites = {"flash_attention/full": nl,
                  "flash_attention/route:mma": nl}
    others = {k: v for k, v in counts.items() if k != "flash_attention" and v}
    if counts["flash_attention"] != nl or sites != want_sites or others \
            or heads != [rank0_heads] * nl:
        raise SystemExit(f"chip_smoke: {label}: launches {counts} {sites}, "
                         f"heads {heads}; want {nl} K4 launches on route "
                         f"mma at {rank0_heads} heads")
    kw = {k: v for k, v in kept.pop("kw").items() if k != "site"}
    q, k, v = kept.pop("q"), kept.pop("k"), kept.pop("v")
    gen = torch.Generator(device=q.device).manual_seed(19)
    for x in (q, k, v):
        x.copy_(torch.randn(x.shape, generator=gen, device=x.device))
    before = _build.SITE_LAUNCHES["flash_attention/route:mma"]
    got = kfa.flash_attention(q, k, v, **kw)
    if _build.SITE_LAUNCHES["flash_attention/route:mma"] != before + 1:
        raise SystemExit(f"chip_smoke: {label}: K4 layer 0 did not take "
                         f"route mma")
    want = plain_by_query_chunks(kfa, q, k, v, **kw)
    k4 = {"q": list(q.shape), "q_stride": list(q.stride()),
          "k": list(k.shape), "k_stride": list(k.stride()),
          "dtype": str(q.dtype), **kw, "tol": list(K4_BF16_TOL),
          "max_abs_err": close(f"{label}: K4 layer 0", got, want,
                               K4_BF16_TOL)}
    del q, k, v, got, want
    gc.collect()
    torch.cuda.empty_cache()
    am = dryrun.analytic_memory(cfg, shape, mesh, 1)
    mf = dryrun.model_flops(cfg, shape) / mesh.size()
    one = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 1, "model": 1}, size=1)
    train17b = ShapeConfig("train_8x1024", TRAIN_SEQ, TRAIN_BATCH, "train")
    am17b = dryrun.analytic_memory(get_config("musicgen-medium"), train17b,
                                   one, 1)
    res = {"phase": "19", "label": label, "heads_rank0": rank0_heads,
           "launches": counts, "sites": sites,
           "logits_local_shape": local_logits, "k4_layer0": k4,
           "placed_bytes": placed, "placement_peak_bytes": place_peak,
           "step_peak_bytes": step_peak,
           "analytic_bytes_per_chip": am,
           "cpu_trace_bytes_per_chip": {
               "arguments": args_cpu, "temp": costs["temp"],
               "peak": args_cpu + costs["temp"]},
           "cpu_trace_per_chip": {k: costs[k] for k in
                                  ("flops", "bytes", "ici", "dcn")},
           "cpu_probe_s": probe_s,
           "step_s": step_s,
           "model_flops_per_chip": mf,
           "peak_share": mf / step_s / hlostats.H100.peak_flops,
           "phase17b_analytic_bytes": am17b,
           "phase17b_peak_gb": trained["musicgen-medium"]["peak_gb"],
           "wall_s": time.perf_counter() - t0, "card": card}
    log(json.dumps(res))
    return res


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


AOT_LANES = 4     # phase 20: K1 at [4, 512, 512]
AOT_ITERS = 100
AOT_WARM_TIMEOUT_S = 180


def aot_solve(name: str, engine, topos, dems, runs) -> tuple[list, float]:
    """One solve with K1's counts reset just before and read just after;
    (bounds, wall seconds)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = engine.solve_batch(topos, dems)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    record_path(name, runs, ["minplus_acc"], steps=max(
        r.meta["iterations"] for r in res) + 1)
    return [r.throughput for r in res], wall


def aot_warm() -> None:
    """Phase 20b's warm process: the same seeded instances through the
    same engine; prints one JSON line (whether nvcc ran, the library's
    counts, bounds, walls)."""
    t_proc = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from repro_torch.core import get_engine, graphs, traffic
    from repro_torch.core.plan import compile_cache_sizes
    from repro_torch.kernels import _build
    topos, dems = instances(graphs, traffic, 512, 16, 8, range(AOT_LANES))
    runs: list[dict] = []
    eng = get_engine("dual-pallas", iters=AOT_ITERS, devices=1)
    bounds, wall = aot_solve("phase 20b warm process", eng, topos, dems,
                             runs)
    sizes = compile_cache_sizes()
    print(json.dumps({"aot_warm": {
        "aot": {k: sizes[k] for k in ("aot.compiles", "aot.hits")},
        "build_seconds": _build.build_seconds(), "bounds": bounds,
        "minplus_acc": runs[-1]["launches"]["minplus_acc"],
        "solve_s": wall, "process_s": time.perf_counter() - t_proc}}),
        flush=True)


def phase_aot(card: str, topos, dems, runs) -> dict:
    """Phase 20: the kernel library as the port's one compile, in this
    process and in a warm one; no new program across a second solve or a
    refill; ``devices``."""
    from repro_torch.core import get_engine
    from repro_torch.core.plan import compile_cache_sizes, device_count
    from repro_torch.kernels import _build
    pile = topos[:AOT_LANES], dems[:AOT_LANES]
    rec: dict = {}

    def dual_delta(before):
        after = compile_cache_sizes()
        return {k: after[k] - before[k] for k in after
                if k.startswith("dual.")}

    # (a) one process: the second solve of a shape adds no program
    eng = get_engine("dual-pallas", iters=AOT_ITERS, devices=1)
    first, first_s = aot_solve("phase 20a dual-pallas first solve", eng,
                               *pile, runs)
    before = compile_cache_sizes()
    second, second_s = aot_solve("phase 20a dual-pallas second solve", eng,
                                 *pile, runs)
    delta = dual_delta(before)
    if not delta or any(delta.values()):
        raise SystemExit(f"chip_smoke: phase 20a second solve added dual "
                         f"programs: {delta}")
    if second != first:
        raise SystemExit(f"chip_smoke: phase 20a bounds differ between two "
                         f"solves: {first} {second}")
    aot = {k: before[k] for k in ("aot.compiles", "aot.hits")}
    if sum(aot.values()) != 1:
        raise SystemExit(f"chip_smoke: phase 20a library counts {aot}")
    rec["a"] = {"aot": aot, "nvcc_s": _build.build_seconds(),
                "bounds": first, "delta": delta, "first_solve_s": first_s,
                "second_solve_s": second_s}

    # (b) a warm process on the same sources, started now: its start-up
    # overlaps (c) and (d)
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--aot-warm"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (c) a refill of (a)'s plan adds no dual program
        plan = eng.plan(*pile)
        before = compile_cache_sizes()
        torch.cuda.synchronize()
        _build.reset_launches()
        refilled = plan.refill(topos[AOT_LANES:2 * AOT_LANES],
                               dems[AOT_LANES:2 * AOT_LANES]).execute(
            solver="dual", device="cuda", **eng._solver_kw())
        record_path("phase 20c refill", runs, ["minplus_acc"],
                    steps=AOT_ITERS + 1)
        delta = dual_delta(before)
        if not delta or any(delta.values()):
            raise SystemExit(f"chip_smoke: phase 20c refill added dual "
                             f"programs: {delta}")
        if plan.stats.compile_keys != ((512, AOT_LANES),):
            raise SystemExit(f"chip_smoke: phase 20c compile keys "
                             f"{plan.stats.compile_keys}")
        if not all(np.isfinite(r.value) and r.value > 0 for r in refilled):
            raise SystemExit("chip_smoke: phase 20c refill bounds")
        rec["c"] = {"delta": delta, "compile_keys": plan.stats.compile_keys}

        # (d) devices=None is one card; an explicit count is every card
        dual = get_engine("dual", iters=10)
        res = dual.solve_batch(*pile)
        ncards = torch.cuda.device_count()
        if dual.last_plan.devices != 1 or \
                any(r.meta["devices"] != 1 for r in res) or \
                device_count(ncards) != ncards:
            raise SystemExit(f"chip_smoke: phase 20d devices: "
                             f"{dual.last_plan}, {ncards} card(s)")
        rec["d"] = {"devices_none": dual.last_plan.devices,
                    "devices_all": device_count(ncards),
                    "cuda_device_count": ncards}
        out, err = child.communicate(timeout=AOT_WARM_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t_child
    if child.returncode != 0:
        raise SystemExit(f"chip_smoke: phase 20b warm process exited "
                         f"{child.returncode}:\n{err[-4000:]}")
    warm = json.loads(out.strip().splitlines()[-1])["aot_warm"]
    if warm["build_seconds"] is not None or \
            warm["aot"] != {"aot.compiles": 0, "aot.hits": 1} or \
            warm["minplus_acc"] == 0:
        raise SystemExit(f"chip_smoke: phase 20b warm process: {warm}")
    if warm["bounds"] != first:
        raise SystemExit(f"chip_smoke: phase 20b bounds differ from "
                         f"20a's: {warm['bounds']} {first}")
    rec["b"] = {**warm, "wall_from_spawn_s": child_s}
    log(json.dumps({"phase 20": rec, "card": card}))
    return rec


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
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
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

        # phase 14: routing-restricted throughput (K1; K3 slab at N=512)
        from repro_torch.core import vl2
        t0 = time.perf_counter()
        routed = phase_routing(graphs, traffic, vl2, lp, bounds, get_engine,
                               topos, dems, runs)
        log(f"{card}: phase 14 routing families "
            f"{sum(routed['a']['walls_s'].values()):.1f} s, ecmp "
            f"RRG(512,16) {routed['b']['instances_per_s']:.2f} instances/s "
            f"({routed['b']['ecmp_hops']} hops), ksp RRG(128,8) "
            f"{routed['c']['mw_ms_per_step']:.2f} ms a MW step (phase wall "
            f"{time.perf_counter() - t0:.1f} s)")

        # phase 15: the lifecycle layer (K1), its HiGHS sample in lp_pool
        t0 = time.perf_counter()
        life = phase_lifecycle(graphs, vl2, lp, CertifiedEngine, runs,
                               lp_pool)
        log(f"{card}: phase 15 degradation "
            f"{life['a']['instances_per_s']:.2f} instances/s "
            f"({life['a']['wall_s']:.1f} s), expansion "
            f"{life['b']['wall_s']:.1f} s (phase wall "
            f"{time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        check_figure(fig5, held)
        log(f"phase 10 HiGHS waited {time.perf_counter() - t0:.1f} s")
    finally:
        lp_pool.shutdown(cancel_futures=True)

    # phase 16: the moe, vlm, audio and hybrid families at full width and
    # depth (K4 with the local window and head dim 256 on the hybrid)
    for phase, arch, positions, seed in FAMILIES:
        t0 = time.perf_counter()
        served[arch] = phase_family(phase, arch, positions, seed, runs)
        log(f"{card}: phase {phase} {arch} prefill "
            f"{served[arch]['prefill_tok_per_s']:.1f} tok/s, decode "
            f"{served[arch]['decode_tok_per_s']:.1f} tok/s (phase wall "
            f"{time.perf_counter() - t0:.1f} s)")

    # phase 17: training (K4b and K5b against their plain backwards; the
    # entry point at full depth; three families at 4 layers)
    t17 = time.perf_counter()
    train_timed = phase_train_kernels(kfa, kwkv)
    log(f"phase 17a (backward kernels) wall {time.perf_counter() - t17:.1f} s")
    t0 = time.perf_counter()
    trained = {"musicgen-medium": phase_train_entry(runs)}
    log(f"{card}: phase 17b musicgen-medium train "
        f"{trained['musicgen-medium']['train_tok_per_s']:.1f} tok/s, "
        f"{trained['musicgen-medium']['step_ms']:.1f} ms a step, peak "
        f"{trained['musicgen-medium']['peak_gb']:.1f} GB (phase wall "
        f"{time.perf_counter() - t0:.1f} s)")
    for arch, seq, seed in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        trained[arch] = phase_train_family(arch, seq, seed, runs)
        log(f"{card}: phase 17c {arch} 4 layers 8x{seq} (phase wall "
            f"{time.perf_counter() - t0:.1f} s)")
    log(f"phase 17 wall {time.perf_counter() - t17:.1f} s")

    # phase 18: the sharded train step (a one-rank NCCL mesh)
    t0 = time.perf_counter()
    sharded = phase_sharded(card, runs)
    log(f"{card}: phase 18a {sharded['a']['step_s']:.2f} s a sharded step, "
        f"bits equal {sharded['a']['bits_equal']} (phase wall "
        f"{time.perf_counter() - t0:.1f} s)")

    # phase 19: the dry run on the card (rank 0 of a fake 256-rank world)
    t0 = time.perf_counter()
    dry = phase_dryrun(card, runs, trained)
    log(f"{card}: phase 19 {DRY_ARCH} {DRY_SHAPE} rank 0: "
        f"{dry['step_s']:.2f} s a step, step peak "
        f"{dry['step_peak_bytes'] / 1e9:.2f} GB, analytic "
        f"{dry['analytic_bytes_per_chip']['total'] / 1e9:.2f} GB, K4 layer 0 "
        f"max abs err {dry['k4_layer0']['max_abs_err']:.3g} (phase wall "
        f"{time.perf_counter() - t0:.1f} s)")

    # phase 20: the planner's last contracts (compile counts, devices)
    t0 = time.perf_counter()
    aot = phase_aot(card, topos, dems, runs)
    log(f"{card}: phase 20 first solve {aot['a']['first_solve_s']:.2f} s, "
        f"second {aot['a']['second_solve_s']:.2f} s, warm process "
        f"{aot['b']['process_s']:.2f} s ({aot['b']['solve_s']:.2f} s "
        f"solving, no nvcc), devices=None -> {aot['d']['devices_none']} "
        f"(phase wall {time.perf_counter() - t0:.1f} s)")

    # phase 21: summary
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
        "flash_attention_bwd": (
            K4B_SOURCES["mma"],
            "none (no TPU kernel): the backward of the jnp "
            "src/repro/models/layers.py:152 attention, which XLA "
            "differentiates"),
        "wkv_chunked_bwd": (
            "src/repro_torch/csrc/wkv_bwd.cu",
            "none (no TPU kernel): the backward of the jnp "
            "src/repro/models/rwkv6.py:112 _wkv_chunked, which XLA "
            "differentiates"),
    })
    timed["flash_attention"] = lm_timed["flash_attention/prefill"]
    timed["wkv_chunked"] = lm_timed["wkv_chunked/heads T1000"]
    timed["flash_attention_bwd"] = train_timed[
        "flash_attention_bwd/minitron-4b"]
    timed["wkv_chunked_bwd"] = train_timed["wkv_chunked_bwd/T1024"]
    lm_timed.update(train_timed)
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
        if name in ("flash_attention", "flash_attention_bwd"):
            # the source of each route; "source" above is the bf16 one
            entry["sources"] = (K4_SOURCES if name == "flash_attention"
                                else K4B_SOURCES)
        if name in ("flash_attention", "wkv_chunked", "flash_attention_bwd",
                    "wkv_chunked_bwd"):
            entry["tolerance"] = t["tolerance"]
            entry["shapes"] = {k.split("/", 1)[1]: {
                f: v for f, v in row.items() if f in (
                    "shape", "route", "source", "ms", "call_ms", "plain_ms",
                    "library_ms", "tf32_floor_ms", "bound_ms", "bound_kind",
                    "max_abs_err", "own_rounding",
                    "max_abs_err_vs_own_rounding", "timed")}
                for k, row in lm_timed.items() if k.startswith(name + "/")}
        kernels.append(entry)
    log(json.dumps({"serving": {
        arch: {k: r[k] for k in ("prefill_tok_per_s", "decode_tok_per_s",
                                 "prefill_s", "decode_s", "peak_gb")}
        for arch, r in served.items()}, "card": card}))
    log(json.dumps({"training": {
        "musicgen-medium": {k: trained["musicgen-medium"][k] for k in (
            "train_tok_per_s", "step_ms", "peak_gb", "losses")},
        **{arch: {"fp32_leaf_rel_l2_max": r["fp32_leaf_rel_l2_max"],
                  "profile": r["profile"]}
           for arch, r in trained.items() if arch != "musicgen-medium"}},
        "card": card}))
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--aot-warm"]:
        aot_warm()
    else:
        main()
