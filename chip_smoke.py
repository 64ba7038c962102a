#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and continues):

1. setup — the card's name and power limit (nvidia-smi), the kernels'
   nvcc build and its seconds;
2. kernels — K1 ``minplus_acc``, K2 ``fw_pivot`` and K3 ``ell_relax_round``
   against their plain torch versions on the card at main-path shapes, on
   integer weights 1-16 over random-regular patterns with 1e18 non-edges:
   every result must match exactly; CUDA-event times (median of 30 runs
   after warm-up) beside the bound;
3. main path, sparse — 20 seeds of RRG(512, 16) with 8 servers per switch
   (4,096 servers) under permutation traffic through
   ``get_engine("dual", tol=1e-4).solve_batch`` ("auto" resolves to
   "ell-bf", so K3); bounds finite and positive, beside Theorem 1;
4. main path, dense — 4 seeds of RRG(512, 48) with 16 servers per switch
   ("auto" resolves to "blocked-fw": K1 + K2), then ``"dual-pallas"`` (K1)
   against ``backend="ell-bf"`` on 4 phase-3 instances, within rel 1e-3;
5. oracle — 3 seeds of RRG(40, 10) with 5 servers per switch: the HiGHS
   optimum <= dual ub <= 1.05 x optimum at 800 iterations, and the card's
   ub within rel 1e-3 of the same solve on the CPU (plain versions);
6. summary — one JSON line with every kernel, then the device line last.

Launch counts are reset just before each path's run (phase 3's and each
of phase 4's three) and read just after it; a kernel of a path that was not
launched fails the run.  The summary reports every path's own counts,
never a sum over runs: ``launches`` of a kernel is from the first path
that needs it (phase 3 for K3, the blocked-fw run for K1 and K2), and
``paths`` lists each run that launched it, with K1's launches in the
blocked-fw run split by panel (row, column, outer).
"""
from __future__ import annotations

import json
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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
TIMING_RUNS = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median milliseconds of one call (CUDA events, after warm-up)."""
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

    # K2: pivot tiles read and written in place through strided views
    got = kfw.fw_pivot(w[:, :128, :128].clone())
    want = kfw.fw_tile_closure(w[:, :128, :128])
    err2 = compare("K2 fw_pivot", got, want)
    tile = w[:, :128, :128].clone()
    bnd, kind = bound_ms(20 * 128 ** 3, 4 * 2 * 20 * 128 * 128)
    k2 = {"kernel": "fw_pivot", "shape": "[20,128,128]",
          "ms": time_ms(lambda: kfw.fw_pivot(tile)),
          "plain_ms": time_ms(lambda: kfw.fw_tile_closure(tile)),
          "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err2,
          "exact": True}
    log(json.dumps(k2))

    # K3: one Jacobi round on the all-source carry, d_max = 16
    idx, wgt = apsp_mod._pack_ell(w, 16)
    m = kell._full_init(idx, wgt)
    got_m, got_f = kell.ell_relax_round(m, idx, wgt)
    want_m, want_f = kell.ell_relax_round_plain(m, idx, wgt)
    err3 = compare("K3 ell_relax_round", got_m, want_m)
    compare("K3 flags", got_f, want_f)
    bnd, kind = bound_ms(20 * 512 * 512 * 16,
                         4 * 2 * 20 * 512 * 512 + 8 * 20 * 512 * 16)
    k3 = {"kernel": "ell_relax_round", "shape": "[20,512,512] d_max=16",
          "ms": time_ms(lambda: kell.ell_relax_round(m, idx, wgt)),
          "plain_ms": time_ms(lambda: kell.ell_relax_round_plain(m, idx, wgt)),
          "bound_ms": bnd, "bound_kind": kind, "max_abs_err": err3,
          "exact": True}
    log(json.dumps(k3))
    # and the whole closure on the card against plain Floyd-Warshall
    d_ell, rounds = kell.ell_bf_apsp(idx, wgt)
    compare("ell-bf closure vs Floyd-Warshall", d_ell.contiguous(),
            kfw.fw_apsp_plain(w))
    compare("blocked-fw closure vs Floyd-Warshall",
            kfw.fw_apsp_blocked(w), kfw.fw_apsp_plain(w))
    log(f"closures: ell-bf ({rounds} Jacobi rounds) == blocked-fw == plain "
        "Floyd-Warshall on [20,512,512]")
    return {"minplus_acc": square, "fw_pivot": k2, "ell_relax_round": k3}


def instances(graphs, traffic, n, deg, servers, seeds):
    topos, dems = [], []
    for s in seeds:
        t = graphs.random_regular_graph(n, deg, seed=s, servers=servers)
        topos.append(t)
        dems.append(traffic.make("permutation", t.servers, seed=s + 1))
    return topos, dems


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
    counts = dict(_build.LAUNCHES)
    sites = dict(_build.SITE_LAUNCHES)
    for k in need:
        if counts[k] == 0:
            raise SystemExit(f"chip_smoke: {name} did not launch {k}: "
                             f"{counts}")
    its = [r.meta["iterations"] for r in res]
    # descent steps plus the final forward, per batched chunk
    steps = sum(max(r.meta["iterations"] for r in res
                    if r.meta["chunk"] == c) + 1
                for c in range(res[0].meta["chunks"]))
    runs.append({"path": name, "launches": counts, "sites": sites,
                 "steps": steps})
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
    return {"steps": steps, "wall_ms": wall_ms,
            "wall_ms_per_step": wall_ms / steps,
            "kernel_ms": busy, "kernel_ms_per_step": busy / steps,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "range_kernel_ms": ranges,
            "top_kernels_ms": [[k[:70], ms] for k, ms in top]}


def main() -> None:
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
    pal = run_path("phase 4 dual-pallas RRG(512,16) x4",
                   get_engine("dual-pallas", iters=200), topos[:4],
                   dems[:4], runs, ["minplus_acc"])
    ell = run_path("phase 4 dual ell-bf RRG(512,16) x4",
                   get_engine("dual", iters=200, backend="ell-bf"),
                   topos[:4], dems[:4], runs, ["ell_relax_round"])
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

    # phase 6: summary
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
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timed[name]
        paths = []
        for run in runs:
            n = run["launches"][name]
            if n == 0:
                continue
            entry = {"path": run["path"], "launches": n,
                     "steps": run["steps"],
                     "launches_per_step": n / run["steps"]}
            by_site = {k.split("/", 1)[1]: v for k, v in run["sites"].items()
                       if k.startswith(name + "/")}
            if by_site:
                entry["by_site"] = by_site
            paths.append(entry)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[0]["launches"],
            "launches_per_step": paths[0]["launches_per_step"],
            "launches_path": paths[0]["path"], "paths": paths,
            "max_abs_err": t["max_abs_err"], "exact": t["exact"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_kind"],
            "library_ms": None, "card": card})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
