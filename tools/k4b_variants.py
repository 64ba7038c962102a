#!/usr/bin/env python3
"""Time variants of K4b's route "mma" (``csrc/flash_attention_bwd_mma.cu``)
on one card, to show what each design choice is worth.

    python3 tools/k4b_variants.py [--only NAME ...]

Each variant is the shipped source built with some of its ``K4B_*`` macros
set by ``-D`` (the source's defaults are the shipped design) and the flags
of ``kernels/_build.py``: one ``nvcc`` each, in parallel, into
``build/variants/``.  Each is called through its C entry on the train
shapes of ``chip_smoke.py`` phase 17a (rows 9a-9c: minitron-4b,
musicgen-medium, recurrentgemma-2b with its window) and timed with its
``time_ms`` (device time per call, 5 calls a batch).  Each row gives the
most registers ``ptxas`` reports for the variant's kernels at the row's
padded head dim, whether any of them spills, and how many gradient entries
fall outside K4b's bf16 tolerance against the plain backward (the shipped
source gives 0).  The shipped source is timed first and last.  Needs a
card; prints one JSON line per variant and row.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd_mma.cu"
OUT = ROOT / "build" / "variants"
ENTRY = "flash_attention_bwd_mma"

# name: (what it changes, the source's macros it sets)
VARIANTS = {
    "shipped": ("the shipped source", ()),
    "recompute_both_256": ("pass 2 at DP = 256: both warps of a pair compute "
                           "S^T and dP^T (nothing handed over)",
                           ("K4B_DKV_HAND_OVER=0",)),
    "dkv_4_warps_256": ("pass 2 blocks of 4 warps at DP = 256 (32 keys, 2 "
                        "blocks an SM): twice the Q and dO traffic from L2",
                        ("K4B_DKV_WARPS=4",
                         "K4B_DKV_MIN_BLOCKS=(DP>64?2:3)")),
    "dkv_split_128": ("pass 2 at DP = 128 as at 256: two warps share 16 keys "
                      "(64 dims each, S^T and dP^T handed over), 3 blocks an "
                      "SM",
                      ("K4B_DKV_SPLIT=(DP>64?2:1)",
                       "K4B_DKV_MIN_BLOCKS=(DP>128?1:3)")),
    "dkv_br64_d64": ("pass 2 row tiles of 64 up to DP = 64, 2 blocks an SM",
                     ("K4B_DKV_BR=(DP>64?32:64)",
                      "K4B_DKV_MIN_BLOCKS=(DP>128?1:2)")),
    "dq_2_blocks": ("pass 3 bounded to 2 blocks an SM up to DP = 128",
                    ("K4B_DQ_BLOCKS=(DP>128?1:2)",)),
}


def build(name: str, defines) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build._FLAGS,
         *(f"-D{x}" for x in defines), "-shared", "-o",
         str(OUT / f"{name}.so"), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(name: str, proc: subprocess.Popen):
    """The variant's C entry and, per padded head dim, the most registers
    and whether any kernel spills."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k4b_variants: {name} does not build:\n{log}")
    regs: dict[int, tuple[int, bool]] = {}
    # ptxas reports each kernel as "Compiling entry function '<mangled>'"
    # then its spills and registers; the mangled name holds ILi<DP>E
    for block in log.split("Compiling entry function")[1:]:
        dp = int(re.search(r"ILi(\d+)E", block.split("'")[1]).group(1))
        used = int(re.search(r"Used (\d+) registers", block).group(1))
        spill = " 0 bytes spill stores" not in block
        old = regs.get(dp, (0, False))
        regs[dp] = (max(old[0], used), old[1] or spill)
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    fn = getattr(lib, ENTRY)
    fn.argtypes = list(_build._SIGNATURES[ENTRY])
    fn.restype = ctypes.c_int
    return fn, regs


def padded(d: int) -> int:
    return next(p for p in (16, 32, 64, 128, 256) if d <= p)


def outside(got, want, tol) -> int:
    atol, rtol = tol
    n = 0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        lim = atol * float(w.abs().max()) + rtol * w.abs()
        n += int(((g - w).abs() > lim).sum())
    return n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to build besides the shipped source")
    opts = ap.parse_args()
    names = ["shipped"] + [n for n in VARIANTS if n != "shipped" and (
        opts.only is None or n in opts.only)]
    procs = {n: build(n, VARIANTS[n][1]) for n in names}
    fns = {n: load(n, p) for n, p in procs.items()}
    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    stream = _build.stream_ptr(dev)
    for key, label, (b, lq, lk, hq, hkv, d), dtype, valid, window, timed \
            in cs.K4B_SHAPES:
        if dtype != torch.bfloat16 or not timed:
            continue
        q, do = (torch.randn((b, lq, hq, d), generator=gen, device=dev,
                             dtype=dtype) for _ in range(2))
        k, v = (torch.randn((b, lk, hkv, d), generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        valid = lk if valid is None else valid
        kw = dict(causal=True, lk_valid=valid, window=window)
        o = kfa.flash_attention(q, k, v, **kw)
        want = kfa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        g = hq // hkv
        rows = -(-lq * g // kfa.BWD_ROWS) * kfa.BWD_ROWS
        lse = torch.empty(b * hkv * rows, device=dev)
        dsum = torch.empty_like(lse)
        calls, bad, outs = {}, {}, {}
        for name in names:
            fn, _regs = fns[name]
            got = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
            st = (ctypes.c_longlong * 24)(*(
                s for x in (q, k, v, o, do, *got) for s in x.stride()[:3]))
            args = (*(x.data_ptr() for x in got), q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), b, lq, lk, valid, hq,
                    hkv, d, 1, window, d ** -0.5, st, stream)
            calls[name] = (lambda fn=fn, args=args, st=st, name=name:
                           _build.check(fn(*args), name))
            calls[name]()
            torch.cuda.synchronize()
            bad[name] = outside(got, want, cs.K4B_TOL[dtype])
            outs[name] = got   # the timed calls write here
        del want
        times = {n: [] for n in names}
        for name in names + ["shipped"]:
            times[name].append(cs.time_ms(calls[name], cs.PHASE17_RUNS))
        for name in names:
            regs, spill = fns[name][1][padded(d)]
            print(json.dumps({
                "variant": name, "change": VARIANTS[name][0], "row": key,
                "shape": label, "ms": times[name], "max_registers": regs,
                "spills": spill, "outside_tolerance": bad[name],
                "card": card}), flush=True)
        del q, k, v, o, do, lse, dsum, outs, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
