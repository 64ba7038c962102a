#!/usr/bin/env python3
"""Time K4b's route "f32" (``csrc/flash_attention_bwd.cu``) and K5b
(``csrc/wkv_bwd.cu``) against an earlier checkout's designs and against
variants of the shipped ones, on one card, in one call.

    python3 tools/k4b_k5b_variants.py [--parent DIR] [--only NAME ...]

``DIR`` is the ``csrc`` directory of an earlier checkout unpacked by ``git
archive`` (e.g. ``mkdir -p build/parent && git archive HEAD~1
src/repro_torch/csrc | tar -x -C build/parent``, then
``DIR=build/parent/src/repro_torch/csrc``); its two sources are built as
they are and called through the same C entries.  The variants are the
shipped sources built with some of their macros set by ``-D`` (the
sources' defaults are the shipped designs): for K4b the TF32 rounding by
``cvt.rna.tf32.f32`` in place of integer operations (the same bits), the
small part rounded too, pass 2's sums over a key block's whole band of
rows in place of segments of 4096, and pass 2 at D = 128 with two warps
a 16-key group; for K5b the two sweeps launched one after the other
rather than as one grid.  Every source is built with the flags of
``kernels/_build.py`` (one ``nvcc`` each, in parallel, into
``build/variants/``).

The rows are ``chip_smoke.py`` phase 17a's: K4b's timed float32 rows (9d
minitron-4b, 9f recurrentgemma-2b with its window, 9e ragged) and K5b's at
T = 1024 and 1000 (10a, 10b; [8, T, 64, 64] as [B, H, T, n] views).  Each
variant is timed with ``chip_smoke.time_ms`` (device time per call), the
shipped source first and last, and gives the registers and spill bytes
``ptxas`` reports for each of its kernels at the row's head dim, and the
count of gradient entries outside the kernel's tolerance against the
plain backward (``K4B_TOL``'s float32 entry, ``K5B_TOL``).  Then the
shipped kernels' time by pass (``torch.profiler``).  Needs a card; prints
one JSON line per variant and row.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
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
from repro_torch.kernels import wkv as kwkv  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"
K4B, K5B = "flash_attention_bwd", "wkv_chunked_bwd"
SOURCES = {K4B: "flash_attention_bwd.cu", K5B: "wkv_bwd.cu"}

# name: (kernel, what it changes, the shipped source's macros it sets)
VARIANTS = {
    "k4b shipped": (K4B, "the shipped source", ()),
    "k4b rna by cvt": (K4B, "rna(x) by cvt.rna.tf32.f32 in place of (bits "
                       "+ 0x1000) & ~0x1fff (the same bits)",
                       ("K4B_TF32_CVT=1",)),
    "k4b small rna": (K4B, "the small part rounded to tf32 by rna too, not "
                      "handed over as the remainder", ("K4B_SMALL_RNA=1",)),
    "k4b one segment": (K4B, "pass 2 sums dK and dV over the whole band "
                        "in the tensor cores' accumulators, no segments of "
                        "4096 rows", ("K4B_SEG_ROWS=1073741824",)),
    "k4b dkv split at 128": (K4B, "pass 2 at DP = 128 as at 256: two warps "
                             "share 16 keys (64 dims each, S^T and dP^T "
                             "handed over), 8 warps, one block an SM",
                             ("K4B_DKV_SPLIT=(DP>64?2:1)",
                              "K4B_DKV_BLOCKS=(DP>64?1:2)")),
    "k5b shipped": (K5B, "the shipped source", ()),
    "k5b sweeps apart": (K5B, "the state sweep, then the cotangent sweep, "
                         "as two launches of one block a lane",
                         ("K5B_SWEEPS_APART=1",)),
}


def build(name: str, src: pathlib.Path, defines):
    """The build's process, its library and whether it is an earlier K4b
    entry (no segment scratch: its source lacks ``int nseg``)."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{re.sub(r'[^a-z0-9]+', '_', name)}.so"
    earlier = src.name == SOURCES[K4B] and "int nseg" not in src.read_text()
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build._FLAGS,
         *(f"-D{x}" for x in defines), "-shared", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so, \
        earlier


# route "f32"'s C entry before its pass 2 took row segments (no part, nseg)
_K4B_EARLIER = (*(ctypes.c_void_p,) * 10, *(ctypes.c_int,) * 9, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p)


def load(name: str, kernel: str, proc: subprocess.Popen, so: pathlib.Path,
         earlier: bool):
    """The variant's C entry and, per kernel (mangled name), registers and
    spill-store bytes."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k4b_k5b_variants: {name} does not build:\n{log}")
    info, kname, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            kname, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and kname:
            info[kname] = (int(m.group(1)), spill)
    fn = getattr(ctypes.CDLL(str(so)), kernel)
    fn.argtypes = list(_K4B_EARLIER if earlier else _build._SIGNATURES[kernel])
    fn.restype = ctypes.c_int
    return fn, info, earlier


KERNELS = ("bwd_tf32_lse", "bwd_tf32_dkv_sum", "bwd_tf32_dkv",
           "bwd_tf32_dq", "bwd_lse", "bwd_dkv", "bwd_dq", "wkv_bwd_sweep",
           "wkv_bwd_chunk", "wkv_bwd_du", "wkv_bwd_kernel")


def regs(info: dict, tag: str | None) -> dict[str, list[int]]:
    """[registers, spill bytes] of each kernel whose mangled name holds
    ``tag`` (a template argument such as ``ILi128E``; all if None), by the
    kernel's name."""
    out = {}
    for k, v in info.items():
        if tag is None or tag in k:
            name = next((n for n in KERNELS if n in k), k)
            out[name] = list(v)
    return out


def outside(got, want, tol) -> tuple[int, list[float]]:
    """Entries outside the tolerance, and each gradient's largest |error| /
    allowed."""
    atol, rtol = tol
    n, worst = 0, []
    for g, w in zip(got, want):
        if w is None:
            continue
        g, w = g.double(), w.double()
        lim = atol * float(w.abs().max()) + rtol * w.abs()
        err = (g - w).abs()
        n += int((~(err <= lim)).sum())
        worst.append(float((err / lim).max()))
    return n, worst


def seg_rows(name: str) -> int:
    """Pass 2's rows a segment in a K4b variant (its K4B_SEG_ROWS)."""
    for x in VARIANTS.get(name, (None, None, ()))[2]:
        if x.startswith("K4B_SEG_ROWS="):
            return int(x.split("=", 1)[1])
    return kfa.BWD_SEG_ROWS


def padded(d: int) -> int:
    return next(p for p in (16, 32, 64, 128, 256) if d <= p)


def k4b_rows(gen, dev):
    for key, label, (b, lq, lk, hq, hkv, d), dtype, valid, window, timed \
            in cs.K4B_SHAPES:
        if dtype != torch.float32 or not timed:
            continue
        q, do = (torch.randn((b, lq, hq, d), generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((b, lk, hkv, d), generator=gen, device=dev)
                for _ in range(2))
        valid = lk if valid is None else valid
        kw = dict(causal=True, lk_valid=valid, window=window)
        o = kfa.flash_attention(q, k, v, **kw)
        rows = -(-lq * (hq // hkv) // kfa.BWD_ROWS) * kfa.BWD_ROWS
        lse = torch.empty(b * hkv * rows, device=dev)
        dsum = torch.empty_like(lse)
        nseg = -(-lq * (hq // hkv) // kfa.BWD_SEG_ROWS)
        part = torch.empty(nseg * 2 * b * hkv * lk * d, device=dev)
        got = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        st = (ctypes.c_longlong * 24)(*(
            s for x in (q, k, v, o, do, *got) for s in x.stride()[:3]))
        ptrs = (*(x.data_ptr() for x in got), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dsum.data_ptr())
        geo = (b, lq, lk, valid, hq, hkv, d, 1, window)
        tail = (d ** -0.5, st, _build.stream_ptr(dev))
        def args(seg_rows, ptrs=ptrs, geo=geo, tail=tail, part=part):
            """The C entry's arguments for pass-2 segments of ``seg_rows``
            rows (None: the earlier entry's, which has none)."""
            if seg_rows is None:
                return (*ptrs, *geo, *tail)
            n = -(-lq * (hq // hkv) // seg_rows)
            return (*ptrs, part.data_ptr(), *geo, n, *tail)
        yield (key, label, f"ILi{padded(d)}E", args, got,
               lambda: kfa.flash_attention_bwd_plain(q, k, v, o, do, **kw),
               cs.K4B_TOL[torch.float32],
               lambda: kfa.flash_attention_bwd(q, k, v, o, do, **kw))


def k5b_rows(gen, dev):
    b, h, n = 8, 64, 64
    for t in (1024, 1000):
        def view(x):
            return x.permute(0, 2, 1, 3)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        r, k, v, dout = (view(randn(b, t, h, n)) for _ in range(4))
        log_w = view(-torch.clamp(torch.exp(randn(b, t, h, n)), 1e-6, 2.5))
        u = randn(h, n) * 0.5
        s0, ds = randn(b, h, n, n) * 0.3, randn(b, h, n, n)
        lanes, nc = b * h, -(-t // kwkv.CHUNK)
        # room for either design's scratch: the chunk-start states and the
        # end cotangents, rows padded to 4, and the du partials
        scratch = torch.empty(lanes * nc * (2 * n * (-(-n // 4) * 4)
                                            + kwkv.N_MAX), device=dev)
        outs = [torch.empty_like(x) for x in (r, k, v, log_w)]
        du = torch.empty((lanes, n), device=dev)
        ds0 = torch.empty((b, h, n, n), device=dev)
        # u per head: no batch stride
        st = (ctypes.c_longlong * 29)(*(
            s for x in (r, k, v, log_w, dout, *outs) for s in x.stride()[:3]),
            0, u.stride(0))
        args = (*(x.data_ptr() for x in outs), du.data_ptr(), ds0.data_ptr(),
                r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                dout.data_ptr(), u.data_ptr(), s0.data_ptr(), ds.data_ptr(),
                scratch.data_ptr(), b, h, t, n, st, _build.stream_ptr(dev))
        pl = (r, k, v, log_w, u, s0, dout, ds)

        def plain(pl=pl):
            # du per lane and ds0 in the C entry's layout
            dr, dk, dv, dw, _, d0 = kwkv.wkv_chunked_bwd_plain(*pl)
            return dr, dk, dv, dw, d0
        yield (f"T{t}", f"[{b},{t},{h},{n}] f32 as [B,H,T,n] views, s0, ds",
               None, args, (*outs, ds0), plain, cs.K5B_TOL,
               lambda pl=pl: kwkv.wkv_chunked_bwd(*pl))


def pass_split(call, tags) -> dict:
    """Device ms a call of each of the kernels named by ``tags`` (an event
    counts under the first tag its name holds), from ``torch.profiler``
    over 3 calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        tag = next((t for t in tags if t in e.key), None)
        if tag is not None:
            ms = getattr(e, "device_time_total", None)
            if ms is None:
                ms = e.cuda_time_total
            out[tag] = out.get(tag, 0.0) + ms / 1e3 / 3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="csrc directory of an earlier checkout")
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to build besides the shipped sources")
    opts = ap.parse_args()
    names = [n for n in VARIANTS if n.endswith("shipped") or (
        opts.only is None or n in opts.only)]
    procs = {n: build(n, CSRC / SOURCES[VARIANTS[n][0]], VARIANTS[n][2])
             for n in names}
    kernel_of = {n: VARIANTS[n][0] for n in names}
    change = {n: VARIANTS[n][1] for n in names}
    if opts.parent is not None:
        for kernel in (K4B, K5B):
            name = f"{'k4b' if kernel == K4B else 'k5b'} parent"
            procs[name] = build(name, opts.parent / SOURCES[kernel], ())
            kernel_of[name] = kernel
            change[name] = f"{opts.parent / SOURCES[kernel]} as it is"
    fns = {n: load(n, kernel_of[n], *procs[n]) for n in procs}
    card = cs.card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(17)
    for kernel, rows in ((K4B, k4b_rows(gen, dev)), (K5B, k5b_rows(gen, dev))):
        mine = [n for n in fns if kernel_of[n] == kernel]
        shipped = next(n for n in mine if n.endswith("shipped"))
        order = [shipped] + [n for n in mine if n != shipped] + [shipped]
        for key, label, tag, args, got, plain, tol, wrapper in rows:
            want = plain()
            bad, calls = {}, {}
            for name in mine:
                fn, _, earlier = fns[name]
                a = args(None if earlier else seg_rows(name)) \
                    if kernel == K4B else args
                calls[name] = (lambda fn=fn, name=name, a=a:
                               _build.check(fn(*a), name))
                calls[name]()
                torch.cuda.synchronize()
                bad[name] = outside(got, want, tol)
            del want
            times = {n: [] for n in mine}
            for name in order:
                runs = cs.PHASE17_RUNS if key != "ragged f32" else \
                    cs.TIMING_RUNS
                times[name].append(cs.time_ms(calls[name], runs))
            for name in mine:
                print(json.dumps({
                    "variant": name, "change": change[name], "row": key,
                    "shape": label, "ms": times[name],
                    "registers_and_spill_bytes": regs(fns[name][1], tag),
                    "outside_tolerance": bad[name][0],
                    "worst_ratio_by_gradient": bad[name][1], "card": card}),
                    flush=True)
            tags = (("bwd_tf32_lse", "bwd_tf32_dkv_sum", "bwd_tf32_dkv",
                     "bwd_tf32_dq")
                    if kernel == K4B else
                    ("wkv_bwd_sweep", "wkv_bwd_chunk", "wkv_bwd_du"))
            split = pass_split(wrapper, tags)
            print(json.dumps({"pass_split_ms": split, "row": key,
                              "total_ms": math.fsum(split.values()),
                              "card": card}), flush=True)
            del args, got, calls
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
