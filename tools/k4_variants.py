#!/usr/bin/env python3
"""Time variants of K4's three CUDA routes on one card, to show what each
design choice of ``csrc/flash_attention_mma.cu``, ``csrc/flash_decode.cu``
and ``csrc/flash_attention.cu`` is worth.

    python3 tools/k4_variants.py [--parent DIR] [--f32]

Each variant is the shipped source with a few constants or lines rewritten;
all are built with the flags of ``kernels/_build.py`` (one ``nvcc`` each,
in parallel, into ``build/variants/``), called through their C entry on the
inputs of ``chip_smoke.py`` phase 6 and timed with its ``time_ms`` (device
time per call).  Route "mma" at the prefill shape [8,1000,24/8,128] bf16
causal and at [8,200,24/8,128]; route "decode" at cache 1016, lk_valid 1001,
four input sets in turn.  Each row gives the most registers ``ptxas``
reports for a kernel of the variant, whether any kernel spills, and how many
outputs fall outside K4's bf16 tolerance against the plain version (the
shipped sources give 0).  With ``--parent DIR`` (the ``csrc`` directory of
an earlier checkout, e.g. from ``git archive``) that checkout's three K4
sources are built too, through their own C entries (with the ``window``
argument where the parent's source declares one, without it for sources
older than the local window; with the ``dtype`` argument where its
``flash_attention`` takes one), and phase 6's D = 128 rows of routes "mma"
([8,1000,24/8,128] bf16) and "decode" (the 1016 cache) are checked against
the plain version on both sides and timed parent, shipped, shipped, parent
in the same call.

Route "f32" runs at phase 6's rows 7c ([8,1000,24/8,128] float32 causal),
7f ([8,1000,10/1,256]) and 7h ([8,3000,10/1,256], window 2048): the
parent's source (with ``--parent``), the shipped design (each K and V
fragment split into TF32 big and small parts as it is loaded) and the
variants the ``K4F_*`` macros select (S's accumulator chains; the first
design's 64-row blocks of 4 warps; each K and V tile split once a block
into shared big and small planes; big . big alone, a diagnostic that
misses the tolerance), timed parent, shipped, the variants, shipped,
parent.  Each row gives every
build's entries outside K4's float32 tolerance against the plain version,
and the registers and spill bytes ``ptxas`` reports for its kernels at the
row's head dim.  ``--f32`` runs route "f32" alone.  Needs a card; prints
one JSON line per row.
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

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"


def edit(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"k4_variants: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def drop(text: str, needle: str) -> str:
    lines = text.splitlines()
    kept = [ln for ln in lines if needle not in ln]
    if len(kept) == len(lines):
        raise SystemExit(f"k4_variants: no line holds {needle!r}")
    return "\n".join(kept) + "\n"


def build(name: str, text: str, flags=()) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build._FLAGS, *flags, "-shared",
         "-o", str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def has_window(source: str) -> bool:
    """Whether a K4 source's C entries take the local window."""
    return re.search(r"\bint window\b", source) is not None


def has_dtype(source: str) -> bool:
    """Whether a K4 source's ``flash_attention`` entry takes a dtype (the
    CUDA-core design, float32 or bf16)."""
    entry = source.split('extern "C" int flash_attention(', 1)[-1]
    return re.search(r"\bint dtype\b", entry.split(")", 1)[0]) is not None


def signature(entry: str, window: bool, dtype: bool = False) -> list:
    """An entry's C signature; without ``window`` the same less the
    ``window`` int that precedes the float scale (sources older than the
    local window); with ``dtype`` one more int after the four pointers."""
    sig = list(_build._SIGNATURES[entry])
    if dtype:
        sig = sig[:4] + [ctypes.c_int] + sig[4:]
    if window:
        return sig
    f = sig.index(ctypes.c_float)
    return sig[:f - 1] + sig[f:]


def ptxas(log: str, dp: int) -> tuple[int, int]:
    """The most registers and the spill bytes (stores + loads) ``ptxas``
    reports for the kernels of head dim ``dp`` in a build's log."""
    regs, spill = 0, 0
    for block in log.split("Compiling entry function")[1:]:
        if f"Li{dp}E" not in block.split("'")[1]:
            continue
        m = re.search(r"Used (\d+) registers", block)
        regs = max(regs, int(m.group(1)) if m else 0)
        for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", block):
            spill += int(a) + int(b)
    return regs, spill


def load(stem: str, proc: subprocess.Popen, entry: str, window=True):
    """The variant's C entry, and the most registers and any spill of its
    kernels built for head dims up to 128 (the timed shapes; the D = 256
    instantiations are not timed here)."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k4_variants: {stem}.cu does not build:\n{log}")
    # ptxas reports each kernel as "Compiling entry function '<mangled>'"
    # then its spills and registers; keep the blocks not of DP/DM = 256
    blocks = log.split("Compiling entry function")[1:]
    log = "".join(b for b in blocks if "Li256E" not in b.split("'")[1])
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
    fn = getattr(lib, entry)
    fn.argtypes = signature(entry, window)
    fn.restype = ctypes.c_int
    spills = any(" 0 bytes spill stores" not in ln
                 for ln in log.splitlines() if "spill stores" in ln)
    return fn, max(regs), spills


def outside(got: torch.Tensor, want: torch.Tensor,
            tol=cs.K4_BF16_TOL) -> int:
    atol, rtol = tol
    g, w = got.double(), want.double()
    return int(((g - w).abs() > atol + rtol * w.abs()).sum())


def parent_rows(parent: pathlib.Path, card: str) -> None:
    """Phase 6's D = 128 rows through the parent's and the shipped C
    entries, timed parent, shipped, shipped, parent."""
    entries = {"mma": ("flash_attention_mma.cu", "flash_attention_mma"),
               "decode": ("flash_decode.cu", "flash_decode")}
    OUT.mkdir(parents=True, exist_ok=True)
    procs, windowed = {}, {}
    for route, (src, entry) in entries.items():
        windowed[("parent", route)] = has_window((parent / src).read_text())
        windowed[("shipped", route)] = True
        procs[("parent", route)] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH, *_build._FLAGS, "-shared", "-o",
             str(OUT / f"p_{route}.so"), str(parent / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[("shipped", route)] = build(f"s_{route}",
                                          (CSRC / src).read_text())
    fns = {key: load(("p_" if key[0] == "parent" else "s_") + key[1], proc,
                     entries[key[1]][1], windowed[key])[0]
           for key, proc in procs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, hq, hkv, d = 8, 24, 8, 128
    stream = _build.stream_ptr(dev)
    for route, lq, lk, valid, dtype, sets in (
            ("mma", 1000, 1000, 1000, torch.bfloat16, 1),
            ("decode", 1, 1016, 1001, torch.bfloat16, 4)):
        inputs = [tuple(torch.randn((b, n, h, d), generator=gen, device=dev,
                                    dtype=dtype)
                        for n, h in ((lq, hq), (lk, hkv), (lk, hkv)))
                  for _ in range(sets)]
        want = kfa.flash_attention_plain(*inputs[0], lk_valid=valid)
        calls, outs = {}, {}
        for side in ("parent", "shipped"):
            fn = fns[(side, route)]
            window = (0,) if windowed[(side, route)] else ()
            calls[side] = []
            for q, k, v in inputs:
                out = torch.empty_like(q)
                st = [s for x in (q, k, v, out) for s in x.stride()[:3]]
                ptrs = (out.data_ptr(), q.data_ptr(), k.data_ptr(),
                        v.data_ptr())
                if route == "decode":
                    part = torch.empty(b * hkv * -(-lk // 64) * (hq // hkv)
                                       * (d + 2), device=dev)
                    args = (*ptrs, part.data_ptr(), 1, b, 1, lk, valid, hq,
                            hkv, d, 1, *window, d ** -0.5, *st, stream)
                    outs.setdefault(side, []).append((out, part))
                else:
                    args = (*ptrs, b, lq, valid, hq, hkv, d, 1, *window,
                            d ** -0.5, *st, stream)
                    outs.setdefault(side, []).append(out)
                calls[side].append(lambda fn=fn, args=args: _build.check(
                    fn(*args), "K4"))
            calls[side][0]()
        torch.cuda.synchronize()
        bad = {}
        for side, side_outs in outs.items():
            got = side_outs[0][0] if route == "decode" else side_outs[0]
            bad[side] = outside(got, want)
        times = {}
        for side in ("parent", "shipped", "shipped", "parent"):
            times.setdefault(side, []).append(cs.time_ms(calls[side]))
        print(json.dumps({
            "route": route, "shape": f"[{b},{lq},{hq}/{hkv},{d}] bf16, "
            f"keys {valid}",
            "parent_ms": times["parent"], "shipped_ms": times["shipped"],
            "parent_has_window": windowed[("parent", route)],
            "outside_tolerance": bad, "card": card}), flush=True)


# route "f32"'s variants: -D flags over the shipped source
FIRST = ("-DK4F_WARPS=4", "-DK4F_BLOCKS=(DP>128?1:DP>64?2:3)",
         "-DK4F_S_CHAINS=1")   # the first design: 64-row blocks, S in 1 chain
F32_VARIANTS = {
    "f32 shipped": (),
    "f32 S in 1 chain": ("-DK4F_S_CHAINS=1",),
    "f32 S in 4 chains": ("-DK4F_S_CHAINS=4",),
    "f32 4 warps, S in 1 chain (first design)": FIRST,
    "f32 4 warps, S in 1 chain, K and V split once, 16-key tiles": (
        *FIRST, "-DK4F_SPLIT_ONCE=1", "-DK4F_BK=16"),
    # a diagnostic: 1xTF32 (no split) misses the tolerance
    "f32 one product (1xTF32, misses the tolerance)": (
        "-DK4F_ONE_PRODUCT=1",),
}
# phase 6's float32 rows: label, lq, (hq, hkv, d), window
F32_ROWS = (("7c", 1000, (24, 8, 128), 0), ("7f", 1000, (10, 1, 256), 0),
            ("7h", 3000, (10, 1, 256), 2048))


def f32_rows(parent: pathlib.Path | None, card: str) -> None:
    """Route "f32" at rows 7c, 7f and 7h: the parent's source, the shipped
    one and its K4F_* variants, each checked against the plain version and
    timed parent, shipped, variants, shipped, parent."""
    src = (CSRC / "flash_attention.cu").read_text()
    procs = {name: build(f"f{i}", src, flags)
             for i, (name, flags) in enumerate(F32_VARIANTS.items())}
    if parent is not None:
        psrc = (parent / "flash_attention.cu").read_text()
        procs["parent"] = build("f_parent", psrc)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k4_variants: {name} does not build:\n{log}")
        stem = "f_parent" if name == "parent" else \
            f"f{list(F32_VARIANTS).index(name)}"
        fn = getattr(ctypes.CDLL(str(OUT / f"{stem}.so")), "flash_attention")
        text = psrc if name == "parent" else src
        dtype_arg = has_dtype(text)
        fn.argtypes = signature("flash_attention", has_window(text), dtype_arg)
        fn.restype = ctypes.c_int
        fns[name] = (fn, dtype_arg, has_window(text), log)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    stream = _build.stream_ptr(dev)
    b = 8
    for row, lq, (hq, hkv, d), window in F32_ROWS:
        q = torch.randn((b, lq, hq, d), generator=gen, device=dev)
        k, v = (torch.randn((b, lq, hkv, d), generator=gen, device=dev)
                for _ in range(2))
        kw = dict(causal=True, lk_valid=lq, window=window)
        want = kfa.flash_attention_plain(q, k, v, **kw)
        calls, bad, regs, outs = {}, {}, {}, {}
        for name, (fn, dtype_arg, windowed, log) in fns.items():
            if window and not windowed:
                continue
            out = torch.empty_like(q)
            st = [s for x in (q, k, v, out) for s in x.stride()[:3]]
            args = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    *((0,) if dtype_arg else ()), b, lq, lq, hq, hkv, d, 1,
                    *((window,) if windowed else ()), d ** -0.5, *st, stream)
            calls[name] = (lambda fn=fn, args=args: _build.check(
                fn(*args), "K4 f32"))
            try:
                calls[name]()
            except RuntimeError as err:   # e.g. more shared memory than a block has
                bad[name] = str(err)
                del calls[name]
                continue
            torch.cuda.synchronize()
            bad[name] = outside(out, want, cs.K4_F32_TOL)
            # the parent's CUDA-core kernels: DM = 128 or 256
            regs[name] = ptxas(log, 128 if d <= 128 else 256)
            outs[name] = out      # the timed calls write it
        del want
        order = (["parent"] if "parent" in calls else []) + list(
            F32_VARIANTS) + ["f32 shipped"] + (
            ["parent"] if "parent" in calls else [])
        times: dict[str, list] = {}
        for name in (n for n in order if n in calls):
            times.setdefault(name, []).append(cs.time_ms(calls[name]))
        pairs = cs.visible_pairs(lq, lq, window)
        print(json.dumps({
            "route": "f32", "row": row,
            "shape": f"[{b},{lq},{hq}/{hkv},{d}] f32 causal"
                     + (f", window {window}" if window else ""),
            "order": order, "ms": times, "outside_tolerance": bad,
            "registers_spill_bytes": regs,
            "tf32_floor_ms": cs.tf32_floor_ms(b, hq, d, pairs),
            "fp32_bound_ms": cs.flop_bound_ms(
                4.0 * b * hq * d * pairs, cs.FP32_FLOP_PER_S,
                4 * (2 * q.numel() + 2 * k.numel()))[0],
            "card": card}), flush=True)
        del q, k, v, calls, outs
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="csrc directory of an earlier checkout")
    ap.add_argument("--f32", action="store_true",
                    help="route f32 alone")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device is available")
    f32_rows(opts.parent, cs.card_line())
    if opts.f32:
        return
    if opts.parent is not None:
        parent_rows(opts.parent, cs.card_line())
    mma = (CSRC / "flash_attention_mma.cu").read_text()
    dec = (CSRC / "flash_decode.cu").read_text()
    lb = "constexpr int MIN_BLOCKS = 3;"
    mma_variants = {
        "mma shipped (32-key tiles, <=168 registers, 3 blocks/SM)": mma,
        "mma 2 blocks/SM": edit(mma, (lb, "constexpr int MIN_BLOCKS = 2;")),
        "mma 4 blocks/SM (<=128 registers)": edit(
            mma, (lb, "constexpr int MIN_BLOCKS = 4;")),
        "mma 64-key tiles, 2 blocks/SM": edit(
            mma, ("constexpr int BK = 32;", "constexpr int BK = 64;"),
            (lb, "constexpr int MIN_BLOCKS = 2;")),
        "mma P in bf16 alone (no lo product)": drop(mma, "], pl, bv["),
    }
    dec_variants = {f"decode split {n}": edit(
        dec, ("constexpr int SPLIT = 64;", f"constexpr int SPLIT = {n};"))
        for n in (32, 64, 128)}
    procs = {name: (f"v{i}", build(f"v{i}", text)) for i, (name, text) in
             enumerate(list(mma_variants.items()) + list(dec_variants.items()))}
    fns = {name: load(stem, proc, "flash_attention_mma" if name.startswith(
        "mma") else "flash_decode") for name, (stem, proc) in procs.items()}
    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, hq, hkv, d = 8, 24, 8, 128
    stream = _build.stream_ptr(dev)

    def strides(*xs):
        return [s for x in xs for s in x.stride()[:3]]

    for lq in (1000, 200):
        q, k, v = (torch.randn((b, lq, h, d), generator=gen, device=dev,
                               dtype=torch.bfloat16) for h in (hq, hkv, hkv))
        want = kfa.flash_attention_plain(q, k, v)
        for name, (fn, regs, spills) in fns.items():
            if not name.startswith("mma"):
                continue
            out = torch.empty_like(q)
            args = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    b, lq, lq, hq, hkv, d, 1, 0, d ** -0.5,
                    *strides(q, k, v, out), stream)

            def call(fn=fn, args=args):
                _build.check(fn(*args), "variant")
            call()
            print(json.dumps({
                "variant": name, "shape": f"[{b},{lq},{hq}/{hkv},{d}] bf16",
                "ms": cs.time_ms(call), "registers": regs, "spills": spills,
                "outside_tolerance": outside(out, want), "card": card}),
                flush=True)

    lk, valid = 1016, 1001
    sets = [tuple(torch.randn((b, n, h, d), generator=gen, device=dev,
                              dtype=torch.bfloat16)
                  for n, h in ((1, hq), (lk, hkv), (lk, hkv)))
            for _ in range(4)]
    want = kfa.flash_attention_plain(*sets[0], lk_valid=valid)
    for name, (fn, regs, spills) in fns.items():
        if name.startswith("mma"):
            continue
        split = int(name.rsplit(" ", 1)[1])
        calls, outs = [], []
        for q, k, v in sets:
            out = torch.empty_like(q)
            part = torch.empty(b * hkv * -(-lk // split) * (hq // hkv)
                               * (d + 2), device=dev)
            args = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    part.data_ptr(), 1, b, 1, lk, valid, hq, hkv, d, 1, 0,
                    d ** -0.5, *strides(q, k, v, out), stream)
            calls.append(lambda fn=fn, args=args: _build.check(
                fn(*args), "variant"))
            outs.append((out, part))
        calls[0]()
        print(json.dumps({
            "variant": name, "shape": "[8,1,24/8,128] bf16, cache 1016, "
            "lk_valid 1001", "ms": cs.time_ms(calls), "registers": regs,
            "spills": spills, "outside_tolerance": outside(outs[0][0], want),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
