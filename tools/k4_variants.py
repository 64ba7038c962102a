#!/usr/bin/env python3
"""Time variants of K4's two CUDA routes on one card, to show what each
design choice of ``csrc/flash_attention_mma.cu`` and ``csrc/flash_decode.cu``
is worth.

    python3 tools/k4_variants.py

Each variant is the shipped source with a few constants or lines rewritten;
all are built with the flags of ``kernels/_build.py`` (one ``nvcc`` each,
in parallel, into ``build/variants/``), called through their C entry on the
inputs of ``chip_smoke.py`` phase 6 and timed with its ``time_ms`` (device
time per call).  Route "mma" at the prefill shape [8,1000,24/8,128] bf16
causal and at [8,200,24/8,128]; route "decode" at cache 1016, lk_valid 1001,
four input sets in turn.  Each row gives the most registers ``ptxas``
reports for a kernel of the variant, whether any kernel spills, and how many
outputs fall outside K4's bf16 tolerance against the plain version (the
shipped sources give 0).  Needs a card;
prints one JSON line per variant.
"""
from __future__ import annotations

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


def build(name: str, text: str) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build._FLAGS, "-shared", "-o",
         str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(stem: str, proc: subprocess.Popen, entry: str):
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k4_variants: {stem}.cu does not build:\n{log}")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
    fn = getattr(lib, entry)
    fn.argtypes = list(_build._SIGNATURES[entry])
    fn.restype = ctypes.c_int
    spills = any(" 0 bytes spill stores" not in ln
                 for ln in log.splitlines() if "spill stores" in ln)
    return fn, max(regs), spills


def outside(got: torch.Tensor, want: torch.Tensor) -> int:
    atol, rtol = cs.K4_BF16_TOL
    g, w = got.double(), want.double()
    return int(((g - w).abs() > atol + rtol * w.abs()).sum())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device is available")
    mma = (CSRC / "flash_attention_mma.cu").read_text()
    dec = (CSRC / "flash_decode.cu").read_text()
    lb = "__launch_bounds__(THREADS, 3)"
    mma_variants = {
        "mma shipped (32-key tiles, <=168 registers, 3 blocks/SM)": mma,
        "mma 2 blocks/SM": edit(mma, (lb, "__launch_bounds__(THREADS, 2)")),
        "mma 4 blocks/SM (<=128 registers)": edit(
            mma, (lb, "__launch_bounds__(THREADS, 4)")),
        "mma 64-key tiles, 2 blocks/SM": edit(
            mma, ("constexpr int BK = 32;", "constexpr int BK = 64;"),
            (lb, "__launch_bounds__(THREADS, 2)")),
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
                    b, lq, lq, hq, hkv, d, 1, d ** -0.5,
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
                    part.data_ptr(), 1, b, 1, lk, valid, hq, hkv, d, 1,
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
