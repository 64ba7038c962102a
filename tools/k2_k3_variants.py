#!/usr/bin/env python3
"""Time design variants of K2 (``csrc/fw_pivot.cu``) and K3 (``csrc/ell.cu``)
on one card, to show what each design choice is worth.

    python3 tools/k2_k3_variants.py [--parent DIR]

K2: the tile in registers as a 4x4 micro-tile a thread (1024 threads) and
as an 8x8 one (256 threads), copies of the shipped source with ``MICRO``
edited, on the pivot tiles of ``chip_smoke.py`` phase 2 ([20, 128, 128],
and the ragged [20, 100, 100]), checked bit for bit against
``fw_tile_closure``.  K3: route ``slab`` with spans of 32 sources (shipped)
and of 16 (an edited copy: two target rows a warp at once, half the slab),
and route ``l2``, on one Jacobi round of the all-source carry of RRG(N, 16)
at N = 512 (20 lanes, phase 2's input), 1024 (5 lanes) and 2048 (2 lanes),
checked bit for bit against ``ell_relax_round_plain``, flags too; ``ms``
times one carry over and over (it stays in the 50 MB L2), ``cold_ms`` takes
3 distinct carries in turn (3 x 21 MB or more, so they come from device
memory).  A slab that does not fit a block's shared memory is reported
and not run.  Ablations (copies of the shipped source with one part taken
out; their results are wrong on purpose and reported, not checked) show
what holds each kernel back: K2 without its barrier, and with an add in
place of the min; K3 with the slab load alone, without the table loads
and without the gathers.  K3 is also timed on [b, 512, 512] for b = 8, 16,
17, 20 and 25 (128 to 400 blocks against the card's 132 SMs x 3 slots).
With ``--parent DIR`` (the ``csrc`` directory of an earlier
checkout, e.g. from ``git archive``) that checkout's ``fw_pivot.cu`` and
``ell.cu`` are built too and timed on the same inputs through their own C
entries, in the same call.

Every variant is built with the flags of ``kernels/_build.py`` (one
``nvcc`` each, in parallel, into ``build/variants/``) and timed with
``chip_smoke.time_ms`` (device time per call).  Each row gives the
registers, spill bytes and stack frame ``ptxas`` reports for the kernel the
row ran.  Needs a card; prints one JSON line per row.
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
from repro_torch.core import apsp as apsp_mod  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ell as kell  # noqa: E402
from repro_torch.kernels import fw as kfw  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"
_P, _I = ctypes.c_void_p, ctypes.c_int
# K3's C entry before the routes (no route argument; int32 flags per
# 8 x 128)
_EARLIER_ELL = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_EARLIER_SPAN = 128


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"k2_k3_variants: {old!r} is not in the source")
    return text.replace(old, new)


def build(name: str, src: pathlib.Path) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build._FLAGS, "-shared",
         "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas(log: str) -> dict[str, dict]:
    """Registers, spill-store bytes and stack frame per kernel of a
    ``-Xptxas -v`` log, keyed by the kernel's mangled name."""
    out, name, frame, spill = {}, None, 0, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, frame, spill = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m:
            frame, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = {"registers": int(m.group(1)), "spill_bytes": spill,
                         "stack_frame": frame}
    return out


def load(name: str, proc: subprocess.Popen, entry: str, argtypes):
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k2_k3_variants: {name} does not build:\n{log}")
    fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn, ptxas(log)


def regs(info: dict[str, dict], tag: str) -> dict:
    """ptxas figures of the one kernel whose mangled name holds ``tag``."""
    hits = [v for k, v in info.items() if tag in k]
    return hits[0] if len(hits) == 1 else {"registers": None,
                                           "spill_bytes": None,
                                           "stack_frame": None}


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def timed_rows(fns: dict, card: str, stream: int) -> None:
    k2 = {k: v for k, v in fns.items() if k.startswith("K2")}
    k3 = {k: v for k, v in fns.items() if k.startswith("K3")}
    k2_rows(k2, card, stream)
    k3_rows(k3, card, stream)
    k3_lanes(k3["K3 route slab, span 32 (shipped)"][0], card, stream)


def k2_rows(fns: dict, card: str, stream: int) -> None:
    dev = torch.device("cuda")
    w = torch.tensor(cs.quantized_weights(512, 16, 20, 100, graphs),
                     device=dev)
    for t in (128, 100):
        want = kfw.fw_tile_closure(w[:, :t, :t])
        for name, (fn, info) in fns.items():
            wrong = "wrong result" in name
            if wrong and t != 128:
                continue
            got = w[:, :t, :t].clone()
            _build.check(fn(got.data_ptr(), 20, t, got.stride(0),
                            got.stride(1), stream), name)
            torch.cuda.synchronize()
            tile = w[:, :t, :t].clone()

            def call(fn=fn, tile=tile):
                _build.check(fn(tile.data_ptr(), 20, t, tile.stride(0),
                                tile.stride(1), stream), "variant")
            emit({"variant": name, "shape": f"[20,{t},{t}]",
                  "ms": cs.time_ms(call), **regs(info, "fw_pivot_kernel"),
                  "exact": None if wrong else bool(torch.equal(got, want)),
                  "card": card})


def ell_args(fn, route, span, out, flags, x, idx, wgt, stream):
    """A bound call of a K3 C entry (route None: the earlier entry)."""
    bsz, n, s = x.shape
    head = (out.data_ptr(), flags.data_ptr(), x.data_ptr(), idx.data_ptr(),
            wgt.data_ptr(), bsz, n, s, idx.shape[-1], kell.TILE)
    tail = ((_EARLIER_SPAN, stream) if route is None else
            (kell.SPAN, kell.ROUTES.index(route), stream))
    return lambda: fn(*head, *tail)


def k3_rows(fns: dict, card: str, stream: int) -> None:
    dev = torch.device("cuda")
    for n, lanes in ((512, 20), (1024, 5), (2048, 2)):
        w = torch.tensor(cs.quantized_weights(n, 16, lanes, 100, graphs),
                         device=dev)
        idx, wgt = apsp_mod._pack_ell(w, 16)
        del w
        m = kell._full_init(idx, wgt)
        carries = [m] + [m.clone() for _ in range(2)]
        want, _ = kell.ell_relax_round_plain(m, idx, wgt)
        bsz, _, s = m.shape
        d = idx.shape[-1]
        nt = -(-n // kell.TILE)
        for name, (fn, info, route, span) in fns.items():
            wrong = "wrong result" in name
            if wrong and n != 512:
                continue
            out = torch.empty_like(m)
            flags = torch.empty((bsz, nt, -(-s // span)), device=dev,
                                dtype=torch.int32 if route is None
                                else torch.bool)
            code = ell_args(fn, route, span, out, flags, m, idx, wgt,
                            stream)()
            if route == "slab" and code == kell._ERR_ROUTE:
                emit({"variant": name, "shape": f"[{lanes},{n},{n}] d_max=16",
                      "ms": None, "note": "the slab does not fit a block's "
                      "shared memory", "card": card})
                continue
            _build.check(code, name)
            torch.cuda.synchronize()
            exact = None if wrong else bool(torch.equal(out, want)) and bool(
                torch.equal(flags.bool(), kell._block_flags(want, m, span)))
            calls = [lambda c=ell_args(fn, route, span, out, flags, x, idx,
                                       wgt, stream): _build.check(c(), "v")
                     for x in carries]
            tag = ("ell_slab_kernelILi16E" if span == 16 else
                   "ell_slab_kernelILi32E" if route == "slab" else
                   "ell_l2_kernel" if route == "l2" else
                   "ell_relax_round_kernel")
            emit({"variant": name, "route": route or "earlier",
                  "span": span, "shape": f"[{lanes},{n},{n}] d_max=16",
                  "picked": kell.ell_route(n, d), "ms": cs.time_ms(calls[0]),
                  "cold_ms": cs.time_ms(calls), **regs(info, tag),
                  "exact": exact, "card": card})
        del m, carries, want, idx, wgt
        torch.cuda.empty_cache()


def k3_lanes(fn, card: str, stream: int) -> None:
    """Route slab on [b, 512, 512]: 16 blocks a lane, 3 resident an SM."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = torch.tensor(cs.quantized_weights(512, 16, 25, 100, graphs),
                     device=dev)
    idx, wgt = apsp_mod._pack_ell(w, 16)
    m = kell._full_init(idx, wgt)
    for b in (8, 16, 17, 20, 25):
        x, ib, wb = m[:b].contiguous(), idx[:b].contiguous(), \
            wgt[:b].contiguous()
        out = torch.empty_like(x)
        flags = torch.empty((b, 64, 16), dtype=torch.bool, device=dev)
        call = ell_args(fn, "slab", kell.SPAN, out, flags, x, ib, wb, stream)
        _build.check(call(), "variant")
        ms = cs.time_ms(lambda: _build.check(call(), "variant"))
        emit({"variant": "K3 route slab, span 32 (shipped)",
              "shape": f"[{b},512,512] d_max=16", "blocks": 16 * b,
              "slots": 3 * sms, "ms": ms, "ms_per_lane": ms / b,
              "card": card})


# one part of a shipped kernel taken out (the result is wrong on purpose)
_K2_ABLATIONS = {
    "K2 shipped without the barrier (wrong result)": (
        "    }\n    __syncthreads();\n}\n\ntemplate <int M, int G>",
        "    }\n}\n\ntemplate <int M, int G>"),
    "K2 shipped, an add in place of the min (wrong result)": (
        "x[i][j] = fminf(x[i][j], cv[i] + rv[j]);",
        "x[i][j] = x[i][j] + (cv[i] + rv[j]);"),
}
_GATHERS = [f"sl[iv.{c} {op}]" for c in "xyzw" for op in ("& 0xffff", ">> 16")]
_K3_ABLATIONS = {
    "K3 slab, the slab load alone (wrong result)": [(
        "for (int tile = warp; tile < nt; tile += SLAB_WARPS) {",
        "for (int tile = warp; tile < 0; tile += SLAB_WARPS) {")],
    "K3 slab without the table loads (wrong result)": [(
        "const uint4 iv = ri[p];\n"
        "                    const float4 wa = rw[2 * p], wb = rw[2 * p + 1];",
        "const unsigned r = static_cast<unsigned>(t * SP) * 0x10001u;\n"
        "                    const uint4 iv = make_uint4(r, r, r, r);\n"
        "                    const float4 wa = make_float4(1.f, 2.f, 3.f, 4.f),"
        " wb = wa;")],
    "K3 slab without the gathers (wrong result)": [
        (g, "__uint_as_float(" + g[3:-1] + ")") for g in _GATHERS],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="csrc directory of an earlier checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_k3_variants: no CUDA device is available")
    OUT.mkdir(parents=True, exist_ok=True)
    fw_text = (CSRC / "fw_pivot.cu").read_text()
    micro = "constexpr int MICRO = "
    shipped = int(re.search(micro + r"(\d+);", fw_text).group(1))
    # name -> (source text or path, entry kind, route, span)
    srcs: dict = {}
    for mm, threads in ((4, 1024), (8, 256)):
        label = (f"K2 {mm}x{mm} micro-tile, {threads} threads"
                 + (" (shipped)" if mm == shipped else ""))
        srcs[label] = (edit(fw_text, f"{micro}{shipped};", f"{micro}{mm};"),
                       "fw", None, None)
    for name, (old, new) in _K2_ABLATIONS.items():
        srcs[name] = (edit(fw_text, old, new), "fw", None, None)
    ell_text = (CSRC / "ell.cu").read_text()
    srcs["K3 route slab, span 32 (shipped)"] = (ell_text, "ell", "slab", 32)
    srcs["K3 route slab, span 16"] = (
        edit(ell_text, "return launch_slab<SPAN>(", "return launch_slab<16>("),
        "ell", "slab", 16)
    for name, pairs in _K3_ABLATIONS.items():
        text = ell_text
        for old, new in pairs:
            text = edit(text, old, new)
        srcs[name] = (text, "ell", "slab", 32)
    if args.parent is not None:
        srcs["K2 earlier design"] = (args.parent / "fw_pivot.cu", "fw",
                                     None, None)
        srcs["K3 earlier design (8 targets x 128 sources a block, L2 "
             "gathers)"] = (args.parent / "ell.cu", "ell", None, _EARLIER_SPAN)
    procs = {}
    for i, (name, (src, kind, _, _)) in enumerate(srcs.items()):
        if not isinstance(src, pathlib.Path):
            path = OUT / f"v{i}.cu"
            path.write_text(src)
            src = path
        procs[name] = (f"v{i}", build(f"v{i}", src))
    fns = {}
    for name, (stem, proc) in procs.items():
        _, kind, route, span = srcs[name]
        if kind == "fw":
            fns[name] = load(stem, proc, "fw_pivot",
                             _build._SIGNATURES["fw_pivot"])
            continue
        sig = (_EARLIER_ELL if route is None
               else _build._SIGNATURES["ell_relax_round"])
        fns[name] = (*load(stem, proc, "ell_relax_round", sig), route, span)
        if name == "K3 route slab, span 32 (shipped)":
            fns["K3 route l2 (shipped)"] = (*fns[name][:2], "l2", kell.SPAN)
    timed_rows(fns, cs.card_line(), _build.stream_ptr(torch.device("cuda")))


if __name__ == "__main__":
    main()
