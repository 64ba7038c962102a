#!/usr/bin/env python3
"""Time design variants of K1 (``csrc/minplus.cu``) and K5 (``csrc/wkv.cu``)
on one card, to show what each design choice is worth.

    python3 tools/k1_k5_variants.py [--parent DIR]

K5 variants are copies of the shipped source, edited: 512 threads a block
in place of 256; two shared copies of the state (S' stored before o reads
S, so one block an SM); and a lane's value columns split over 2 or 4
blocks (32 or 16 columns a block, with two copies of S); each is timed on
the inputs of ``chip_smoke.py`` phase 6 ([512, 1000, 64] float32, contiguous) and on the
model's layout (the [8, 1000, 64, 64] projections as [B, H, T, n] views),
with the count of outputs outside K5's tolerance against the plain
version.  K1 is timed at the five shapes of ``chip_smoke.py`` phase 2 with
each of its two instantiations (a 128x128 tile at 2 blocks and at 1 block
an SM) and with a 64x64 tile (8x8 a thread, 64 threads) in place of the
second, and checked bit for bit.  With ``--parent DIR`` (the ``csrc`` directory
of an earlier checkout, e.g. from ``git archive``) that checkout's
``minplus.cu`` and ``wkv.cu`` are built too and timed on the same inputs
through their own C entries, in the same call.

Every variant is built with the flags of ``kernels/_build.py`` (one
``nvcc`` each, in parallel, into ``build/variants/``) and timed with
``chip_smoke.time_ms`` (device time per call).  Each row gives the
registers and spill bytes ``ptxas`` reports for the kernel the row ran.
Needs a card; prints one JSON line per row.
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
from repro_torch.core import graphs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import minplus as kmin  # noqa: E402
from repro_torch.kernels import wkv as kwkv  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entries before the redesign (contiguous [BH, T, n] for K5, no tile
# argument for K1)
_EARLIER = {
    "wkv_chunked": (_P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _P),
    "minplus_acc": (_P, _P, _P, _P, _I, _I, _I, _I, *(_L,) * 8, _P),
}


def edit(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"k1_k5_variants: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


# K5 ablations: each skips one phase's loop (the result is wrong; the row
# shows what the phase costs)
_SKIP = {
    "cumulative decay": "for (int ch = tid; ch < NP; ch += THREADS) {\n            float l",
    "decay weights (exp)": "for (int q = warp * 4; q < NP; q += WARPS * 4) {",
    "A": "for (int q = kq * 4; q < NP; q += 16) {",
    "state update": "for (int t = 0; t < C; ++t) {\n                const float4 vt",
    "o intra-chunk": "for (int g = o_kh; g <= o_tr; g += 2) {",
    "o from the state": "for (int q = o_kh * 4; q < NP; q += 8) {",
}


def threads512(text: str) -> str:
    return edit(text, ("return NP < 32 ? 8 * NP : 256;",
                       "return NP < 32 ? 8 * NP : 512;"))


def split_columns(text: str, mb: int, threads: int) -> str:
    """The shipped K5 with a lane's value columns split over blocks of
    ``mb`` columns (o[:, m] and S[:, m] need only column m of v and S0),
    ``threads`` a block, and two shared copies of S; mb = 64 keeps one
    block a lane and only adds the second copy."""
    return edit(
        text,
        ("constexpr int NMAX = 64;       // largest head size\n",
         "constexpr int NMAX = 64;       // largest head size\n"
         f"constexpr int MBV = {mb};\n"
         "template <int NP>\n"
         "__host__ __device__ constexpr int mb_of() "
         "{ return MBV < NP ? MBV : NP; }\n"),
        ("return NP < 32 ? 8 * NP : 256;",
         f"return {threads} < 8 * mb_of<NP>() ? {threads} : 8 * mb_of<NP>();"),
        ("static constexpr int AS = C + 4;      // row stride of A\n",
         "static constexpr int AS = C + 4;      // row stride of A\n"
         "    static constexpr int MB = mb_of<NP>(), VS = MB + 4;\n"),
        ("static constexpr int STAGE = 4 * C * RS;",
         "static constexpr int STAGE = 3 * C * RS + C * VS;"),
        ("+ NP * RS + WARPS * C + 2 * NP + C;",
         "+ 2 * NP * VS + WARPS * C + 2 * NP + C;"),
        ("constexpr int RS = L::RS, AS = L::AS;",
         "constexpr int RS = L::RS, AS = L::AS, MB = L::MB, VS = L::VS;"),
        ("float* Dp = Sb + NP * RS;", "float* Dp = Sb + 2 * NP * VS;"),
        ("const long long lid = blockIdx.x;",
         "const int nsplit = (n + MB - 1) / MB;\n"
         "    const long long lid = blockIdx.x / nsplit;\n"
         "    const int m0 = static_cast<int>(blockIdx.x % nsplit) * MB;"),
        ("const float* vl = p.v + bi * p.sv.b + hi * p.sv.h;",
         "const float* vl = p.v + bi * p.sv.b + hi * p.sv.h + m0;"),
        ("float* ol = p.o + bi * p.so.b + hi * p.so.h;",
         "float* ol = p.o + bi * p.so.b + hi * p.so.h + m0;"),
        ("                cp16(V + t * RS + q, vl + tt * p.sv.t + qq, ok);\n"
         "            }\n",
         "            }\n"
         "            for (int e = tid; e < C * (MB / 4); e += THREADS) {\n"
         "                const int t = e / (MB / 4), q = (e % (MB / 4)) * 4;\n"
         "                const bool ok = t0 + t < T && m0 + q < n;\n"
         "                cp16(V + t * VS + q,\n"
         "                     vl + (ok ? (t0 + t) * p.sv.t + q : 0), ok);\n"
         "            }\n"),
        ("                cp4(V + t * RS + q, vl + tt * p.sv.t + qq, ok);\n"
         "            }\n",
         "            }\n"
         "            for (int e = tid; e < C * MB; e += THREADS) {\n"
         "                const int t = e / MB, q = e % MB;\n"
         "                const bool ok = t0 + t < T && m0 + q < n;\n"
         "                cp4(V + t * VS + q,\n"
         "                    vl + (ok ? (t0 + t) * p.sv.t + q : 0), ok);\n"
         "            }\n"),
        ("constexpr int SG = NP / 4,", "constexpr int SG = MB / 4,"),
        ("const int m = sx * 4 + i;\n            x[i] = (s0l",
         "const int m = m0 + sx * 4 + i;\n            x[i] = (s0l"),
        ("if (ch < NP) st4(Sb + ch * RS + sx * 4, sreg[j]);",
         "if (ch < NP) st4(Sb + ch * VS + sx * 4, sreg[j]);"),
        ("constexpr int OTASKS = 2 * (C / 4) * (NP / 4);",
         "constexpr int OTASKS = 2 * (C / 4) * (MB / 4);"),
        ("o_tr = (tid >> 1) / (NP / 4),\n              o_tc = (tid >> 1) % (NP / 4);",
         "o_tr = (tid >> 1) / (MB / 4),\n              o_tc = (tid >> 1) % (MB / 4);"),
        ("const float* V = st + 3 * C * RS;\n",
         "const float* V = st + 3 * C * RS;\n"
         "        const float* Scur = Sb + (c & 1) * NP * VS;\n"
         "        float* Snext = Sb + ((c + 1) & 1) * NP * VS;\n"),
        ("ld4(V + t * RS + sx * 4)", "ld4(V + t * VS + sx * 4)"),
        ("for (int j = 0; j < SR; ++j) sreg[j] = acc[j];",
         "for (int j = 0; j < SR; ++j) {\n"
         "                sreg[j] = acc[j];\n"
         "                if (sy * SR + j < NP)\n"
         "                    st4(Snext + (sy * SR + j) * VS + sx * 4, acc[j]);\n"
         "            }"),
        ("ld4(V + t * RS + o_tc * 4)", "ld4(V + t * VS + o_tc * 4)"),
        ("ld4(V + (g * 4 + i) * RS + o_tc * 4)",
         "ld4(V + (g * 4 + i) * VS + o_tc * 4)"),
        ("ld4(Sb + (q + i) * RS + o_tc * 4)",
         "ld4(Scur + (q + i) * VS + o_tc * 4)"),
        ("const int m = o_tc * 4;", "const int m = m0 + o_tc * 4;"),
        ("#pragma unroll\n        for (int j = 0; j < SR; ++j)\n"
         "            if (sy * SR + j < NP) st4(Sb + (sy * SR + j) * RS + sx * 4, sreg[j]);\n",
         ""),
        ("const int m = sx * 4 + i;\n            if (m < n) sol",
         "const int m = m0 + sx * 4 + i;\n            if (m < n) sol"),
        ("wkv_chunked_kernel<NP><<<static_cast<unsigned>(lanes),",
         "wkv_chunked_kernel<NP><<<static_cast<unsigned>(\n"
         "        lanes * ((a.n + mb_of<NP>() - 1) / mb_of<NP>())),"))


def skip(text: str, *phases: str) -> str:
    for ph in phases:
        loop = _SKIP[ph]
        cond = loop.split("; ", 2)[1]
        text = edit(text, (loop, loop.replace(f"; {cond};", f"; false && ({cond});", 1)))
    return text


def build(name: str, src: pathlib.Path, *defines: str) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build._FLAGS, *defines, "-shared",
         "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas(log: str) -> dict[str, tuple[int, int]]:
    """(registers, spill-store bytes) per kernel of a ``-Xptxas -v`` log,
    keyed by the kernel's mangled name."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = (int(m.group(1)), spill)
    return out


def load(name: str, proc: subprocess.Popen, entry: str, argtypes):
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k1_k5_variants: {name} does not build:\n{log}")
    fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn, ptxas(log)


def kernel_regs(info: dict[str, tuple[int, int]], *tags: str) -> dict:
    """Registers and spill bytes of the one kernel whose mangled name holds
    every tag (a template argument list such as ``ILi64EE``)."""
    hits = [v for k, v in info.items() if all(t in k for t in tags)]
    if len(hits) != 1:
        return {"registers": None, "spill_bytes": None}
    return {"registers": hits[0][0], "spill_bytes": hits[0][1]}


def outside(got: torch.Tensor, want: torch.Tensor) -> int:
    """Outputs outside K5's tolerance; a NaN counts as outside."""
    atol, rtol = cs.K5_TOL
    g, w = got.double(), want.double()
    return int((~((g - w).abs() <= atol + rtol * w.abs())).sum())


def wkv_strides(x: torch.Tensor) -> list[int]:
    return [x.stride(0), 0, x.stride(1)] if x.dim() == 3 else \
        list(x.stride()[:3])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="csrc directory of an earlier checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_k5_variants: no CUDA device is available")
    wkv_src, mp_src = CSRC / "wkv.cu", CSRC / "minplus.cu"
    small = OUT / "minplus_64x64.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    text = mp_src.read_text()
    one = "launch<128, 128, 1>(args, batch, st)"
    if one not in text:
        raise SystemExit("k1_k5_variants: minplus.cu's second instantiation "
                         "moved")
    small.write_text(text.replace(one, "launch<64, 64, 4>(args, batch, st)"))
    wtext = wkv_src.read_text()
    edited = {
        "wkv 512 threads (one block a lane)": threads512(wtext),
        "wkv 2 copies of S (one block a lane, 1 block/SM)": split_columns(
            wtext, 64, 256),
        "wkv columns over 2 blocks a lane (32 each), 2 copies of S":
            split_columns(wtext, 32, 256),
        "wkv columns over 4 blocks a lane (16 each), 128 threads, "
        "2 copies of S": split_columns(wtext, 16, 128),
    }
    edited.update({f"wkv shipped without {ph} (wrong result)": skip(wtext, ph)
                   for ph in _SKIP})
    edited["wkv shipped, loads and barriers only (wrong result)"] = skip(
        wtext, *_SKIP)
    wkv_variants = {"wkv shipped (256 threads, one copy of S, 2 blocks/SM)":
                    wkv_src}
    for i, (name, text) in enumerate(edited.items()):
        (OUT / f"a{i}.cu").write_text(text)
        wkv_variants[name] = OUT / f"a{i}.cu"
    procs = {name: build(f"w{i}", src)
             for i, (name, src) in enumerate(wkv_variants.items())}
    procs["minplus shipped"] = build("m0", mp_src)
    procs["minplus 64x64 tile (8x8 a thread, 64 threads) as tile 1"] = \
        build("m1", small)
    if args.parent is not None:
        procs["wkv earlier design"] = build("wp", args.parent / "wkv.cu")
        procs["minplus earlier design"] = build(
            "mp", args.parent / "minplus.cu")
    stems = {"minplus shipped": "m0",
             "minplus 64x64 tile (8x8 a thread, 64 threads) as tile 1": "m1",
             "wkv earlier design": "wp", "minplus earlier design": "mp"}
    stems.update({name: f"w{i}" for i, name in enumerate(wkv_variants)})
    fns = {}
    for name, proc in procs.items():
        entry = "wkv_chunked" if name.startswith("wkv") else "minplus_acc"
        sig = _EARLIER[entry] if "earlier" in name else _build._SIGNATURES[entry]
        fns[name] = load(stems[name], proc, entry, sig)
    card = cs.card_line()
    dev = torch.device("cuda")
    stream = _build.stream_ptr(dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # K5: phase 6's contiguous lanes, and the model's strided head views
    bh, t, n = 512, 1000, 64
    flat = [randn(bh, t, n) for _ in range(3)]
    flat.append(-torch.clamp(torch.exp(randn(bh, t, n)), 1e-6, 2.5))
    proj = [randn(8, t, 64, n) for _ in range(3)]
    proj.append(-torch.clamp(torch.exp(randn(8, t, 64, n)), 1e-6, 2.5))
    views = [x.permute(0, 2, 1, 3) for x in proj]
    u_flat, u_head = randn(bh, n) * 0.5, randn(64, n) * 0.5
    for label, xs, u in (("[512,1000,64] f32", flat, u_flat),
                         ("[8,1000,64,64] f32 head views", views, u_head)):
        want_o, _ = kwkv.wkv_chunked_plain(*xs, u)
        lead = tuple(xs[0].shape[:-2])
        nb, nh = (lead[0], 1) if len(lead) == 1 else lead
        su = (u.stride(0), 0) if len(lead) == 1 else (0, u.stride(0))
        for name, (fn, info) in fns.items():
            if not name.startswith("wkv"):
                continue
            if "earlier" in name:
                ins = [x.reshape(bh, t, n).contiguous() for x in xs]
                uu = u.expand(*lead, n).reshape(bh, n).contiguous()
                o = torch.empty((bh, t, n), device=dev)
                s = torch.empty((bh, n, n), device=dev)
                call_args = (o.data_ptr(), s.data_ptr(),
                             *(x.data_ptr() for x in ins), uu.data_ptr(),
                             uu.stride(0), None, bh, t, n, stream)
                got = o.view(*lead, t, n)
            else:
                o = torch.empty_like(xs[0])
                s = torch.empty((*lead, n, n), device=dev)
                call_args = (o.data_ptr(), s.data_ptr(),
                             *(x.data_ptr() for x in xs), u.data_ptr(), None,
                             nb, nh, t, n,
                             *(st for x in (*xs, o) for st in wkv_strides(x)),
                             *su, stream)
                got = o

            def call(fn=fn, call_args=call_args):
                _build.check(fn(*call_args), "variant")
            call()
            torch.cuda.synchronize()
            print(json.dumps({
                "variant": name, "shape": label, "ms": cs.time_ms(call),
                **kernel_regs(info, "wkv_chunked_kernel", "ILi64E"),
                "outside_tolerance": outside(got, want_o), "card": card}),
                flush=True)
        del want_o

    # K1: phase 2's shapes, both tiles
    w = torch.tensor(cs.quantized_weights(512, 16, 20, 100, graphs), device=dev)
    piv = w[:, :128, :128]
    wr = w[:, :200, :200].contiguous()
    cases = (("[20,512,512] x [20,512,512] (+C0)", w, w, w),
             ("row panel [20,128,128] x [20,128,512] (+C0)",
              piv, w[:, :128, :], w[:, :128, :]),
             ("col panel [20,512,128] x [20,128,128] (+C0)",
              w[:, :, :128], piv, w[:, :, :128]),
             ("outer [20,512,128] x [20,128,512] (+C0)",
              w[:, :, :128], w[:, :128, :], w),
             ("ragged [20,200,200] x [20,200,200]", wr, wr, None))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, a, b, c0 in cases:
        bsz, m, k = a.shape
        nn = b.shape[-1]
        want = kmin.minplus_acc_plain(a, b, c0)
        strides = (a.stride(0), a.stride(1), b.stride(0), b.stride(1))
        c0s = (c0.stride(0), c0.stride(1)) if c0 is not None else (0, 0)
        for name, (fn, info) in fns.items():
            if not name.startswith("minplus"):
                continue
            tiles = ((None,) if "earlier" in name else
                     kmin.TILES[1:] if "64x64" in name else kmin.TILES)
            for tile in tiles:
                out = torch.empty((bsz, m, nn), device=dev)
                tail = () if tile is None else (kmin.TILES.index(tile),)
                call_args = (out.data_ptr(),
                             c0.data_ptr() if c0 is not None else None,
                             a.data_ptr(), b.data_ptr(), bsz, m, nn, k,
                             *strides, out.stride(0), out.stride(1), *c0s,
                             *tail, stream)

                def call(fn=fn, call_args=call_args):
                    _build.check(fn(*call_args), "variant")
                call()
                torch.cuda.synchronize()
                print(json.dumps({
                    "variant": name,
                    "tile": ("64x64" if "64x64" in name else tile)
                    or "64x64, 4x4 a thread",
                    "picked": kmin.minplus_tile(bsz, m, nn, sms),
                    "shape": label, "ms": cs.time_ms(call),
                    **kernel_regs(info, "minplus_acc_kernel",
                                  *minplus_tags(name, tile)),
                    "exact": bool(torch.equal(out, want)), "card": card}),
                    flush=True)
    k1_waves(fns["minplus shipped"][0], card, stream)


def minplus_tags(name: str, tile: str | None) -> tuple[str, ...]:
    """The template arguments of the K1 kernel a row ran, as they appear
    in its mangled name (BM, BN, and blocks an SM)."""
    if tile is None:
        return ()
    if "64x64" in name:
        return ("ILi64ELi64E",)
    return (f"ILi128ELi128ELi{1 if tile == kmin.TILES[1] else 2}E",)


def k1_waves(fn, card: str, stream: int) -> None:
    """K1 shipped (2 blocks an SM) on [b, 512, 512]: 256 blocks (b = 16) fit
    the card's 264 slots in one wave, 272 (b = 17) and 320 (b = 20) take
    two; ms per lane shows what the second wave costs."""
    dev = torch.device("cuda")
    for b in (16, 17, 20):
        w = torch.tensor(cs.quantized_weights(512, 16, b, 100, graphs),
                         device=dev)
        out = torch.empty_like(w)
        call_args = (out.data_ptr(), w.data_ptr(), w.data_ptr(),
                     w.data_ptr(), b, 512, 512, 512, *w.stride()[:2],
                     *w.stride()[:2], *out.stride()[:2], *w.stride()[:2], 0,
                     stream)

        def call(call_args=call_args):
            _build.check(fn(*call_args), "variant")
        call()
        ms = cs.time_ms(call)
        print(json.dumps({"variant": "minplus shipped, 128x128 2/SM",
                          "shape": f"[{b},512,512]^2 (+C0)",
                          "blocks": b * 16, "ms": ms, "ms_per_lane": ms / b,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
