#!/usr/bin/env python3
"""How K4b's roundings on the tensor cores move the gradients, on the CPU:
why route "mma" splits P and dS into a bf16 high and low part, and why
route "f32" runs every product as 3xTF32.

    PYTHONPATH=src python3 tools/k4b_rounding.py [--float32]

On seeded bf16 inputs at the train shapes of ``chip_smoke.py`` phase 17a
cut to batch 1 (recurrentgemma-2b's also to 1500 positions with a window
of 1024), and its ragged row, the plain backward's algebra
(``kernels.flash_attention._bwd_algebra``) runs with P and dS rounded
once to bf16, or split into a bf16 high and low part (route "mma"'s
choice), and each result is held against the plain backward under K4b's
bf16 tolerance (atol 1e-3 of each gradient's largest entry, rtol 8e-3).
dV depends only on P's rounding and dQ, dK only on dS's, so the two runs
give every mix.  Prints one JSON line per shape and rounding: for dq, dk
and dv the largest |error| / allowed (above 1 fails) and the entries that
fail.  About 3 minutes and 4 GB.

With ``--float32`` the inputs are seeded float32 and the five products
(S = Q K^T, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q) run with
their operands rounded once to TF32 (all five, or one while the others
run 3xTF32) or split into a TF32 big and small part (3xTF32, route
"f32"'s choice), held under K4b's float32 tolerance (atol 1e-4 of each
gradient's largest entry, rtol 1e-4).  About 6 minutes and 4 GB.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import flash_attention as kfa  # noqa: E402

TOL = {"bf16": (1e-3, 8e-3), "float32": (1e-4, 1e-4)}
# (label, [b, lq, lk, hq, hkv, d], lk_valid, window)
SHAPES = (
    ("minitron-4b at batch 1", (1, 1024, 1024, 24, 8, 128), None, 0),
    ("musicgen-medium at batch 1", (1, 1024, 1024, 24, 24, 64), None, 0),
    ("recurrentgemma-2b at batch 1, 1500 positions, window 1024",
     (1, 1500, 1500, 10, 1, 256), None, 1024),
    ("ragged [2,300/400,8/2,128], lk_valid 350, window 100",
     (2, 300, 400, 8, 2, 128), 350, 100),
)


def single(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUNDINGS = {"single": single, "split": kfa._bf16_split}


def _f32_roundings() -> dict:
    """float32: name -> ``_bwd_algebra``'s ``mm`` map."""
    split = dict.fromkeys(kfa.TF32_PRODUCTS, kfa._mm_3xtf32)
    out = {"tf32 once, all five": dict.fromkeys(kfa.TF32_PRODUCTS,
                                                 kfa._mm_tf32),
           "3xtf32, all five": split}
    for name in kfa.TF32_PRODUCTS:
        out[f"3xtf32 but {name} tf32 once"] = {**split, name: kfa._mm_tf32}
    return out


def ratios(got, want, tol) -> list:
    out = []
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        lim = tol[0] * float(w.abs().max()) + tol[1] * w.abs()
        err = (g - w).abs()
        out.append([float((err / lim).max()), int((err > lim).sum())])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--float32", action="store_true",
                    help="route f32's TF32 roundings on float32 inputs")
    f32 = ap.parse_args().float32
    dtype = torch.float32 if f32 else torch.bfloat16
    tol = TOL["float32" if f32 else "bf16"]
    torch.manual_seed(0)
    for label, (b, lq, lk, hq, hkv, d), valid, window in SHAPES:
        rng = np.random.default_rng(lq + d)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dtype)

        q, do = randn(b, lq, hq, d), randn(b, lq, hq, d)
        k, v = randn(b, lk, hkv, d), randn(b, lk, hkv, d)
        kw = dict(causal=True, lk_valid=valid, window=window)
        o = kfa.flash_attention_plain(q, k, v, **kw)
        want = kfa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        if f32:
            for name, mm in _f32_roundings().items():
                got = kfa._bwd_algebra(q, k, v, o, do, True, None, valid,
                                       window, mm=mm)
                print(json.dumps({"shape": label, "products": name,
                                  "ratio_and_fails_dq_dk_dv":
                                      ratios(got, want, tol)}), flush=True)
            continue
        for name, rnd in ROUNDINGS.items():
            got = kfa._bwd_algebra(q, k, v, o, do, True, None, valid, window,
                                   rnd)
            print(json.dumps({"shape": label, "p_and_ds": name,
                              "ratio_and_fails_dq_dk_dv":
                                  ratios(got, want, tol)}), flush=True)


if __name__ == "__main__":
    main()
