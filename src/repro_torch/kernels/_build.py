"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

On first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and the objects are linked into one
shared library under ``build/kernels/`` at the repository root, named by a
hash of the sources so an edit never loads a stale build.  The library has
a plain C interface and is loaded with ``ctypes``: every pointer and the
stream are ``c_void_p``, every C entry returns ``cudaGetLastError()`` and
``check`` raises on a non-zero code.  A failed build raises; there is no
fallback.

``LAUNCHES`` counts, per kernel, the calls its wrapper launched:
``minplus_acc`` (K1), ``fw_pivot`` (K2), ``ell_relax_round`` (K3),
``flash_attention`` (K4, any route), ``wkv_chunked`` (K5),
``flash_attention_bwd`` (K4b) and ``wkv_chunked_bwd`` (K5b).
``SITE_LAUNCHES`` splits them by the caller that names itself (the blocked
Floyd-Warshall panels, the full-sequence and the decode attention, and the
attention backward's site) and, for K3, K4 and K4b, by route
(``ell_relax_round/route:slab``, ``route:l2``; ``flash_attention/route:mma``,
``route:decode``, ``route:f32``; ``flash_attention_bwd/route:mma``,
``route:f32``); a run resets both with ``reset_launches``
and reads them afterwards to show which kernels the path went through.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

__all__ = ["load", "check", "stream_ptr", "LAUNCHES", "SITE_LAUNCHES",
           "reset_launches",
           "BUILD_DIR", "SOURCES", "build_seconds", "build_log"]

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the kernel entries (argument types, all return int)
_SIGNATURES = {
    "minplus_acc": (_P, _P, _P, _P, _I, _I, _I, _I,
                    _L, _L, _L, _L, _L, _L, _L, _L, _I, _P),
    "fw_pivot": (_P, _I, _I, _L, _L, _P),
    "ell_relax_round": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "flash_attention": (_P, _P, _P, _P, *(_I,) * 8, _F, *(_L,) * 12, _P),
    "flash_attention_mma": (_P, _P, _P, _P, *(_I,) * 8, _F, *(_L,) * 12,
                            _P),
    "flash_decode": (_P, _P, _P, _P, _P, *(_I,) * 10, _F, *(_L,) * 12, _P),
    "wkv_chunked": (*(_P,) * 8, _I, _I, _I, _I, *(_L,) * 17, _P),
    # the two backward entries take their strides as a host array of int64
    "flash_attention_bwd": (*(_P,) * 11, *(_I,) * 10, _F, _P, _P),
    "flash_attention_bwd_mma": (*(_P,) * 10, *(_I,) * 9, _F, _P, _P),
    "wkv_chunked_bwd": (*(_P,) * 15, *(_I,) * 4, _P, _P),
}

# the kernels K1-K5 and the backwards K4b, K5b; K4's three C entries (its
# routes) all count under "flash_attention" and K4b's two under
# "flash_attention_bwd", split by route in SITE_LAUNCHES; a call of K4b
# (three kernels) or K5b counts once
LAUNCHES: dict[str, int] = dict.fromkeys(
    ("minplus_acc", "fw_pivot", "ell_relax_round", "flash_attention",
     "wkv_chunked", "flash_attention_bwd", "wkv_chunked_bwd"), 0)
SITE_LAUNCHES: collections.Counter[str] = collections.Counter()
_BUILD_SECONDS: list[float] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SITE_LAUNCHES.clear()


def build_seconds() -> float | None:
    """Wall seconds the build took in this process (None if it loaded a
    library that was already built, or has not loaded yet)."""
    return _BUILD_SECONDS[-1] if _BUILD_SECONDS else None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: pathlib.Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        # per-process names: concurrent first users never share a file
        obj = BUILD_DIR / f"{src.stem}-{target.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / f"{target.stem}.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)   # atomic: a concurrent loader sees all or none
    for _, obj, _ in procs:
        obj.unlink()
    _BUILD_SECONDS.append(time.perf_counter() - t0)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    if not SOURCES:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) of the library ``load`` built, or '' if none."""
    log = BUILD_DIR / f"librepro_torch_{_digest()}.log"
    return log.read_text() if log.exists() else ""


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream
