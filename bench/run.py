"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints each number compared for
``correct`` beside its limit as the last lines on stderr, and one JSON
object as the last line on stdout.  Exits non-zero, printing no result,
without enough CUDA cards, when no pile returns inside the window, or when
JAX or the JAX package was loaded.  Every cache the run writes stays inside
the checkout, under ``build/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"


def _caches() -> None:
    """Fixed cache directories inside the checkout, set before torch
    loads (the CUDA JIT cache, torch's extensions and Triton), and the
    environment the run's libraries read."""
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, few threads: the card's work needs no host thread pool
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be >= 0")
    _caches()
    import torch
    from harness import cell as cell_mod
    from harness import guard, spec

    cell = spec.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA card(s), this "
              f"machine has {have}", file=sys.stderr)
        return 2
    try:
        result = cell_mod.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), t_start=T_START)
    except (cell_mod.NoPileReturned, guard.Forbidden) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    cell_mod.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
