"""Run phases of ``chip_smoke.py`` alone on one card, with the knobs of
its time cuts (ROADMAP S1), to iterate on a phase or to give a cut the
seconds it saves.

    python3 tools/smoke_phases.py 20               # the planner's contracts
    python3 tools/smoke_phases.py 12 12:rounds=4   # phase 12 at 3, then 4 rounds
    python3 tools/smoke_phases.py 6 6:heavy=30     # phase 6, heavy calls in
                                                   # batches of 10, then 30

Each argument is a phase (6, 12 or 20), optionally with ``:knob=value``:
``rounds`` sets phase 12's adversarial rounds (``ADV_BUDGET``), ``heavy``
phase 6's runs a timed batch for its heavy calls (``PHASE6_HEAVY_RUNS``);
the knob holds for that run only.  The kernel library is loaded first, as
in the script.  Each phase prints its own lines, then one JSON line
``{"phase": ..., "knobs": ..., "wall_s": ...}``; the card's name and power
limit come first.  Exits non-zero where the phase's checks fail.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KNOBS = {"rounds": ("ADV_BUDGET", "rounds"),
         "heavy": ("PHASE6_HEAVY_RUNS", None)}


def parse(spec: str) -> tuple[int, dict[str, int]]:
    phase, _, rest = spec.partition(":")
    knobs = {}
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        if k not in KNOBS:
            raise SystemExit(f"smoke_phases: unknown knob {k!r}; known: "
                             f"{sorted(KNOBS)}")
        knobs[k] = int(v)
    if int(phase) not in (6, 12, 20):
        raise SystemExit(f"smoke_phases: phase {phase} is not one of 6, 12, "
                         "20")
    return int(phase), knobs


def set_knobs(knobs: dict[str, int]) -> dict[str, object]:
    """Apply ``knobs`` to the script's globals; returns what to restore."""
    saved = {}
    for k, v in knobs.items():
        name, key = KNOBS[k]
        saved[name] = getattr(cs, name)
        setattr(cs, name, v if key is None
                else {**getattr(cs, name), key: v})
    return saved


def main() -> None:
    specs = [parse(a) for a in sys.argv[1:]] or [(20, {})]
    if not torch.cuda.is_available():
        raise SystemExit("smoke_phases: no CUDA device is available")
    from repro_torch.core import graphs, lp, traffic
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import wkv as kwkv
    card = cs.card_line()
    cs.log(card)
    _build.load()
    cs.log(json.dumps({"nvcc_s": _build.build_seconds()}))
    topos, dems = cs.instances(graphs, traffic, 512, 16, 8, range(8))
    runs: list[dict] = []
    for phase, knobs in specs:
        saved = set_knobs(knobs)
        try:
            t0 = time.perf_counter()
            if phase == 6:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                cs.phase_lm_kernels(kfa, kwkv)
            elif phase == 12:
                cs.phase_adversarial(graphs, lp, traffic, topos[0], runs)
            else:
                cs.phase_aot(card, topos, dems, runs)
            wall = time.perf_counter() - t0
        finally:
            for name, value in saved.items():
                setattr(cs, name, value)
        cs.log(json.dumps({"phase": phase, "knobs": knobs, "wall_s": wall,
                           "card": card}))


if __name__ == "__main__":
    main()
