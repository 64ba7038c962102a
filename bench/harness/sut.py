"""The system under test: the port's engines (``src/repro_torch``), given
only the capacity and demand arrays of each pile.  The only module of the
harness that imports the program."""
from __future__ import annotations

import dataclasses
import sys

from harness.spec import ROOT
from harness.traffic import Instance

WARM_ITERS = 50   # warm-up descent steps: two check windows and a finish


@dataclasses.dataclass(frozen=True)
class Answer:
    """One instance's result: the dual upper bound and, from a bracket
    engine, the primal lower bound and the gap; the descent steps it ran
    and where the plan put it."""

    ub: float
    lb: float | None
    gap: float | None
    iterations: int
    chunk: int
    padded_n: int
    nodes: int
    plan: dict


def _answer(r) -> Answer:
    m = r.meta
    return Answer(ub=float(m.get("ub", r.throughput)),
                  lb=None if "lb" not in m else float(m["lb"]),
                  gap=None if "gap" not in m else float(m["gap"]),
                  iterations=int(m["iterations"]), chunk=int(m["chunk"]),
                  padded_n=int(m["padded_n"]), nodes=int(m["nodes"]),
                  plan=dict(m["plan"]))


class Program:
    """``get_engine(mix["engine"], **mix["engine_kw"])`` of the port on
    ``device``; ``solve(pile)`` runs one ``solve_batch``."""

    def __init__(self, mix: dict, device: str = "cuda"):
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        from repro_torch.core import get_engine
        self._get_engine = get_engine
        self.mix = mix
        self.device = device
        self.engine = get_engine(mix["engine"], device=device,
                                 **mix.get("engine_kw", {}))

    def build(self) -> dict:
        """Load the kernel library (nvcc only where this checkout has not
        built it yet); the counts of builds and loads."""
        if self.device != "cuda":
            return {}
        from repro_torch.kernels import _build
        _build.load()
        builds, hits = _build.build_counts()
        return {"nvcc_builds": builds, "library_loads": hits,
                "build_seconds": _build.build_seconds()}

    def warm(self, pile: list[Instance]) -> None:
        """Every kernel and shape of the cell once, at its own size."""
        kw = {**self.mix.get("engine_kw", {}), "iters": WARM_ITERS}
        eng = self._get_engine(self.mix["engine"], device=self.device, **kw)
        eng.solve_batch([i.cap for i in pile], [i.dem for i in pile])

    def solve(self, pile: list[Instance]) -> list[Answer]:
        res = self.engine.solve_batch([i.cap for i in pile],
                                      [i.dem for i in pile])
        return [_answer(r) for r in res]


class Control:
    """The control: the plain reference put in the program's place,
    computed in bfloat16 (one precision below the program's float32)."""

    def __init__(self, mix: dict, device: str = "cuda"):
        import torch
        self.mix = mix
        self.device = device
        self.dtype = torch.bfloat16

    def build(self) -> dict:
        return {}

    def warm(self, pile) -> None:
        pass

    def solve(self, pile: list[Instance]) -> list[Answer]:
        from harness import reference
        kind = "primal" if self.mix["answers"] == "bracket" else "dual"
        r = reference.solve(kind, [i.cap for i in pile],
                            [i.dem for i in pile], dtype=self.dtype,
                            device=self.device,
                            **self.mix.get("engine_kw", {}))
        n = pile[0].cap.shape[0]
        plan = {"compile_keys": ((n, len(pile)),)}
        out = []
        for j in range(len(pile)):
            lb = None if "lb" not in r else float(r["lb"][j])
            ub = float(r["ub"][j])
            gap = None if lb is None else (ub - lb) / max(ub, 1e-30)
            out.append(Answer(ub=ub, lb=lb, gap=gap,
                              iterations=int(r["iterations"][j]), chunk=0,
                              padded_n=n, nodes=n, plan=plan))
        return out
