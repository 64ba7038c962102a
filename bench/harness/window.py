"""The measured window: a closed loop of whole piles, each sent when the
last returns, from the first pile's submission until ``seconds`` have
passed.  A pile still in flight then is abandoned at its next step (the
program's step span, ``spans.deadline``) and not counted."""
from __future__ import annotations

import dataclasses
import time

from harness import spans


@dataclasses.dataclass
class Returned:
    pile: int             # the pile's number in the run
    answers: list         # sut.Answer, in the pile's order
    returned: float       # seconds from the window's start


@dataclasses.dataclass
class Window:
    seconds: float
    piles: list[Returned]

    @property
    def answers(self) -> list:
        return [a for p in self.piles for a in p.answers]

    @property
    def elapsed(self) -> float:
        """From the first submission to the last whole pile's return."""
        return self.piles[-1].returned if self.piles else 0.0


def run(solve, pile, seconds: float, max_piles: int | None = None) -> Window:
    """Drive ``solve`` over ``pile(0)``, ``pile(1)``, ... for ``seconds``,
    or until ``max_piles`` whole piles returned."""
    t0 = time.perf_counter()
    out: list[Returned] = []
    with spans.SpanWatch(on_enter=spans.deadline(t0 + seconds)):
        k = 0
        while True:
            try:
                answers = solve(pile(k))
            except spans.Stop:
                break
            tr = time.perf_counter() - t0
            if tr > seconds:
                break
            out.append(Returned(k, answers, tr))
            k += 1
            if k == max_piles:
                break
    return Window(seconds, out)
