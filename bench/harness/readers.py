"""Arithmetic the per-layer metric readers (``bench/metrics/*.py``) share.
Each returns None where the run has nothing to read."""
from __future__ import annotations

from harness import roofline

FORWARD = "repro_torch.apsp.forward"
BACKWARD = "repro_torch.apsp.backward"
LINE_SEARCH = "repro_torch.primal.line_search"


def chunks(run) -> list[tuple[list, list]]:
    """(answers, instances) of every chunk of every whole pile."""
    out = []
    for p in run.window.piles:
        pile = run.piles(p.pile)
        by: dict[int, tuple[list, list]] = {}
        for a, inst in zip(p.answers, pile):
            by.setdefault(a.chunk, ([], []))
            by[a.chunk][0].append(a)
            by[a.chunk][1].append(inst)
        out.extend(by[c] for c in sorted(by))
    return out


def chunk_steps(answers: list) -> int:
    """Descent steps a chunk ran: until its slowest lane stopped."""
    return max(a.iterations for a in answers)


def span_device_ms_per_step(run, span: str) -> float | None:
    """Device ms of the kernels launched inside ``span``, per span, in the
    traced slice B."""
    t = run.trace
    if not t or not t["span_count"].get(span) or span not in \
            t["span_device_s"]:
        return None
    return 1e3 * t["span_device_s"][span] / t["span_count"][span]


def idle_percent(run) -> float | None:
    """1 - the device's busy time in the traced slice A over the host time
    of as many steps just before it, untraced, in the same solve (tracing
    the device alone still lengthens a step: CUPTI records every launch)."""
    t = run.trace
    if not t or not t.get("untraced_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["untraced_s"])


def forward_least_seconds(run) -> float | None:
    """The least time of one forward in the traced slice (harness.roofline):
    the lanes of the first pile's first chunk that were still descending at
    the slice's steps (the window solved the same pile, so their step
    counts are known)."""
    t = run.trace
    if not t:
        return None
    first = run.window.piles[0]
    pile = run.piles(first.pile)
    lo = t["start"] - 1
    hi = lo + t["a_steps"] + t["b_steps"]
    works = []
    for a, inst in zip(first.answers, pile):
        if a.chunk != 0:
            continue
        # the lane's share of slice B's steps while it still descended
        live = max(0, min(a.iterations, hi) - lo - t["a_steps"]) / t["b_steps"]
        if live > 0:
            ops, nbytes = roofline.forward_work(inst.cap)
            works.append((ops * live, nbytes * live))
    if not works:
        return None
    return roofline.least_seconds(works)[0]
