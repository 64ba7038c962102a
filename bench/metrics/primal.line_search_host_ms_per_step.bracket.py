"""Host milliseconds inside the program's ``repro_torch.primal.line_search``
span a step, in the traced slice A (timed at the span's entry and exit,
with no host tracing on)."""
from harness.readers import LINE_SEARCH

LAYER = "primal FW"
MOVES = "brackets_per_s"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    t = run.trace
    if not t or LINE_SEARCH not in t["host_span_s"]:
        return None
    return 1e3 * t["host_span_s"][LINE_SEARCH] / t["a_steps"]
