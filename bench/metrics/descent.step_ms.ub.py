"""Host milliseconds a chunk step: the window's time, from the first pile's
submission to the last whole pile's return, over the steps its chunks ran
(each chunk's slowest lane, plus its final forward)."""
from harness.readers import chunk_steps, chunks

LAYER = "descent"
MOVES = "bounds_per_s"
UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    steps = sum(chunk_steps(a) + 1 for a, _ in chunks(run))
    return 1e3 * run.window.elapsed / steps if steps else None
