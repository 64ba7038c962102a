"""The APSP forward's share of its roofline: the least time of the closure
the step needs (harness.roofline, counted from the graphs of the lanes
still descending, whatever implements it) over the device time inside the
``repro_torch.apsp.forward`` span, in the traced slice."""
from harness.readers import (FORWARD, forward_least_seconds,
                             span_device_ms_per_step)

LAYER = "kernels"
MOVES = "bounds_per_s"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    ms = span_device_ms_per_step(run, FORWARD)
    least = forward_least_seconds(run)
    if not ms or least is None:
        return None
    return 100.0 * least / (ms * 1e-3)
