"""Device milliseconds of the kernels launched inside the program's
``repro_torch.apsp.forward`` span, per span (one a descent step), in the
traced slice."""
from harness.readers import FORWARD, span_device_ms_per_step

LAYER = "APSP forward"
MOVES = "bounds_per_s"
UNIT = "ms"
SOURCE = "device_trace"


def read(run):
    return span_device_ms_per_step(run, FORWARD)
