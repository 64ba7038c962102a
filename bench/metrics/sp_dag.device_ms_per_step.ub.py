"""Device milliseconds of the kernels launched inside the program's
``repro_torch.apsp.backward`` span (the SP-DAG backward), per span, in the
traced slice of a dual pile."""
from harness.readers import BACKWARD, span_device_ms_per_step

LAYER = "SP-DAG backward"
MOVES = "bounds_per_s"
UNIT = "ms"
SOURCE = "device_trace"


def read(run):
    return span_device_ms_per_step(run, BACKWARD)
