"""Device idle after the program's host reads, ms a step: the share of
slice A's device idle in gaps that hold the end of a
``repro_torch.apsp.backward.read`` or ``repro_torch.descent.check`` span
the program recorded there (the device ran dry while the host waited, and
stayed dry until its next launch), of the idle of the same steps untraced
(``harness.program_trace``)."""
from harness import program_trace

LAYER = "device"
MOVES = "bounds_per_s"
UNIT = "ms"
SOURCE = "device_trace"


def read(run):
    return program_trace.idle_after_reads_ms_per_step(
        program_trace.recorded_slice(run))
