"""Device idle inside the program's ``repro_torch.apsp.backward`` spans,
ms a step: the share of slice A's device idle that lies inside the spans
the program recorded there, of the idle of the same steps untraced
(``harness.program_trace``)."""
from harness import program_trace

LAYER = "SP-DAG backward"
MOVES = "bounds_per_s"
UNIT = "ms"
SOURCE = "device_trace"


def read(run):
    return program_trace.idle_ms_per_step(
        program_trace.recorded_slice(run), (program_trace.BACKWARD,))
