"""Host reads of the SP-DAG backward a descent step (one backward a step):
the program's ``sp_dag.host_reads`` over its ``sp_dag.backwards``, counted
with its recording on around slice A (``harness.program_trace``)."""
from harness import program_trace

LAYER = "SP-DAG backward"
MOVES = "bounds_per_s"
UNIT = "count"
SOURCE = "program_counter"


def read(run):
    return program_trace.host_reads_per_step(
        program_trace.recorded_slice(run))
