"""Share of the steps just before the traced slice A, timed untraced in
the same solve, in which no operation ran on the device: 1 - slice A's busy
time (device activity only) over that wall."""
from harness.readers import idle_percent

LAYER = "device"
MOVES = "bounds_per_s"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    return idle_percent(run)
