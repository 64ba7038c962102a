"""Share of the lane-steps a chunk runs after a lane's own descent stopped:
the chunk runs until its slowest lane stops, and a stopped lane is carried
along frozen (from each answer's ``iterations``)."""
from harness.readers import chunk_steps, chunks

LAYER = "descent"
MOVES = "bounds_per_s"
UNIT = "%"
SOURCE = "program_counter"


def read(run):
    frozen = total = 0
    for answers, _ in chunks(run):
        steps = chunk_steps(answers)
        frozen += sum(steps - a.iterations for a in answers)
        total += steps * len(answers)
    return 100.0 * frozen / total if total else None
