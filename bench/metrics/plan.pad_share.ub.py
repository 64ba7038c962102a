"""Share of the node pairs the plan computes that are padding: padded nodes
and replicated lanes, over every chunk of the window's whole piles (from
each answer's ``padded_n``, ``nodes`` and the plan's chunk shapes)."""
from harness.readers import chunks

LAYER = "engine / plan"
MOVES = "bounds_per_s"
UNIT = "%"
SOURCE = "program_counter"


def read(run):
    useful = computed = 0
    for answers, _ in chunks(run):
        n = answers[0].padded_n
        lanes = dict((k[0], k[1]) for k in answers[0].plan["compile_keys"])
        computed += lanes[n] * n * n
        useful += sum(a.nodes * a.nodes for a in answers)
    return 100.0 * (1 - useful / computed) if computed else None
