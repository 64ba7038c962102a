"""Lifecycle: what happens to a wiring after day one (the port of
``repro.lifecycle``).

The paper designs topologies; this package keeps them honest over their
operational life — failures and growth — using the same certified-solver
and ``BatchPlan`` machinery as the design search::

    from repro_torch.core.graphs import random_regular_graph
    from repro_torch.lifecycle import degradation_surface, plan_expansion

    base = random_regular_graph(24, 5, seed=0, servers=3)
    surface = degradation_surface({"rrg": base}, trials=20)   # on the card
    growth = plan_expansion(base, [[6], [6], [6]], max_recabled_links=3)

Modules: ``failures`` (seeded degraded-fleet generation: independent
link cuts, switch deaths, correlated shared-risk groups — node counts
preserved so a whole fleet shares one plan bucket), ``degradation``
(certified throughput-vs-failure-fraction surfaces, one
``BatchPlan.execute`` per failure kind with ``refill`` keeping compile
keys shared), ``expansion`` (Jellyfish incremental growth under a
``max_recabled_links`` budget, with a certified lb trajectory that is
monotone non-decreasing by construction).  The solves run on the
engine's ``device`` (the default engines': ``"cuda"``); pass e.g.
``engine=CertifiedEngine(device="cpu")`` for the plain versions.
``chip_smoke.py`` phase 15 drives both at the lifecycle benchmark's
paper scale.
"""
from repro_torch.lifecycle.degradation import (  # noqa: F401
    DegradationPoint, DegradationResult, degradation_surface,
)
from repro_torch.lifecycle.expansion import (  # noqa: F401
    Attachment, ExpansionResult, ExpansionSpace, ExpansionStep,
    attach_new_switches, plan_expansion, recabled_links,
)
from repro_torch.lifecycle.failures import (  # noqa: F401
    FAIL_KINDS, Scenario, fail_links, fail_srg, fail_switches,
    scenario_fleet, srg_from_labels,
)
