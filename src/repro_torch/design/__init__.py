"""Batched topology design: fleet search over wirings through one BatchPlan
(the port of ``repro.design``; ``spaces`` and ``moves`` are numpy copies,
so the same rng state gives the same candidates bit for bit).

The paper's design method — start from random wirings, search server
placement and interconnect for throughput — as a seeded, resumable
stochastic optimizer whose every search round is ONE
``BatchPlan.execute`` over the whole candidate fleet::

    from repro_torch.design import TwoClassSpace, optimize
    from repro_torch.core import heterogeneous as het

    spec = het.TwoClassSpec(n_large=10, k_large=18, n_small=20, k_small=6,
                            num_servers=90)
    result = optimize(TwoClassSpace(spec), rounds=4, fleet=12, seed=0)
    print(result.best.lb, "vs recipe", result.reference.lb)

Modules: ``spaces`` (DesignSpace protocol + the two-class and VL2 pools),
``moves`` (composable move kernels: degree-preserving edge swaps, server
re-distribution, cross-bias perturbation), ``optimizer`` (the fleet loop,
elite selection, final primal certification).  Drivers:
``repro_torch.core.vl2.designed_vl2_topology`` and
``repro_torch.core.heterogeneous.optimize_spec`` wrap this package, and
``repro_torch.launch.figures.fig11`` reports the designed wiring.  The
searches run on the card unless the engine was asked for the CPU.
"""
from repro_torch.design.moves import MOVES, move_servers, perturb_bias, swap_edges  # noqa: F401,E501
from repro_torch.design.optimizer import (  # noqa: F401
    DesignResult, DesignState, Evaluated, optimize,
)
from repro_torch.design.spaces import (  # noqa: F401
    Candidate, DesignSpace, TwoClassSpace, VL2Space,
)
