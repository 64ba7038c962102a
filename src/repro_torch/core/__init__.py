"""The port's throughput engines: graphs and traffic (numpy), the HiGHS
oracle (scipy), the APSP backends, the dual descent and the Frank–Wolfe
primal (torch), the routing-restricted ECMP/KSP bounds (routing),
BatchPlan and the engine registry, the worst-case traffic search
(adversarial), and the Fig. 1–11 layer on top (bounds, decompose,
heterogeneous, vl2, fabric).  The design layer is ``repro_torch.design``.

    from repro_torch.core import Topology, get_engine, graphs, traffic

    topo = graphs.random_regular_graph(40, 10, seed=0, servers=5)
    dem = traffic.make("permutation", topo.servers, seed=1)
    get_engine("dual").solve(topo, dem)                 # on the card
    get_engine("certified", device="cpu").solve(topo, dem)  # plain versions
"""
from repro_torch.core import (  # noqa: F401
    adversarial, apsp, bounds, decompose, engine, fabric, graphs, heterogeneous, lp, mcf,
    plan, primal, routing, traffic, vl2,
)
from repro_torch.core.engine import (  # noqa: F401
    AdversarialEngine, CertifiedEngine, DualEngine, EcmpEngine, ExactLPEngine, KspEngine,
    PrimalEngine, Sweep, SweepPoint, ThroughputEngine, ThroughputResult, as_engine, get_engine,
    run_sweep, run_sweeps,
)
from repro_torch.core.graphs import Topology  # noqa: F401
from repro_torch.core.plan import BatchPlan, PlanStats  # noqa: F401
