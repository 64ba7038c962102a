"""The port's throughput engines: graphs and traffic (numpy), the HiGHS
oracle (scipy), the APSP backends and the dual descent (torch), BatchPlan
and the engine registry.

    from repro_torch.core import Topology, get_engine, graphs, traffic

    topo = graphs.random_regular_graph(40, 10, seed=0, servers=5)
    dem = traffic.make("permutation", topo.servers, seed=1)
    get_engine("dual").solve(topo, dem)                 # on the card
    get_engine("dual", device="cpu").solve(topo, dem)   # plain versions
"""
from repro_torch.core import (  # noqa: F401
    apsp, bounds, engine, graphs, lp, mcf, plan, traffic,
)
from repro_torch.core.engine import (  # noqa: F401
    DualEngine, ExactLPEngine, Sweep, SweepPoint, ThroughputEngine,
    ThroughputResult, as_engine, get_engine, run_sweep, run_sweeps,
)
from repro_torch.core.graphs import Topology  # noqa: F401
from repro_torch.core.plan import BatchPlan, PlanStats  # noqa: F401
