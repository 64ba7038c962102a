"""The port's recorder (``repro_torch.obs``) and the spans and counters the
program records with it, on the CPU: off it records nothing and hands out
one shared context; on it keeps nesting, threads and counter totals; the
bounds are the same bits either way; the SP-DAG backward's counts equal
the hop depth of graphs where that depth is known; a torch profiler trace
names exactly the five profiler ranges, and a span lies on the trace's
time axis around its range."""
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs.registry import get_smoke  # noqa: E402
from repro_torch.core import apsp as p_apsp  # noqa: E402
from repro_torch.core import get_engine, graphs, mcf, traffic  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

READ = "repro_torch.apsp.backward.read"
CHECK = "repro_torch.descent.check"
RANGES = {"repro_torch.apsp.forward", "repro_torch.apsp.backward",
          "repro_torch.primal.line_search", "repro_torch.adamw",
          "repro_torch.rglru"}


def _pile(lanes=3, n=20, r=4):
    topos = [graphs.random_regular_graph(n, r, seed=s, servers=3)
             for s in range(lanes)]
    dems = [traffic.make("permutation", t.servers, seed=s + 50)
            for s, t in enumerate(topos)]
    return topos, dems


def test_off_hands_out_one_shared_context_and_records_nothing():
    assert obs._rec is None
    a, b = obs.span(READ), obs.span(CHECK)
    assert a is b
    with a as got:
        assert got is None
    obs.count("sp_dag.hops", 5)
    topos, dems = _pile(lanes=2)
    get_engine("dual", iters=30, device="cpu").solve_batch(topos, dems)
    with obs.record() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    # a profiler range off is the plain range, entered as before
    rf = obs.span("repro_torch.apsp.forward", profiler=True)
    assert isinstance(rf, torch.profiler.record_function)
    assert rf is not obs.span("repro_torch.apsp.forward", profiler=True)


def test_on_records_nesting_threads_and_counters():
    with obs.record() as rec:
        with obs.span("outer"):
            with obs.span("inner", profiler=True):
                obs.count("c", 2)
            obs.count("c")

        def work():
            with obs.span("outer"):
                with obs.span("inner"):
                    pass
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(RuntimeError, match="already on"):
            obs.record().start()
        late = obs.span("late")
        late.__enter__()
    late.__exit__(None, None, None)        # closed after the stop: not kept
    assert obs._rec is None
    assert rec.counts == {"c": 3}
    assert rec.clock == obs.CLOCK == "time.time_ns"
    got = [(s.name, s.parent) for s in rec.spans]
    assert got == [("inner", "outer"), ("outer", None)] * 2
    main, other = rec.spans[:2], rec.spans[2:]
    assert {s.tid for s in main} == {threading.get_native_id()}
    assert len({s.tid for s in other}) == 1 and other[0].tid != main[0].tid
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    inner, outer = main
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # nothing leaks into the next recording
    with obs.record() as again:
        pass
    assert again.spans == [] and again.counts == {}


def test_counters_keep_every_add_across_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.record() as rec:
            def add():
                for _ in range(2000):
                    obs.count("n")
                    with obs.span("s"):
                        pass
            threads = [threading.Thread(target=add) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counts == {"n": 16000}
    assert len(rec.spans) == 16000
    assert all(s.parent is None for s in rec.spans)


def _answers(res):
    return [(r.throughput, r.meta.get("ub"), r.meta.get("lb"),
             r.meta["iterations"]) for r in res]


@pytest.mark.parametrize("engine", ["dual", "certified"])
def test_bounds_are_the_same_bits_with_recording_on(engine):
    topos, dems = _pile()
    eng = get_engine(engine, iters=60, tol=1e-4, check_every=10,
                     device="cpu")
    off = _answers(eng.solve_batch(topos, dems))
    with obs.record() as rec:
        on = _answers(eng.solve_batch(topos, dems))
    assert on == off
    steps = max(a[3] for a in off)
    assert rec.counts["sp_dag.backwards"] == steps
    names = {s.name for s in rec.spans}
    assert {READ, CHECK, "repro_torch.apsp.forward",
            "repro_torch.apsp.backward"} <= names
    assert ("repro_torch.primal.line_search" in names) == (
        engine == "certified")
    # every read of the backward sits inside it; the stop read outside
    assert {s.parent for s in rec.spans if s.name == READ} == {
        "repro_torch.apsp.backward"}
    assert {s.parent for s in rec.spans if s.name == CHECK} == {None}
    # one stop read a check window the chunk ran past
    assert sum(s.name == CHECK for s in rec.spans) == (steps - 1) // 10


def _unit(n, arcs):
    w = np.full((n, n), p_apsp._INF, np.float32)
    np.fill_diagonal(w, 0.0)
    for a, b in arcs:
        w[a, b] = 1.0
    return w


@pytest.mark.parametrize("shape,n,depth", [
    ("directed path", 6, 5), ("directed ring", 7, 6),
    ("ring both ways", 8, 4)])
def test_backward_counts_one_sweep_a_hop(shape, n, depth):
    """The cotangent of every reachable pair goes back one hop a sweep, so
    a backward sweeps as often as the longest shortest path has hops, and
    reads the widths once and the mass before each sweep and after the
    last."""
    arcs = [(i, i + 1) for i in range(n - 1)]
    if shape != "directed path":
        arcs.append((n - 1, 0))
    if shape == "ring both ways":
        arcs += [(b, a) for a, b in arcs]
    w = torch.from_numpy(_unit(n, arcs))[None].requires_grad_(True)
    with obs.record() as rec:
        d = p_apsp.apsp(w, "squaring")
        d.backward(torch.ones_like(d))
    assert int(d[torch.isfinite(d) & (d < p_apsp._INF / 2)].max()) == depth
    assert rec.counts == {"sp_dag.backwards": 1, "sp_dag.hops": depth,
                          "sp_dag.host_reads": depth + 2}
    assert sum(s.name == READ for s in rec.spans) == depth + 2


@pytest.mark.parametrize("hop", [1, 3])
def test_dual_descent_counts_the_demanded_depth(hop):
    """On a directed ring every pair has one path, so a demand of ``hop``
    hops sweeps ``hop`` times in every backward of the descent."""
    n, iters = 9, 30
    cap = np.zeros((n, n), np.float32)
    dem = np.zeros((n, n), np.float32)
    for i in range(n):
        cap[i, (i + 1) % n] = 1.0
        dem[i, (i + hop) % n] = 1.0
    with obs.record() as rec:
        res = mcf.solve_dual_batch(cap[None], dem[None], iters=iters,
                                   backend="squaring", device="cpu")
    assert int(res.iterations[0]) == iters
    assert rec.counts == {"sp_dag.backwards": iters,
                          "sp_dag.hops": iters * hop,
                          "sp_dag.host_reads": iters * (hop + 2)}
    # check windows at steps 25 (every 25 steps, not at step 0)
    assert sum(s.name == CHECK for s in rec.spans) == (iters - 1) // 25


def _profiled_names(recording: bool) -> set[str]:
    from torch.profiler import ProfilerActivity, profile
    topos, dems = _pile(lanes=2)
    cfg = get_smoke("recurrentgemma-2b")
    lw = rglru.init_params(cfg, 0, "cpu")["blocks"][0]
    x = torch.randn(1, 4, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    params = {"w": torch.ones(3, 2)}
    opt = AdamW(lr=1e-3)
    rec = obs.record()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if recording:
            rec.start()
        try:
            get_engine("certified", iters=30, device="cpu").solve_batch(
                topos, dems)
            opt.update(params, {"w": torch.full((3, 2), 0.5)},
                       opt.init(params))
            rglru._rec_block(cfg, x, lw, None)
        finally:
            rec.stop()
    if recording:
        assert {s.name for s in rec.spans} >= RANGES | {READ, CHECK}
    return {e.name for e in prof.events() if e.name.startswith("repro_torch")}


@pytest.mark.parametrize("recording", [False, True])
def test_profiler_ranges_are_exactly_the_five(recording):
    assert _profiled_names(recording) == RANGES


def test_span_lies_around_its_range_on_the_trace_time_axis(tmp_path):
    """A profiler span's stamps, put on the exported trace's axis by
    ``trace_us`` and its ``baseTimeNanoseconds``, enclose the range the
    profiler stamped itself."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.record() as rec:
            for _ in range(5):
                with obs.span("probe", profiler=True):
                    time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"])
                    for e in trace["traceEvents"]
                    if e.get("ph") == "X" and e["name"] == "probe")
    spans = sorted((obs.trace_us(s.start_ns, base), obs.trace_us(s.end_ns,
                                                                 base))
                   for s in rec.spans)
    assert len(ranges) == len(spans) == 5
    for (a, b), (lo, hi) in zip(ranges, spans):
        assert lo <= a and b <= hi and hi - lo < (b - a) + 1000.0
