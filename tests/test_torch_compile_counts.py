"""The port's compile counts (``compile_cache_sizes``), against the
reference's contract (``tests/test_aot_cache.py``'s counters,
``tests/test_routing.py``'s zero-delta checks).

The port compiles no program per shape.  Each entry point counts the
distinct (shapes, dtypes, static kwargs) keys it has run in this process,
and its one compile is the kernel library's: ``aot.compiles`` counts the
nvcc builds of this process, ``aot.hits`` the loads that found the library
built already (``kernels._build`` keeps it across processes, named by a
hash of its sources).  A failed build raises; nothing falls back.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as r_plan  # noqa: E402
from repro_torch.core import mcf, primal, routing, traffic  # noqa: E402
from repro_torch.core.engine import get_engine  # noqa: E402
from repro_torch.core.graphs import random_regular_graph  # noqa: E402
from repro_torch.core.plan import BatchPlan, compile_cache_sizes  # noqa: E402,E501
from repro_torch.kernels import _build  # noqa: E402

_ITERS = 20


def _instance(n=12, servers=3, seed=0):
    t = random_regular_graph(n, 4, seed=seed, servers=servers)
    return t, traffic.make("permutation", t.servers, seed=seed + 1)


def _engine(name="dual", **kw):
    return get_engine(name, iters=_ITERS, device="cpu", **kw)


def _delta(c0, c1, prefix):
    return {k: c1[k] - c0[k] for k in c1 if k.startswith(prefix)}


def test_compile_cache_sizes_has_the_reference_keys():
    port = compile_cache_sizes()
    assert set(port) == set(r_plan.compile_cache_sizes())
    assert all(isinstance(v, int) for v in port.values()), port
    assert mcf.jit_cache_size(mcf._PROGRAMS["solve_batch"]) == \
        port["dual.solve_batch"]


def test_a_second_solve_of_a_shape_adds_no_program():
    """The reference's miss-then-hit, as counts: the first solve of a shape
    adds one ``dual.solve_batch`` program, the same shape again none, with
    the same bits."""
    t, dem = _instance(n=14, seed=21)
    eng = _engine()
    c0 = compile_cache_sizes()
    first = eng.solve_batch([t] * 3, [dem] * 3)
    c1 = compile_cache_sizes()
    second = eng.solve_batch([t] * 3, [dem] * 3)
    c2 = compile_cache_sizes()
    assert c1["dual.solve_batch"] - c0["dual.solve_batch"] <= 1
    assert not any(_delta(c1, c2, "dual.").values())
    assert [r.throughput for r in first] == [r.throughput for r in second]


def test_different_shapes_are_different_programs():
    keys = {mcf.program_key((torch.zeros(2, n, n), 0.08, 0.0),
                            {"iters": 20, "backend": "auto"})
            for n in (12, 16)}
    assert len(keys) == 2
    # a dynamic scalar's value is not part of the key; a static kwarg is
    base = mcf.program_key((torch.zeros(2, 12, 12), 0.08, 0.0), {"iters": 20})
    assert mcf.program_key((torch.zeros(2, 12, 12), 0.5, 1e-3),
                           {"iters": 20}) == base
    assert mcf.program_key((torch.zeros(2, 12, 12), 0.08, 0.0),
                           {"iters": 21}) != base
    assert mcf.program_key((torch.zeros(2, 12, 12, dtype=torch.float64),
                            0.08, 0.0), {"iters": 20}) != base
    with pytest.raises(TypeError, match="cannot key"):
        mcf.program_key((object(),), {})


class _FakeLib:
    """Stands in for the ``ctypes`` handle: entries take attributes."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """``_build.load`` over a library path in ``tmp_path``, with a fake
    nvcc and ``ctypes`` handle and this process's counts cleared."""
    target = tmp_path / "librepro_torch_test.so"
    builds = []

    def build(path):
        builds.append(path)
        path.write_bytes(b"built")
        _build._BUILD_SECONDS.append(0.5)

    monkeypatch.setattr(_build, "library_path", lambda: target)
    monkeypatch.setattr(_build, "_build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(_build, "_BUILD_SECONDS", [])
    monkeypatch.setattr(_build, "_FOUND", [])
    _build.load.cache_clear()
    yield target, builds
    _build.load.cache_clear()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_aot_counters_are_the_library_builds(fake_library, warm):
    """A cold process builds the library (``aot.compiles`` 1); a warm one
    finds it built and runs no nvcc (``aot.compiles`` 0, ``aot.hits`` 1,
    ``build_seconds()`` None)."""
    target, builds = fake_library
    if warm:
        target.write_bytes(b"built by an earlier process")
    lib = _build.load()
    assert lib.path == str(target)
    assert _build.load() is lib          # once a process
    sizes = compile_cache_sizes()
    got = (sizes["aot.compiles"], sizes["aot.hits"])
    assert got == ((0, 1) if warm else (1, 0))
    assert builds == ([] if warm else [target])
    assert (_build.build_seconds() is None) == warm


def test_a_failed_build_raises_and_counts_nothing(fake_library,
                                                  monkeypatch):
    def broken(path):
        raise RuntimeError("nvcc failed on ['minplus.cu']")

    monkeypatch.setattr(_build, "_build", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load()
    sizes = compile_cache_sizes()
    assert (sizes["aot.compiles"], sizes["aot.hits"]) == (0, 0)


@pytest.mark.parametrize("solve", [mcf.solve_dual, primal.solve_primal,
                                   routing.solve_ecmp, routing.solve_ksp],
                         ids=["dual", "primal", "ecmp", "ksp"])
def test_single_solve_counts_under_its_own_entry(solve):
    t, dem = _instance()
    name, batch = {"solve_dual": ("dual.solve", "dual.solve_batch"),
                   "solve_primal": ("primal.solve", "primal.solve_batch"),
                   "solve_ecmp": ("routing.ecmp", "routing.ecmp_batch"),
                   "solve_ksp": ("routing.ksp", "routing.ksp_batch"),
                   }[solve.__name__]
    before = compile_cache_sizes()
    res = solve(t, dem, iters=_ITERS, device="cpu")
    assert np.isfinite(dataclasses.astuple(res)[0])
    # a single solve counts under its own entry point, not the batch's
    after = compile_cache_sizes()
    assert after[name] >= 1 and after[batch] == before[batch]


def _routing_pile(seed0, n=12, count=4):
    topos = [random_regular_graph(n, 3, seed=s, servers=2)
             for s in range(seed0, seed0 + count)]
    dems = [traffic.make("permutation", t.servers, seed=9 + s)
            for s, t in enumerate(topos)]
    return topos, dems


@pytest.mark.parametrize("name", ["ecmp", "ksp"])
def test_one_batchplan_per_sweep_and_fresh_round_reuses_programs(name):
    """The reference's plan contract on the routing engines: one
    solve_batch = one BatchPlan over every instance, and a second round of
    fresh instances of the same shapes adds no routing program."""
    topos, dems = _routing_pile(0)
    eng = get_engine(name, iters=_ITERS, device="cpu")
    res = eng.solve_batch(topos, dems)
    assert len(res) == 4 and all(r.bound == "lower" for r in res)
    stats = eng.last_plan
    assert stats.instances == 4
    assert stats.chunks == stats.buckets == 1
    keys = stats.compile_keys
    c0 = compile_cache_sizes()
    eng.solve_batch(*_routing_pile(50))
    c1 = compile_cache_sizes()
    assert eng.last_plan.compile_keys == keys
    delta = _delta(c0, c1, "routing.")
    assert delta and all(v == 0 for v in delta.values()), delta
    assert c0[f"routing.{name}_batch"] >= 1


@pytest.mark.parametrize("solver,prefix", [
    ("dual", "dual."), ("dual-demgrad", "dual."), ("primal", "primal."),
    ("ecmp", "routing."), ("ksp", "routing.")])
def test_batchplan_refill_reuses_programs(solver, prefix):
    """``BatchPlan.refill`` + ``execute``: the structural compile-key
    guarantee holds for every solver's program counts."""
    topos = [random_regular_graph(10, 3, seed=s, servers=1)
             for s in range(3)]
    dems = [traffic.make("permutation", t.servers, seed=s)
            for s, t in enumerate(topos)]
    plan = BatchPlan.build(topos, dems, device="cpu")
    r1 = plan.execute(solver=solver, iters=_ITERS, device="cpu")
    c0 = compile_cache_sizes()
    plan2 = plan.refill([random_regular_graph(10, 3, seed=s + 7)
                         for s in range(3)], dems)
    r2 = plan2.execute(solver=solver, iters=_ITERS, device="cpu")
    c1 = compile_cache_sizes()
    assert plan2.stats.compile_keys == plan.stats.compile_keys
    delta = _delta(c0, c1, prefix)
    assert delta and all(v == 0 for v in delta.values()), delta
    assert len(r1) == len(r2) == 3
