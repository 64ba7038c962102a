"""``devices``: each chunk's lanes sharded over the local cards
(``repro_torch.core.plan``), against the reference's sharded-plan contract
(``tests/test_plan.py``'s five sharded tests).

The reference needs forced host devices to run those tests; the port's
``devices=k`` on the CPU splits each chunk into k shards run in turn, so
tier-1 drives the sharded path.  A lane's bits do not depend on its batch,
so every solver's sharded lanes equal ``devices=1``'s bit for bit.  The
plan's structure at ``devices=8`` is held against the reference's, built in
one subprocess with 8 forced host devices.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import adversarial, graphs, mcf, traffic  # noqa: E402
from repro_torch.core.engine import DualEngine, get_engine  # noqa: E402
from repro_torch.core.plan import BatchPlan, device_count  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_ITERS = 30


def _instances(ns, deg=4, servers=3):
    topos, dems = [], []
    for s, n in enumerate(ns):
        t = graphs.random_regular_graph(n, deg, seed=s, servers=servers)
        topos.append(t)
        dems.append(traffic.make("permutation", t.servers, seed=s + 1))
    return topos, dems


def _bounds(results):
    return np.array([r.throughput for r in results])


def _engine(name="dual", **kw):
    return get_engine(name, iters=_ITERS, device="cpu", **kw)


def test_sharded_bounds_bit_identical_to_single_device():
    # 6 mixed-size instances: uneven against 4 devices in every bucket
    topos, dems = _instances([8, 10, 12, 12, 16, 20])
    one = _engine(devices=1)
    many = _engine(devices=4)
    a = one.solve_batch(topos, dems)
    b = many.solve_batch(topos, dems)
    assert np.array_equal(_bounds(a), _bounds(b)), \
        "sharding the batch axis must not change any bound bit"
    assert [x.meta["iterations"] for x in a] == \
        [y.meta["iterations"] for y in b]
    assert many.last_plan.devices == 4
    assert all(r.meta["devices"] == 4 for r in b)
    # every chunk's lane count is a device multiple; the surplus lanes are
    # replicated real instances
    assert all(c.lanes % 4 == 0 for c in many.plan(topos, dems).chunks)
    assert many.last_plan.lanes_padded > 0


def test_sharded_uneven_batch_to_device_split():
    # 5 equal-size instances over 8 devices: single chunk padded 5 -> 8
    topos, dems = _instances([12] * 5)
    eng = _engine(devices=8)
    plan = eng.plan(topos, dems)
    assert [c.lanes for c in plan.chunks] == [8]
    assert plan.stats.lanes_padded == 3
    capp, _, _ = plan._pack(plan.chunks[0])
    assert all(np.array_equal(capp[i], capp[0]) for i in (5, 6, 7))
    got = _bounds(eng.solve_batch(topos, dems))
    ref = _bounds(_engine(devices=1).solve_batch(topos, dems))
    assert np.array_equal(got, ref)
    assert len(plan.execute(iters=_ITERS, device="cpu")) == 5
    assert len(plan.last_shard_seconds) == 8


def test_sharded_chunking_under_tiny_lane_budget():
    # a budget below the device count is raised to one lane per device; a
    # non-multiple budget floors to the device multiple
    topos, dems = _instances([12] * 20)
    plan = _engine(devices=8, max_lanes=12).plan(topos, dems)
    assert all(c.lanes == 8 for c in plan.chunks)       # 12 -> floor -> 8
    assert [len(c.indices) for c in plan.chunks] == [8, 8, 4]
    assert [c.lanes for c in _engine(devices=8, max_lanes=3).plan(
        topos, dems).chunks] == [8, 8, 8]
    # the solve at a smaller pile: lanes freeze per lane under tol, so
    # (unlike the reference's) the chunked sharded bounds are bit-equal
    topos, dems = topos[:6], dems[:6]
    eng = _engine(devices=2, max_lanes=3, tol=1e-3, check_every=5)
    assert [c.lanes for c in eng.plan(topos, dems).chunks] == [2, 2, 2]
    got = _bounds(eng.solve_batch(topos, dems))
    ref = _bounds(_engine(devices=1, tol=1e-3, check_every=5)
                  .solve_batch(topos, dems))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("solver", ["primal", "certified", "ecmp", "ksp"])
def test_sharded_solver_bounds_bit_identical_to_single_device(solver):
    # every planned solver rides the same sharded plan machinery
    topos, dems = _instances([8, 10, 12, 12, 16])
    a = _engine(solver, devices=1).solve_batch(topos, dems)
    b = _engine(solver, devices=3).solve_batch(topos, dems)
    assert np.array_equal(_bounds(a), _bounds(b))
    for x, y in zip(a, b):
        assert x.meta["ub"] == y.meta["ub"]
        assert x.meta["final_util"] == y.meta["final_util"]
        assert x.meta["iterations"] == y.meta["iterations"]


def test_sharded_dual_demgrad_bit_identical_to_single_device():
    topos, dems = _instances([10, 12, 12])
    got = BatchPlan.build(topos, dems, devices=2, device="cpu").execute(
        solver="dual-demgrad", iters=_ITERS, device="cpu")
    ref = BatchPlan.build(topos, dems, devices=1, device="cpu").execute(
        solver="dual-demgrad", iters=_ITERS, device="cpu")
    for x, y in zip(got, ref):
        assert x.value == y.value and x.iterations == y.iterations
        assert np.array_equal(x.meta["dem_grad"], y.meta["dem_grad"])
        assert x.meta["devices"] == 2 and y.meta["devices"] == 1


def test_sharded_empty_and_single_instance():
    assert _engine(devices=8).solve_batch([], []) == []
    topos, dems = _instances([12])
    got = _engine(devices=8).solve_batch(topos, dems)
    ref = mcf.solve_dual(topos[0], dems[0], iters=_ITERS, device="cpu")
    assert got[0].throughput == ref.throughput_ub


def test_find_worst_tm_takes_devices():
    topo = graphs.random_regular_graph(10, 4, seed=0, servers=2)
    kw = dict(seed=1, rounds=2, candidates=4, iters=_ITERS, device="cpu")
    one = adversarial.find_worst_tm(topo, devices=1, **kw)
    two = adversarial.find_worst_tm(topo, devices=2, **kw)
    assert np.array_equal(one.tm, two.tm)
    assert (one.lb, one.ub, one.baseline_lb, one.baseline_ub) == \
        (two.lb, two.ub, two.baseline_lb, two.baseline_ub)
    assert two.stats["last_plan"]["devices"] == 2


def test_devices_resolution_on_the_cpu_and_the_card(monkeypatch):
    assert device_count(None, "cpu") == 1
    assert device_count(5, "cpu") == 5
    with pytest.raises(ValueError, match="devices=0 out of range"):
        device_count(0, "cpu")
    # on the card too ``None`` is one device: sharding is asked for by
    # number (``plan.device_count`` says why the port differs here)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_count(None, "cuda") == 1
    assert device_count(2, "cuda") == 2
    assert DualEngine(device="cuda").plan(*_instances([8])).devices == 1
    assert DualEngine(devices=2, device="cuda").plan(
        *_instances([8])).devices == 2


def test_devices_above_the_card_count_raise(monkeypatch):
    """An explicit ``devices`` above the local card count raises with the
    reference's message, at planning and at execution: no fallback."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    topos, dems = _instances([8, 8, 8])
    with pytest.raises(ValueError, match="devices=3 out of range; 2 local "
                       "device"):
        device_count(3, "cuda")
    with pytest.raises(ValueError, match="devices=3 out of range"):
        BatchPlan.build(topos, dems, devices=3, device="cuda")
    with pytest.raises(ValueError, match="devices=3 out of range"):
        DualEngine(devices=3, device="cuda").solve_batch(topos, dems)
    # a plan made for three CPU shards is not run on two cards either
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    plan = BatchPlan.build(topos, dems, devices=3, device="cpu")
    with pytest.raises(ValueError, match="devices=3 out of range"):
        plan.execute(device="cuda")
    # without a card an explicit count cannot be met at all
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="0 local device"):
        device_count(1, "cuda")
    assert device_count(None, "cuda") == 1


_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import numpy as np
    from repro.core.plan import BatchPlan

    out = []
    for ns, kw in json.loads(sys.argv[1]):
        caps = [np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
                for n in ns]
        plan = BatchPlan.build(caps, caps, devices=8, **kw)
        out.append({"stats": plan.stats.as_dict(),
                    "chunks": [dataclasses.astuple(c) for c in plan.chunks]})
    print(json.dumps(out))
""")

_CASES = [
    ([12, 14, 16, 16, 20, 20, 24, 24, 33, 40], {}),
    ([16] * 5, {}),
    ([16] * 20, {"max_lanes": 12}),
    ([16] * 20, {"max_lanes": 3}),
    ([12, 14, 16, 20, 24, 33, 16], {"bucket": None, "max_lanes": 9}),
    ([12, 14, 16, 20, 24, 33, 16], {"bucket": 8, "max_lanes": 17}),
]


def test_plan_structure_equals_reference_at_8_devices():
    """Buckets, chunk lanes, padded lanes and compile keys at devices=8
    against the reference's sharded planner (8 forced host devices)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT, json.dumps(_CASES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for (ns, kw), want in zip(_CASES, ref):
        caps = [np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
                for n in ns]
        plan = BatchPlan.build(caps, caps, devices=8, device="cpu", **kw)
        got = json.loads(json.dumps(
            {"stats": plan.stats.as_dict(),
             "chunks": [dataclasses.astuple(c) for c in plan.chunks]}))
        assert got == want, (ns, kw)
        assert plan.stats.devices == 8


def test_one_given_table_stat_is_completed_from_the_whole_chunk():
    """With ``d_max`` pinned and ``mean_degree`` left to the solver, every
    shard must resolve the backend as the whole chunk would: the plan
    takes the missing stat from the chunk's padded stack, not the shard's."""
    from repro_torch.core.graphs import degree_stats
    topos, dems = _instances([12, 12, 12, 12], deg=4)
    topos[3] = graphs.random_regular_graph(12, 8, seed=9, servers=3)
    plan = BatchPlan.build(topos, dems, devices=2, device="cpu")
    (chunk,) = plan.chunks
    capp, _, _ = plan._pack(chunk)
    kw = plan._chunk_kw(chunk, capp, {"backend": "auto", "d_max": 8}, False)
    assert kw["d_max"] == 8
    assert kw["mean_degree"] == degree_stats(capp)[1] != \
        degree_stats(capp[2:])[1]
    one = BatchPlan.build(topos, dems, devices=1, device="cpu")
    assert one._chunk_kw(chunk, capp, {"backend": "auto", "d_max": 8},
                         False) == {"backend": "auto", "d_max": 8}
