"""CPU tests of the port's benchmark harness (``bench/``): every part of
``BENCHMARK.json`` resolves to its files by name, the frozen input
generators reproduce the package's inputs bit for bit, the plain reference
agrees with the port on small instances, the trace arithmetic, the window's
deadline, and the refusal to measure without a card.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import json
import pathlib
import re
import sys
import time

import numpy as np
import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

torch = pytest.importorskip("torch")

from families import random_regular, rewired_vl2  # noqa: E402
from harness import (bounds, check, reference, roofline, spans,  # noqa: E402
                     spec, trace, traffic, window)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# --- BENCHMARK.json and its files --------------------------------------------

def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells, at 60 s a run and 180 s a cell over the
    # window, with 1,200 s spare, fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(w):
    c = spec.cell(w["name"], SPEC)
    assert c.chips == w["chips"] == 1
    assert c.family().build
    names = {m["name"] for m in c.end_to_end}
    assert names == {"setup_s", c.mix["rate"]}
    for key in c.limits:
        assert c.limits[key] >= 0
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = ROOT / cfg["file"]
    assert path == BENCH / "configs" / f"{cfg['name']}.json"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert (BENCH / "families" / f"{data['family']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_by_name(m):
    mod = spec.metric_reader(m["name"])
    assert (mod.LAYER, mod.MOVES, mod.UNIT, mod.SOURCE) == (
        m["layer"], m["moves"], m["unit"], m["source"])
    moves = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]][0]
    # every cell that reports the metric reports what it moves
    for w in m["workloads"]:
        assert "workloads" not in moves or w in moves["workloads"]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
        assert m["unit"] == "%"


def test_metric_names_unique_and_layers_named():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    perf = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert m["layer"] in perf


# --- the frozen input generators ---------------------------------------------

def test_random_regular_bit_for_bit():
    from repro_torch.core import graphs
    for n, r in ((20, 4), (40, 10), (64, 7 + 1)):
        for s in range(12):
            want = graphs.random_regular_graph(n, r, seed=s, servers=3)
            cap, srv = random_regular.build(
                {"n": n, "r": r, "servers": 3}, s)
            assert np.array_equal(cap, want.cap)
            assert np.array_equal(srv, want.servers)


def test_rewired_vl2_bit_for_bit():
    from repro_torch.core import vl2
    for d in (6, 8):
        spec_ = vl2.VL2Spec(d, d)
        for s in range(6):
            want = vl2.rewired_vl2_topology(spec_, spec_.n_tor_full, s)
            cap, srv = rewired_vl2.build(
                {"d_a": d, "d_i": d, "n_tor": spec_.n_tor_full}, s)
            assert np.array_equal(cap, want.cap)
            assert np.array_equal(srv, want.servers)


def test_traffic_and_theorem1_bit_for_bit():
    from repro_torch.core import bounds as pbounds
    from repro_torch.core import traffic as ptraffic
    servers = np.array([3, 0, 2, 5, 1, 4, 2, 3])
    for s in (0, 5, 2 ** 33 + 1):
        assert np.array_equal(traffic.random_permutation(servers, s),
                              ptraffic.random_permutation(servers, s))
    for n, r, f in ((512, 16, 4090.0), (40, 10, 380.0)):
        assert bounds.throughput_upper_bound(n, r, f) == \
            pbounds.throughput_upper_bound(n, r, f)


def test_piles_are_drawn_from_the_seed():
    mix = {"pattern": "permutation", "pile": 3}
    params = {"n": 20, "r": 4, "servers": 2}
    seed = 2 ** 31 + 9
    a = traffic.make_pile(random_regular, params, mix, seed, 1)
    again = traffic.make_pile(random_regular, params, mix, seed, 1)
    assert all(np.array_equal(x.cap, y.cap) and np.array_equal(x.dem, y.dem)
               for x, y in zip(a, again))
    # every instance of a run is its own: across positions, piles, seeds,
    # and the warm-up's stream
    others = (traffic.make_pile(random_regular, params, mix, seed, 0)
              + traffic.make_pile(random_regular, params, mix, seed + 1, 1)
              + traffic.make_pile(random_regular, params, mix, seed, 1,
                                  traffic.WARM))
    caps = [i.cap for i in a + others]
    assert all(not np.array_equal(caps[i], caps[j])
               for i in range(len(caps)) for j in range(i))
    assert len({i.key for i in a + others[:3] + others[6:]}) == 9


def test_a_pattern_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "ring.py").write_text(
        "import numpy as np\n"
        "def demand(servers, seed, mix):\n"
        "    n = len(servers)\n"
        "    dem = np.zeros((n, n))\n"
        "    dem[np.arange(n), (np.arange(n) + mix['hop']) % n] = servers\n"
        "    return dem\n")
    monkeypatch.setattr(traffic, "TRAFFIC", tmp_path)
    traffic._pattern.cache_clear()
    try:
        dem = traffic.make({"pattern": "ring", "hop": 2},
                           np.array([1, 2, 3, 4]), 0)
        assert dem[1, 3] == 2 and dem.sum() == 10
        with pytest.raises(ValueError, match="unknown traffic pattern"):
            traffic.make({"pattern": "nowhere"}, np.array([1, 1]), 0)
    finally:
        traffic._pattern.cache_clear()


# --- the reference against the port ------------------------------------------

def _instances(kind, seeds):
    out = []
    for s in seeds:
        if kind == "rrg":
            cap, srv = random_regular.build({"n": 20, "r": 4, "servers": 3},
                                            s)
        else:
            cap, srv = rewired_vl2.build(
                {"d_a": 6, "d_i": 6, "n_tor": 9, "servers_per_tor": 4}, s)
        out.append((cap, traffic.random_permutation(srv, s + 100)))
    return out


@pytest.mark.parametrize("kind", ["rrg", "vl2"])
@pytest.mark.parametrize("engine", ["dual", "certified"])
def test_reference_agrees_with_the_port(kind, engine):
    """After the port's own step counts, the float64 reference holds the
    same bounds to the float32 program's rounding of a chaotic descent."""
    from repro_torch.core import get_engine
    inst = _instances(kind, (3, 4, 5))
    caps, dems = [c for c, _ in inst], [d for _, d in inst]
    res = get_engine(engine, tol=1e-4, device="cpu").solve_batch(caps, dems)
    steps = [r.meta["iterations"] for r in res]
    rk = "primal" if engine == "certified" else "dual"
    ref = reference.solve(rk, caps, dems, tol=1e-4, steps=steps,
                          device="cpu")
    ub = np.array([r.meta.get("ub", r.throughput) for r in res])
    assert np.all(np.abs(ub / ref["ub_at"] - 1) < 2e-2)
    if rk == "primal":
        lb = np.array([r.meta["lb"] for r in res])
        assert np.all(np.abs(lb / ref["lb_at"] - 1) < 2e-2)
        assert np.all(ref["lb"] <= ref["ub"])
    # where the port stopped a lane, its stopping rule read little gain
    # on the reference's trajectory too
    stopped = np.array(steps) < 800
    assert np.all(np.abs(ref["stop_gain"][stopped]) < 2e-2)
    own = reference.solve(rk, caps, dems, tol=1e-4, device="cpu")
    assert np.all(own["iterations"] % 25 == 0)


def test_reference_apsp_is_exact_on_hop_counts():
    cap, _ = random_regular.build({"n": 30, "r": 4, "servers": 1}, 7)
    capt = torch.as_tensor(cap)[None]
    edge, idx, valid = reference._tables(capt)
    dist, _ = reference._apsp(torch.where(edge, 1.0, 0.0).double(), idx,
                              valid)
    assert int(dist.max()) == roofline.hop_diameter(cap)


# --- roofline, trace arithmetic, the window ----------------------------------

def test_forward_least_time_counts_the_problem():
    cap, _ = random_regular.build({"n": 512, "r": 16, "servers": 8}, 1)
    ops, nbytes = roofline.forward_work(cap)
    diam = roofline.hop_diameter(cap)
    assert ops == 2 * 512 * 512 * 16 * diam and nbytes == 2 * 512 * 512 * 4
    least, by = roofline.least_seconds([(ops, nbytes)] * 20)
    assert by == "operations"
    assert least == pytest.approx(20 * ops / 33.5e12)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_arithmetic():
    ev = [_ev("user_annotation", "repro_torch.apsp.forward", 0, 10),
          _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=2),
          _ev("user_annotation", "repro_torch.apsp.backward", 20, 10, tid=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, tid=2,
              correlation=3),
          _ev("cpu_op", "aten::item", 12, 6),
          _ev("kernel", "k1", 2, 4, tid=7, correlation=1),
          _ev("kernel", "k2", 5, 3, tid=7, correlation=2),
          _ev("kernel", "k3", 22, 5, tid=7, correlation=3)]
    dev = trace.device_summary(ev)
    assert dev["busy_s"] == pytest.approx(11e-6)       # [2, 8] and [22, 27]
    assert dev["ops_s"]["k1"] == pytest.approx(4e-6)
    by, count = trace.span_device_s(ev)
    assert by["repro_torch.apsp.forward"] == pytest.approx(7e-6)
    assert by["repro_torch.apsp.backward"] == pytest.approx(5e-6)
    assert count == {"repro_torch.apsp.forward": 1,
                     "repro_torch.apsp.backward": 1}
    gaps = trace.idle_gaps(ev)
    assert gaps == [["aten::item", pytest.approx(14e-6)]]


def test_window_abandons_the_pile_in_flight():
    from torch.profiler import record_function

    def solve(pile):
        for _ in range(pile):
            with record_function(spans.STEP_SPAN):
                time.sleep(0.01)
        return [pile]
    w = window.run(solve, [5, 200].__getitem__, 0.5)
    assert [p.answers for p in w.piles] == [[5]]
    assert w.elapsed < 0.5


def test_sample_always_holds_the_longest():
    class A:
        def __init__(self, it):
            self.iterations = it
    answers = [A(i % 7) for i in range(40)]
    for seed in (1, 2 ** 31 + 3):
        got = check.sample(seed, answers, 6)
        assert len(got) == 6 and 6 in got
        assert got == check.sample(seed, answers, 6)
        # an instance solved twice in a window is checked once
        twice = check.sample(seed, answers, 6, [i % 20 for i in range(40)])
        assert len({i % 20 for i in twice}) == 6


def test_refuses_to_measure_without_a_card(monkeypatch, capsys):
    import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", SPEC["workloads"][0]["name"],
                         "--seed", "3", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from harness import cell
    c = spec.cell(SPEC["workloads"][0]["name"], SPEC)
    res = cell.run_cell(c, 2 ** 31 + 11, 30.0, False)
    assert res["correct"] and res["device"]["platform"] == "gpu"
