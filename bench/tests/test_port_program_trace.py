"""CPU tests of the readers built on the program's own spans
(``harness/program_trace.py``): device gaps clipped to a span's intervals,
a gap that holds a read's end against one that does not, the division by
the slice's steps, ``None`` where there is no recording, and the recorded
slice's mechanics on a solve that runs on the CPU.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import importlib.util
import json
import pathlib
import sys
import types

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

torch = pytest.importorskip("torch")

from harness import program_trace as pt  # noqa: E402
from harness import spans, spec, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"sp_dag.host_reads_per_step.ub", "sp_dag.idle_ms_per_step.ub",
       "sp_dag.idle_ms_per_step.bracket",
       "primal.line_search_idle_ms_per_step.bracket",
       "device.idle_after_reads_ms_per_step.ub"}
READ, CHECK = pt.READS


def _span(name, a, b, parent=None, tid=1):
    return (name, parent, tid, float(a), float(b))


def _slice(device, spans_, counts=None, steps=2, untraced_idle_us=None):
    """A recorded slice whose wall is its busy time and its gaps; the
    untraced steps idle ``untraced_idle_us`` (as long as the slice's gaps
    by default: no scaling)."""
    merged = trace.merged(device)
    busy = sum(b - a for a, b in merged)
    idle = sum(b - a for a, b in pt.gaps(merged))
    if untraced_idle_us is None:
        untraced_idle_us = idle
    return {"steps": steps, "spans": spans_, "counts": counts or {},
            "device": merged, "window_s": 1e-6 * (busy + idle),
            "untraced_s": 3e-6 * (busy + untraced_idle_us),
            "untraced_steps": 3 * steps}


# device busy [0, 10], [30, 40], [50, 60], [100, 110]: gaps (10, 30),
# (40, 50), (60, 100)
DEVICE = [(0, 4), (3, 10), (30, 40), (50, 60), (100, 110)]


def test_gaps_lie_between_merged_busy_intervals():
    assert pt.gaps(trace.merged(DEVICE)) == [(10, 30), (40, 50), (60, 100)]
    assert pt.gaps([]) == [] and pt.gaps([[0, 1]]) == []


def test_gaps_clipped_to_a_spans_intervals():
    rec = _slice(DEVICE, [
        _span(pt.BACKWARD, 20, 45, tid=2),     # 10 of gap 1, 5 of gap 2
        _span(pt.BACKWARD, 44, 48, tid=3),     # overlaps: counted once
        _span(pt.BACKWARD, 70, 80),            # 10 of gap 3
        _span(pt.FORWARD, 0, 20),              # not asked for
        _span(READ, 25, 28, parent=pt.BACKWARD)])
    assert pt.clipped_us(pt.gaps(rec["device"]),
                         pt.span_intervals(rec, (pt.BACKWARD,))) == 28.0
    # per step of the slice, in ms
    assert pt.idle_ms_per_step(rec, (pt.BACKWARD,)) == pytest.approx(
        28e-3 / 2)
    assert pt.idle_ms_per_step(rec, (pt.LINE_SEARCH,)) == 0.0
    assert pt.idle_ms_per_step(rec, (pt.BACKWARD, pt.FORWARD)) == \
        pytest.approx(38e-3 / 2)


def test_a_gap_counts_after_reads_if_it_starts_in_a_read_or_holds_its_end():
    rec = _slice(DEVICE, [
        _span(READ, 5, 12, parent=pt.BACKWARD),   # ends in gap 1: 20
        _span(READ, 13, 15, parent=pt.BACKWARD),  # gap 1 again: once
        _span(CHECK, 35, 39),                     # ends while busy: none
        _span(pt.BACKWARD, 55, 70),               # not a read: gap 3 no
        _span(CHECK, 58, 100)],                   # ends at gap 3's end: 40
        steps=4)
    assert pt.idle_after_reads_ms_per_step(rec) == pytest.approx(60e-3 / 4)
    rec["spans"] = [_span(CHECK, 35, 39), _span(READ, 111, 112)]
    assert pt.idle_after_reads_ms_per_step(rec) == 0.0
    # the device's stamps a little late or early on the host's clock: gap
    # 2 starts inside a read that ends past it (10), gap 3 holds the end of
    # a read begun before it (40); a gap that began before its read started
    # and ended inside it is the host's launch gap, not the read's (gap 1)
    rec["spans"] = [_span(READ, 38, 55), _span(CHECK, 55, 65),
                    _span(READ, 25, 32)]
    assert pt.idle_after_reads_ms_per_step(rec) == pytest.approx(50e-3 / 4)


def test_idle_is_the_untraced_idle_split_as_the_slice_splits_its_own():
    """The slice idles 70 µs (CUPTI's cost a launch in it), the same
    steps untraced 35: every reading is its share of 35."""
    spans_ = [_span(pt.BACKWARD, 0, 45), _span(READ, 5, 12)]
    rec = _slice(DEVICE, spans_, untraced_idle_us=35.0)
    assert pt.untraced_scale(rec) == pytest.approx(0.5)
    assert pt.idle_ms_per_step(rec, (pt.BACKWARD,)) == pytest.approx(
        0.5 * 25e-3 / 2)
    assert pt.idle_after_reads_ms_per_step(rec) == pytest.approx(
        0.5 * 20e-3 / 2)
    # the same slice on a host twice as slow: twice the traced idle
    # (longer gaps between launches), the same untraced share
    slow = _slice([(0, 10), (50, 60), (80, 90), (170, 180)],
                  [_span(pt.BACKWARD, 0, 70), _span(READ, 5, 12)],
                  untraced_idle_us=35.0)
    assert pt.idle_ms_per_step(slow, (pt.BACKWARD,)) == pytest.approx(
        pt.idle_ms_per_step(rec, (pt.BACKWARD,)))
    # a slice with no idle of its own scales nothing
    flat = _slice([(0, 10)], spans_)
    assert pt.untraced_scale(flat) is None
    assert pt.idle_ms_per_step(flat, (pt.BACKWARD,)) is None


def test_host_reads_a_backward():
    rec = _slice(DEVICE, [], {"sp_dag.backwards": 4, "sp_dag.hops": 20,
                              "sp_dag.host_reads": 28}, steps=1)
    assert pt.host_reads_per_step(rec) == 7.0
    rec["counts"] = {}
    assert pt.host_reads_per_step(rec) is None


def test_idle_by_span_of_the_tool():
    """``tools/recorded_windows.py`` puts each gap under the innermost
    span open at its midpoint."""
    spec_ = importlib.util.spec_from_file_location(
        "recorded_windows", ROOT / "tools" / "recorded_windows.py")
    tool = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(tool)
    rec = _slice(DEVICE, [
        _span(pt.FORWARD, 5, 15),                 # gap 1's mid 20: no
        _span(pt.BACKWARD, 15, 100, tid=2),
        _span(READ, 18, 25, parent=pt.BACKWARD, tid=2),   # mid 20
        _span(pt.LINE_SEARCH, 44, 46)], steps=1)  # mid 45
    by = tool.idle_by_span(rec)
    assert list(by) == list(tool.IDLE_CLASSES)
    assert by["reads"] == pytest.approx(20e-3)
    assert by["line search"] == pytest.approx(10e-3)
    assert by["backward less its reads"] == pytest.approx(40e-3)
    assert by["forward"] == 0.0 and by["rest of the step"] == 0.0


def test_no_recording_reads_none(monkeypatch):
    assert pt.idle_ms_per_step(None, (pt.BACKWARD,)) is None
    assert pt.idle_after_reads_ms_per_step(None) is None
    assert pt.host_reads_per_step(None) is None
    untraced = types.SimpleNamespace(trace=None)
    parent = types.SimpleNamespace(trace={"start": 102})
    monkeypatch.setattr(pt, "_memo", None)
    for name in sorted(NEW):
        assert spec.metric_reader(name).read(untraced) is None
    # a program without the recorder (as the parent commit's) builds
    # nothing and reads nothing
    monkeypatch.setattr(pt, "recorder", lambda: None)
    monkeypatch.setattr(pt.sut, "Program", None)
    for name in sorted(NEW):
        assert spec.metric_reader(name).read(parent) is None


def test_recorded_slice_runs_as_far_as_the_first_chunk(monkeypatch):
    """``RECORDED_STEPS`` from the traced slice's start, or fewer where
    the pile's first chunk stops sooner; computed once a run."""
    calls = []

    def slice_of(solve, pile, start, obs, steps):
        calls.append((pile, start, steps))
        return {"steps": steps}
    monkeypatch.setattr(pt, "slice_of", slice_of)
    monkeypatch.setattr(pt.sut, "Program", lambda mix: types.SimpleNamespace(
        solve=None))
    monkeypatch.setattr(pt.torch.cuda, "empty_cache", lambda: None)
    answer = types.SimpleNamespace
    for iterations, steps in ((400, 30), (125, 23)):
        monkeypatch.setattr(pt, "_memo", None)
        first = [answer(chunk=0, iterations=iterations - 50),
                 answer(chunk=0, iterations=iterations),
                 answer(chunk=1, iterations=iterations + 500)]
        run = types.SimpleNamespace(
            trace={"start": 102}, cell=types.SimpleNamespace(mix={}),
            piles=lambda k: f"pile {k}",
            window=types.SimpleNamespace(piles=[types.SimpleNamespace(
                answers=first)]))
        assert pt.recorded_slice(run) == {"steps": steps}
        assert pt.recorded_slice(run) == {"steps": steps}
        assert calls.pop() == ("pile 0", 102, steps) and not calls


def test_recorder_is_found_only_where_the_program_has_it(monkeypatch):
    assert pt.recorder().__name__ == "repro_torch.obs"
    real = pt.importlib.import_module

    def without(name):
        if name == "repro_torch.obs":
            raise ModuleNotFoundError(f"No module named {name!r}",
                                      name=name)
        return real(name)
    monkeypatch.setattr(pt.importlib, "import_module", without)
    assert pt.recorder() is None


@pytest.mark.parametrize("m", [m for m in SPEC["per_layer"]
                               if m["name"] in NEW],
                         ids=lambda m: m["name"])
def test_new_metrics_are_declared_beside_their_readers(m):
    mod = spec.metric_reader(m["name"])
    assert (mod.LAYER, mod.MOVES, mod.UNIT, mod.SOURCE) == (
        m["layer"], m["moves"], m["unit"], m["source"])
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert all(w in cells for w in m["workloads"])


def test_recorded_slice_on_a_cpu_solve():
    """The recording runs from the step span before the slice to the
    slice's end, the profile over the slice, then the solve is abandoned;
    spans come back on the trace's axis with their counts."""
    obs = pt.recorder()
    steps_run = []

    def solve(pile):
        for i in range(pile):
            with obs.span(spans.STEP_SPAN, profiler=True):
                steps_run.append(i)
            with obs.span(pt.BACKWARD, profiler=True):
                with obs.span(READ):
                    pass
                obs.count("sp_dag.backwards")
                obs.count("sp_dag.host_reads", 3)
        return []
    start = trace.A_STEPS + 2
    rec = pt.slice_of(solve, 40, start, obs, cuda=False)
    # steps 1..start + A_STEPS entered; the last one abandoned the pile
    assert len(steps_run) == start + trace.A_STEPS - 1
    assert rec["steps"] == trace.A_STEPS and rec["device"] == []
    assert rec["clock"] == obs.CLOCK and rec["base_ns"] > 0
    assert rec["untraced_s"] > 0 and rec["window_s"] > 0
    # steps 2 .. start - 2 untraced, at most UNTRACED_STEPS of them
    assert rec["untraced_steps"] == start - 3
    late = pt.slice_of(solve, 100, 70, obs, cuda=False,
                       steps=pt.RECORDED_STEPS)
    assert late["untraced_steps"] == pt.UNTRACED_STEPS == 60
    assert late["steps"] == 30
    assert [s[0] for s in late["spans"]].count(spans.STEP_SPAN) == 30
    # the backward of the step before the slice and each slice step's
    assert rec["counts"] == {"sp_dag.backwards": trace.A_STEPS + 1,
                             "sp_dag.host_reads": 3 * (trace.A_STEPS + 1)}
    assert pt.host_reads_per_step(rec) == 3.0
    names = [s[0] for s in rec["spans"]]
    assert names.count(spans.STEP_SPAN) == trace.A_STEPS
    assert names.count(READ) == trace.A_STEPS + 1
    assert all(s[1] == pt.BACKWARD for s in rec["spans"] if s[0] == READ)
    assert all(0 < s[3] <= s[4] for s in rec["spans"])
    assert pt.recorder()._rec is None
    with pytest.raises(RuntimeError, match="before its recorded slice"):
        pt.slice_of(solve, start + 3, start, obs, cuda=False)
    assert pt.recorder()._rec is None
