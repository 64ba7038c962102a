"""Reading ``BENCHMARK.json`` and finding each part of a cell by its name:

* a configuration ``<config>``: ``bench/configs/<config>.json`` (its
  ``family`` names ``bench/families/<family>.py``, the generator);
* a traffic mix ``<traffic>``: ``bench/traffic/<traffic>.json``;
* a per-layer metric ``<metric>``: ``bench/metrics/<metric>.py``;
* a cell ``<workload>``'s limits for ``correct``:
  ``bench/limits/<workload>.json``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from types import ModuleType

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict          # bench/configs/<config>.json
    mix: dict             # bench/traffic/<traffic>.json
    limits: dict          # bench/limits/<workload>.json
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    def family(self) -> ModuleType:
        return importlib.import_module(f"families.{self.config['family']}")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None,
         base: pathlib.Path = BENCH) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``), its files read from under ``base``."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(base / "configs" / f"{w['config']}.json"),
        mix=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str, base: pathlib.Path = BENCH) -> ModuleType:
    """The module of ``bench/metrics/<name>.py`` (names hold dots, so it is
    loaded from its path)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
