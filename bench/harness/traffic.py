"""The general traffic generator: a mix file (``bench/traffic/<mix>.json``)
names a pattern and its parameters, and this module turns (configuration,
mix, ``--seed``) into piles of switch-level (capacity, demand) arrays.

The built-in pattern is ``permutation``, a frozen copy of the port's
``core.traffic.random_permutation`` (server-level traffic aggregated to
switches, intra-switch flows dropped, drawn from numpy's generator in the
same order as the package).  A mix whose ``pattern`` is another name finds
it in ``bench/traffic/<pattern>.py``, whose ``demand(servers, seed, mix)``
returns the [N, N] switch-level demand.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "traffic"
WARM, WINDOW = 0, 1     # the streams of a run's seed: warm-up, window piles


def _aggregate(src_sw: np.ndarray, dst_sw: np.ndarray, n: int) -> np.ndarray:
    dem = np.zeros((n, n), dtype=np.float64)
    keep = src_sw != dst_sw
    np.add.at(dem, (src_sw[keep], dst_sw[keep]), 1.0)
    return dem


def random_permutation(servers: np.ndarray, seed) -> np.ndarray:
    """Every server sends to one other server and receives from one (a
    random derangement over servers)."""
    servers = np.asarray(servers, np.int64)
    n = len(servers)
    s = int(servers.sum())
    if s < 2:
        raise ValueError(f"a permutation needs >= 2 servers, got {s}")
    sw_of_server = np.repeat(np.arange(n), servers)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(s)
    for _ in range(100):
        fixed = np.flatnonzero(perm == np.arange(s))
        if len(fixed) == 0:
            break
        if len(fixed) == 1:
            j = (fixed[0] + 1) % s
            perm[fixed[0]], perm[j] = perm[j], perm[fixed[0]]
        else:
            perm[fixed] = perm[np.roll(fixed, 1)]
    if (perm == np.arange(s)).any():
        raise RuntimeError("no derangement after 100 passes")
    return _aggregate(sw_of_server, sw_of_server[perm], n)


@functools.cache
def _pattern(name: str):
    path = TRAFFIC / f"{name}.py"
    if not path.exists():
        raise ValueError(f"unknown traffic pattern {name!r}: neither "
                         f"'permutation' nor {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_traffic_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.demand


def make(mix: dict, servers: np.ndarray, seed) -> np.ndarray:
    """The switch-level demand of one instance of ``mix``."""
    servers = np.asarray(servers, np.int64)
    if mix["pattern"] == "permutation":
        return random_permutation(servers, seed)
    return _pattern(mix["pattern"])(servers, seed, mix)


@dataclasses.dataclass(frozen=True)
class Instance:
    """One request of a pile: switch-level capacity and demand, and where
    it was drawn."""

    cap: np.ndarray      # [N, N] float64, symmetric, zero diagonal
    dem: np.ndarray      # [N, N] float64 unit flows between switches
    key: tuple           # (stream, pile, position): distinct in a run


def make_pile(family, params: dict, mix: dict, seed: int, pile: int,
              stream: int = WINDOW) -> list[Instance]:
    """Pile ``pile`` of a run seeded ``seed`` (any whole number >= 0):
    ``mix["pile"]`` fresh instances, instance j's topology and traffic
    seeds drawn from (seed, stream, pile, j).  ``stream`` WARM gives the
    warm-up's, which the window never sends."""
    out = []
    for j in range(int(mix["pile"])):
        ts, ds = np.random.SeedSequence(
            [int(seed), stream, pile, j]).generate_state(2)
        cap, servers = family.build(params, int(ts))
        out.append(Instance(cap, make(mix, servers, int(ds)),
                            (stream, pile, j)))
    return out
