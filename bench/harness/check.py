"""Deciding ``correct``: what the window returned, held against the plain
reference (``reference.py``) worked out again from the same inputs.

Every answer of the window's whole piles is checked for being a bound at
all (finite, positive, lb <= ub) and, where the configuration states
Theorem 1, for lying under it.  A sample of answers drawn from the seed
(the one that ran the most steps among them) is solved again by the
reference in float64 for as many steps as the program ran it: the widest
relative gap of the ub to the reference's is held against the cell's limit
in ``bench/limits/<workload>.json``, and so is what the engine's stopping
rule reads, on the reference's trajectory, at the step where the program
stopped each lane (``stop_gain``: a lane stopped early reads a large gain).
A bracket's lb may not lie above the reference's ub (``lb_over_ub_ref``),
nor fall short of the reference's lb after as many steps by more than its
limit (``lb_shortfall``: one-sided, since float32 rounding moves the
Frank-Wolfe trajectory either way, while a weaker line search or a lower
precision lowers the lb).  Of these sampled numbers a cell compares those
its limits file names.
"""
from __future__ import annotations

import gc

import numpy as np

from harness import reference


def sample(seed: int, answers: list, size: int,
           keys: list | None = None) -> list[int]:
    """Indices of ``size`` answers drawn from ``seed``, always with the one
    that ran the most descent steps, and no two with the same ``keys``
    entry (an instance the window solved twice is checked once)."""
    keys = list(range(len(answers))) if keys is None else keys
    longest = int(np.argmax([a.iterations for a in answers]))
    rng = np.random.default_rng([int(seed), 0x5A17])
    out, seen = [longest], {keys[longest]}
    for i in rng.permutation(len(answers)):
        if len(out) >= size:
            break
        if keys[i] not in seen:
            out.append(int(i))
            seen.add(keys[i])
    return sorted(out)


def judge(cell, instances: list, answers: list, seed: int,
          device: str = "cuda") -> tuple[dict, int]:
    """(numbers compared, each {"value", "limit"}; answers judged wrong)."""
    limits = cell.limits
    kind = "primal" if cell.mix["answers"] == "bracket" else "dual"
    ub = np.array([a.ub for a in answers])
    ok = np.isfinite(ub) & (ub > 0)
    if kind == "primal":
        lb = np.array([a.lb for a in answers])
        ok &= np.isfinite(lb) & (lb > 0) & (lb <= ub)
    numbers = {"bad_answers": float((~ok).sum())}
    wrong = ~ok
    family = cell.family()
    if cell.config.get("theorem1") and hasattr(family, "theorem1"):
        thm = np.array([family.theorem1(cell.config["params"], i.dem.sum())
                        for i in instances])
        over = ub / thm - 1.0
        numbers["thm1_excess"] = float(over.max())
        wrong |= over > limits["thm1_excess"]
    picked = sample(seed, answers, int(cell.mix["sample"]),
                    [i.key for i in instances])
    by_n: dict[int, list[int]] = {}
    for i in picked:
        by_n.setdefault(instances[i].cap.shape[0], []).append(i)
    ref = {}
    for idx in by_n.values():
        r = reference.solve(kind, [instances[i].cap for i in idx],
                            [instances[i].dem for i in idx],
                            steps=[answers[i].iterations for i in idx],
                            device=device, **cell.mix.get("engine_kw", {}))
        for j, i in enumerate(idx):
            ref[i] = {k: float(v[j]) for k, v in r.items()}
        gc.collect()
    at = {k: np.array([ref[i][k] for i in picked])
          for k in ref[picked[0]]}
    got = {"ub": np.array([answers[i].ub for i in picked])}
    # the program's answer against the reference's after as many steps,
    # and what the stopping rule read where the program stopped
    errs = {"ub_rel_err": np.abs(got["ub"] / at["ub_at"] - 1.0),
            "stop_gain": np.nan_to_num(at["stop_gain"], nan=0.0)}
    if kind == "primal":
        # a lower bound above the reference's certified upper bound is
        # wrong; one below the reference's lb after as many steps is held
        # one-sided
        got["lb"] = np.array([answers[i].lb for i in picked])
        errs["lb_over_ub_ref"] = got["lb"] / at["ub_at"] - 1.0
        errs["lb_shortfall"] = 1.0 - got["lb"] / at["lb_at"]
    for name, e in errs.items():
        if name not in limits:
            continue        # a number this cell does not compare
        e = np.where(np.isnan(e), np.inf, e)
        numbers[name] = float(e.max())
        wrong[np.array(picked)[e > limits[name]]] = True
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)} in "
                       f"bench/limits/{cell.name}.json")
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in numbers.items()}
    return checks, int(wrong.sum())


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
