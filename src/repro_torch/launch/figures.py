"""The paper's Fig. 1–11 rows on the port (the counterpart of the
reference's ``benchmarks/fig1.py`` … ``fig11.py``).

One function per figure.  Each returns the reference figure script's row dicts,
with the same keys, and takes the script's sizes as keyword arguments:
left at None they take the script's ``scale="small"`` or ``"paper"``
values, so a caller can run a figure smaller.  Figures whose script takes
an engine take one here (a registry name or an engine instance); with a
bracket engine (``"certified"``) Fig. 5–7's rows carry the ``gap`` column
(the worst (ub − lb) / ub of the point's runs).  Fig. 8 and Fig. 9–10 run
the HiGHS oracle, as their scripts do.

Fig. 5 pools its three configurations into one ``run_sweeps`` call, so a
batching engine solves the whole figure through one ``BatchPlan`` (the
reference's script makes one plan per configuration; the rows are the
same).  Fig. 11 leaves out the script's ``designed_tors`` and
``designed_gain_pct`` columns: they come from the design layer's fleet
search, which the port does not have yet.

    python -m repro_torch.launch.figures --only fig5 --engine certified \\
        --scale paper [--tol 1e-4] [--device cpu]

prints one CSV block per figure and its wall seconds.  Planned engines run
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import csv
import inspect
import sys
import time

import numpy as np

from repro_torch.core import bounds, decompose, graphs, lp, traffic, vl2
from repro_torch.core import heterogeneous as het
from repro_torch.core.engine import as_engine, get_engine, run_sweeps

__all__ = ["FIGURES", "fig1", "fig2", "fig3", "fig4", "fig5", "fig6", "fig7",
           "fig8", "fig9_10", "fig11", "rows_to_csv", "bracket_cols",
           "main"]


def rows_to_csv(rows: list[dict], file=None) -> None:
    """Write rows as CSV (floats to 4 places), header from the first row."""
    if not rows:
        return
    w = csv.DictWriter(file or sys.stdout, fieldnames=list(rows[0]))
    w.writeheader()
    for r in rows:
        w.writerow({k: (f"{v:.4f}" if isinstance(v, float) else v)
                    for k, v in r.items()})


def bracket_cols(point) -> dict:
    """``{"gap": worst (ub − lb) / ub of the point's runs}`` on a bracket
    engine, ``{}`` otherwise."""
    return {} if point.gap_max is None else {"gap": point.gap_max}


def _by_scale(value, scale: str, small, paper):
    if value is not None:
        return value
    return small if scale == "small" else paper


def fig1(scale: str = "small", engine="exact", *, degrees=None,
         runs=None, n: int = 40) -> list[dict]:
    """RRG throughput and ASPL against the universal bounds, N fixed, the
    degree swept (permutation traffic at 5 and 10 servers a switch, and
    all-to-all)."""
    degrees = _by_scale(degrees, scale, [5, 10, 15, 20, 25],
                        [5, 10, 15, 20, 25, 30, 35])
    runs = _by_scale(runs, scale, 3, 10)
    eng = as_engine(engine)
    cases = [(r, label, srv) for r in degrees
             for label, srv in (("perm-5", 5), ("perm-10", 10), ("a2a", 2))]
    topos, dems = [], []
    for r, label, srv in cases:
        for rr in range(runs):
            topo = graphs.random_regular_graph(n, r, seed=100 * r + rr,
                                               servers=srv)
            pattern = "all_to_all" if label == "a2a" else "permutation"
            topos.append(topo)
            dems.append(traffic.make(pattern, topo.servers, seed=rr))
    results = eng.solve_batch(topos, dems)
    rows = []
    for ci, (r, label, srv) in enumerate(cases):
        sl = slice(ci * runs, (ci + 1) * runs)
        ths = [res.throughput for res in results[sl]]
        ds = [lp.aspl_hops(t, d) for t, d in zip(topos[sl], dems[sl])]
        nf = traffic.num_flows(dems[sl][-1])
        ub = bounds.throughput_upper_bound(n, r, nf)
        rows.append({
            "figure": "fig1", "traffic": label, "degree": r,
            "throughput": float(np.mean(ths)),
            "throughput_std": float(np.std(ths)),
            "upper_bound": ub,
            "frac_of_bound": float(np.mean(ths)) / ub,
            "aspl": float(np.mean(ds)),
            "aspl_lower": bounds.aspl_lower_bound(n, r),
        })
    return rows


def fig2(scale: str = "small", engine="exact", *, sizes=None,
         runs=None, r: int = 10) -> list[dict]:
    """RRG throughput and ASPL against the bounds, degree fixed, the size
    swept."""
    sizes = _by_scale(sizes, scale, [15, 20, 30, 40, 60],
                      [15, 20, 30, 40, 60, 80, 120, 160])
    runs = _by_scale(runs, scale, 3, 10)
    eng = as_engine(engine)
    topos, dems = [], []
    for n in sizes:
        for rr in range(runs):
            topo = graphs.random_regular_graph(n, r, seed=10_000 + n + rr,
                                               servers=5)
            topos.append(topo)
            dems.append(traffic.make("permutation", topo.servers, seed=rr))
    results = eng.solve_batch(topos, dems)
    rows = []
    for si, n in enumerate(sizes):
        sl = slice(si * runs, (si + 1) * runs)
        ths = [res.throughput for res in results[sl]]
        ds = [lp.aspl_hops(t, d) for t, d in zip(topos[sl], dems[sl])]
        nf = traffic.num_flows(dems[sl][-1])
        ub = bounds.throughput_upper_bound(n, r, nf)
        rows.append({
            "figure": "fig2", "size": n, "degree": r,
            "throughput": float(np.mean(ths)),
            "upper_bound": ub,
            "frac_of_bound": float(np.mean(ths)) / ub,
            "aspl": float(np.mean(ds)),
            "aspl_lower": bounds.aspl_lower_bound(n, r),
        })
    return rows


def _fig3_specs(scale: str) -> dict:
    if scale == "small":
        return {
            "a_3:1": het.TwoClassSpec(10, 18, 20, 6, 90),
            "a_2:1": het.TwoClassSpec(10, 18, 20, 9, 90),
            "b_more_small": het.TwoClassSpec(10, 18, 30, 6, 90),
            "c_oversub": het.TwoClassSpec(10, 18, 20, 6, 120),
        }
    return {
        "a_3:1": het.TwoClassSpec(20, 30, 40, 10, 300),
        "a_2:1": het.TwoClassSpec(20, 30, 40, 15, 300),
        "a_3:2": het.TwoClassSpec(20, 30, 40, 20, 300),
        "c_480": het.TwoClassSpec(20, 30, 30, 20, 480),
    }


def fig3(scale: str = "small", engine="exact", *, specs=None,
         xs=(0.4, 0.7, 1.0, 1.3, 1.6), runs=None) -> list[dict]:
    """Servers split over two switch classes: proportional (x = 1) is
    optimal."""
    specs = specs if specs is not None else _fig3_specs(scale)
    runs = _by_scale(runs, scale, 3, 10)
    rows = []
    for name, spec in specs.items():
        pts = het.server_distribution_sweep(spec, list(xs), runs=runs,
                                            seed0=7, engine=engine)
        peak_x = max(pts, key=lambda p: p.mean).x
        for p in pts:
            rows.append({"figure": "fig3", "config": name, "x": p.x,
                         "throughput": p.mean, "std": p.std,
                         "peak_x": peak_x})
    return rows


def fig4(scale: str = "small", engine="exact", *, n=None, servers=None,
         runs=None, betas=(0.0, 0.5, 0.8, 1.0, 1.2, 1.4, 2.0)) -> list[dict]:
    """Power-law port counts, servers attached in proportion to k^β."""
    n = _by_scale(n, scale, 24, 60)
    servers = _by_scale(servers, scale, 60, 200)
    runs = _by_scale(runs, scale, 3, 10)
    pts = het.power_law_beta_sweep(n=n, k_min=4, k_max=24, alpha=2.0,
                                   num_servers=servers, betas=list(betas),
                                   runs=runs, seed0=11, engine=engine)
    best = max(pts, key=lambda p: p.mean)
    return [{"figure": "fig4", "beta": p.x, "throughput": p.mean,
             "std": p.std, "best_beta": best.x} for p in pts]


def _fig5_specs(scale: str) -> dict:
    if scale == "small":
        return {
            "a_ports": het.TwoClassSpec(10, 18, 20, 6, 90),
            "b_counts": het.TwoClassSpec(10, 18, 30, 6, 90),
            "c_servers": het.TwoClassSpec(10, 18, 20, 6, 120),
        }
    return {
        "a_ports": het.TwoClassSpec(20, 30, 40, 10, 300),
        "b_counts": het.TwoClassSpec(20, 30, 20, 10, 300),
        "c_servers": het.TwoClassSpec(20, 30, 40, 10, 500),
    }


def fig5(scale: str = "small", engine="exact", *, specs=None,
         biases=(0.1, 0.3, 0.6, 1.0, 1.4, 1.8), runs=None) -> list[dict]:
    """Throughput against cross-cluster connectivity: a wide plateau at the
    peak.  Every configuration's (bias × run) instances go through one
    ``run_sweeps`` call."""
    specs = specs if specs is not None else _fig5_specs(scale)
    runs = _by_scale(runs, scale, 3, 10)
    items = [het.cross_cluster_sweep_item(spec, list(biases), runs=runs,
                                          seed0=3)
             for spec in specs.values()]
    rows = []
    for name, pts in zip(specs, run_sweeps(items, engine)):
        peak = max(p.mean for p in pts)
        for p in pts:
            rows.append({"figure": "fig5", "config": name, "bias": p.x,
                         "throughput": p.mean, "std": p.std,
                         "frac_of_peak": p.mean / peak, **bracket_cols(p)})
    return rows


def fig6(scale: str = "small", engine="exact", *,
         spec=het.TwoClassSpec(10, 18, 20, 6, 90),
         splits=((5, 2), (7, 1), (3, 3)), biases=(0.3, 0.7, 1.0, 1.5),
         runs=None) -> list[dict]:
    """Server split × cross-cluster grid: several configurations tie at
    the peak (one ``run_sweeps`` call)."""
    runs = _by_scale(runs, scale, 3, 10)
    splits = [s for s in splits
              if s[0] * spec.n_large + s[1] * spec.n_small
              == spec.num_servers]
    out = het.combined_sweep(spec, splits, list(biases), runs=runs, seed0=5,
                             engine=engine)
    peak = max(p.mean for pts in out.values() for p in pts)
    rows = []
    for (pl, ps), pts in out.items():
        for p in pts:
            rows.append({"figure": "fig6", "split": f"{pl}H,{ps}L",
                         "bias": p.x, "throughput": p.mean, "std": p.std,
                         "frac_of_peak": p.mean / peak, **bracket_cols(p)})
    return rows


def fig7(scale: str = "small", engine="exact", *,
         spec=het.TwoClassSpec(10, 18, 20, 6, 90, h_links=2, h_speed=4.0),
         biases=(0.2, 0.6, 1.0, 1.5), runs=None,
         splits=((5, 2), (7, 1), (3, 3)), h_speeds=(1.0, 4.0, 10.0),
         h_counts=(1, 3, 5)) -> list[dict]:
    """Two line speeds: (a) server splits, (b) the high-speed links' speed
    and (c) their count, against cross-cluster connectivity; all three
    panels through one ``run_sweeps`` call."""
    runs = _by_scale(runs, scale, 3, 10)
    biases = list(biases)
    items, labels = [], []
    for split in splits:
        if split[0] * spec.n_large + split[1] * spec.n_small \
                != spec.num_servers:
            continue
        items.append(het.cross_cluster_sweep_item(
            spec, biases, runs=runs, seed0=13,
            servers_on_large=split[0] * spec.n_large))
        labels.append(("fig7a", f"{split[0]}H,{split[1]}L"))
    keys, sub = het.line_speed_sweep_items(spec, biases,
                                           h_speeds=list(h_speeds),
                                           runs=runs, seed0=17)
    items.extend(sub)
    labels.extend(("fig7b", f"speed={k}") for k in keys)
    keys, sub = het.line_speed_sweep_items(spec, biases,
                                           h_counts=list(h_counts),
                                           runs=runs, seed0=19)
    items.extend(sub)
    labels.extend(("fig7c", f"hlinks={k}") for k in keys)
    rows = []
    for (figure, config), pts in zip(labels, run_sweeps(items, engine)):
        for p in pts:
            rows.append({"figure": figure, "config": config, "bias": p.x,
                         "throughput": p.mean, "std": p.std,
                         **bracket_cols(p)})
    return rows


def fig8(scale: str = "small", *,
         spec=het.TwoClassSpec(10, 18, 20, 6, 120),
         biases=(0.1, 0.3, 0.6, 1.0, 1.5), runs=None) -> list[dict]:
    """Throughput decomposed into C·U / (f·⟨D⟩·AS) along a cross-cluster
    sweep (HiGHS), each factor normalised to its value at the peak, and the
    utilisation of each link class."""
    runs = _by_scale(runs, scale, 3, 10)
    per_bias = []
    for bias in biases:
        decomps, utils = [], []
        for rr in range(runs):
            topo = het.build_two_class(
                spec, spec.proportional_large_servers, bias, seed=rr * 97)
            dem = traffic.random_permutation(topo.servers, seed=rr * 97 + 1)
            res = lp.max_concurrent_flow(topo, dem)
            decomps.append(decompose.decompose(topo, dem, res))
            utils.append(decompose.utilization_by_class(res, topo.labels))
        per_bias.append({
            "bias": bias,
            "throughput": np.mean([d.throughput for d in decomps]),
            "utilization": np.mean([d.utilization for d in decomps]),
            "inv_aspl": np.mean([1.0 / d.aspl for d in decomps]),
            "inv_stretch": np.mean([1.0 / d.stretch for d in decomps]),
            "util_cross": np.mean([u.get((0, 1), 0) for u in utils]),
            "util_small": np.mean([u.get((0, 0), 0) for u in utils]),
            "util_large": np.mean([u.get((1, 1), 0) for u in utils]),
        })
    peak = max(per_bias, key=lambda r: r["throughput"])
    return [{
        "figure": "fig8", "bias": r["bias"],
        "T_norm": r["throughput"] / peak["throughput"],
        "U_norm": r["utilization"] / peak["utilization"],
        "invD_norm": r["inv_aspl"] / peak["inv_aspl"],
        "invAS_norm": r["inv_stretch"] / peak["inv_stretch"],
        "util_cross": r["util_cross"], "util_small": r["util_small"],
        "util_large": r["util_large"],
    } for r in per_bias]


def fig9_10(scale: str = "small", *,
            biases=(0.1, 0.2, 0.4, 0.7, 1.0, 1.4), runs=None,
            specs=None) -> list[dict]:
    """The analytic heterogeneous bound (Eqn. 1) against the observed
    throughput (HiGHS) along a cross-cluster sweep, and the cut threshold
    C̄* below which throughput must drop (Eqn. 2)."""
    eng = get_engine("exact")
    runs = _by_scale(runs, scale, 3, 10)
    specs = specs if specs is not None else {
        "uniform": het.TwoClassSpec(10, 18, 20, 6, 90),
        "mixed": het.TwoClassSpec(10, 18, 20, 6, 90, h_links=2,
                                  h_speed=4.0),
    }
    rows = []
    for name, spec in specs.items():
        series = []
        for bias in biases:
            ths, ubs = [], []
            for rr in range(runs):
                topo = het.build_two_class(
                    spec, spec.proportional_large_servers, bias, 37 * rr)
                dem = traffic.random_permutation(topo.servers, 37 * rr + 5)
                th = eng.solve(topo, dem).throughput
                mask = topo.labels == 1
                cbar = topo.cut_capacity(mask)
                n1 = int(topo.servers[mask].sum())
                n2 = int(topo.servers[~mask].sum())
                ub = bounds.het_throughput_upper_bound(
                    topo.total_capacity, cbar, lp.aspl_hops(topo, dem),
                    n1, n2)
                ths.append(th)
                ubs.append(ub)
            series.append((bias, float(np.mean(ths)), float(np.mean(ubs)),
                           cbar))
        t_star = max(t for _, t, _, _ in series)
        cbar_star = bounds.cut_threshold(t_star, n1, n2)
        for bias, th, ub, cbar in series:
            rows.append({
                "figure": "fig9_10", "config": name, "bias": bias,
                "throughput": th, "eqn1_bound": ub,
                "bound_gap": ub / th if th else float("inf"),
                "cut_capacity": cbar, "cbar_star": cbar_star,
                "below_threshold": cbar < cbar_star,
                "t_star": t_star,
            })
    return rows


def fig11(scale: str = "small", engine="exact", *, sizes=None,
          runs=None) -> list[dict]:
    """VL2 rewired with the same equipment: ToRs supported at full
    throughput under random-permutation and 100% stride traffic (the
    recipe's columns; see the module docstring)."""
    sizes = _by_scale(sizes, scale, [(4, 4), (6, 6), (8, 8)],
                      [(4, 4), (6, 6), (8, 8), (10, 10)])
    runs = _by_scale(runs, scale, 2, 5)
    rows = []
    for d_a, d_i in sizes:
        spec = vl2.VL2Spec(d_a=d_a, d_i=d_i, servers_per_tor=20)
        base = spec.n_tor_full
        for tname, tfn in (
            ("permutation", None),
            ("stride100", lambda servers, seed: traffic.stride(
                servers, 1.0, seed)),
        ):
            best = vl2.max_tors_at_full_throughput(
                spec, vl2.rewired_vl2_topology, lo=base,
                hi=base + max(2, base // 2), runs=runs, seed0=2,
                engine=engine, traffic_fn=tfn)
            rows.append({
                "figure": "fig11", "d_a": d_a, "d_i": d_i,
                "traffic": tname,
                "vl2_tors": base, "rewired_tors": best,
                "gain_pct": 100.0 * (best - base) / base,
                "vl2_servers": base * spec.servers_per_tor,
                "rewired_servers": best * spec.servers_per_tor,
            })
    return rows


FIGURES = {"fig1": fig1, "fig2": fig2, "fig3": fig3, "fig4": fig4,
           "fig5": fig5, "fig6": fig6, "fig7": fig7, "fig8": fig8,
           "fig9_10": fig9_10, "fig11": fig11}


def main(argv=None) -> dict[str, list[dict]]:
    ap = argparse.ArgumentParser(
        description="The paper's Fig. 1-11 rows on the port.")
    ap.add_argument("--only", default=",".join(FIGURES),
                    help="comma-separated figures (default: all)")
    ap.add_argument("--engine", default="exact",
                    help="engine registry name, for the figures that take "
                         "one (fig8 and fig9_10 run HiGHS)")
    ap.add_argument("--scale", choices=("small", "paper"), default="small")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="early-stop tolerance of a planned engine")
    ap.add_argument("--device", default="cuda",
                    help="where a planned engine runs (cuda or cpu)")
    args = ap.parse_args(argv)
    names = [s for s in args.only.split(",") if s]
    unknown = sorted(set(names) - set(FIGURES))
    if unknown:
        ap.error(f"unknown figure(s) {unknown}; known: {list(FIGURES)}")
    kw = {} if args.engine == "exact" else {"device": args.device,
                                            "tol": args.tol}
    engine = get_engine(args.engine, **kw)
    out = {}
    for name in names:
        fn = FIGURES[name]
        fkw = ({"engine": engine}
               if "engine" in inspect.signature(fn).parameters else {})
        t0 = time.perf_counter()
        out[name] = fn(args.scale, **fkw)
        print(f"# {name}: {len(out[name])} rows, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows_to_csv(out[name])
    return out


if __name__ == "__main__":
    main()
