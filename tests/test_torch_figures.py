"""The port's Fig. 1–11 layer (``heterogeneous``, ``vl2``, ``fabric``,
``decompose`` and ``launch.figures``) against the reference.

The builders are numpy on both sides, so their arrays must be equal; the
sweeps on the exact engine run the same HiGHS LP on the same instances, so
their values agree within 1e-9; the figure functions must give the
reference figure scripts' row keys.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import (fig1 as r_fig1, fig2 as r_fig2, fig3 as r_fig3,  # noqa: E402
                        fig4 as r_fig4, fig5 as r_fig5, fig6 as r_fig6,
                        fig7 as r_fig7, fig8 as r_fig8, fig9_10 as r_fig9_10,
                        fig11 as r_fig11)
from repro.core import decompose as r_decompose  # noqa: E402
from repro.core import fabric as r_fabric  # noqa: E402
from repro.core import heterogeneous as r_het  # noqa: E402
from repro.core import lp as r_lp  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro.core import vl2 as r_vl2  # noqa: E402
from repro_torch.core import decompose as p_decompose  # noqa: E402
from repro_torch.core import engine as p_engine  # noqa: E402
from repro_torch.core import fabric as p_fabric  # noqa: E402
from repro_torch.core import heterogeneous as p_het  # noqa: E402
from repro_torch.core import vl2 as p_vl2  # noqa: E402
from repro_torch.launch import figures  # noqa: E402

_TOL = 1e-9
# a small two-class pool: 4 large switches of 8 ports, 6 small of 4, 16
# servers (9 proportionally on the large switches)
_SPEC = dict(n_large=4, k_large=8, n_small=6, k_small=4, num_servers=16)


def _arrays(topo):
    return (np.asarray(topo.cap), np.asarray(topo.servers),
            None if topo.labels is None else np.asarray(topo.labels))


def _same_topology(a, b):
    for x, y in zip(_arrays(a), _arrays(b)):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("bias,h_links", [(None, 0), (0.4, 0), (1.5, 2),
                                          (None, 3)])
def test_build_two_class_equals_reference(seed, bias, h_links):
    kw = dict(_SPEC, h_links=h_links, h_speed=4.0)
    r_spec, p_spec = r_het.TwoClassSpec(**kw), p_het.TwoClassSpec(**kw)
    for on_large in (r_spec.proportional_large_servers, 12, 14):
        _same_topology(r_het.build_two_class(r_spec, on_large, bias, seed),
                       p_het.build_two_class(p_spec, on_large, bias, seed))
    a = r_het.build_two_class(r_spec, 9, bias, seed, server_nodes=True)
    b = p_het.build_two_class(p_spec, 9, bias, seed, server_nodes=True)
    _same_topology(a, b)
    assert np.array_equal(a.server_nodes, b.server_nodes)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_vl2_and_fabric_builders_equal_reference(seed):
    for d_a, d_i in ((4, 4), (6, 6), (8, 4)):
        r_spec = r_vl2.VL2Spec(d_a=d_a, d_i=d_i, servers_per_tor=20)
        p_spec = p_vl2.VL2Spec(d_a=d_a, d_i=d_i, servers_per_tor=20)
        _same_topology(r_vl2.vl2_topology(r_spec), p_vl2.vl2_topology(p_spec))
        n_tor = r_spec.n_tor_full + 2
        _same_topology(r_vl2.rewired_vl2_topology(r_spec, n_tor, seed),
                       p_vl2.rewired_vl2_topology(p_spec, n_tor, seed))
    ports = [12, 12, 8, 8, 8, 6, 6, 6, 4, 4]
    for prop in (True, False):
        a = r_fabric.design_fabric(ports, 6, nics_per_pod=2, seed=seed,
                                   proportional=prop)
        b = p_fabric.design_fabric(ports, 6, nics_per_pod=2, seed=seed,
                                   proportional=prop)
        _same_topology(a.topology, b.topology)
        assert np.array_equal(a.pod_switch, b.pod_switch)
        for pattern in ("ring", "alltoall", "allgather"):
            assert np.array_equal(
                r_fabric._pod_demand_to_switch(
                    a, r_fabric.collective_demand(6, pattern)),
                p_fabric._pod_demand_to_switch(
                    b, p_fabric.collective_demand(6, pattern)))


def test_decompose_and_fabric_bandwidth_equal_reference():
    spec = r_het.TwoClassSpec(**_SPEC)
    for bias in (0.3, 1.0):
        topo = r_het.build_two_class(spec, 9, bias, seed=2)
        dem = r_traffic.random_permutation(topo.servers, seed=3)
        a = r_decompose.decompose(topo, dem)
        b = p_decompose.decompose(topo, dem)
        for f in dataclasses.fields(a):
            assert getattr(b, f.name) == pytest.approx(getattr(a, f.name),
                                                       rel=_TOL)
        assert b.reconstructed == pytest.approx(b.throughput, rel=1e-6)
        res = r_lp.max_concurrent_flow(topo, dem)
        ua = r_decompose.utilization_by_class(res, topo.labels)
        ub = p_decompose.utilization_by_class(res, topo.labels)
        assert ua.keys() == ub.keys()
        for k in ua:
            assert ub[k] == pytest.approx(ua[k], rel=_TOL)
    ports = [12, 12, 8, 8, 8, 6, 6, 6, 4, 4]
    a = r_fabric.compare_with_traditional(ports, 6, runs=2, engine="exact")
    b = p_fabric.compare_with_traditional(ports, 6, runs=2, engine="exact")
    assert b == pytest.approx(a, rel=_TOL)


def _same_points(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert y.x == x.x
        assert y.mean == pytest.approx(x.mean, rel=_TOL)
        assert y.std == pytest.approx(x.std, rel=_TOL, abs=_TOL)
        assert y.values == pytest.approx(x.values, rel=_TOL)
        assert y.lb_mean is x.lb_mean is None


def test_fig3_to_fig7_sweeps_equal_reference_on_exact():
    r_spec, p_spec = r_het.TwoClassSpec(**_SPEC), p_het.TwoClassSpec(**_SPEC)
    _same_points(
        r_het.server_distribution_sweep(r_spec, [1.0, 1.3], runs=2, seed0=7),
        p_het.server_distribution_sweep(p_spec, [1.0, 1.3], runs=2, seed0=7))
    kw = dict(n=12, k_min=3, k_max=8, alpha=2.0, num_servers=20,
              betas=[0.5, 1.0], runs=2, seed0=11)
    _same_points(r_het.power_law_beta_sweep(**kw),
                 p_het.power_law_beta_sweep(**kw))
    _same_points(r_het.cross_cluster_sweep(r_spec, [0.4, 1.2], runs=2),
                 p_het.cross_cluster_sweep(p_spec, [0.4, 1.2], runs=2))
    splits = [(2, 1), (1, 2)]     # 4*2 + 6*1 != 16: rejected by both
    for het in (r_het, p_het):
        with pytest.raises(ValueError, match="servers"):
            het.combined_sweep(het.TwoClassSpec(**_SPEC), splits, [1.0])
    splits = [(1, 2), (4, 0)]
    a = r_het.combined_sweep(r_spec, splits, [0.5, 1.0], runs=1)
    b = p_het.combined_sweep(p_spec, splits, [0.5, 1.0], runs=1)
    assert a.keys() == b.keys()
    for k in a:
        _same_points(a[k], b[k])
    hs = dataclasses.replace(r_spec, h_links=2, h_speed=4.0)
    hp = dataclasses.replace(p_spec, h_links=2, h_speed=4.0)
    a = r_het.line_speed_sweep(hs, [1.0], h_speeds=[2.0], h_counts=[1],
                               runs=1)
    b = p_het.line_speed_sweep(hp, [1.0], h_speeds=[2.0], h_counts=[1],
                               runs=1)
    assert list(a) == list(b) == [2.0, 1]
    for k in a:
        _same_points(a[k], b[k])


def test_max_tors_at_full_throughput_equals_reference():
    r_spec = r_vl2.VL2Spec(d_a=4, d_i=4, servers_per_tor=20)
    p_spec = p_vl2.VL2Spec(d_a=4, d_i=4, servers_per_tor=20)
    for r_build, p_build in ((r_vl2.rewired_vl2_topology,
                              p_vl2.rewired_vl2_topology),
                             (lambda s, n, seed: r_vl2.vl2_topology(s, n),
                              lambda s, n, seed: p_vl2.vl2_topology(s, n))):
        a = r_vl2.max_tors_at_full_throughput(r_spec, r_build, lo=4, hi=6,
                                              runs=2, seed0=2)
        b = p_vl2.max_tors_at_full_throughput(p_spec, p_build, lo=4, hi=6,
                                              runs=2, seed0=2)
        assert a == b >= 4


def _script_row_keys(module) -> list[str]:
    """The keys of the row dict a reference figure script emits, in order, read
    from its source: the dict literal that sets "figure", with the
    ``**bracket_cols(p)`` spread as its "gap" column."""
    import ast
    import inspect
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "figure"
                for k in node.keys):
            return [k.value if k is not None else "gap" for k in node.keys]
    raise AssertionError(f"{module.__name__}: no row dict")


def test_figure_functions_give_the_reference_row_keys():
    """Each port figure at a reduced size, on a real engine (the certified
    engine for Fig. 5-7, so their bracket column is there), gives the
    reference figure script's row keys (Fig. 11 without the design layer's
    ``designed_*`` columns)."""
    assert _script_row_keys(r_fig5)[-1] == "gap"
    spec = p_het.TwoClassSpec(**_SPEC)
    cert = p_engine.get_engine("certified", iters=40, device="cpu")
    port = {
        "fig1": figures.fig1(degrees=[4], runs=1, n=12),
        "fig2": figures.fig2(sizes=[12], runs=1, r=4),
        "fig3": figures.fig3(specs={"t": spec}, xs=(1.0,), runs=1),
        "fig4": figures.fig4(runs=1, betas=(1.0,)),
        "fig5": figures.fig5(specs={"t": spec}, biases=(1.0,), runs=2,
                             engine=cert),
        "fig6": figures.fig6(spec=spec, splits=((1, 2),), biases=(1.0,),
                             runs=1, engine=cert),
        "fig7": figures.fig7(spec=dataclasses.replace(spec, h_links=2),
                             splits=((1, 2),), biases=(1.0,), runs=1,
                             h_speeds=(2.0,), h_counts=(1,), engine=cert),
        "fig8": figures.fig8(spec=spec, biases=(1.0,), runs=1),
        "fig9_10": figures.fig9_10(biases=(1.0,), runs=1,
                                   specs={"uniform": spec}),
        "fig11": figures.fig11(sizes=[(4, 4)], runs=1),
    }
    scripts = {"fig1": r_fig1, "fig2": r_fig2, "fig3": r_fig3,
               "fig4": r_fig4, "fig5": r_fig5, "fig6": r_fig6,
               "fig7": r_fig7, "fig8": r_fig8, "fig9_10": r_fig9_10,
               "fig11": r_fig11}
    assert list(port) == list(figures.FIGURES) == list(scripts)
    designed = {"designed_tors", "designed_gain_pct"}
    assert designed <= set(_script_row_keys(r_fig11))
    for name, rows in port.items():
        want = [k for k in _script_row_keys(scripts[name])
                if k not in designed]
        assert rows and all(list(r) == want for r in rows), name
        assert all(r["figure"].startswith(name[:4]) for r in rows)
    for row in port["fig5"] + port["fig6"] + port["fig7"]:
        assert 0 <= row["gap"] < 1
    assert [r["traffic"] for r in port["fig11"]] == ["permutation",
                                                     "stride100"]


def test_figures_command_line(monkeypatch, capsys):
    """``--only`` / ``--engine`` / ``--scale`` / ``--tol`` / ``--device``
    reach the figure functions (stand-ins here: every real figure solves
    dozens of LPs at its smallest scale)."""
    calls = []

    def fake(scale="small", engine="exact"):
        calls.append((scale, engine))
        return [{"figure": "fig5", "bias": 1.0, "gap": 0.5}]

    monkeypatch.setitem(figures.FIGURES, "fig5", fake)
    monkeypatch.setitem(figures.FIGURES, "fig8",
                        lambda scale="small": [{"figure": "fig8"}])
    out = figures.main(["--only", "fig5,fig8", "--engine", "certified",
                        "--scale", "paper", "--tol", "1e-4",
                        "--device", "cpu"])
    assert list(out) == ["fig5", "fig8"]
    [(scale, eng)] = calls
    assert scale == "paper" and isinstance(eng, p_engine.CertifiedEngine)
    assert eng.tol == 1e-4 and eng.device == "cpu"
    text = capsys.readouterr().out
    assert "# fig5: 1 rows" in text and "figure,bias,gap" in text
    assert "fig5,1.0000,0.5000" in text
    with pytest.raises(SystemExit):
        figures.main(["--only", "fig12"])
