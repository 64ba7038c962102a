"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one.  The file imports neither jax nor ``repro``, so it runs where
only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import apsp as p_apsp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ell as p_ell  # noqa: E402
from repro_torch.kernels import fw as p_fw  # noqa: E402
from repro_torch.kernels import flash_attention as p_flash  # noqa: E402
from repro_torch.kernels import minplus as p_minplus  # noqa: E402
from repro_torch.kernels import wkv as p_wkv  # noqa: E402

_INF = 1.0e18


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    # the plain versions' float32 products run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _w(n, seed, p=0.35):
    """Quantized random lengths with _INF non-edges, zero diagonal."""
    rng = np.random.default_rng(seed)
    w = np.round(rng.uniform(0.5, 8.0, (n, n)) * 8.0) / 8.0
    w = np.where(rng.random((n, n)) < p, w, _INF).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    return w


def _lanes(n, lanes, p=0.35):
    return torch.from_numpy(np.stack([_w(n, s, p) for s in range(lanes)]))


@pytest.mark.cuda
def test_cuda_minplus_acc_matches_plain(cuda):
    w = _lanes(200, 3).to(cuda)
    before = _build.LAUNCHES["minplus_acc"]
    for a, b, c0 in ((w, w, w), (w, w, None),
                     (w[:, :, :72], w[:, :72, :], w)):
        got = p_minplus.minplus_acc(a, b, c0)
        assert torch.equal(got, p_minplus.minplus_acc_plain(a, b, c0))
    assert _build.LAUNCHES["minplus_acc"] == before + 3


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("tile", p_minplus.TILES)
@pytest.mark.parametrize("m,n,k", [
    (1, 1, 1), (127, 129, 200), (129, 127, 513), (200, 513, 127),
    (513, 200, 129), (128, 512, 128),
])
def test_cuda_minplus_acc_each_tile_is_exact(cuda, tile, m, n, k):
    """Both builds of K1 (a batch with more blocks than SMs takes the
    first, a small one the second) on ragged m, n and k (scalar and float4
    loads, sentinel edges), with and without C0: bit-equal to the plain
    version, one launch counted per call."""
    per_lane = -(-m // 128) * -(-n // 128)
    bsz = _sms(cuda) // per_lane + 1 if tile == p_minplus.TILES[0] else 2
    assert p_minplus.minplus_tile(bsz, m, n, _sms(cuda)) == tile
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    a = torch.from_numpy(np.round(rng.uniform(0.5, 8.0, (bsz, m, k)) * 8)
                         .astype(np.float32) / 8).to(cuda)
    b = torch.from_numpy(np.round(rng.uniform(0.5, 8.0, (bsz, k, n)) * 8)
                         .astype(np.float32) / 8).to(cuda)
    c0 = torch.from_numpy(rng.uniform(0.0, 12.0, (bsz, m, n))
                          .astype(np.float32)).to(cuda)
    for c in (c0, None):
        before = _build.LAUNCHES["minplus_acc"]
        got = p_minplus.minplus_acc(a, b, c)
        assert _build.LAUNCHES["minplus_acc"] == before + 1
        assert torch.equal(got, p_minplus.minplus_acc_plain(a, b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", p_minplus.TILES)
def test_cuda_minplus_acc_fw_panels_and_aliasing(cuda, tile):
    """The three Floyd-Warshall panel products on strided views of one
    [lanes, 384, 384] matrix, and ``out`` aliasing ``c0`` in place, with
    enough lanes for each build of K1: bit-equal to the plain version."""
    lanes = _sms(cuda) // 3 + 1 if tile == p_minplus.TILES[0] else 3
    w = _lanes(384, lanes, p=0.1).to(cuda)
    piv = w[:, 128:256, 128:256].clone()
    row, col = w[:, 128:256, :], w[:, :, 128:256]
    for a, b, c0 in ((piv, row, row), (col, piv, col), (col, row, w)):
        assert p_minplus.minplus_tile(lanes, a.shape[1], b.shape[2],
                                      _sms(cuda)) == tile
        before = _build.LAUNCHES["minplus_acc"]
        got = p_minplus.minplus_acc(a, b, c0)
        assert _build.LAUNCHES["minplus_acc"] == before + 1
        assert torch.equal(got, p_minplus.minplus_acc_plain(a, b, c0))
    d = w.clone()
    want = p_minplus.minplus_acc_plain(col.clone(), row.clone(), d)
    out = p_minplus.minplus_acc(col.clone(), row.clone(), d, out=d)
    assert out.data_ptr() == d.data_ptr() and torch.equal(d, want)
    # a strided out view of a wider buffer: rows outside stay untouched
    buf = w.clone()
    view = buf[:, 128:256, :]
    p_minplus.minplus_acc(piv, w[:, 128:256, :], view, out=view)
    assert torch.equal(view, p_minplus.minplus_acc_plain(
        piv, w[:, 128:256, :], w[:, 128:256, :]))
    assert torch.equal(buf[:, :128], w[:, :128])
    assert torch.equal(buf[:, 256:], w[:, 256:])


def test_minplus_tile_by_shape():
    """The instantiation the wrapper picks at the main path's shapes on 132
    SMs: 2 blocks an SM for the 320-block square and outer products, 1 for
    the 80-block panels."""
    two, one = p_minplus.TILES
    assert p_minplus.minplus_tile(20, 512, 512, 132) == two
    assert p_minplus.minplus_tile(20, 128, 512, 132) == one
    assert p_minplus.minplus_tile(20, 512, 128, 132) == one
    assert p_minplus.minplus_tile(20, 200, 200, 132) == one
    assert p_minplus.minplus_tile(33, 256, 256, 132) == one
    assert p_minplus.minplus_tile(34, 256, 256, 132) == two


@pytest.mark.cuda
def test_cuda_fw_pivot_and_blocked_fw_match_plain(cuda):
    w = _lanes(256, 2, p=0.05).to(cuda)
    tile = w[:, :128, :128].clone()
    assert torch.equal(p_fw.fw_pivot(tile.clone()),
                       p_fw.fw_tile_closure(tile))
    assert torch.equal(p_fw.fw_apsp_blocked(w), p_fw.fw_apsp_plain(w))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 100, 128])
def test_cuda_fw_pivot_each_tile_size_is_exact(cuda, t):
    """K2 at blocked Floyd-Warshall's t = 128 and at smaller tiles (masked
    micro-tiles), on a contiguous batch and in place in a strided view that
    starts off the diagonal and off a 16-byte boundary of a wider matrix:
    bit-equal to ``fw_tile_closure``, the rest of the matrix untouched, one
    launch a call."""
    w = _lanes(t + 37, 3, p=0.1).to(cuda)
    before = _build.LAUNCHES["fw_pivot"]
    tiles = w[:, :t, :t].clone()
    assert torch.equal(p_fw.fw_pivot(tiles.clone()),
                       p_fw.fw_tile_closure(tiles))
    d = w.clone()
    p_fw.fw_pivot(d[:, 5:5 + t, 9:9 + t])
    assert torch.equal(d[:, 5:5 + t, 9:9 + t],
                       p_fw.fw_tile_closure(w[:, 5:5 + t, 9:9 + t]))
    d[:, 5:5 + t, 9:9 + t] = w[:, 5:5 + t, 9:9 + t]
    assert torch.equal(d, w)
    assert _build.LAUNCHES["fw_pivot"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("t", [129, 200, 256])
def test_cuda_fw_pivot_closes_tiles_over_128(cuda, t):
    """Tiles wider than K2's 128 are padded to 256 with the non-edge
    sentinel and closed blocked (2 K2 + 6 K1 launches), in place in a
    strided view too: bit-equal to plain Floyd-Warshall; and
    ``fw_apsp_blocked(w, t=256)`` closes N = 512 like ``t=128``."""
    w = _lanes(t + 21, 2, p=0.05).to(cuda)
    tiles = w[:, :t, :t].clone()
    _build.reset_launches()
    got = p_fw.fw_pivot(tiles.clone())
    assert _build.LAUNCHES["fw_pivot"] == 2
    assert _build.LAUNCHES["minplus_acc"] == 6
    assert torch.equal(got, p_fw.fw_apsp_plain(tiles))
    d = w.clone()
    p_fw.fw_pivot(d[:, 7:7 + t, 13:13 + t])
    assert torch.equal(d[:, 7:7 + t, 13:13 + t],
                       p_fw.fw_apsp_plain(w[:, 7:7 + t, 13:13 + t]))
    d[:, 7:7 + t, 13:13 + t] = w[:, 7:7 + t, 13:13 + t]
    assert torch.equal(d, w)
    big = _lanes(512, 2, p=0.02).to(cuda)
    assert torch.equal(p_fw.fw_apsp_blocked(big, t=256),
                       p_fw.fw_apsp_plain(big))


@pytest.mark.parametrize("t", [129, 200, 256])
def test_wide_tile_closure_pads_and_blocks(t):
    """The wide-tile route's padding and blocking on the CPU (plain K1/K2
    versions): bit-equal to plain Floyd-Warshall."""
    w = _lanes(t, 2, p=0.05)
    assert torch.equal(p_fw._close_wide(w), p_fw.fw_apsp_plain(w))


@pytest.mark.cuda
def test_cuda_blocked_fw_counts_each_panel(cuda):
    w = _lanes(384, 2, p=0.05).to(cuda)
    _build.reset_launches()
    p_fw.fw_apsp_blocked(w)
    nb = 384 // p_fw.FW_TILE
    assert _build.LAUNCHES["fw_pivot"] == nb
    assert _build.LAUNCHES["minplus_acc"] == 3 * nb
    assert dict(_build.SITE_LAUNCHES) == {
        "minplus_acc/fw-row": nb, "minplus_acc/fw-col": nb,
        "minplus_acc/fw-outer": nb}
    # the pivot closes a strided view in place and leaves the rest alone
    d = w.clone()
    p_fw.fw_pivot(d[:, 128:256, 128:256])
    assert torch.equal(d[:, 128:256, 128:256],
                       p_fw.fw_tile_closure(w[:, 128:256, 128:256]))
    d[:, 128:256, 128:256] = w[:, 128:256, 128:256]
    assert torch.equal(d, w)


@pytest.mark.cuda
def test_cuda_ell_round_matches_plain(cuda):
    w = _lanes(300, 2, p=0.05).to(cuda)
    d_max = int(((w < _INF / 2).sum(dim=1) - 1).max())
    idx, wgt = p_apsp._pack_ell(w, d_max)
    m = p_ell._full_init(idx, wgt)
    got = p_ell.ell_relax_round(m, idx, wgt)
    want = p_ell.ell_relax_round_plain(m, idx, wgt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _build.reset_launches()
    d, rounds = p_ell.ell_bf_apsp(idx, wgt)
    assert _build.SITE_LAUNCHES["ell_relax_round/route:slab"] == rounds
    assert torch.equal(d.contiguous(), p_fw.fw_apsp_plain(w))


def test_ell_route_by_shape():
    """K3's route: ``slab`` while the [N, 32] carry slab and the table
    stages (3 KB) fit a block's 227 KB of shared memory, i.e. N <= 1,792,
    and rows have at most 64 slots, else ``l2``."""
    assert p_ell.ell_route(512, 16) == "slab"     # the main path
    assert p_ell.ell_route(1024, 16) == "slab"
    assert p_ell.ell_route(1792, 16) == "slab"
    assert p_ell.ell_route(1793, 16) == "l2"
    assert p_ell.ell_route(2048, 16) == "l2"
    for d in (1, 16, 32):
        assert p_ell.ell_route(300, d) == "slab"
        assert p_ell.ell_route(1800, d) == "l2"
    assert p_ell.ell_route(512, 64) == "slab"
    assert p_ell.ell_route(512, 65) == "l2"


def _ell_tables(bsz, n, s, d, seed, device):
    """Random ELL tables (10% of slots padded with _INF) and a carry of
    quantized lengths with 30% _INF, [bsz, n, s]."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (bsz, n, d)).astype(np.int32)
    wgt = (np.round(rng.uniform(0.5, 8.0, (bsz, n, d)) * 8) / 8).astype(
        np.float32)
    wgt[rng.random((bsz, n, d)) < 0.1] = _INF
    m = (np.round(rng.uniform(0.0, 40.0, (bsz, n, s)) * 8) / 8).astype(
        np.float32)
    m[rng.random((bsz, n, s)) < 0.3] = _INF
    return tuple(torch.from_numpy(x).to(device) for x in (m, idx, wgt))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 16, 32])
@pytest.mark.parametrize("route,n,s", [
    ("slab", 300, 77),    # S ragged and not a multiple of 4: 4-byte copies
    ("slab", 37, 300),    # N ragged against the 8-target tile
    ("slab", 512, 512),   # the main path's shape
    ("slab", 1792, 40),   # the largest slab
    ("l2", 1800, 77),
    ("l2", 1800, 45),
])
def test_cuda_ell_round_each_route_is_exact(cuda, route, n, s, d):
    """K3 on each route, at ragged N and S and d_max 1, 16 and 32: the new
    carry and every (8 targets x 32 sources) flag equal the plain
    version's, one launch counted on the route."""
    assert p_ell.ell_route(n, d) == route
    m, idx, wgt = _ell_tables(2, n, s, d, n + s + d, cuda)
    key = f"ell_relax_round/route:{route}"
    before = _build.SITE_LAUNCHES[key]
    got_m, got_f = p_ell.ell_relax_round(m, idx, wgt)
    assert _build.SITE_LAUNCHES[key] == before + 1
    want_m, want_f = p_ell.ell_relax_round_plain(m, idx, wgt)
    assert got_f.shape == (2, -(-n // 8), -(-s // 32))
    assert torch.equal(got_m, want_m) and torch.equal(got_f, want_f)


@pytest.mark.cuda
def test_cuda_ell_bf_closure_on_route_l2(cuda):
    """At N = 1800 every Jacobi round takes route l2 and the closure equals
    plain Floyd-Warshall (route slab: ``test_cuda_ell_round_matches_plain``)."""
    w = _lanes(1800, 1, p=0.006).to(cuda)
    d_max = int(((w < _INF / 2).sum(dim=1) - 1).max())
    assert p_ell.ell_route(1800, d_max) == "l2"
    idx, wgt = p_apsp._pack_ell(w, d_max)
    _build.reset_launches()
    d, rounds = p_ell.ell_bf_apsp(idx, wgt)
    assert _build.SITE_LAUNCHES["ell_relax_round/route:l2"] == rounds
    assert _build.LAUNCHES["ell_relax_round"] == rounds
    assert torch.equal(d.contiguous(), p_fw.fw_apsp_plain(w))


@pytest.mark.cuda
@pytest.mark.parametrize("n,route,block", [(2048, "l2", 1024),
                                           (512, "slab", 128)])
def test_cuda_streamed_ell_closure_equals_full(cuda, n, route, block):
    """Source blocks streamed through K3 give the full closure's bits and
    rounds, on each route; every launch is counted on the route."""
    w = _lanes(n, 1, p=12.0 / n).to(cuda)
    d_max = int(((w < _INF / 2).sum(dim=1) - 1).max())
    assert p_ell.ell_route(n, d_max) == route
    idx, wgt = p_apsp._pack_ell(w, d_max)
    full, rounds = p_ell.ell_bf_apsp(idx, wgt)
    _build.reset_launches()
    got, got_rounds = p_ell.ell_bf_apsp_streamed(idx[0], wgt[0],
                                                 block=block)
    launches = _build.LAUNCHES["ell_relax_round"]
    assert launches >= n // block * 2
    assert _build.SITE_LAUNCHES[f"ell_relax_round/route:{route}"] == launches
    assert got_rounds == rounds
    assert np.array_equal(got, full[0].cpu().numpy())


@pytest.mark.cuda
def test_cuda_dual_demgrad_matches_cpu(cuda):
    """The demand-gradient solve on the card (K1 squaring) against the same
    solve on the CPU.  Before any step the lengths are 1 and the gradient
    is −hops/α on both, equal but for α's sum order.  After a descent the
    bounds agree within rel 1e-3, but the lengths do not: Adam's float32
    exp, sqrt and sums round differently on the two devices, and on edges
    whose gradient is near 0 Adam's normalised step follows the sign of
    that rounding, so lengths the bound does not pin (the dual optimum is
    not unique) wander apart, and the distances through them with them.
    There each device's gradient is held to its own identity, Σ dem·g =
    −α/α = −1."""
    from repro_torch.core import graphs, mcf, traffic
    caps = np.zeros((3, 40, 40), np.float32)
    dems = np.zeros((3, 40, 40), np.float32)
    nv = np.array([24, 32, 40], np.int32)
    for s, n in enumerate(nv):
        t = graphs.random_regular_graph(int(n), 4, seed=s, servers=3)
        caps[s, :n, :n] = t.cap
        dems[s, :n, :n] = traffic.make("permutation", t.servers, seed=s + 1)
    for iters in (0, 60):
        kw = dict(n_valid=nv, iters=iters, backend="squaring")
        _build.reset_launches()
        card = mcf.solve_dual_demgrad_batch(caps, dems, **kw)
        assert _build.LAUNCHES["minplus_acc"] > 0
        cpu = mcf.solve_dual_demgrad_batch(caps, dems, device="cpu", **kw)
        np.testing.assert_allclose(card.throughput_ub, cpu.throughput_ub,
                                   rtol=1e-3)
        np.testing.assert_allclose(card.final_ratio, cpu.final_ratio,
                                   rtol=1e-3)
        if iters == 0:
            np.testing.assert_allclose(card.dem_grad, cpu.dem_grad,
                                       rtol=1e-6)
        np.testing.assert_allclose((dems * card.dem_grad).sum(axis=(1, 2)),
                                   -1.0, rtol=1e-5)
        for g, n in zip(card.dem_grad, nv):
            assert np.all(g[n:] == 0) and np.all(g[:, n:] == 0)
            assert np.all(g[:n, :n][~np.eye(n, dtype=bool)] < 0)


@pytest.mark.cuda
def test_cuda_apsp_backends_and_subgradients_agree(cuda):
    w = _lanes(96, 3, p=0.1).to(cuda)
    d_max = int(((w < _INF / 2).sum(dim=1) - 1).max())
    g = torch.from_numpy(np.round(np.random.default_rng(5).uniform(
        0.5, 2.0, (3, 96, 96)) * 8) / 8).float().to(cuda)
    dists, grads = {}, {}
    for backend in ("squaring", "squaring-pallas", "blocked-fw", "ell-bf"):
        wt = w.clone().requires_grad_(True)
        d = p_apsp.apsp(wt, backend, d_max if backend == "ell-bf" else None)
        (d * torch.where(d < _INF / 2, g, 0.0)).sum().backward()
        dists[backend], grads[backend] = d.detach(), wt.grad
    for backend in dists:
        assert torch.equal(dists[backend], dists["squaring"]), backend
        assert torch.equal(grads[backend], grads["squaring"]), backend
    # the card's subgradient equals the CPU's: every order is pinned
    wc = w.cpu().requires_grad_(True)
    d = p_apsp.apsp(wc, "blocked-fw")
    (d * torch.where(d < _INF / 2, g.cpu(), 0.0)).sum().backward()
    assert torch.equal(wc.grad, grads["squaring"].cpu())


@pytest.mark.cuda
def test_cuda_certified_brackets_agree_across_backends(cuda):
    """The certified engine on the card, APSP by K1 squaring and by K3
    Bellman-Ford.  On each backend the card's brackets are the CPU's bit
    for bit (the descent is built from exactly rounded ops and sums in a
    fixed order, see ``repro_torch.core.primal``).  Across the two
    backends they are not: squaring and Bellman-Ford add a path's lengths
    in another association, so α = Σ dem·dist differs by an ulp, the next
    lengths differ by an ulp, and a near-tied pair of paths then falls on
    the other side of the SP-DAG's tie test; the FW loads move a whole
    demand unit and the lower bounds part (by 0.6% at 150 steps on this
    pile).  So across backends each bracket is held to the LP optimum."""
    from repro_torch.core import engine, graphs, lp, traffic
    topos = [graphs.random_regular_graph(n, 4, seed=s, servers=3)
             for s, n in enumerate((24, 32, 40))]
    dems = [traffic.make("permutation", t.servers, seed=s + 1)
            for s, t in enumerate(topos)]
    theta = [lp.max_concurrent_flow(t.cap, d, want_flows=False).throughput
             for t, d in zip(topos, dems)]
    for backend, kernel in (("squaring", "minplus_acc"),
                            ("ell-bf", "ell_relax_round")):
        _build.reset_launches()
        card = engine.get_engine("certified", iters=150,
                                 backend=backend).solve_batch(topos, dems)
        assert _build.LAUNCHES[kernel] > 0, backend
        cpu = engine.get_engine("certified", iters=150, backend=backend,
                                device="cpu").solve_batch(topos, dems)
        for a, b, th in zip(card, cpu, theta):
            assert (a.meta["lb"], a.meta["ub"]) == (b.meta["lb"],
                                                    b.meta["ub"]), backend
            assert 0 < a.meta["lb"] <= th * (1 + 1e-6)
            assert th <= a.meta["ub"] * (1 + 1e-6)


def _routing_pile(ns=(24, 32, 40), deg=4):
    from repro_torch.core import graphs, traffic
    nmax = max(ns)
    caps = np.zeros((len(ns), nmax, nmax), np.float32)
    dems = np.zeros_like(caps)
    for s, n in enumerate(ns):
        t = graphs.random_regular_graph(n, deg, seed=s, servers=3)
        caps[s, :n, :n] = t.cap
        dems[s, :n, :n] = traffic.make("permutation", t.servers, seed=s + 1)
    return caps, dems, np.array(ns, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kernel", [("squaring", "minplus_acc"),
                                            ("ell-bf", "ell_relax_round")])
def test_cuda_ecmp_matches_cpu(cuda, backend, kernel):
    """ECMP on the card: unit-hop distances from K1 or K3 are exact and
    every sum of the split's propagation has a fixed order, so the lower
    bound, the utilisation and the hop at which the fixed point repeats
    are the CPU's bit for bit.  The free ub is the dual descent's, whose
    card and CPU iterates part at 100 steps (1.8e-3 on one lane, H100;
    ``test_cuda_dual_demgrad_matches_cpu`` says why), so it is held to
    HiGHS: ecmp lb <= θ <= ub on both devices."""
    from repro_torch.core import lp, routing
    caps, dems, nv = _routing_pile()
    kw = dict(n_valid=nv, iters=100, backend=backend)
    _build.reset_launches()
    card = routing.solve_ecmp_batch(caps, dems, **kw)
    assert _build.LAUNCHES[kernel] > 0
    cpu = routing.solve_ecmp_batch(caps, dems, device="cpu", **kw)
    assert np.array_equal(card.throughput_lb, cpu.throughput_lb)
    assert np.array_equal(card.final_util, cpu.final_util)
    assert np.array_equal(card.ecmp_hops, cpu.ecmp_hops)
    for i, n in enumerate(nv):
        theta = lp.max_concurrent_flow(caps[i, :n, :n], dems[i, :n, :n],
                                       want_flows=False).throughput
        assert 0 < card.throughput_lb[i] <= theta * (1 + 1e-6)
        assert theta <= min(card.throughput_ub[i],
                            cpu.throughput_ub[i]) * (1 + 1e-6)


@pytest.mark.cuda
def test_cuda_ksp_loads_equal_cpu(cuda):
    """The MW step's loads for fixed logits: gathers and sums in each
    edge's fixed order, no atomics, so the card's are the CPU's bit for
    bit, for the weights and through the softmax."""
    from repro_torch.core import routing
    caps, dems, nv = _routing_pile()
    paths = routing._paths_tensor(caps, nv, 8, 12)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(0, 2, paths.shape[:3])
                         .astype(np.float32))
    flows = torch.from_numpy(rng.uniform(0, 1, paths.shape[:3])
                             .astype(np.float32))
    demv = torch.from_numpy(dems.reshape(len(nv), -1))
    got = {}
    for dev in ("cpu", cuda):
        tables = routing._path_tables(paths, caps.shape[1], dev)
        wgt, _ = routing._path_weights(z.to(dev), tables, demv.to(dev))
        got[str(dev)] = (wgt.cpu(), routing._edge_loads(wgt, tables).cpu(),
                         routing._edge_loads(flows.to(dev), tables).cpu())
    for a, b in zip(got["cpu"], got[str(cuda)]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_ksp_keeps_the_certificates(cuda):
    from repro_torch.core import lp, routing
    caps, dems, nv = _routing_pile()
    _build.reset_launches()
    ksp = routing.solve_ksp_batch(caps, dems, n_valid=nv, iters=200, k=8)
    assert _build.LAUNCHES["minplus_acc"] > 0
    ecmp = routing.solve_ecmp_batch(caps, dems, n_valid=nv, iters=10)
    for i, n in enumerate(nv):
        theta = lp.max_concurrent_flow(caps[i, :n, :n], dems[i, :n, :n],
                                       want_flows=False).throughput
        assert 0 < ecmp.throughput_lb[i] <= ksp.throughput_lb[i]
        assert ksp.throughput_lb[i] <= theta * (1 + 1e-6)
        assert theta <= ksp.throughput_ub[i] * (1 + 1e-6)
        assert ksp.iterations[i] == 200


def _normal(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _close(got, want, dtype):
    # float32: the same float32 math summed in another order; bf16: both
    # round float32 results to bf16, so they may differ by one bf16 ulp
    # (at most |x| / 128)
    atol, rtol = (2e-5, 1e-4) if dtype == torch.float32 else (1e-3, 8e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,lk_valid", [
    (2, 200, 200, 6, 2, 128, True, None),      # ragged prefill, GQA g = 3
    (1, 128, 300, 4, 1, 64, True, None),       # cached prefix, MQA
    (1, 96, 160, 4, 4, 64, False, 150),        # not causal, padded keys
    (2, 1, 1016, 24, 8, 128, True, 1001),      # one decode step
    (1, 128, 128, 2, 1, 64, True, 64),         # first rows see no key
    (1, 300, 300, 2, 2, 16, True, None),       # d = 16
    (2, 77, 77, 6, 2, 64, True, None),         # 231 rows: not 64-aligned
    (1, 100, 400, 6, 2, 128, True, None),      # Lq < Lk, g = 3
    (1, 50, 50, 4, 1, 12, True, None),         # d = 12: unaligned rows
    (2, 1, 1016, 24, 8, 128, True, 1),         # decode, one valid key
    (2, 1, 1016, 24, 8, 128, True, 128),       # decode, two full splits
    (2, 1, 1016, 24, 8, 128, True, 129),       # decode, one key into a third
    (2, 1, 70, 4, 1, 12, True, 60),            # decode, d = 12, 4 rows
    (1, 5, 40, 3, 1, 64, True, None),          # short prefill, 15 rows
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, b, lq, lk, hq, hkv,
                                            d, causal, lk_valid):
    q = _normal(1, b, lq, hq, d).to(cuda, dtype)
    k = _normal(2, b, lk, hkv, d).to(cuda, dtype)
    v = _normal(3, b, lk, hkv, d).to(cuda, dtype)
    route = p_flash.flash_route(dtype, lq, hq // hkv)
    key = f"flash_attention/route:{route}"
    before = _build.LAUNCHES["flash_attention"]
    before_route = _build.SITE_LAUNCHES[key]
    got = p_flash.flash_attention(q, k, v, causal=causal, lk_valid=lk_valid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert _build.SITE_LAUNCHES[key] == before_route + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    want = p_flash.flash_attention_plain(q, k, v, causal=causal,
                                         lk_valid=lk_valid)
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,lk_valid,window", [
    (2, 300, 300, 10, 1, 256, None, 100),  # D = 256, band not tile-aligned
    (1, 200, 250, 4, 2, 256, 230, 37),     # Lq < lk_valid < Lk, ragged
    (1, 130, 130, 2, 1, 64, None, 1),      # window 1: each row sees itself
    (1, 77, 77, 6, 2, 128, None, 500),     # window >= L: plain causal
    (1, 100, 100, 1, 1, 256, None, 64),    # g = 1, band of whole tiles
    (1, 64, 64, 2, 1, 250, None, 20),      # d = 250: rows not 16-aligned
    (1, 160, 160, 2, 2, 136, 150, 50),     # d = 136, lk_valid < Lk
    (2, 1, 2048, 10, 1, 256, 2048, 0),     # decode over a full 2048 ring
    (2, 1, 2048, 10, 1, 256, 700, 0),      # the ring before its wrap
    (2, 1, 300, 10, 1, 256, 290, 70),      # decode, splits left of the band
    (1, 3, 200, 4, 1, 256, 150, 33),       # 12 rows: route decode, window
])
def test_cuda_flash_attention_window_and_head_dim_256(
        cuda, dtype, b, lq, lk, hq, hkv, d, lk_valid, window):
    """K4 with a local window and head dims up to 256 on each route
    (``mma`` for bf16 prefill, ``f32`` for float32, ``decode`` up to 16
    rows) against the plain version with the same window."""
    q = _normal(11, b, lq, hq, d).to(cuda, dtype)
    k = _normal(12, b, lk, hkv, d).to(cuda, dtype)
    v = _normal(13, b, lk, hkv, d).to(cuda, dtype)
    route = p_flash.flash_route(dtype, lq, hq // hkv)
    key = f"flash_attention/route:{route}"
    before = _build.SITE_LAUNCHES[key]
    got = p_flash.flash_attention(q, k, v, causal=True, lk_valid=lk_valid,
                                  window=window)
    torch.cuda.synchronize()
    assert _build.SITE_LAUNCHES[key] == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    want = p_flash.flash_attention_plain(q, k, v, causal=True,
                                         lk_valid=lk_valid, window=window)
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,lk_valid,window,view", [
    (2, 200, 200, 6, 2, 128, True, None, 0, False),   # g = 3, ragged rows
    (1, 130, 130, 10, 1, 256, True, None, 33, False),  # g = 10, D = 256, band
    (1, 90, 90, 2, 1, 64, True, None, 1, False),       # window 1
    (1, 80, 120, 4, 4, 16, False, 100, 0, False),      # not causal, g = 1
    (1, 100, 100, 2, 1, 64, True, 40, 0, False),       # rows that see no key
    (2, 50, 50, 4, 1, 12, True, None, 0, False),       # d = 12: plain loads
    (1, 60, 60, 6, 2, 64, True, None, 0, True),        # q a strided view
])
def test_cuda_flash_attention_f32_matches_its_rounding(
        cuda, b, lq, lk, hq, hkv, d, causal, lk_valid, window, view):
    """Route "f32" (3xTF32 on the tensor cores) against both plain versions:
    the float32 one and the route's own rounding
    (``flash_attention_tf32_plain``), under K4's float32 tolerance."""
    if view:
        proj = _normal(24, b, lq, 2 * hq * d).to(cuda)
        q = proj[..., :hq * d].view(b, lq, hq, d)
    else:
        q = _normal(24, b, lq, hq, d).to(cuda)
    k = _normal(25, b, lk, hkv, d).to(cuda)
    v = _normal(26, b, lk, hkv, d).to(cuda)
    kw = dict(causal=causal, lk_valid=lk_valid, window=window)
    assert p_flash.flash_route(torch.float32, lq, hq // hkv) == "f32"
    before = _build.SITE_LAUNCHES["flash_attention/route:f32"]
    got = p_flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.SITE_LAUNCHES["flash_attention/route:f32"] == before + 1
    assert torch.isfinite(got).all()
    qc = q.contiguous()
    _close(got, p_flash.flash_attention_plain(qc, k, v, **kw), torch.float32)
    _close(got, p_flash.flash_attention_tf32_plain(qc, k, v, **kw),
           torch.float32)
    valid = lk if lk_valid is None else lk_valid
    if causal and valid < lq:
        assert float(got[:, :lq - valid].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [1, 40])
def test_cuda_flash_attention_reads_a_cache_slice_in_place(cuda, lq):
    """A layer's [B, max_len, Hkv, D] slice of a stacked cache goes in as
    a strided view, with q a view of a wider projection: route "decode"
    (Lq = 1, 3 rows) and route "mma" (Lq = 40, 120 rows)."""
    cache = _normal(4, 3, 2, 80, 2, 64).to(cuda, torch.bfloat16)
    proj = _normal(5, 2, lq, 2 * 6 * 64).to(cuda, torch.bfloat16)
    q = proj[..., :6 * 64].view(2, lq, 6, 64)
    k, v = cache[1], cache[2]
    route = p_flash.flash_route(torch.bfloat16, lq, 3)
    assert route == ("decode" if lq == 1 else "mma")
    before = _build.SITE_LAUNCHES[f"flash_attention/route:{route}"]
    got = p_flash.flash_attention(q, k, v, causal=True, lk_valid=57)
    assert _build.SITE_LAUNCHES[f"flash_attention/route:{route}"] == \
        before + 1
    want = p_flash.flash_attention_plain(q.contiguous(), k.contiguous(),
                                         v.contiguous(), lk_valid=57)
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,n,with_state,lane_u", [
    (2, 64, 16, False, False),
    (3, 70, 32, True, True),       # ragged T
    (1, 32, 64, True, False),
    (64, 1000, 64, True, True),    # ragged, main-path head size
])
def test_cuda_wkv_matches_plain(cuda, bh, t, n, with_state, lane_u):
    r, k, v = (_normal(s, bh, t, n).to(cuda) for s in (6, 7, 8))
    log_w = -torch.clamp(torch.exp(_normal(9, bh, t, n)), 1e-6,
                         2.5).to(cuda)
    u = (_normal(10, bh, n) if lane_u else _normal(10, n)).to(cuda) * 0.5
    s0 = _normal(11, bh, n, n).to(cuda) * 0.3 if with_state else None
    before = _build.LAUNCHES["wkv_chunked"]
    o, s = p_wkv.wkv_chunked(r, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv_chunked"] == before + 1
    want_o, want_s = p_wkv.wkv_chunked_plain(r, k, v, log_w, u, s0)
    # the same chunked float32 algebra summed in another order; exponents
    # up to +-80 within a chunk scale the rounding of exp
    torch.testing.assert_close(o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(12, 0), (16, 0), (32, 0), (64, 0),
                                      (6, 0), (10, 0), (16, 1), (64, 1)])
@pytest.mark.parametrize("t", [1, 31, 33, 70, 1000])
def test_cuda_wkv_reads_strided_head_views(cuda, t, n, offset):
    """[B, T, H, n] projections handed over as [B, H, T, n] views (the
    model's layout), ragged T, a per-head bonus [H, n], with s0 at odd T:
    within K5's tolerance of the plain version on contiguous copies, o in
    r's memory layout, one launch counted.  n = 12 leaves channels of the
    kernel's 16-wide tile empty.  n = 6 or 10 (rows an odd number of floats
    apart) and views that start ``offset`` floats into a wider
    [B, T, H, n + offset] buffer cannot be copied 16 bytes at a time: the
    kernel then takes 4-byte copies and stores o one float at a time, and
    o comes back packed as [B, T, H, n] where r has gaps."""
    b, h = 2, 3

    def view(x):
        buf = torch.zeros(b, t, h, n + offset, device=cuda)
        buf[..., offset:] = x.to(cuda)
        return buf[..., offset:].permute(0, 2, 1, 3)

    r, k, v = (view(_normal(s, b, t, h, n)) for s in (20, 21, 22))
    log_w = view(-torch.clamp(torch.exp(_normal(23, b, t, h, n)), 1e-6, 2.5))
    u = _normal(24, h, n).to(cuda) * 0.5
    s0 = _normal(25, b, h, n, n).to(cuda) * 0.3 if t % 2 else None
    before = _build.LAUNCHES["wkv_chunked"]
    o, s = p_wkv.wkv_chunked(r, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv_chunked"] == before + 1
    assert o.shape == (b, h, t, n) and s.shape == (b, h, n, n)
    assert o.permute(0, 2, 1, 3).is_contiguous()
    if not offset:
        assert o.stride() == r.stride()
    want_o, want_s = p_wkv.wkv_chunked_plain(
        *(x.contiguous() for x in (r, k, v, log_w)), u, s0)
    # the same chunked float32 algebra summed in another order (see above)
    torch.testing.assert_close(o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, want_s, atol=1e-4, rtol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-4b", "rwkv6-7b",
                                  "granite-moe-3b-a800m", "qwen2-vl-7b",
                                  "musicgen-medium", "recurrentgemma-2b"])
def test_cuda_serving_matches_cpu(cuda, arch):
    """The smoke config served on the card (K4 or K5 on the path; the
    hybrid's 45-token prompt is past its 16-key window) gives the CPU's
    logits (plain versions) from the same float32 weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = get_smoke(arch)
    params = model.get_model(cfg, "cpu").init_params(0)
    on_card = _to(params, cuda)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32)
    rec = {}
    _build.reset_launches()
    toks = serve.generate(cfg, on_card, prompts, 4, device=cuda, record=rec)
    kernel = "wkv_chunked" if cfg.family == "ssm" else "flash_attention"
    assert _build.LAUNCHES[kernel] > 0
    # teacher-forced on the CPU with the card's tokens
    cpu_model = model.get_model(cfg, "cpu")
    want, cache = cpu_model.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, 49)
    for i, got in enumerate(rec["logits"]):
        # float32 on both (no TF32): order of additions only
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        if i < 3:
            want, cache = cpu_model.decode_step(
                params, cache, torch.from_numpy(toks[:, 45 + i:46 + i]))


# ---------------------------------------------------------------------------
# K4b and K5b: the backward kernels
# ---------------------------------------------------------------------------

def _close_grad(got, want, dtype, scale=None):
    # float32: the same float32 algebra summed in another order, over up to
    # Lq * g rows for dK and dV; bf16: both compute in float32 from the same
    # bf16 inputs and round the result to bf16, so they may differ by one
    # bf16 ulp (at most |x| / 128).  atol is relative to ``scale``: the
    # gradient's own largest entry, or the call's largest entry where the
    # caller says why: a gradient that is 0 in exact arithmetic (dQ and dK
    # when each row sees only its own key) is rounding noise of the terms
    # that cancel, on the scale of the others
    if scale is None:
        scale = float(want.float().abs().max())
    atol, rtol = ((1e-4, 1e-4) if dtype == torch.float32 else (1e-3, 8e-3))
    torch.testing.assert_close(got.float(), want.float(),
                               atol=atol * max(scale, 1e-30), rtol=rtol)


def _scale(grads):
    return max(float(g.float().abs().max()) for g in grads if g is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,lk_valid,window", [
    (2, 200, 200, 6, 2, 128, True, None, 0),    # ragged prefill, g = 3
    (1, 100, 160, 4, 1, 64, True, 150, 0),      # Lq < lk_valid < Lk, MQA
    (1, 96, 160, 4, 4, 64, False, 150, 0),      # not causal, padded keys
    (1, 128, 128, 2, 1, 64, True, 64, 0),       # first rows see no key
    (2, 300, 300, 10, 1, 256, True, None, 100),  # D = 256 with a window
    (1, 200, 250, 4, 2, 256, True, 230, 37),    # window, ragged, D = 256
    (1, 50, 50, 4, 1, 12, True, None, 0),       # d = 12
    (1, 64, 64, 2, 1, 250, True, None, 20),     # d = 250
    (1, 160, 160, 2, 2, 136, True, 150, 50),    # d = 136, lk_valid < Lk
    (2, 5, 40, 3, 1, 64, True, None, 0),        # 15 rows
    (1, 130, 130, 2, 1, 64, True, None, 1),     # window 1
    (2, 150, 150, 28, 4, 128, True, None, 0),   # g = 7 (qwen2-vl-7b)
    (1, 180, 260, 10, 1, 256, True, 240, 90),   # D = 256, g = 10, Lq != Lk
    (1, 700, 700, 12, 2, 64, True, None, 300),  # 4,200 rows: 2 segments (f32)
])
def test_cuda_flash_attention_bwd_matches_plain(cuda, dtype, b, lq, lk, hq,
                                                hkv, d, causal, lk_valid,
                                                window):
    """K4b against ``flash_attention_bwd_plain`` on the same inputs (the
    output from the plain forward), one call counted on the dtype's route;
    a second call gives the same bits (no atomics).  Each route is also
    held against the plain version of its own rounding: route "mma" (bf16)
    against ``flash_attention_bwd_mma_plain``, which rounds P and dS as it
    does (the same float32 algebra summed in another order, so one bf16 ulp
    (2^-7 |x|) and 1e-4 of the scale apart); route "f32" against
    ``flash_attention_bwd_tf32_plain``, which runs every product as 3xTF32
    as it does (the same split products, summed in another order and by
    the tensor cores' float32 accumulation: the float32 tolerance, which
    one TF32 rounding of any product misses)."""
    q = _normal(31, b, lq, hq, d).to(cuda, dtype)
    k = _normal(32, b, lk, hkv, d).to(cuda, dtype)
    v = _normal(33, b, lk, hkv, d).to(cuda, dtype)
    do = _normal(34, b, lq, hq, d).to(cuda, dtype)
    kw = dict(causal=causal, lk_valid=lk_valid, window=window)
    o = p_flash.flash_attention_plain(q, k, v, **kw)
    route = "mma" if dtype == torch.bfloat16 else "f32"
    assert p_flash.flash_bwd_route(dtype) == route
    site = f"flash_attention_bwd/route:{route}"
    before = (_build.LAUNCHES["flash_attention_bwd"], _build.SITE_LAUNCHES[site])
    got = p_flash.flash_attention_bwd(q, k, v, o, do, site="test", **kw)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["flash_attention_bwd"],
            _build.SITE_LAUNCHES[site]) == (before[0] + 1, before[1] + 1)
    again = p_flash.flash_attention_bwd(q, k, v, o, do, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = p_flash.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    # window 1: dQ and dK are 0 in exact arithmetic
    scale = _scale(want) if window == 1 else None
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        _close_grad(g, w, dtype, scale)
    if route == "mma":
        emu = p_flash.flash_attention_bwd_mma_plain(q, k, v, o, do, **kw)
        own_atol, own_rtol = 1e-4, 2.0 ** -7
    else:
        emu = p_flash.flash_attention_bwd_tf32_plain(q, k, v, o, do, **kw)
        own_atol, own_rtol = 1e-4, 1e-4
    for g, w in zip(got, emu):
        sc = scale if scale is not None else float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=own_atol * max(sc, 1e-30),
                                   rtol=own_rtol)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_reads_strided_views(cuda):
    """q a view of a wider projection, k and v slices of a stacked
    buffer, dO transposed: the same as on contiguous copies."""
    dt = torch.bfloat16
    buf = _normal(35, 3, 2, 80, 2, 64).to(cuda, dt)
    proj = _normal(36, 2, 70, 2 * 6 * 64).to(cuda, dt)
    q = proj[..., :6 * 64].view(2, 70, 6, 64)
    k, v = buf[1, :, :75], buf[2, :, :75]
    do = _normal(37, 6, 2, 70, 64).to(cuda, dt).permute(1, 2, 0, 3)
    o = p_flash.flash_attention_plain(q, k, v, lk_valid=72)
    got = p_flash.flash_attention_bwd(q, k, v, o, do, lk_valid=72)
    want = p_flash.flash_attention_bwd_plain(
        *(x.contiguous() for x in (q, k, v, o, do)), lk_valid=72)
    for g, w in zip(got, want):
        _close_grad(g, w, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_gradients_reach_q_k_v(cuda, dtype):
    """The fault K4b closes: K4's output was filled through ctypes with no
    autograd node, so a backward on the card gave q, k and v no gradient.
    Through the wrapper they now get K4b's, equal to the plain path's
    autograd gradients."""
    q = _normal(40, 2, 90, 6, 64).to(cuda, dtype)
    k = _normal(41, 2, 90, 2, 64).to(cuda, dtype)
    v = _normal(42, 2, 90, 2, 64).to(cuda, dtype)
    w = _normal(43, 2, 90, 6, 64).to(cuda, dtype)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = _build.LAUNCHES["flash_attention_bwd"]
    o = p_flash.flash_attention(*ins, window=40)
    assert o.grad_fn is not None
    (o.float() * w.float()).sum().backward()
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    (p_flash.flash_attention_plain(*plain, window=40).float()
     * w.float()).sum().backward()
    # float32: the same algebra, each gradient on its own scale.  bf16: the
    # plain path's autograd rounds P, dP and dS to bf16 where K4 and K4b
    # keep them in float32, so the two differ by bf16 rounding of terms on
    # the scale of the call's largest gradient, not of each gradient's own
    scale = _scale([x.grad for x in plain]) if dtype == torch.bfloat16 \
        else None
    for a, b in zip(ins, plain):
        assert a.grad is not None and float(a.grad.float().abs().max()) > 0
        _close_grad(a.grad, b.grad, dtype, scale)


def _wkv_views(seed, b, t, h, n, cuda):
    """[B, T, H, n] projections as [B, H, T, n] views (the model's layout)."""
    out = [_normal(seed + i, b, t, h, n).to(cuda).permute(0, 2, 1, 3)
           for i in range(3)]
    w = -torch.clamp(torch.exp(_normal(seed + 3, b, t, h, n)), 1e-6, 2.5)
    return (*out, w.to(cuda).permute(0, 2, 1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,n,with_state,with_ds", [
    (1, 2, 64, 16, False, False),
    (2, 3, 70, 32, True, True),       # ragged T
    (1, 1, 1, 8, True, True),         # one step
    (2, 2, 33, 12, False, True),      # n = 12
    (1, 2, 31, 24, True, True),       # one ragged chunk, n = 24
    (8, 8, 1000, 64, True, False),    # ragged, the model's head size
])
def test_cuda_wkv_bwd_matches_plain(cuda, b, h, t, n, with_state, with_ds):
    """K5b against ``wkv_chunked_bwd_plain`` on [B, H, T, n] views with a
    per-head bonus: dr, dk, dv, dlog_w in the inputs' layout, du summed to
    [H, n], ds0; one call counted, and a second call gives the same bits
    (no atomics: every sum in a fixed order)."""
    r, k, v, log_w = _wkv_views(50, b, t, h, n, cuda)
    u = _normal(55, h, n).to(cuda) * 0.5
    s0 = _normal(56, b, h, n, n).to(cuda) * 0.3 if with_state else None
    do = _normal(57, b, h, t, n).to(cuda)
    ds = _normal(58, b, h, n, n).to(cuda) if with_ds else None
    before = _build.LAUNCHES["wkv_chunked_bwd"]
    got = p_wkv.wkv_chunked_bwd(r, k, v, log_w, u, s0, do, ds)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv_chunked_bwd"] == before + 1
    again = p_wkv.wkv_chunked_bwd(r, k, v, log_w, u, s0, do, ds)
    assert all(a is c or torch.equal(a, c) for a, c in zip(got, again))
    want = p_wkv.wkv_chunked_bwd_plain(r, k, v, log_w, u, s0, do, ds)
    assert (got[5] is None) == (s0 is None)
    assert got[0].stride() == r.stride() and got[4].shape == (h, n)
    for g, w in zip(got, want):
        if w is None:
            continue
        assert torch.isfinite(g).all()
        # the chunk algebra in float32 summed in another order; exponents up
        # to +-80 in a chunk scale the rounding of exp (K5's own tolerance,
        # relative to the gradient's largest entry)
        _close_grad(g, w, torch.float32)


@pytest.mark.cuda
def test_cuda_wkv_gradients_reach_r_k_v_log_w(cuda):
    """The fault K5b closes, as for K4: through the wrapper on the card r,
    k, v, log_w and u get K5b's gradients, equal to the plain path's
    autograd."""
    base = _wkv_views(60, 2, 45, 3, 16, cuda)
    u0 = _normal(64, 3, 16).to(cuda) * 0.5
    w = _normal(65, 2, 3, 45, 16).to(cuda)
    ins = [x.detach().clone().requires_grad_(True) for x in (*base, u0)]
    plain = [x.detach().clone().requires_grad_(True) for x in (*base, u0)]
    before = _build.LAUNCHES["wkv_chunked_bwd"]
    o, _ = p_wkv.wkv_chunked(*ins)
    assert o.grad_fn is not None
    (o * w).sum().backward()
    assert _build.LAUNCHES["wkv_chunked_bwd"] == before + 1
    (p_wkv.wkv_chunked_plain(*plain)[0] * w).sum().backward()
    for a, b in zip(ins, plain):
        assert a.grad is not None and float(a.grad.abs().max()) > 0
        _close_grad(a.grad, b.grad, torch.float32)


# --------------------------------------------------------------------------
# the planner's device placement and compile cache on the card
# --------------------------------------------------------------------------

def _plan_pile(ns, deg=4, servers=3):
    from repro_torch.core import graphs, traffic
    topos = [graphs.random_regular_graph(n, deg, seed=s, servers=servers)
             for s, n in enumerate(ns)]
    return topos, [traffic.make("permutation", t.servers, seed=s + 1)
                   for s, t in enumerate(topos)]


@pytest.mark.cuda
def test_cuda_devices_none_is_one_card(cuda):
    from repro_torch.core import get_engine
    from repro_torch.core.plan import device_count
    ncards = torch.cuda.device_count()
    assert device_count(None) == 1
    assert device_count(ncards) == ncards
    with pytest.raises(ValueError, match="out of range"):
        device_count(ncards + 1)
    eng = get_engine("dual", iters=20)
    res = eng.solve_batch(*_plan_pile([16, 16, 24]))
    assert eng.last_plan.devices == 1
    assert all(r.meta["devices"] == 1 for r in res)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dual", "certified", "ecmp", "ksp"])
def test_cuda_sharded_plan_bit_identical_to_one_card(cuda, solver):
    """Shard j on cuda:j, one host thread a card: every lane's bits equal a
    one-card plan's (needs two cards or more)."""
    from repro_torch.core import get_engine
    ncards = torch.cuda.device_count()
    if ncards < 2:
        pytest.skip("needs two cards or more")
    topos, dems = _plan_pile([16, 16, 24, 24, 32])
    one = get_engine(solver, iters=60, devices=1).solve_batch(topos, dems)
    eng = get_engine(solver, iters=60, devices=ncards)
    many = eng.solve_batch(topos, dems)
    assert [r.throughput for r in one] == [r.throughput for r in many]
    assert eng.last_plan.devices == ncards


@pytest.mark.cuda
def test_cuda_warm_process_builds_no_library(cuda):
    """The kernel library is the port's one compile: a second process on
    the same sources loads it without nvcc (``aot.compiles`` 0, ``aot.hits``
    1) and gives the same bits; a refill adds no program."""
    import json as _json
    import pathlib
    import subprocess
    import sys
    from repro_torch.core import get_engine
    from repro_torch.core.plan import compile_cache_sizes
    topos, dems = _plan_pile([64] * 4)
    eng = get_engine("dual-pallas", iters=30, devices=1)
    before = _build.LAUNCHES["minplus_acc"]
    first = [r.throughput for r in eng.solve_batch(topos, dems)]
    assert _build.LAUNCHES["minplus_acc"] > before
    assert sum(compile_cache_sizes()[k] for k in ("aot.compiles",
                                                  "aot.hits")) == 1
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from repro_torch.core import get_engine, graphs, traffic\n"
        "from repro_torch.core.plan import compile_cache_sizes\n"
        "from repro_torch.kernels import _build\n"
        "ts = [graphs.random_regular_graph(64, 4, seed=s, servers=3)"
        " for s in range(4)]\n"
        "ds = [traffic.make('permutation', t.servers, seed=s + 1)"
        " for s, t in enumerate(ts)]\n"
        "res = get_engine('dual-pallas', iters=30, devices=1)"
        ".solve_batch(ts, ds)\n"
        "print(json.dumps({'sizes': compile_cache_sizes(), 'nvcc':"
        " _build.build_seconds(), 'bounds': [r.throughput for r in res]}))"
        % str(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    warm = _json.loads(out.stdout.strip().splitlines()[-1])
    assert warm["nvcc"] is None
    assert (warm["sizes"]["aot.compiles"], warm["sizes"]["aot.hits"]) == \
        (0, 1)
    assert warm["bounds"] == first
    plan = eng.plan(topos, dems)
    c0 = compile_cache_sizes()
    plan.refill(*_plan_pile([64] * 4, deg=5)).execute(
        iters=30, backend="squaring-pallas")
    c1 = compile_cache_sizes()
    assert all(c1[k] == c0[k] for k in c1 if k.startswith("dual."))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["squaring", "ell-bf"])
def test_cuda_chunks_do_not_change_a_lane(cuda, backend):
    """The reference's plan contract on the card: chunking a bucket (and so
    sharding it) must not change any bound bit.  A CUDA reduction's order
    depends on the number of lanes, so the dual ratio's sums run in an
    order fixed by N (``apsp._sum_sources``)."""
    from repro_torch.core import get_engine
    topos, dems = _plan_pile([128] * 6, deg=8)
    kw = dict(iters=60, backend=backend, devices=1)
    whole = get_engine("dual", **kw).solve_batch(topos, dems)
    chunked = get_engine("dual", max_lanes=2, **kw).solve_batch(topos, dems)
    assert [r.throughput for r in whole] == [r.throughput for r in chunked]
    assert [r.meta["final_ratio"] for r in whole] == \
        [r.meta["final_ratio"] for r in chunked]
