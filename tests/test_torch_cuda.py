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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-4b", "rwkv6-7b"])
def test_cuda_serving_matches_cpu(cuda, arch):
    """The smoke config served on the card (K4 or K5 on the path) gives
    the CPU's logits (plain versions) from the same float32 weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = get_smoke(arch)
    params = model.get_model(cfg, "cpu").init_params(0)
    on_card = {k: ({n: w.to(cuda) for n, w in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32)
    rec = {}
    _build.reset_launches()
    toks = serve.generate(cfg, on_card, prompts, 4, device=cuda, record=rec)
    kernel = "flash_attention" if cfg.family == "dense" else "wkv_chunked"
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
