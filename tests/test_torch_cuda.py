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
from repro_torch.kernels import minplus as p_minplus  # noqa: E402

_INF = 1.0e18


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
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


@pytest.mark.cuda
def test_cuda_fw_pivot_and_blocked_fw_match_plain(cuda):
    w = _lanes(256, 2, p=0.05).to(cuda)
    tile = w[:, :128, :128].clone()
    assert torch.equal(p_fw.fw_pivot(tile.clone()),
                       p_fw.fw_tile_closure(tile))
    assert torch.equal(p_fw.fw_apsp_blocked(w), p_fw.fw_apsp_plain(w))


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
    d, _ = p_ell.ell_bf_apsp(idx, wgt)
    assert torch.equal(d.contiguous(), p_fw.fw_apsp_plain(w))


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
