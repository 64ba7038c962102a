"""The port's APSP registry and shared SP-DAG adjoint against the reference.

Distances must be bit-equal to ``repro.core.apsp.apsp`` on quantized
weights for every backend.  Subgradients must be bit-identical across the
port's own backends (one adjoint, one order of additions) and agree with
the reference's within a tolerance: each edge's deposit is a sum over
sources that the reference leaves to an XLA reduction and the port adds
by pairwise halving, so the two differ by a few float32 ulps of the
summed mass (rtol 1e-5 covers ~100 ulps at these sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import apsp as r_apsp  # noqa: E402
from repro_torch.core import apsp as p_apsp  # noqa: E402
from tests.test_apsp_backends import _ell_d_max, _quantize, _w_cases  # noqa: E402

_BACKENDS = ("squaring", "squaring-pallas", "blocked-fw", "ell-bf", "auto")
_GRAD_RTOL = 1e-5


def _port(w, backend, d_max=None):
    dm = d_max if backend == "ell-bf" else None
    return p_apsp.apsp(torch.from_numpy(np.array(w)), backend, dm)


@pytest.mark.parametrize("backend", _BACKENDS)
@pytest.mark.parametrize("case", sorted(_w_cases()))
def test_distances_bit_equal_to_reference(case, backend):
    w = _w_cases()[case]
    ref = np.asarray(r_apsp.apsp(w, "squaring"))
    got = _port(w, backend, _ell_d_max(w)).numpy()
    assert np.array_equal(got, ref)


def test_padded_lanes_isolated_and_batched_lanes_independent():
    cases = _w_cases()
    w = np.asarray(cases["random-sparse"])
    n, m = w.shape[0], 40
    wp = np.full((m, m), r_apsp._INF, np.float32)
    wp[:n, :n] = w
    np.fill_diagonal(wp, 0.0)
    other = np.full((m, m), r_apsp._INF, np.float32)
    other[:32, :32] = np.asarray(cases["rrg-unit"])
    np.fill_diagonal(other, 0.0)
    batch = torch.from_numpy(np.stack([wp, other]))
    d_max = max(_ell_d_max(wp), _ell_d_max(other))
    ref = np.asarray(r_apsp.apsp(jnp.asarray(w), "squaring"))
    for backend in ("squaring", "squaring-pallas", "blocked-fw", "ell-bf"):
        d = p_apsp.apsp(batch, backend,
                        d_max if backend == "ell-bf" else None)
        assert np.array_equal(d[0, :n, :n].numpy(), ref), backend
        off = ~np.eye(m - n, dtype=bool)
        assert np.all(d[0, n:, n:].numpy()[off] > r_apsp._INF / 2)
        assert torch.equal(d[1], _port(other, backend, d_max)), backend


def _grad_port(w, g, backend, d_max):
    wt = torch.from_numpy(np.array(w)).requires_grad_(True)
    d = p_apsp.apsp(wt, backend, d_max if backend == "ell-bf" else None)
    gt = torch.from_numpy(g)
    (d * torch.where(d < p_apsp._INF / 2, gt, 0.0)).sum().backward()
    return wt.grad.numpy()


def _grad_ref(w, g, backend, d_max):
    def loss(w):
        d = r_apsp.apsp(w, backend, None,
                        d_max if backend == "ell-bf" else None)
        return jnp.sum(d * jnp.where(d < r_apsp._INF / 2, g, 0.0))
    return np.asarray(jax.grad(loss)(w))


@pytest.mark.parametrize("case", sorted(_w_cases()))
def test_subgradients_identical_across_port_backends(case):
    w = _w_cases()[case]
    n = w.shape[0]
    d_max = _ell_d_max(w)
    rng = np.random.default_rng(7)
    g = _quantize(rng.uniform(0.5, 2.0, (n, n))).astype(np.float32)
    grads = {b: _grad_port(w, g, b, d_max) for b in _BACKENDS}
    for b, gb in grads.items():
        assert np.array_equal(gb, grads["squaring"]), b
    assert np.all(grads["squaring"][np.asarray(w) > p_apsp._INF / 2] == 0.0)
    ref = _grad_ref(w, g, "squaring", d_max)
    np.testing.assert_allclose(grads["squaring"], ref, rtol=_GRAD_RTOL,
                               atol=_GRAD_RTOL * np.abs(ref).max())
    # the non-zero pattern (which edges carry flow) is exactly the same
    assert np.array_equal(grads["squaring"] != 0, ref != 0)


def test_subgradients_chunking_and_batch_invariant(monkeypatch):
    """The target-chunked adjoint must give the same bits as one chunk,
    and a lane the same bits alone as in a batch (the ascending-target
    order and the halving sum over sources do not depend on either)."""
    w = _w_cases()["two-cluster"]
    n = w.shape[0]
    rng = np.random.default_rng(11)
    g = _quantize(rng.uniform(0.5, 2.0, (n, n))).astype(np.float32)
    whole = _grad_port(w, g, "blocked-fw", None)
    d_in = _ell_d_max(w)
    monkeypatch.setattr(p_apsp, "_BWD_ELEMS", n * d_in * 5)   # c=5, ragged
    assert np.array_equal(_grad_port(w, g, "blocked-fw", None), whole)
    monkeypatch.undo()
    other = np.asarray(_w_cases()["rrg-unit"])[:n, :n]
    wt = torch.from_numpy(np.stack([np.asarray(w), other])).requires_grad_()
    d = p_apsp.apsp(wt, "blocked-fw")
    gt = torch.from_numpy(np.stack([g, g]))
    (d * torch.where(d < p_apsp._INF / 2, gt, 0.0)).sum().backward()
    assert np.array_equal(wt.grad[0].numpy(), whole)


def test_grad_is_unit_flow_and_splits_ties():
    w = np.full((4, 4), p_apsp._INF, np.float32)
    np.fill_diagonal(w, 0.0)
    for a, b in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        w[a, b] = w[b, a] = 1.0
    for backend in ("squaring", "blocked-fw", "ell-bf"):
        wt = torch.from_numpy(w.copy()).requires_grad_(True)
        p_apsp.apsp(wt, backend, 2 if backend == "ell-bf" else None)[0, 3] \
            .backward()
        g = wt.grad.numpy()
        assert g[0, 1] == 0.5 and g[1, 3] == 0.5, backend
        assert g.sum() == 2.0, backend


def test_pack_ell_matches_reference():
    for case, w in sorted(_w_cases().items()):
        d_max = _ell_d_max(w)
        ri, rw = r_apsp._pack_ell(w, d_max)
        pi, pw = p_apsp._pack_ell(torch.from_numpy(np.array(w))[None],
                                  d_max)
        assert np.array_equal(pi[0].numpy(), np.asarray(ri)), case
        assert np.array_equal(pw[0].numpy(), np.asarray(rw)), case


def test_registry_matches_reference():
    assert p_apsp.BACKENDS == r_apsp.BACKENDS
    assert p_apsp.AUTO_THRESHOLD == r_apsp.AUTO_THRESHOLD
    assert p_apsp.SPARSE_THRESHOLD == r_apsp.SPARSE_THRESHOLD
    assert p_apsp._INF == r_apsp._INF
    for spec in (None, True, False, "blocked-fw", "ell-bf"):
        assert (p_apsp.normalize_backend(spec)
                == r_apsp.normalize_backend(spec))
    assert p_apsp.normalize_backend(None, use_pallas=True) == \
        "squaring-pallas"
    for n, md in ((511, None), (512, None), (512, 32.0), (512, 33.0),
                  (100, 4.0)):
        for b in ("auto", "squaring"):
            assert (p_apsp.resolve_backend(b, n, mean_degree=md)
                    == r_apsp.resolve_backend(b, n, mean_degree=md))
    with pytest.raises(ValueError, match="unknown APSP backend"):
        p_apsp.normalize_backend("dijkstra")
    with pytest.raises(ValueError, match="d_max"):
        p_apsp.apsp(torch.zeros(4, 4), "ell-bf")
