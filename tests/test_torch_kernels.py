"""The port's kernel modules against the reference's Pallas kernels.

On the CPU every wrapper runs its kernel's plain torch version; those are
held bit-equal to the reference's Pallas kernels in interpret mode on
quantized weights (multiples of 1/8, 1e18 non-edges), where every path sum
is exact in float32.  The CUDA kernels themselves are compared with the
plain versions on the card by ``tests/test_torch_cuda.py`` (and by
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ell as r_ell  # noqa: E402
from repro.kernels import fw as r_fw  # noqa: E402
from repro.kernels import minplus as r_minplus  # noqa: E402
from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.core import apsp as p_apsp  # noqa: E402
from repro_torch.kernels import ell as p_ell  # noqa: E402
from repro_torch.kernels import fw as p_fw  # noqa: E402
from repro_torch.kernels import minplus as p_minplus  # noqa: E402
from repro_torch.kernels import ops as p_ops  # noqa: E402

_INF = 1.0e18


def _w(n, seed, p=0.35, m=None):
    """Quantized random lengths with _INF non-edges, zero diagonal."""
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    w = np.round(rng.uniform(0.5, 8.0, (n, m)) * 8.0) / 8.0
    w = np.where(rng.random((n, m)) < p, w, _INF).astype(np.float32)
    if n == m:
        np.fill_diagonal(w, 0.0)
    return w


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K1: tropical product
# ---------------------------------------------------------------------------

def test_plain_minplus_bit_equal_to_pallas_kernel():
    a, b = _w(128, 0, m=256), _w(256, 1, m=128)
    ref = np.asarray(r_minplus.minplus_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = p_minplus.minplus_acc(_t(a)[None], _t(b)[None])[0].numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(p_ops.minplus_matmul(_t(a), _t(b)).numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(130, 200, 150), (129, 129, 129),
                                   (64, 64, 64), (7, 3, 5)])
def test_plain_minplus_ragged_matches_reference_wrapper(m, k, n):
    a, b = _w(m, m + k, m=k), _w(k, n + 1, m=n)
    ref = np.asarray(r_ops.minplus_matmul(jnp.asarray(a), jnp.asarray(b),
                                          128, True))
    assert np.array_equal(p_ops.minplus_matmul(_t(a), _t(b)).numpy(), ref)
    # the un-padded plain K1 gives the same product on the valid block
    got = p_minplus.minplus_acc(_t(a)[None], _t(b)[None])[0].numpy()
    assert np.array_equal(got, np.asarray(r_ref.minplus_matmul_ref(
        jnp.asarray(a), jnp.asarray(b))))


def test_plain_minplus_accumulator_and_strided_views():
    w = _t(np.stack([_w(24, s) for s in range(3)]))
    c0 = w + 0.5
    got = p_minplus.minplus_acc(w, w, c0)
    want = torch.minimum(c0, p_minplus.minplus_matmul_ref(w, w))
    assert torch.equal(got, want)
    # panels as strided views of a bigger matrix, written into a view
    d = w.clone()
    p_minplus.minplus_acc(w[:, :8, :8], w[:, :8, :], w[:, :8, :],
                          out=d[:, :8, :])
    want = torch.minimum(w[:, :8, :],
                         p_minplus.minplus_matmul_ref(w[:, :8, :8],
                                                      w[:, :8, :]))
    assert torch.equal(d[:, :8, :], want)
    assert torch.equal(d[:, 8:, :], w[:, 8:, :])


def test_minplus_acc_validates_shapes():
    with pytest.raises(ValueError, match="batched 3-D"):
        p_minplus.minplus_acc(torch.zeros(4, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="disagree"):
        p_minplus.minplus_acc(torch.zeros(2, 4, 5), torch.zeros(2, 4, 5))


def test_minplus_acc_out_may_alias_c0_only():
    w = _t(np.stack([_w(16, s) for s in range(2)]))
    d = w.clone()
    want = torch.minimum(w, p_minplus.minplus_matmul_ref(w[:, :, :4],
                                                         w[:, :4, :]))
    got = p_minplus.minplus_acc(w[:, :, :4].clone(), w[:, :4, :].clone(), d,
                                out=d)
    assert got.data_ptr() == d.data_ptr() and torch.equal(d, want)
    with pytest.raises(ValueError, match="alias"):
        p_minplus.minplus_acc(d[:, :, :4], w[:, :4, :], d, out=d)
    with pytest.raises(ValueError, match="alias"):
        p_minplus.minplus_acc(w[:, :, :4], d[:, 4:8, :], d, out=d)


def _grads_ref(a, b, scale=1.0):
    f = lambda ab: r_ops.minplus_matmul(ab[0] * scale, ab[1] * scale,  # noqa: E731
                                        128, True).sum()
    ga, gb = jax.grad(f)((jnp.asarray(a), jnp.asarray(b)))
    return np.asarray(ga), np.asarray(gb)


def _grads_port(a, b, scale=1.0):
    ta = _t(a).requires_grad_(True)
    tb = _t(b).requires_grad_(True)
    p_ops.minplus_matmul(ta * scale, tb * scale).sum().backward()
    return ta.grad.numpy(), tb.grad.numpy()


def test_minplus_backward_matches_reference():
    rng = np.random.default_rng(0)
    # quantized entries make ties real: the argmin masks must agree
    a = (np.round(rng.uniform(0, 5, (8, 8)) * 2) / 2).astype(np.float32)
    b = (np.round(rng.uniform(0, 5, (8, 8)) * 2) / 2).astype(np.float32)
    for ref, got in zip(_grads_ref(a, b), _grads_port(a, b)):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_minplus_gradient_tie_tolerance_is_scale_invariant():
    """The reference's tie test (test_kernels.py): scaling every length
    never changes which paths are shortest, so the subgradient pattern
    must match at tiny scale (cotangents scale linearly)."""
    rng = np.random.default_rng(3)
    a = (rng.uniform(0.1, 1.0, (8, 8)) * 5).astype(np.float32)
    b = (rng.uniform(0.1, 1.0, (8, 8)) * 5).astype(np.float32)
    g_unit = _grads_port(a, b, 1.0)
    g_tiny = _grads_port(a, b, 1e-6)
    for tiny, unit in zip(g_tiny, g_unit):
        np.testing.assert_allclose(tiny, unit * 1e-6, rtol=1e-4)
    for ref, got in zip(_grads_ref(a, b, 1e-6), g_tiny):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-12)


# ---------------------------------------------------------------------------
# K2 + blocked Floyd-Warshall
# ---------------------------------------------------------------------------

def test_blocked_fw_bit_equal_to_pallas_tiles():
    w = _w(32, 3)
    ref = np.asarray(r_fw.fw_apsp_pallas(jnp.asarray(w), t=8, chunk=8,
                                         interpret=True))
    got = p_fw.fw_apsp_blocked(_t(w)[None], t=8)[0].numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(p_fw.fw_apsp_plain(_t(w)).numpy(),
                          np.asarray(r_fw.fw_apsp_jnp(jnp.asarray(w))))


def test_blocked_fw_ragged_padded_and_single_tile():
    w = _w(21, 5)
    pad = np.full((24, 24), _INF, np.float32)
    pad[:21, :21] = w
    got = p_fw.fw_apsp_blocked(_t(pad)[None], t=8)[0, :21, :21].numpy()
    assert np.array_equal(got, np.asarray(r_fw.fw_apsp_jnp(jnp.asarray(w))))
    one = _w(16, 4)
    ref = np.asarray(r_fw.fw_apsp_pallas(jnp.asarray(one), t=16, chunk=8,
                                         interpret=True))
    assert np.array_equal(p_fw.fw_apsp_blocked(_t(one)[None], t=16)[0]
                          .numpy(), ref)
    with pytest.raises(ValueError, match="multiple of the"):
        p_fw.fw_apsp_blocked(torch.zeros(1, 10, 10), t=4)


def test_fw_pivot_plain_is_in_place_tile_closure():
    tiles = _t(np.stack([_w(8, s) for s in range(4)]))
    want = np.stack([np.asarray(r_fw.fw_tile_closure(jnp.asarray(x)))
                     for x in tiles.numpy()])
    d = torch.full((4, 16, 16), _INF)
    d[:, 4:12, 4:12] = tiles
    p_fw.fw_pivot(d[:, 4:12, 4:12])
    assert np.array_equal(d[:, 4:12, 4:12].numpy(), want)
    assert torch.all(d[:, :4] == _INF)


# ---------------------------------------------------------------------------
# K3: ELL Jacobi round
# ---------------------------------------------------------------------------

def _ell_case(n, seed):
    w = _w(n, seed, p=0.2)
    d_max = max(1, int(((w < _INF / 2) & ~np.eye(n, dtype=bool))
                       .sum(axis=0).max()))
    idx, wgt = p_apsp._pack_ell(_t(w)[None], d_max)
    return w, idx, wgt


def test_plain_ell_round_bit_equal_to_pallas_round():
    w, idx, wgt = _ell_case(32, 7)
    m = p_ell._full_init(idx, wgt)
    ref_m, ref_flags = r_ell.ell_relax_round_pallas(
        jnp.asarray(m[0].numpy()), jnp.asarray(idx[0].numpy()),
        jnp.asarray(wgt[0].numpy()), tile=p_ell.TILE, interpret=True)
    got_m, got_flags = p_ell.ell_relax_round_plain(m, idx, wgt)
    assert np.array_equal(got_m[0].numpy(), np.asarray(ref_m))
    # flags are per (target tile, source span); a tile changed iff any span
    assert np.array_equal(got_flags[0].any(dim=1).numpy(),
                          np.asarray(ref_flags))
    assert got_flags.shape == (1, 32 // p_ell.TILE, 1)
    # the wrapper takes the plain version on CPU tensors
    wm, wf = p_ell.ell_relax_round(m, idx, wgt)
    assert torch.equal(wm, got_m) and torch.equal(wf, got_flags)


@pytest.mark.parametrize("n,s", [(40, 13), (40, 45), (64, 33)])
def test_plain_ell_flags_on_ragged_sources_match_pallas_tiles(n, s):
    """A carry of S sources that is not a multiple of SPAN: the plain round
    equals the reference's Pallas round, and its flags, one per (TILE
    targets, SPAN sources) patch with the last span ragged, OR over the
    spans to the reference's per-tile flags and equal each patch's own
    change."""
    _, idx, wgt = _ell_case(n, s)
    m = p_ell._full_init(idx, wgt)[:, :, :s].contiguous()
    ref_m, ref_flags = r_ell.ell_relax_round_pallas(
        jnp.asarray(m[0].numpy()), jnp.asarray(idx[0].numpy()),
        jnp.asarray(wgt[0].numpy()), tile=p_ell.TILE, interpret=True)
    got_m, got_flags = p_ell.ell_relax_round_plain(m, idx, wgt)
    assert np.array_equal(got_m[0].numpy(), np.asarray(ref_m))
    nt, ns = n // p_ell.TILE, -(-s // p_ell.SPAN)
    assert got_flags.shape == (1, nt, ns)
    assert np.array_equal(got_flags[0].any(dim=1).numpy(),
                          np.asarray(ref_flags))
    ch = (got_m < m)[0].numpy()
    t, sp = p_ell.TILE, p_ell.SPAN
    want = [[ch[i * t:(i + 1) * t, j * sp:(j + 1) * sp].any()
             for j in range(ns)] for i in range(nt)]
    assert np.array_equal(got_flags[0].numpy(), np.array(want))


def test_ell_init_matches_reference_and_rounds_are_jacobi():
    w, idx, wgt = _ell_case(27, 2)     # ragged against TILE
    m0 = p_ell._full_init(idx, wgt)[0].numpy()
    ref0 = np.asarray(r_ell._full_init(jnp.asarray(idx[0].numpy()),
                                       jnp.asarray(wgt[0].numpy())))
    assert np.array_equal(m0, ref0)
    d, rounds = p_ell.ell_bf_apsp(idx, wgt)
    assert np.array_equal(d[0].numpy(),
                          np.asarray(r_fw.fw_apsp_jnp(jnp.asarray(w))))
    # round count of a numpy Jacobi schedule (the last round reports no
    # change), not the reference's Gauss-Seidel CPU sweep
    m, jac = m0.astype(np.float64), 0
    i, g = idx[0].numpy(), wgt[0].numpy().astype(np.float64)
    while True:
        new = np.minimum(m, (g[:, :, None] + m[i]).min(axis=1))
        jac += 1
        if np.array_equal(new, m):
            break
        m = new
    assert rounds == jac
    capped, two = p_ell.ell_bf_apsp(idx, wgt, max_rounds=2)
    assert two == 2


def test_ell_round_validates_tables():
    _, idx, wgt = _ell_case(16, 1)
    m = p_ell._full_init(idx, wgt)
    with pytest.raises(ValueError, match="int32/float32"):
        p_ell.ell_relax_round(m, idx.long(), wgt)
    with pytest.raises(ValueError, match="does not match"):
        p_ell.ell_relax_round(m[:, :8], idx, wgt)
