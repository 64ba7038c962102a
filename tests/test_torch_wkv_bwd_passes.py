"""K5b's three passes in torch (``kernels/wkv.py``): the state sweep, the
cotangent sweep and the chunk pass that ``wkv_chunked_bwd_plain`` runs, as
the kernel runs them, each held on its own against autograd through the
forward ``wkv_chunked_plain``; and the kernel's constants.  The whole
backward is held against autograd and the reference's jax.vjp in
``tests/test_torch_lm_kernels.py``, the kernel against it on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 17a."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import wkv as p_wkv  # noqa: E402

# float32 algebra summed in another order than autograd's (the file's
# other tolerances: tests/test_torch_lm_kernels.py BWD_AUTOGRAD_REL)
REL = 1e-5
C = p_wkv.CHUNK


def _inputs(seed, bh, t, n):
    rng = np.random.default_rng(seed)
    r, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, n)).astype(
        np.float32)) for _ in range(4))
    log_w = -torch.from_numpy(np.clip(np.exp(rng.standard_normal(
        (bh, t, n))), 1e-6, 2.5).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((bh, n)) * 0.5).astype(
        np.float32))
    s0 = torch.from_numpy((rng.standard_normal((bh, n, n)) * 0.3).astype(
        np.float32))
    ds = torch.from_numpy(rng.standard_normal((bh, n, n)).astype(np.float32))
    return r, k, v, log_w, u, s0, do, ds


def _close(got, want, what):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=REL, atol=REL * scale + 1e-30,
                               msg=what)


def _passes(r, k, v, log_w, u, s0, do, ds):
    """The three passes as ``wkv_chunked_bwd_plain`` runs them."""
    bh, _, n = r.shape
    xs, exps = p_wkv._bwd_chunks(r, k, v, log_w, do)
    rs, ks, vs, _, dos = xs
    e_r, _, e_s, e_t = exps
    sc = p_wkv._bwd_state_sweep(ks * e_s, vs, e_t, s0)
    dsc, ds0 = p_wkv._bwd_cotangent_sweep(rs * e_r, dos, e_t, ds)
    grads = p_wkv._bwd_chunk_pass(xs, exps, u.reshape(bh, 1, 1, n), sc, dsc)
    return sc, dsc, ds0, grads


@pytest.mark.parametrize("t", [96, 77])
def test_state_sweep_gives_the_forward_state_at_every_chunk_start(t):
    """S_c is the state the forward carries into chunk c: the final state
    of ``wkv_chunked_plain`` over the first c chunks."""
    r, k, v, log_w, u, s0, do, ds = _inputs(t, 2, t, 8)
    sc, _, _, _ = _passes(r, k, v, log_w, u, s0, do, ds)
    assert sc.shape == (2, -(-t // C), 8, 8)
    _close(sc[:, 0], s0, "S_0")
    for c in range(1, sc.shape[1]):
        _, want = p_wkv.wkv_chunked_plain(r[:, :c * C], k[:, :c * C],
                                          v[:, :c * C], log_w[:, :c * C], u,
                                          s0)
        _close(sc[:, c], want, f"S_{c}")


@pytest.mark.parametrize("t", [96, 77])
def test_cotangent_sweep_gives_the_gradient_of_each_chunk_end_state(t):
    """dS_c is the gradient of the loss <o, dO> + <S_T, dS_T> with respect
    to the state leaving chunk c: autograd through ``wkv_chunked_plain``
    over the chunks after c, started from that state; ds0 is the gradient
    with respect to s0."""
    r, k, v, log_w, u, s0, do, ds = _inputs(t + 1, 2, t, 8)
    sc, dsc, ds0, _ = _passes(r, k, v, log_w, u, s0, do, ds)
    nc = sc.shape[1]
    for c in range(nc):
        t1 = (c + 1) * C
        if t1 >= t:                       # the last chunk ends at S_T
            _close(dsc[:, c], ds, f"dS_{c}")
            continue
        start = (sc[:, c + 1]).clone().requires_grad_(True)
        o, s = p_wkv.wkv_chunked_plain(r[:, t1:], k[:, t1:], v[:, t1:],
                                       log_w[:, t1:], u, start)
        (want,) = torch.autograd.grad((o, s), (start,), (do[:, t1:], ds))
        _close(dsc[:, c], want, f"dS_{c}")
    start = s0.clone().requires_grad_(True)
    o, s = p_wkv.wkv_chunked_plain(r, k, v, log_w, u, start)
    (want,) = torch.autograd.grad((o, s), (start,), (do, ds))
    _close(ds0, want, "ds0")


@pytest.mark.parametrize("t", [64, 45])
def test_chunk_pass_gives_each_chunks_own_gradients(t):
    """Given its start state and its end cotangent, each chunk's dr, dk,
    dv, dlog w and du are those of ``wkv_chunked_plain`` over that chunk
    alone, by autograd with the state as s0 and the cotangent as dS_T: no
    chunk needs another's work."""
    r, k, v, log_w, u, s0, do, ds = _inputs(t + 2, 2, t, 8)
    sc, dsc, _, (dr, dk, dv, dw, du) = _passes(r, k, v, log_w, u, s0, do, ds)
    du_want = torch.zeros_like(du)
    for c in range(sc.shape[1]):
        t0, t1 = c * C, min(t, (c + 1) * C)
        ins = [x[:, t0:t1].clone().requires_grad_(True)
               for x in (r, k, v, log_w)]
        uu = u.clone().requires_grad_(True)
        o, s = p_wkv.wkv_chunked_plain(*ins, uu, sc[:, c])
        want = torch.autograd.grad((o, s), (*ins, uu),
                                   (do[:, t0:t1], dsc[:, c]))
        for name, g, w in zip(("dr", "dk", "dv", "dlog_w"),
                              (dr, dk, dv, dw), want):
            _close(g[:, c, :t1 - t0], w, f"{name} of chunk {c}")
        du_want += want[4]
    _close(du, du_want, "du")


def test_wkv_bwd_constants_match_kernel_source():
    """The kernel's chunk and largest head size are the wrapper's; it keeps
    no atomics, and its du partials are 64 wide (the wrapper's scratch)."""
    src = (_build.SOURCES[0].parent / "wkv_bwd.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["C"]) == p_wkv.CHUNK
    assert int(const["NP"]) == p_wkv.N_MAX
    assert "atomicAdd" not in src
    assert 'extern "C" int wkv_chunked_bwd(' in src
    for kernel in ("wkv_bwd_sweep", "wkv_bwd_chunk", "wkv_bwd_du"):
        assert f"{kernel}(" in src
