"""The port's K4 (flash attention) and K5 (chunked WKV-6) modules against
the reference.

On the CPU each wrapper runs its kernel's plain torch version.  Each is
held against the reference's Pallas kernel in interpret mode, against the
reference's plain oracle (``repro.kernels.ref``) and against the jnp
function the reference's models run in its place (``transformer.
_attention_decode``, ``layers.attention``, ``rwkv6._wkv_chunked``).  Inputs
are made with numpy from explicit seeds and handed to both packages.  The
CUDA kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as r_flash  # noqa: E402
from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import rwkv6 as r_rwkv6  # noqa: E402
from repro.models import transformer as r_tfm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as p_flash  # noqa: E402
from repro_torch.kernels import ops as p_ops  # noqa: E402
from repro_torch.kernels import wkv as p_wkv  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import rwkv6 as p_rwkv6  # noqa: E402

# float32 attention: the same softmax in both packages, summed in another
# order (the reference's own kernel-vs-oracle tolerance, test_kernels.py)
ATOL, RTOL = 2e-5, 1e-4


def _normal(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _qkv(seed, b, lq, lk, hq, hkv, d):
    return (_normal(seed, b, lq, hq, d), _normal(seed + 1, b, lk, hkv, d),
            _normal(seed + 2, b, lk, hkv, d))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal", [
    (1, 128, 128, 4, 4, 64, True),
    (2, 256, 256, 8, 2, 64, True),
    (1, 256, 256, 4, 1, 128, True),     # MQA
    (2, 128, 256, 4, 4, 64, True),      # cross lengths (cached prefix)
    (1, 256, 256, 4, 4, 64, False),
    (1, 200, 300, 4, 2, 64, True),      # non-multiple-of-tile
])
def test_plain_flash_matches_pallas_and_ref(b, lq, lk, hq, hkv, d, causal):
    q, k, v = _qkv(lq + lk, b, lq, lk, hq, hkv, d)
    got = p_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    pallas = np.asarray(r_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    oracle = np.asarray(r_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


def test_plain_flash_bf16_matches_ref():
    q, k, v = _qkv(5, 1, 128, 128, 4, 2, 64)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(r_ref.flash_attention_ref(qb, kb, vb, causal=True),
                      np.float32)
    # the same bf16-rounded inputs in both packages
    tq, tk, tv = (_t(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (qb, kb, vb))
    got = p_ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    # both round a float32 softmax to bf16 (8 mantissa bits): the
    # reference's own bf16 tolerance
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("kv_len", [1, 37, 64])
def test_plain_flash_decode_matches_attention_decode(kv_len):
    """Lq = 1 over a cache of 64 whose first ``kv_len`` positions are
    valid (the rest hold junk that must not count), as a decode step runs
    it: K4 with lk_valid = pos + 1."""
    q, k, v = _qkv(kv_len, 2, 1, 64, 6, 2, 32)
    got = p_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                lk_valid=kv_len).numpy()
    want = np.asarray(r_tfm._attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_len,
        q_offset=kv_len - 1))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_flash_valid_prefix_matches_blockwise_attention():
    """Several queries at the end of a valid prefix of the keys: the
    reference's blockwise jnp attention with q_offset = kv_len - Lq."""
    q, k, v = _qkv(11, 2, 24, 96, 4, 2, 32)
    got = p_layers.attention(_t(q), _t(k), _t(v), causal=True,
                             kv_len=70).numpy()
    want = np.asarray(r_layers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=70 - 24, kv_len=70, block=32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_flash_fully_masked_rows_give_zero():
    """Lq > lk_valid: the first queries see no key; the Pallas kernel
    (called directly, tile-aligned) gives 0 there, not NaN."""
    q, k, v = _qkv(13, 1, 128, 128, 2, 1, 64)
    got = p_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                lk_valid=64).numpy()
    want = np.asarray(r_flash.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        lk_valid=64, interpret=True))
    assert np.all(np.isfinite(got))
    assert np.array_equal(got[:, :64], np.zeros_like(got[:, :64]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_flash_wrapper_checks_and_windowed_attention_raises():
    q, k, v = (_t(x) for x in _qkv(3, 1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="lk_valid"):
        p_ops.flash_attention(q, k, v, lk_valid=9)
    with pytest.raises(ValueError, match="query heads"):
        p_ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        p_layers.attention(q, k, v, window=-1)


# K4 route "decode": the split-KV algebra (flash-decoding) in torch
SPLIT = p_flash.DECODE_SPLIT


@pytest.mark.parametrize("lk_valid", [1, 63, 64, 65, 127, 128, 129, 1001])
@pytest.mark.parametrize("hq,hkv,d", [(2, 2, 16), (6, 2, 64), (24, 8, 128)])
def test_split_plain_decode_matches_flash_plain_and_attention_decode(
        lk_valid, hq, hkv, d):
    """One decode step (Lq = 1) over a cache with at least one split wholly
    past lk_valid: the split partials merged in order equal the one-pass
    softmax and the reference's ``_attention_decode``; the splits past
    lk_valid hold m = -1e30, l = 0."""
    lk = SPLIT * (-(-lk_valid // SPLIT) + 1)
    q, k, v = _qkv(lk_valid + d, 2, 1, lk, hq, hkv, d)
    got = p_flash.flash_attention_split_plain(_t(q), _t(k), _t(v),
                                              lk_valid=lk_valid).numpy()
    want = p_flash.flash_attention_plain(_t(q), _t(k), _t(v),
                                         lk_valid=lk_valid).numpy()
    ref = np.asarray(r_tfm._attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=lk_valid,
        q_offset=lk_valid - 1))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    acc, m, l = p_flash.flash_split_partials_plain(_t(q), _t(k), _t(v),
                                                   lk_valid=lk_valid)
    assert acc.shape == (2, hkv, lk // SPLIT, hq // hkv, d)
    past = -(-lk_valid // SPLIT)      # first split wholly past lk_valid
    assert past < lk // SPLIT
    assert bool((m[:, :, past:] == p_flash.NEG).all())
    assert bool((l[:, :, past:] == 0).all())
    assert bool((l[:, :, :past] >= 1).all())   # the max's own term is 1


@pytest.mark.parametrize("lq,hq,hkv,lk,lk_valid", [
    (4, 4, 1, 64, 2),       # the first two queries see no key
    (5, 3, 1, 200, 130),    # 15 rows, keys over three splits
    (16, 2, 2, 64, 64),     # 16 rows, g = 1, one full split
])
def test_split_plain_short_prefill_matches_pallas(lq, hq, hkv, lk, lk_valid):
    """Up to 16 rows of (query, group head) take route "decode" also at
    prefill: the causal mask per row, rows that see no key give 0; against
    the reference's Pallas kernel in interpret mode."""
    q, k, v = _qkv(lq * lk, 1, lq, lk, hq, hkv, 16)
    got = p_flash.flash_attention_split_plain(_t(q), _t(k), _t(v),
                                              lk_valid=lk_valid).numpy()
    pad = (-lk) % 64
    kp, vp = (np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))) for x in (k, v))
    want = np.asarray(r_flash.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), causal=True,
        lk_valid=lk_valid, bq=lq, bk=64, interpret=True))
    assert np.all(np.isfinite(got))
    blind = max(0, lq - lk_valid)     # queries before the first valid key
    assert np.array_equal(got[:, :blind], np.zeros_like(got[:, :blind]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_split_combine_skips_splits_that_saw_nothing():
    """The combine never reads the acc of a split with l = 0 (the kernel
    leaves it unwritten), and a row no split saw gives 0."""
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.standard_normal((1, 1, 3, 2, 4)).astype(
        np.float32))
    m = torch.tensor([[[[0.5, p_flash.NEG], [p_flash.NEG, p_flash.NEG],
                        [2.0, p_flash.NEG]]]])
    l = torch.tensor([[[[1.5, 0.0], [0.0, 0.0], [3.0, 0.0]]]])
    acc[:, :, 1] = float("nan")
    acc[:, :, :, 1] = float("nan")
    got = p_flash.flash_split_combine_plain(acc, m, l)
    w0, w2 = np.exp(0.5 - 2.0), 1.0
    want = (w0 * acc[0, 0, 0, 0] + w2 * acc[0, 0, 2, 0]) / (w0 * 1.5 + 3.0)
    torch.testing.assert_close(got[0, 0, 0], want)
    assert torch.equal(got[0, 0, 1], torch.zeros(4))


@pytest.mark.parametrize("dtype,lq,g,route", [
    (torch.bfloat16, 1, 3, "decode"),      # minitron-4b decode step
    (torch.float32, 1, 3, "decode"),
    (torch.bfloat16, 1, 16, "decode"),     # 16 rows: still route B
    (torch.bfloat16, 1, 48, "mma"),        # granite-20b (MQA) decode step
    (torch.float32, 1, 48, "f32"),
    (torch.bfloat16, 5, 3, "decode"),      # a short prefill, 15 rows
    (torch.bfloat16, 6, 3, "mma"),         # 18 rows
    (torch.bfloat16, 1000, 3, "mma"),      # minitron-4b prefill
    (torch.float32, 1000, 3, "f32"),       # the float32 4-layer check
])
def test_flash_route_by_dtype_and_rows(dtype, lq, g, route):
    assert p_flash.flash_route(dtype, lq, g) == route


def test_decode_constants_match_kernel_sources():
    """The wrapper sizes route B's scratch from DECODE_SPLIT and picks it up
    to DECODE_ROWS rows: both must be the kernel's own constants."""
    import re
    src = (_build.SOURCES[0].parent / "flash_decode.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["SPLIT"]) == p_flash.DECODE_SPLIT
    assert int(const["RMAX"]) == p_flash.DECODE_ROWS
    assert int(const["DMAX"]) == p_flash.D_MAX
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in (
        _build.SOURCES[0].parent / "flash_attention_mma.cu").read_text()


# ---------------------------------------------------------------------------
# K5: chunked WKV-6
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, bh, t, n):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, t, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.clip(np.exp(rng.standard_normal((bh, t, n))), 1e-6,
                     2.5).astype(np.float32)
    u = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return r, k, v, log_w, u


WKV_SHAPES = [(2, 64, 16), (3, 70, 32), (1, 32, 64)]


@pytest.mark.parametrize("bh,t,n", WKV_SHAPES)
def test_plain_wkv_matches_pallas_and_serial_ref(bh, t, n):
    r, k, v, log_w, u = _wkv_inputs(t + n, bh, t, n)
    got, _ = p_ops.wkv_chunked(*map(_t, (r, k, v, log_w, u)))
    js = [jnp.asarray(x) for x in (r, k, v, log_w, u)]
    pallas = np.asarray(r_ops.wkv_chunked(*js, interpret=True))
    serial = np.asarray(r_ref.wkv_ref(*js))
    # the same chunked float32 algebra as the Pallas kernel, summed in
    # another order; exponents up to +-80 within a chunk scale the
    # rounding of exp, so relative 1e-4
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)
    # chunked vs the serial scan: the reference's own tolerance
    np.testing.assert_allclose(got.numpy(), serial, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("bh,t,n", WKV_SHAPES)
def test_plain_wkv_with_state_matches_rwkv6_chunked(bh, t, n):
    """A non-zero s0 in, s_final out, per-lane bonus: against the model's
    jnp ``_wkv_chunked`` (lanes as heads of one batch row), with a ragged
    T padded for the reference as its ``_time_mix`` pads it."""
    r, k, v, log_w, _ = _wkv_inputs(7 * t + n, bh, t, n)
    rng = np.random.default_rng(t * n)
    u = (rng.standard_normal((bh, n)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((bh, n, n)) * 0.3).astype(np.float32)
    got_o, got_s = p_ops.wkv_chunked(*map(_t, (r, k, v, log_w, u, s0)))
    pad = (-t) % p_wkv.CHUNK
    lay = [jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0))).transpose(
        1, 0, 2)[None]) for x in (r, k, v, log_w)]          # [1, T, BH, n]
    want_o, want_s = r_rwkv6._wkv_chunked(*lay, jnp.asarray(u),
                                          jnp.asarray(s0)[None])
    want_o = np.asarray(want_o)[0, :t].transpose(1, 0, 2)
    # same chunked algebra, another summation order (see above)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s)[0],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("u_kind", ["shared", "head", "lane"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 31, 33, 45])
def test_plain_wkv_on_head_views_matches_rwkv6_chunked(t, with_state, u_kind):
    """``wkv_chunked_plain`` on strided [B, H, T, n] views of [B, T, H, n]
    projections (the model's layout) with u [n], [H, n] or [B, H, n]:
    against the reference's jnp ``_wkv_chunked`` on the projections,
    T padded for it as its ``_time_mix`` pads it (per batch row where u
    differs by row)."""
    b, h, n = 2, 3, 8
    rng = np.random.default_rng(100 * t + 7 * with_state + len(u_kind))
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.clip(np.exp(rng.standard_normal((b, t, h, n))), 1e-6,
                     2.5).astype(np.float32)
    u = (rng.standard_normal({"shared": (n,), "head": (h, n),
                              "lane": (b, h, n)}[u_kind]) * 0.5
         ).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, n)) * 0.3).astype(np.float32) \
        if with_state else None
    views = [_t(x).permute(0, 2, 1, 3) for x in (r, k, v, log_w)]
    got_o, got_s = p_wkv.wkv_chunked_plain(
        *views, _t(u), None if s0 is None else _t(s0))
    assert got_o.shape == (b, h, t, n) and got_s.shape == (b, h, n, n)
    pad = (-t) % p_wkv.CHUNK
    lay = [np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
           for x in (r, k, v, log_w)]
    s_in = s0 if with_state else np.zeros((b, h, n, n), np.float32)
    uu = np.broadcast_to(u, (b, h, n))
    for row in range(b):
        want_o, want_s = r_rwkv6._wkv_chunked(
            *(jnp.asarray(x[row:row + 1]) for x in lay), jnp.asarray(uu[row]),
            jnp.asarray(s_in[row:row + 1]))
        # the same chunked algebra, another summation order (see above)
        np.testing.assert_allclose(
            got_o[row].permute(1, 0, 2).numpy(), np.asarray(want_o)[0, :t],
            atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_s[row].numpy(),
                                   np.asarray(want_s)[0], atol=1e-4,
                                   rtol=1e-4)


def test_model_wkv_folds_heads_into_lanes():
    """The port's ``rwkv6._wkv_chunked`` ([B, T, H, n] with u [H, n])
    equals the reference's on two batch rows of three heads."""
    b, t, h, n = 2, 45, 3, 8
    rng = np.random.default_rng(17)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.clip(np.exp(rng.standard_normal((b, t, h, n))), 1e-6,
                     2.5).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    got_o, got_s = p_rwkv6._wkv_chunked(*map(_t, (r, k, v, log_w, u, s0)))
    pad = (-t) % p_wkv.CHUNK
    lay = [jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))))
           for x in (r, k, v, log_w)]
    want_o, want_s = r_rwkv6._wkv_chunked(*lay, jnp.asarray(u),
                                          jnp.asarray(s0))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o)[:, :t],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=1e-4, rtol=1e-4)


def test_cpu_tensors_never_launch_lm_kernels():
    before = dict(_build.LAUNCHES)
    q, k, v = (_t(x) for x in _qkv(1, 1, 16, 16, 2, 1, 16))
    p_ops.flash_attention(q, k, v, site="full")
    p_flash.flash_attention(q, k, v)
    p_flash.flash_attention(q[:, :1], k, v, lk_valid=9)   # a decode shape
    p_ops.wkv_chunked(*map(_t, _wkv_inputs(2, 2, 40, 8)))
    assert _build.LAUNCHES == before
    assert "flash_attention/full" not in _build.SITE_LAUNCHES
    assert not any(key.startswith("flash_attention/route:")
                   for key in _build.SITE_LAUNCHES)


# ---------------------------------------------------------------------------
# K4b and K5b: the backward algebra (plain versions) on the CPU
# ---------------------------------------------------------------------------

# float32 both sides, summed in another order: relative to each gradient's
# largest entry, 1e-5 against torch autograd of the plain forward (the same
# softmax and chunk algebra), 1e-4 against jax.vjp of the reference's jnp
# functions (another framework's sums, as the forward tolerance above)
BWD_AUTOGRAD_REL, BWD_JAX_REL = 1e-5, 1e-4


def _close_rel(got, want, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale + 1e-30,
                               err_msg=what)


FLASH_BWD_CASES = [
    # b, lq, lk, hq, hkv, d, causal, lk_valid, window
    (2, 24, 24, 4, 2, 16, True, None, 0),       # causal GQA
    (1, 24, 40, 6, 2, 16, True, 30, 0),         # Lq < lk_valid < Lk
    (1, 40, 40, 2, 1, 16, True, 20, 0),         # rows that see no key
    (1, 37, 37, 4, 1, 32, True, None, 8),       # local window
    (1, 20, 20, 2, 1, 256, True, None, 0),      # D = 256
    (2, 16, 24, 4, 4, 16, False, None, 0),      # not causal
]


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,lk_valid,window",
                         FLASH_BWD_CASES)
def test_flash_bwd_plain_matches_autograd(b, lq, lk, hq, hkv, d, causal,
                                          lk_valid, window):
    q, k, v = (_t(x).requires_grad_(True)
               for x in _qkv(lq + d, b, lq, lk, hq, hkv, d))
    kw = dict(causal=causal, lk_valid=lk_valid, window=window)
    o = p_flash.flash_attention_plain(q, k, v, **kw)
    do = _t(_normal(7, *o.shape))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = p_flash.flash_attention_bwd_plain(q.detach(), k.detach(),
                                            v.detach(), o.detach(), do, **kw)
    for name, g, w in zip("qkv", got, want):
        _close_rel(g, w, BWD_AUTOGRAD_REL, f"d{name}")
    if lk_valid is not None and lk_valid < lq:          # unseeing rows
        assert float(got[0][:, :lq - lk_valid].abs().max()) == 0.0
    if lk_valid is not None and lk_valid < lk:          # keys past lk_valid
        assert float(got[1][:, lk_valid:].abs().max()) == 0.0


@pytest.mark.parametrize("lq,hq,hkv,d,window,block", [
    (24, 4, 2, 16, 0, 8),        # causal GQA, blockwise
    (37, 4, 1, 16, 8, 16),       # window: the reference's banded branch
    (20, 2, 1, 256, 0, 8),       # D = 256
    (21, 10, 1, 32, 9, 32),      # window, g = 10, one block
])
def test_flash_bwd_plain_matches_reference_vjp(lq, hq, hkv, d, window,
                                               block):
    """The gradients of the reference's jnp attention (the function K4
    stands in for in its models), by jax.vjp."""
    q, k, v = _qkv(3 * lq + d, 2, lq, lq, hq, hkv, d)
    do = _normal(11, 2, lq, hq, d)

    def ref(q_, k_, v_):
        return r_layers.attention(q_, k_, v_, causal=True, window=window,
                                  block=block)

    o, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = p_flash.flash_attention_bwd_plain(
        *map(_t, (q, k, v)), _t(np.array(o)), _t(do), causal=True,
        window=window)
    for name, g, w in zip("qkv", got, want):
        _close_rel(g, w, BWD_JAX_REL, f"d{name}")


def test_flash_attention_backward_runs_the_plain_backward_on_cpu(
        monkeypatch):
    """A gradient through the wrapper goes through the autograd function,
    whose backward on CPU tensors is ``flash_attention_bwd_plain``; no
    kernel launches."""
    calls = []
    plain = p_flash.flash_attention_bwd_plain

    def spy(*args, **kw):
        calls.append(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(p_flash, "flash_attention_bwd_plain", spy)
    before = dict(_build.LAUNCHES)
    q, k, v = (_t(x).requires_grad_(True)
               for x in _qkv(5, 1, 12, 12, 4, 2, 16))
    o = p_ops.flash_attention(q, k, v, window=5, site="full")
    assert o.grad_fn is not None
    o.square().sum().backward()
    assert len(calls) == 1 and calls[0]["window"] == 5
    q2, k2, v2 = (x.detach().requires_grad_(True) for x in (q, k, v))
    p_flash.flash_attention_plain(q2, k2, v2, window=5).square().sum() \
        .backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        _close_rel(a.grad, b.grad.numpy(), BWD_AUTOGRAD_REL, "grad")
    assert _build.LAUNCHES == before


def _wkv_grad_inputs(seed, lead, t, n, u_shape, with_state):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(lead + (t, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.clip(np.exp(rng.standard_normal(lead + (t, n))), 1e-6,
                     2.5).astype(np.float32)
    u = (rng.standard_normal(u_shape) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal(lead + (n, n)).astype(np.float32) * 0.3
          if with_state else None)
    return r, k, v, log_w, u, s0


@pytest.mark.parametrize("lead,t,n,u_kind,with_state", [
    ((2,), 64, 8, "shared", False),
    ((3,), 45, 16, "lane", True),        # ragged T, a state in
    ((2, 3), 33, 8, "head", True),       # [B, H, T, n], u per head
    ((1, 2), 1, 8, "shared", True),      # one step
])
def test_wkv_bwd_plain_matches_autograd(lead, t, n, u_kind, with_state):
    u_shape = {"shared": (n,), "lane": lead + (n,),
               "head": lead[1:] + (n,)}[u_kind]
    arrays = _wkv_grad_inputs(t + n, lead, t, n, u_shape, with_state)
    ins = [None if x is None else _t(x).requires_grad_(True) for x in arrays]
    o, s = p_wkv.wkv_chunked_plain(*ins)
    do = _t(_normal(3, *o.shape))
    ds = _t(_normal(4, *s.shape))
    live = [x for x in ins if x is not None]
    want = torch.autograd.grad((o, s), live, (do, ds))
    got = p_wkv.wkv_chunked_bwd_plain(*(None if x is None else x.detach()
                                        for x in ins), do, ds)
    assert (got[5] is None) == (not with_state)
    assert tuple(got[4].shape) == u_shape
    for name, g, w in zip(("r", "k", "v", "log_w", "u", "s0"),
                          [x for x in got if x is not None], want):
        _close_rel(g, w, BWD_AUTOGRAD_REL, f"d{name}")


@pytest.mark.parametrize("t", [64, 45])
def test_wkv_bwd_plain_matches_reference_vjp(t):
    """The gradients of the reference's jnp ``rwkv6._wkv_chunked`` (the
    function K5 stands in for; a ragged T padded as its ``_time_mix``
    pads it) by jax.vjp, through the port's ``rwkv6._wkv_chunked`` on
    [B, T, H, n] with u [H, n] and a non-zero s0."""
    b, h, n = 2, 3, 8
    rng = np.random.default_rng(t)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    log_w = -np.clip(np.exp(rng.standard_normal((b, t, h, n))), 1e-6,
                     2.5).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32) * 0.3
    do = _normal(5, b, t, h, n)
    ds = _normal(6, b, h, n, n)
    pad = (-t) % p_wkv.CHUNK

    def ref(r_, k_, v_, w_, u_, s_):
        lay = [jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
               for x in (r_, k_, v_, w_)]
        o, s = r_rwkv6._wkv_chunked(*lay, u_, s_)
        return o[:, :t], s

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (r, k, v, log_w, u, s0)))
    want = vjp((jnp.asarray(do), jnp.asarray(ds)))
    ins = [_t(x).requires_grad_(True) for x in (r, k, v, log_w, u, s0)]
    o, s = p_rwkv6._wkv_chunked(*ins)
    got = torch.autograd.grad((o, s), ins, (_t(do), _t(ds)))
    for name, g, w in zip(("r", "k", "v", "log_w", "u", "s0"), got, want):
        _close_rel(g, w, BWD_JAX_REL, f"d{name}")


def test_wkv_backward_runs_the_plain_backward_on_cpu(monkeypatch):
    calls = []
    plain = p_wkv.wkv_chunked_bwd_plain

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(p_wkv, "wkv_chunked_bwd_plain", spy)
    before = dict(_build.LAUNCHES)
    ins = [_t(x).requires_grad_(True) for x in _wkv_inputs(8, 2, 40, 8)]
    o, s = p_ops.wkv_chunked(*ins)
    assert o.grad_fn is not None
    o.sum().backward()
    assert calls == [torch.Size([2, 40, 8])]
    assert all(x.grad is not None for x in ins)
    assert _build.LAUNCHES == before
