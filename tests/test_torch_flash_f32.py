"""K4's route "f32" (float32 on the tensor cores, S = Q K^T and P V as
3xTF32) in torch: its rounding, ``flash_attention_tf32_plain``, held
against the plain version and against the reference's Pallas kernel (in
interpret mode) and jnp attention; that one TF32 rounding would not do;
and the kernel's constants.  The kernel is held against both plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 6."""
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as r_flash  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as p_flash  # noqa: E402

# K4's float32 tolerance (chip_smoke.K4_F32_TOL)
ATOL, RTOL = 2e-5, 1e-4


def _f32(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _ratio(got, want):
    """Largest |got - want| / (ATOL + RTOL |want|)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


CASES = [
    # b, lq, lk, hq, hkv, d, causal, lk_valid, window
    (2, 32, 32, 4, 4, 12, True, None, 0),       # g = 1, D = 12
    (1, 48, 48, 6, 2, 64, True, None, 0),       # g = 3
    (1, 40, 40, 10, 1, 128, True, None, 16),    # g = 10, window
    (1, 24, 40, 4, 2, 64, True, 30, 0),         # Lq < lk_valid < Lk
    (1, 40, 40, 2, 1, 64, True, 24, 0),         # rows that see no key
    (2, 16, 32, 6, 2, 256, False, 28, 0),       # not causal, D = 256
    (1, 33, 33, 3, 1, 64, True, None, 1),       # window 1: itself only
    (1, 20, 20, 10, 1, 256, True, None, 7),     # D = 256, g = 10, window
]


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,lk_valid,window", CASES)
def test_tf32_plain_matches_plain_and_reference(b, lq, lk, hq, hkv, d, causal,
                                                lk_valid, window):
    """3xTF32 keeps ~21 bits of each product's operands, so the route's
    rounding stays within K4's float32 tolerance of the plain version and
    of the reference's jnp attention (and, without a window, its Pallas
    kernel in interpret mode); a row that sees no key gives exactly 0."""
    q = _f32(lq, b, lq, hq, d)
    k, v = _f32(lq + 1, b, lk, hkv, d), _f32(lq + 2, b, lk, hkv, d)
    kw = dict(causal=causal, lk_valid=lk_valid, window=window)
    got = p_flash.flash_attention_tf32_plain(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = p_flash.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    valid = lk if lk_valid is None else lk_valid
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    ref = r_layers.attention(jq, jk, jv, causal=causal, q_offset=valid - lq,
                             kv_len=valid, window=window, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    if not window:
        pallas = r_flash.flash_attention_pallas(
            jq, jk, jv, causal=causal, bq=lq, bk=lk, lk_valid=valid,
            interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   atol=ATOL, rtol=RTOL)
    if causal and valid < lq:                           # unseeing rows
        assert float(got[:, :lq - valid].abs().max()) == 0.0


@pytest.mark.parametrize("product", ["s", "pv"])
def test_one_tf32_rounding_misses_what_3xtf32_meets(product):
    """S = Q K^T or P V once in TF32 (10 mantissa bits) misses K4's float32
    tolerance by far, at the shape of a 64-row prefill; with both products
    as 3xTF32 the route sits far inside it."""
    q = _f32(80, 1, 64, 4, 64)
    k, v = _f32(81, 1, 64, 2, 64), _f32(82, 1, 64, 2, 64)
    want = p_flash.flash_attention_plain(q, k, v)
    split = p_flash.flash_attention_tf32_plain(q, k, v)
    mm = dict.fromkeys(("s", "pv"), p_flash._mm_3xtf32)
    mm[product] = p_flash._mm_tf32
    once = p_flash._fwd_algebra(q, k, v, True, None, None, 0, mm=mm)
    assert _ratio(split, want) < 0.1
    assert _ratio(once, want) > max(2.0, 50 * _ratio(split, want))


def test_fwd_algebra_without_rounding_is_the_plain_version():
    """``_fwd_algebra`` with exact products is ``flash_attention_plain``'s
    function (normalised after P V instead of before)."""
    q = _f32(90, 2, 30, 6, 32)
    k, v = _f32(91, 2, 36, 2, 32), _f32(92, 2, 36, 2, 32)
    kw = dict(causal=True, lk_valid=33, window=9)
    got = p_flash._fwd_algebra(q, k, v, kw["causal"], None, kw["lk_valid"],
                               kw["window"])
    want = p_flash.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_f32_route_kernel_source_constants():
    """Route "f32" runs both products on ``mma.sync`` m16n8k8 in tf32, takes
    head dims up to ``D_MAX``, float32 only, with no atomics and no
    CUDA-core FMA loop over the head dim."""
    src = (_build.SOURCES[0].parent / "flash_attention.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["DMAX"]) == p_flash.D_MAX
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "atomicAdd" not in src and "fmaf(" not in src
    assert "bfloat16" not in src
    assert 'extern "C" int flash_attention(' in src
    assert p_flash.flash_route(torch.float32, 100, 3) == "f32"
    assert p_flash.flash_route(torch.bfloat16, 100, 3) == "mma"
