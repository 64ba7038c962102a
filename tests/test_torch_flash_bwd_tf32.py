"""K4b's route "f32" (float32 on the tensor cores, every product 3xTF32) in
torch: its rounding, ``flash_attention_bwd_tf32_plain``, held against the
plain backward and against the reference's jnp attention differentiated by
jax.vjp; the TF32 rounding itself and the kernel's constants.  The kernel
is held against both plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 17a."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as r_layers  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as p_flash  # noqa: E402

# K4b's float32 tolerance (chip_smoke.K4B_TOL): atol relative to each
# gradient's largest entry
F32_ATOL, F32_RTOL = 1e-4, 1e-4


def _f32(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _ratio(got, want):
    """Largest |got - want| / (atol * scale + rtol |want|) under K4b's
    float32 tolerance."""
    got, want = got.double(), want.double()
    lim = F32_ATOL * float(want.abs().max()) + F32_RTOL * want.abs()
    return float(((got - want).abs() / lim).max())


def _close(got, want, what):
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want))
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=F32_ATOL * max(scale, 1e-30),
                               rtol=F32_RTOL, msg=what)


# tests/test_torch_flash_bwd_mma.py's cases
BWD_CASES = [
    # b, lq, lk, hq, hkv, d, causal, lk_valid, window
    (2, 24, 24, 4, 2, 16, True, None, 0),       # causal GQA
    (1, 24, 40, 6, 2, 16, True, 30, 0),         # Lq < lk_valid < Lk
    (1, 40, 40, 2, 1, 16, True, 20, 0),         # rows that see no key
    (1, 37, 37, 4, 1, 32, True, None, 8),       # local window
    (1, 20, 20, 2, 1, 256, True, None, 0),      # D = 256
    (2, 16, 24, 4, 4, 16, False, None, 0),      # not causal
    (1, 30, 30, 14, 2, 64, True, None, 0),      # g = 7
    (1, 50, 60, 4, 2, 96, True, 55, 20),        # D = 96, ragged, window
]


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,causal,lk_valid,window",
                         BWD_CASES)
def test_bwd_tf32_plain_matches_plain(b, lq, lk, hq, hkv, d, causal,
                                      lk_valid, window):
    """3xTF32 keeps ~21 bits of each product's operands, so the emulation
    stays within K4b's float32 tolerance of the plain backward, and rows
    and keys that see nothing stay exactly 0."""
    q, do = _f32(lq, b, lq, hq, d), _f32(lq + 1, b, lq, hq, d)
    k, v = _f32(lq + 2, b, lk, hkv, d), _f32(lq + 3, b, lk, hkv, d)
    kw = dict(causal=causal, lk_valid=lk_valid, window=window)
    o = p_flash.flash_attention_plain(q, k, v, **kw)
    want = p_flash.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    got = p_flash.flash_attention_bwd_tf32_plain(q, k, v, o, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        _close(g, w, f"d{name}")
    if lk_valid is not None and lk_valid < lq:          # unseeing rows
        assert float(got[0][:, :lq - lk_valid].abs().max()) == 0.0
    if lk_valid is not None and lk_valid < lk:          # keys past lk_valid
        assert float(got[1][:, lk_valid:].abs().max()) == 0.0
        assert float(got[2][:, lk_valid:].abs().max()) == 0.0


@pytest.mark.parametrize("lq,hq,hkv,d,window,block", [
    (24, 4, 2, 16, 0, 8),        # causal GQA, blockwise
    (37, 4, 1, 16, 8, 16),       # window: the reference's banded branch
    (20, 2, 1, 256, 0, 8),       # D = 256
    (21, 10, 1, 32, 9, 32),      # window, g = 10, one block
    (30, 14, 2, 64, 0, 16),      # g = 7
])
def test_bwd_tf32_plain_matches_reference_vjp(lq, hq, hkv, d, window, block):
    """The gradients of the reference's jnp attention by jax.vjp on the
    same float32 q, k, v and cotangent, with the reference's own output
    as o: the emulation differs by the dropped small . small terms (~2^-22
    of a term) and the order of additions, within K4b's float32
    tolerance."""
    q, do = _f32(3 * lq, 2, lq, hq, d), _f32(3 * lq + 1, 2, lq, hq, d)
    k, v = _f32(3 * lq + 2, 2, lq, hkv, d), _f32(3 * lq + 3, 2, lq, hkv, d)

    def ref(q_, k_, v_):
        return r_layers.attention(q_, k_, v_, causal=True, window=window,
                                  block=block)

    o, vjp = jax.vjp(ref, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    got = p_flash.flash_attention_bwd_tf32_plain(
        q, k, v, torch.from_numpy(np.array(o)), do, causal=True,
        window=window)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")


def test_tf32_rounds_to_nearest_ties_away_and_clears_13_bits():
    """``_tf32`` is ``cvt.rna.tf32.f32``: the 13 low mantissa bits cleared,
    to nearest, a tie away from zero, in both signs."""
    one = 1.0
    ulp = 2.0 ** -10                        # tf32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-39, -7.25], dtype=torch.float32)
    got = p_flash._tf32(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp,
                         float(p_flash._tf32(torch.tensor([3.0e-39]))[0]),
                         -7.25], dtype=torch.float32)
    assert torch.equal(got, want)
    bits = p_flash._tf32(_f32(5, 1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_3xtf32_split_is_far_inside_what_one_rounding_misses():
    """Every product once in TF32 misses K4b's float32 tolerance, by far
    more than 3xTF32 moves the gradients (``tools/k4b_rounding.py
    --float32`` measures the ratios at the train shapes: 1.3-7.9x K4b's
    float32 tolerance for one TF32 product, 0.014 at most for 3xTF32)."""
    q, do = _f32(70, 1, 64, 4, 64), _f32(71, 1, 64, 4, 64)
    k, v = _f32(72, 1, 64, 2, 64), _f32(73, 1, 64, 2, 64)
    o = p_flash.flash_attention_plain(q, k, v)
    want = p_flash.flash_attention_bwd_plain(q, k, v, o, do)
    once = p_flash._bwd_algebra(
        q, k, v, o, do, True, None, None, 0,
        mm=dict.fromkeys(p_flash.TF32_PRODUCTS, p_flash._mm_tf32))
    split = p_flash.flash_attention_bwd_tf32_plain(q, k, v, o, do)
    for g1, g3, w in zip(once, split, want):
        assert _ratio(g3, w) < 0.05
        assert _ratio(g1, w) > max(1.0, 20 * _ratio(g3, w))


def test_bwd_tf32_constants_match_kernel_source():
    """Route "f32" pads each (batch, KV head)'s lse and D scratch to
    BWD_ROWS rows, as route "mma" does, and sums dK and dV in segments of
    BWD_SEG_ROWS rows (the wrapper sizes their scratch); it runs every
    product on ``mma.sync`` m16n8k8 in tf32, splitting each operand by the
    rounding of ``cvt.rna.tf32.f32``, with no atomics."""
    src = (_build.SOURCES[0].parent / "flash_attention_bwd.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["ROWS_PAD"]) == p_flash.BWD_ROWS
    assert int(const["DMAX"]) == p_flash.D_MAX
    seg = re.search(r"#define K4B_SEG_ROWS (\d+)", src)
    assert int(seg.group(1)) == p_flash.BWD_SEG_ROWS
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src and "atomicAdd" not in src
    assert 'extern "C" int flash_attention_bwd(' in src
    assert tuple(p_flash.TF32_PRODUCTS) == ("s", "dp", "dv", "dq", "dk")
