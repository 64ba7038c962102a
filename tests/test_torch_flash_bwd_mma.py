"""K4b's route "mma" (bf16 on the tensor cores) in torch: its rounding of P
and dS, ``flash_attention_bwd_mma_plain``, held against the plain backward
and against the reference's jnp attention differentiated by jax.vjp; the
route picker, the kernel's constants and the CPU path.  The kernel itself
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
from repro_torch.kernels import ops as p_ops  # noqa: E402

# K4b's bf16 tolerance (chip_smoke.K4B_TOL): atol relative to each
# gradient's largest entry, rtol one bf16 ulp; both sides round their
# float32 results to bf16, so they may differ by an ulp
BF16_ATOL, BF16_RTOL = 1e-3, 8e-3


def _bf16(seed, *shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want, what):
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want))
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=BF16_ATOL * max(scale, 1e-30),
                               rtol=BF16_RTOL, msg=what)


# tests/test_torch_lm_kernels.py's FLASH_BWD_CASES, then g = 7 (qwen2-vl-7b's
# 28/4) and a head dim the kernel pads (96 to 128)
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
def test_bwd_mma_plain_matches_plain(b, lq, lk, hq, hkv, d, causal, lk_valid,
                                     window):
    """The split rounding of P and dS keeps ~16 bits of each (2^-17 of a
    term), so the emulation stays within K4b's bf16 tolerance of the plain
    backward; a single bf16 rounding would not (the kernel source's
    header gives the measured factors)."""
    q, do = _bf16(lq, b, lq, hq, d), _bf16(lq + 1, b, lq, hq, d)
    k, v = _bf16(lq + 2, b, lk, hkv, d), _bf16(lq + 3, b, lk, hkv, d)
    kw = dict(causal=causal, lk_valid=lk_valid, window=window)
    o = p_flash.flash_attention_plain(q, k, v, **kw)
    want = p_flash.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    got = p_flash.flash_attention_bwd_mma_plain(q, k, v, o, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
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
def test_bwd_mma_plain_matches_reference_vjp(lq, hq, hkv, d, window, block):
    """The gradients of the reference's jnp attention by jax.vjp, on the
    same bf16-rounded q, k, v and cotangent (float32 arrays there), with
    the reference's own float32 output as o.  The emulation's float32
    results differ from the reference's by the split rounding of P and dS
    (2^-17 of a term) and the order of additions, then round to bf16: one
    bf16 ulp, K4b's bf16 tolerance."""
    q, do = _bf16(3 * lq, 2, lq, hq, d), _bf16(3 * lq + 1, 2, lq, hq, d)
    k, v = _bf16(3 * lq + 2, 2, lq, hkv, d), _bf16(3 * lq + 3, 2, lq, hkv, d)

    def ref(q_, k_, v_):
        return r_layers.attention(q_, k_, v_, causal=True, window=window,
                                  block=block)

    o, vjp = jax.vjp(ref, *(jnp.asarray(x.float().numpy())
                            for x in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    got = p_flash.flash_attention_bwd_mma_plain(
        q, k, v, torch.from_numpy(np.array(o)), do, causal=True,
        window=window)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")


def test_bwd_route_is_picked_by_dtype():
    assert p_flash.flash_bwd_route(torch.bfloat16) == "mma"
    assert p_flash.flash_bwd_route(torch.float32) == "f32"


def test_bwd_mma_constants_match_kernel_source():
    """The wrapper pads each (batch, KV head)'s lse and D scratch to
    BWD_ROWS rows: the kernel's ROWS.  The source runs its products on
    ``mma.sync`` with P and dS split into bf16 high and low parts."""
    src = (_build.SOURCES[0].parent / "flash_attention_bwd_mma.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["ROWS_PAD"]) == p_flash.BWD_ROWS
    assert int(const["DMAX"]) == p_flash.D_MAX
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "split_bf16" in src and "atomicAdd" not in src
    assert 'extern "C" int flash_attention_bwd_mma(' in src


def test_cpu_backward_runs_the_plain_backward_never_the_emulation(
        monkeypatch):
    """bf16 CPU tensors take ``flash_attention_bwd_plain`` (the wrapper's
    CPU path), never the emulation of route "mma"; nothing launches."""
    calls = []
    for fn in ("flash_attention_bwd_plain", "flash_attention_bwd_mma_plain"):
        plain = getattr(p_flash, fn)

        def spy(*args, _fn=fn, _plain=plain, **kw):
            calls.append(_fn)
            return _plain(*args, **kw)

        monkeypatch.setattr(p_flash, fn, spy)
    before, sites = dict(_build.LAUNCHES), dict(_build.SITE_LAUNCHES)
    q = _bf16(1, 1, 12, 4, 16).requires_grad_(True)
    k = _bf16(2, 1, 12, 2, 16).requires_grad_(True)
    v = _bf16(3, 1, 12, 2, 16).requires_grad_(True)
    o = p_ops.flash_attention(q, k, v, window=5, site="full")
    o.float().square().sum().backward()
    assert calls == ["flash_attention_bwd_plain"]
    assert all(x.grad is not None for x in (q, k, v))
    assert _build.LAUNCHES == before and dict(_build.SITE_LAUNCHES) == sites
