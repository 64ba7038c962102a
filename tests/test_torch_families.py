"""The moe, vlm, audio and hybrid families of the port against the
reference, module by module and end to end.

Inputs are made with numpy from explicit seeds and handed to both packages;
parameters are the reference's own (``init_params`` from a fixed key),
carried across with ``load_reference_params``.  Everything runs in float32
on the CPU, where attention runs K4's plain version: the packages differ by
the order of additions only, so the model-level tolerance is
``tests/test_torch_models.py``'s ATOL = RTOL = 1e-4.  The forward, prefill
and decode of every family on the reference's small configs and the smoke
configs are also in ``tests/test_torch_models.py`` (``CASES``); this file
adds the pieces (MoE routing, M-RoPE, the local window, RG-LRU, the causal
convolution, parameter loading), the vlm's patch prefix with M-RoPE
positions, and the hybrid's ring cache before, at and past its window.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import get_smoke as r_get_smoke  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import rglru as r_rglru  # noqa: E402
from repro.models.config import ModelConfig as RConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as p_flash  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.models import moe as p_moe  # noqa: E402
from repro_torch.models import rglru as p_rglru  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

# the MOE, HYBRID and VLM configs of tests/test_models.py
_MOE = dict(name="t-moe", family="moe", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=50,
            head_dim=8, num_experts=4, experts_per_token=2,
            moe_group=8, moe_capacity_factor=4.0, dtype="float32")
_HYBRID = dict(name="t-hyb", family="hybrid", num_layers=6, d_model=48,
               num_heads=4, num_kv_heads=1, d_ff=96, vocab_size=61,
               head_dim=12, block_pattern=("rec", "rec", "attn"),
               local_window=8, d_rnn=48, dtype="float32")
_VLM = dict(name="t-vlm", family="vlm", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
            head_dim=8, qkv_bias=True, frontend="patch",
            frontend_dim=12, frontend_len=4,
            mrope_sections=(1, 1, 2), dtype="float32")
NEW_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e", "qwen2-vl-7b",
             "musicgen-medium", "recurrentgemma-2b")

# float32 throughout, additions in another order (test_torch_models.py)
ATOL, RTOL = 1e-4, 1e-4
# float32 attention and scans of a few steps: the kernel-level tolerance of
# tests/test_torch_lm_kernels.py
K_ATOL, K_RTOL = 2e-5, 1e-4
# router probabilities: the packages' float32 softmaxes of one layer's
# input agree within PROBS_ATOL (1-2 ulp of 0.25); the top-k + 1 gap that
# makes a pick no tie (test_torch_models.py says why 2e-6)
PROBS_ATOL = 1e-7
MOE_MARGIN = 2e-6


def _pair(fields):
    return RConfig(**fields), ModelConfig(**fields)


def _same_config(rcfg):
    return ModelConfig(**{f: getattr(rcfg, f)
                          for f in rcfg.__dataclass_fields__})


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _models(rcfg, pcfg):
    """Both packages' models of one config and the reference's parameters
    from a fixed key, carried across (made once a config; no test writes to
    them)."""
    rm = r_model.get_model(rcfg)
    rparams = jax.jit(rm.init_params)(jax.random.PRNGKey(0))
    pparams = p_model.load_reference_params(
        pcfg, jax.tree.map(np.asarray, rparams), "cpu")
    return rm, rparams, p_model.get_model(pcfg, "cpu"), pparams


def _reference_steps(rcfg, max_len):
    """The reference's prefill and decode steps, jitted as its
    ``launch/serve.py`` jits them (run eagerly, the hybrid's per-layer loop
    compiles each operation on its own, seconds a step)."""
    return (jax.jit(r_model.make_prefill_step(rcfg, max_len)),
            jax.jit(r_model.make_decode_step(rcfg)))


def _margin(probs: torch.Tensor, k: int) -> float:
    top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    return float((top[..., :-1] - top[..., 1:]).min())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rcfg", [
    RConfig(**_MOE), r_get_config("granite-moe-3b-a800m"),
    r_get_config("llama4-scout-17b-a16e"),
    r_get_smoke("granite-moe-3b-a800m"), r_get_smoke("llama4-scout-17b-a16e")],
    ids=lambda c: c.name)
def test_expert_capacity_matches_reference(rcfg):
    pcfg = _same_config(rcfg)
    for group in [*range(1, 1025), 2048, 4096, 8000]:
        assert p_moe.expert_capacity(pcfg, group) == \
            r_moe.expert_capacity(rcfg, group), group


@pytest.mark.parametrize("gn,g,e,k,cap,ties", [
    (2, 8, 4, 2, 8, False),       # the MOE config: capacity never binds
    (2, 8, 4, 2, 3, False),       # tokens over capacity are dropped
    (3, 16, 8, 3, 4, False),
    (1, 64, 40, 8, 16, False),    # granite-moe's prefill group
    (1, 8, 40, 8, 4, False),      # granite-moe's decode: 8 tokens, capacity 4
    (2, 12, 6, 2, 3, True),       # equal probabilities: the first max wins
])
def test_top_k_dispatch_is_bit_equal_to_reference(gn, g, e, k, cap, ties):
    rng = np.random.default_rng(gn * 1000 + g * 10 + e)
    logits = (rng.integers(0, 3, (gn, g, e)) if ties
              else rng.standard_normal((gn, g, e))).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want_d, want_c = r_moe._top_k_dispatch(jnp.asarray(probs), k, cap)
    got_d, got_c = p_moe._top_k_dispatch(_t(probs), k, cap)
    assert got_d.dtype == got_c.dtype == torch.float32
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert float(got_d.sum(dim=1).max()) <= 1.0      # one token a slot
    dropped = gn * g * k - int(got_d.sum())
    if g * k > e * cap:         # more picks than slots: some are dropped
        assert dropped > 0
    if cap >= g:                # an expert can take the whole group
        assert dropped == 0
    got_aux = p_moe._aux_loss(_t(probs), got_d)
    want_aux = r_moe._aux_loss(jnp.asarray(probs), want_d)
    _close(got_aux, want_aux, "aux loss", K_ATOL, K_RTOL)


@pytest.mark.parametrize("b,s", [(2, 12), (2, 7), (1, 1)])
def test_apply_moe_matches_reference(b, s):
    """One MoE layer of the MOE config: 24 tokens in groups of 8, 14 in
    groups of 2 (the group halves until it divides the tokens), one token
    in a group of 1 (a decode step of batch 1)."""
    rcfg, pcfg = _pair(_MOE)
    lw = jax.tree.map(lambda x: np.asarray(x[0]), r_moe.init_moe(
        jax.random.PRNGKey(3), rcfg, 1))
    x = _normal(b * 100 + s, b, s, rcfg.d_model)
    want, want_aux = r_moe.apply_moe(
        rcfg, jnp.asarray(x), *(jnp.asarray(lw[n]) for n in (
            "router", "we_gate", "we_up", "we_down")), r_layers.no_shard)
    probs, group = p_moe.route(pcfg, _t(x), _t(lw["router"]))
    assert group == {24: 8, 14: 2, 1: 1}[b * s]
    want_probs = jax.nn.softmax(jnp.einsum(
        "gtd,de->gte", jnp.asarray(x).reshape(-1, group, rcfg.d_model),
        jnp.asarray(lw["router"])), axis=-1)
    _close(probs, want_probs, "router probabilities", PROBS_ATOL, 0.0)
    assert _margin(probs, pcfg.experts_per_token) > MOE_MARGIN
    got, aux = p_moe.apply_moe(pcfg, _t(x), *(_t(lw[n]) for n in (
        "router", "we_gate", "we_up", "we_down")))
    _close(got, want, "moe out", K_ATOL, K_RTOL)
    _close(aux, want_aux, "aux loss", K_ATOL, K_RTOL)


# ---------------------------------------------------------------------------
# M-RoPE and the vlm's patch prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,sections", [(8, (1, 1, 2)), (16, (2, 3, 3)),
                                               (128, (16, 24, 24))])
def test_m_rope_matches_reference(head_dim, sections):
    pos = np.random.default_rng(head_dim).integers(0, 3000, (2, 3, 11))
    want = r_layers.m_rope(jnp.asarray(pos), head_dim, sections, 1e6)
    got = p_layers.m_rope(_t(pos), head_dim, sections, 1e6)
    for g, w, name in zip(got, want, ("sin", "cos")):
        assert tuple(g.shape) == (2, 11, head_dim // 2)
        _close(g, w, name, 1e-6, 0.0)


def test_m_rope_equals_rope_when_components_are_equal():
    pos = torch.arange(40)
    sin1, cos1 = p_layers.rope(pos, 16, 1e6)
    sin3, cos3 = p_layers.m_rope(pos[None, None].expand(2, 3, 40), 16,
                                 (2, 3, 3), 1e6)
    assert torch.equal(sin3[1], sin1) and torch.equal(cos3[0], cos1)
    with pytest.raises(ValueError, match="sections"):
        p_layers.m_rope(pos[None, None].expand(2, 3, 40), 16, (2, 3, 2))


def _vlm_batch(cfg, seed, b=2, text=8):
    """A patch prefix of ``frontend_len`` seeded embeddings on a square grid
    (t = 0, h = i // side, w = i % side) and the text after it, at
    positions side, side + 1, ... in all three components."""
    p = cfg.frontend_len
    side = int(round(p ** 0.5))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, text)).astype(np.int32)
    patches = rng.standard_normal((b, p, cfg.frontend_dim)).astype(np.float32)
    i = np.arange(p)
    grid = np.stack([np.zeros(p), i // side, i % side])
    txt = np.broadcast_to(side + np.arange(text), (3, text))
    pos = np.broadcast_to(np.concatenate([grid, txt], 1), (b, 3, p + text))
    return {"tokens": tokens, "patch_embeds": patches,
            "positions": pos.astype(np.int32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


VLM_CASES = {"vlm": _pair(_VLM),
             "qwen2-vl-7b-smoke": (r_get_smoke("qwen2-vl-7b"),
                                   get_smoke("qwen2-vl-7b"))}


@pytest.mark.parametrize("case", sorted(VLM_CASES))
def test_vlm_patch_prefix_forward_matches_reference(case):
    rcfg, pcfg = VLM_CASES[case]
    rm, rparams, pm, pparams = _models(rcfg, pcfg)
    r_forward = jax.jit(rm.forward)
    batch = _vlm_batch(pcfg, 1)
    want, _, _ = r_forward(rparams, _jnp(batch))
    got, aux, _ = pm.forward(pparams, _torch(batch))
    assert got.shape == (2, pcfg.frontend_len + 8, pcfg.padded_vocab)
    _close(got, want, "forward logits")
    # without positions both fall back to 1-D RoPE over the fused sequence
    del batch["positions"]
    _close(pm.forward(pparams, _torch(batch))[0],
           r_forward(rparams, _jnp(batch))[0], "forward logits, RoPE")


@pytest.mark.parametrize("case", sorted(VLM_CASES))
def test_vlm_prefill_and_decode_match_reference(case):
    """The prefix through ``make_prefill_step`` and four decode steps through
    ``make_decode_step``: a decode step rotates at the cache position
    (ROADMAP R6), in both packages."""
    rcfg, pcfg = VLM_CASES[case]
    _, rparams, pm, pparams = _models(rcfg, pcfg)
    batch = _vlm_batch(pcfg, 2)
    s = pcfg.frontend_len + 8
    r_pre, r_dec = _reference_steps(rcfg, s + 4)
    p_pre = p_model.make_prefill_step(pcfg, s + 4, "cpu")
    p_dec = p_model.make_decode_step(pcfg, "cpu")
    want, rcache = r_pre(rparams, _jnp(batch))
    got, pcache = p_pre(pparams, _torch(batch))
    _close(got, want, "prefill logits")
    toks = np.random.default_rng(3).integers(0, pcfg.vocab_size, (2, 4))
    for t in range(4):
        tok = toks[:, t:t + 1].astype(np.int32)
        want, rcache = r_dec(rparams, rcache, jnp.asarray(tok))
        got, pcache = p_dec(pparams, pcache, _t(tok))
        _close(got, want, f"decode logits at step {t}")
    assert pcache["pos"] == int(rcache["pos"]) == s + 4
    for key in ("k", "v"):
        _close(pcache[key], rcache[key], f"cache {key}")


# ---------------------------------------------------------------------------
# the local window (K4's plain versions) and the hybrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lq,lk,kv_len,window,block", [
    (37, 37, None, 8, 16),     # banded branch, L not a multiple of the block
    (40, 40, None, 8, 8),      # banded, aligned
    (37, 37, None, 1, 16),     # banded, each query sees itself
    (13, 13, None, 16, 8),     # window >= L: the masked branch
    (21, 21, None, 21, 8),     # window == L
    (20, 20, None, 8, 32),     # masked branch (one block), window < L
    (5, 48, 40, 8, 16),        # queries at the end of 40 valid keys
    (1, 48, 33, 8, 16),        # a decode step
])
def test_plain_flash_window_matches_reference_attention(lq, lk, kv_len,
                                                        window, block):
    """``layers.attention(window=)`` (K4's plain version on the CPU) and
    route "decode"'s split algebra against the reference's
    ``layers.attention``, on its banded branch (``Lq == Lk > window``) and
    its masked blockwise branch."""
    q, k, v = (_normal(lq + lk + i, 2, n, h, 16)
               for i, (n, h) in enumerate(((lq, 6), (lk, 2), (lk, 2))))
    valid = lk if kv_len is None else kv_len
    want = np.asarray(r_layers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=valid - lq, kv_len=kv_len, window=window, block=block))
    got = p_layers.attention(_t(q), _t(k), _t(v), causal=True,
                             kv_len=kv_len, window=window)
    _close(got, want, "windowed attention", K_ATOL, K_RTOL)
    split = p_flash.flash_attention_split_plain(_t(q), _t(k), _t(v),
                                                lk_valid=valid, window=window)
    _close(split, want, "split algebra", K_ATOL, K_RTOL)


@pytest.mark.parametrize("window", [0, 9])
def test_split_plain_matches_plain_without_causal_mask(window):
    """Route "decode"'s split algebra with ``causal=False`` (a window then
    counts back from the end of the valid keys) equals the one-pass plain
    version, over splits past ``lk_valid`` too."""
    q = _t(_normal(20, 2, 3, 4, 16))
    k, v = _t(_normal(21, 2, 150, 2, 16)), _t(_normal(22, 2, 150, 2, 16))
    got = p_flash.flash_attention_split_plain(q, k, v, causal=False,
                                              lk_valid=100, window=window)
    want = p_flash.flash_attention_plain(q, k, v, causal=False,
                                         lk_valid=100, window=window)
    _close(got, want, "split vs one pass", K_ATOL, K_RTOL)


def test_split_plain_skips_splits_left_of_the_window():
    """Route "decode" over 300 keys with window 70: the splits wholly left
    of the band hold m = NEG, l = 0, as the kernel writes them."""
    q = _t(_normal(0, 1, 1, 3, 16))
    k, v = _t(_normal(1, 1, 300, 1, 16)), _t(_normal(2, 1, 300, 1, 16))
    acc, m, l = p_flash.flash_split_partials_plain(q, k, v, window=70)
    # the band is keys 230..299: splits 0-2 end at 191
    assert bool((m[:, :, :3] == p_flash.NEG).all())
    assert bool((l[:, :, :3] == 0).all()) and bool((l[:, :, 3:] > 0).all())


def _rec_weights(seed):
    rcfg, _ = _pair(_HYBRID)
    return jax.tree.map(np.asarray, r_rglru._init_rec_layer(
        jax.random.PRNGKey(seed), rcfg))


@pytest.mark.parametrize("t", [1, 7, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(t, with_h0):
    lw = _rec_weights(t)
    x = _normal(t, 2, t, 48)
    h0 = _normal(t + 1, 2, 48) if with_h0 else None
    want_h, want_last = jax.jit(r_rglru._rglru_scan)(
        jax.tree.map(jnp.asarray, lw), jnp.asarray(x),
        None if h0 is None else jnp.asarray(h0))
    got_h, got_last = p_rglru._rglru_scan(
        {n: _t(w) for n, w in lw.items()}, _t(x),
        None if h0 is None else _t(h0))
    assert got_last.dtype == torch.float32
    _close(got_h, want_h, "h", K_ATOL, K_RTOL)
    _close(got_last, want_last, "h_T", K_ATOL, K_RTOL)
    # the one-step update carries the scan on
    want1, _ = r_rglru._rglru_step(jax.tree.map(jnp.asarray, lw),
                                   jnp.asarray(x[:, :1]), want_last)
    got1, _ = p_rglru._rglru_step({n: _t(w) for n, w in lw.items()},
                                  _t(x[:, :1]), got_last)
    _close(got1, want1, "one step", K_ATOL, K_RTOL)


@pytest.mark.parametrize("t", [1, 2, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(t, with_state):
    w = _normal(5, 4, 48) * 0.1
    b = _normal(6, 48)
    x = _normal(t, 2, t, 48)
    state = _normal(t + 7, 2, 3, 48) if with_state else None
    want, want_state = r_rglru._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    got, got_state = p_rglru._causal_conv(_t(x), _t(w), _t(b),
                                          None if state is None else _t(state))
    # the same products added in the same order
    _close(got, want, "conv", 1e-6, 1e-6)
    assert np.array_equal(got_state.numpy(), np.asarray(want_state))


HYBRID_CASES = {"hybrid": _pair(_HYBRID),
                "recurrentgemma-2b-smoke": (r_get_smoke("recurrentgemma-2b"),
                                            get_smoke("recurrentgemma-2b"))}


@pytest.mark.parametrize("case,prompt", [
    ("hybrid", 5), ("hybrid", 8), ("hybrid", 13),
    ("recurrentgemma-2b-smoke", 21)])
def test_hybrid_ring_cache_matches_reference(case, prompt):
    """A prompt shorter than, equal to and longer than the local window,
    then decode steps until one past the ring's next wrap (a position that
    overwrites slot 0): every step's logits and, at the end, every layer's
    cache."""
    rcfg, pcfg = HYBRID_CASES[case]
    _, rparams, pm, pparams = _models(rcfg, pcfg)
    w = pcfg.local_window
    steps = (-prompt) % w + 2
    toks = np.random.default_rng(prompt).integers(
        0, pcfg.vocab_size, (2, prompt + steps)).astype(np.int32)
    r_pre, r_dec = _reference_steps(rcfg, prompt + steps)
    want, rcache = r_pre(rparams, {"tokens": jnp.asarray(toks[:, :prompt])})
    got, pcache = pm.prefill(pparams, {"tokens": _t(toks[:, :prompt])},
                             prompt + steps)
    _close(got, want, "prefill logits")
    for t in range(prompt, prompt + steps):
        want, rcache = r_dec(rparams, rcache, jnp.asarray(toks[:, t:t + 1]))
        got, pcache = pm.decode_step(pparams, pcache, _t(toks[:, t:t + 1]))
        _close(got, want, f"decode logits at {t}")
    assert pcache["pos"] == int(rcache["pos"]) == prompt + steps
    assert any(p >= w and p % w == 0 for p in range(prompt, prompt + steps))
    for i, (pl, rl) in enumerate(zip(pcache["layers"], rcache["layers"])):
        assert sorted(pl) == sorted(rl)
        for key in rl:
            _close(pl[key], rl[key], f"layer {i} {key}")


def test_hybrid_decode_uses_the_ring_prefix(monkeypatch):
    """Each decode step hands K4 the whole ring with ``kv_len = min(pos + 1,
    window)``, and the prefill's attention the local window."""
    from repro_torch.kernels import ops
    cfg = get_smoke("recurrentgemma-2b")
    pm = p_model.get_model(cfg, "cpu")
    params = pm.init_params(0)
    calls = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("lk_valid"),
                      kw.get("window"), kw.get("site")))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 30))
    _, cache = pm.prefill(params, {"tokens": _t(toks[:, :12])}, 30)
    assert calls == [(12, 12, None, 16, "full")]
    for t in range(12, 20):
        calls.clear()
        _, cache = pm.decode_step(params, cache, _t(toks[:, t:t + 1]))
        assert calls == [(1, 16, min(t + 1, 16), 0, "decode")]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_load_reference_params_takes_list_blocks_and_w_patch():
    for fields in (_HYBRID, _VLM):
        rcfg, pcfg = _pair(fields)
        tree = jax.tree.map(np.asarray, jax.jit(
            r_model.get_model(rcfg).init_params)(jax.random.PRNGKey(0)))
        params = p_model.load_reference_params(pcfg, tree, "cpu")
        assert jax.tree.structure(jax.tree.map(
            lambda x: 0, params)) == jax.tree.structure(jax.tree.map(
                lambda x: 0, tree))
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(
            jax.tree.leaves(params), jax.tree.leaves(tree)))
        if fields is _HYBRID:
            assert isinstance(params["blocks"], list)
            with pytest.raises(ValueError, match="6 layers"):
                p_model.load_reference_params(
                    pcfg, dict(tree, blocks=tree["blocks"][:5]), "cpu")
            swapped = [tree["blocks"][2]] + tree["blocks"][1:]
            with pytest.raises(ValueError, match="'rec' layer"):
                p_model.load_reference_params(
                    pcfg, dict(tree, blocks=swapped), "cpu")
            stacked = dataclasses.replace(pcfg, family="dense",
                                          block_pattern=())
            with pytest.raises(ValueError, match="stacked"):
                p_model.load_reference_params(stacked, tree, "cpu")
        else:
            assert tuple(params["w_patch"].shape) == (12, 32)
            with pytest.raises(ValueError, match="w_patch"):
                p_model.load_reference_params(pcfg, {
                    k: v for k, v in tree.items() if k != "w_patch"}, "cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_families_run_from_their_smoke_configs(arch):
    """``get_model(get_smoke(arch), "cpu")`` for every new architecture:
    the port's own init, a forward of finite logits and the full config's
    parameter count equal to the reference's."""
    cfg = get_smoke(arch)
    model = p_model.get_model(cfg, "cpu")
    params = model.init_params(0)
    toks = np.random.default_rng(len(arch)).integers(0, cfg.vocab_size,
                                                     (2, 10))
    logits, aux, _ = model.forward(params, {"tokens": _t(toks)})
    assert logits.shape == (2, 10, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert get_config(arch).param_count() == r_get_config(arch).param_count()
