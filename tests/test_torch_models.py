"""The port's LM serving path against the reference, from the same weights.

The reference's parameters (``init_params`` from a fixed key) are carried
across with ``load_reference_params``; token ids are made with numpy from
explicit seeds.  The port's forward, prefill and three decode steps must
give the reference's logits, aux losses and caches on the ``DENSE``,
``MOE``, ``HYBRID`` and ``SSM`` configs of ``tests/test_models.py`` and on
the smoke configs of every architecture, all float32 (the vlm's here with
tokens only; ``tests/test_torch_families.py`` adds its patch prefix and
M-RoPE positions).  On the CPU attention and WKV run their kernels' plain
versions.  Where a MoE layer routes, every token's top-k + 1 router
probabilities must be more than ``MOE_MARGIN`` apart, and the port's router
probabilities within ``MOE_MARGIN / 2`` of the reference's at every routed
layer, so that an expert picked otherwise would be a fault of the port and
not a tie the two packages' roundings break differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as r_get_smoke  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models.config import ModelConfig as RConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as p_serve  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.models import moe as p_moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

# the DENSE and SSM configs of tests/test_models.py
_DENSE = dict(name="t-dense", family="dense", num_layers=3, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
              head_dim=16, qkv_bias=True, dtype="float32")
_SSM = dict(name="t-ssm", family="ssm", num_layers=3, d_model=32,
            num_heads=0, num_kv_heads=0, d_ff=64, vocab_size=53,
            rwkv_head_dim=8, dtype="float32")
# the MOE and HYBRID configs of tests/test_models.py
_MOE = dict(name="t-moe", family="moe", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=50,
            head_dim=8, num_experts=4, experts_per_token=2,
            moe_group=8, moe_capacity_factor=4.0, dtype="float32")
_HYBRID = dict(name="t-hyb", family="hybrid", num_layers=6, d_model=48,
               num_heads=4, num_kv_heads=1, d_ff=96, vocab_size=61,
               head_dim=12, block_pattern=("rec", "rec", "attn"),
               local_window=8, d_rnn=48, dtype="float32")
ARCHS = ("minitron-4b", "rwkv6-7b", "granite-moe-3b-a800m",
         "llama4-scout-17b-a16e", "qwen2-vl-7b", "musicgen-medium",
         "recurrentgemma-2b", "granite-20b", "mistral-large-123b",
         "qwen2.5-14b")

CASES = {
    "dense": (RConfig(**_DENSE), ModelConfig(**_DENSE)),
    "ssm": (RConfig(**_SSM), ModelConfig(**_SSM)),
    "moe": (RConfig(**_MOE), ModelConfig(**_MOE)),
    "hybrid": (RConfig(**_HYBRID), ModelConfig(**_HYBRID)),
    **{f"{arch}-smoke": (r_get_smoke(arch), get_smoke(arch))
       for arch in ARCHS[:7]},
}
# router probabilities: the two packages' float32 softmaxes differ by at
# most 8.9e-8 at any routed layer of these tests, the deepest included (the
# ``margins`` fixture reads both at every layer and holds the difference
# under MOE_MARGIN / 2), so a top-k + 1 gap over MOE_MARGIN cannot flip a
# pick.  (1e-5 was the first choice: granite-moe's smoke config,
# near-uniform at its 0.02 router scale, has a gap of 8.0e-6 at one decode
# step of test_generate_greedy_logits.)
MOE_MARGIN = 2e-6
# float32 throughout: the two packages differ only in the order of the
# additions inside products and reductions, ~1e-6 relative per op over a
# few layers on logits of order 1
ATOL, RTOL = 1e-4, 1e-4


@pytest.fixture
def margins(monkeypatch):
    """The router probabilities of each MoE layer that the port and the
    reference route during the test, each package's in its call order (the
    reference's read back through ``jax.debug.callback``, inside its scans
    and jitted steps)."""
    seen = {"port": [], "reference": []}
    dispatch, r_dispatch = p_moe._top_k_dispatch, r_moe._top_k_dispatch

    def spy(probs, k, capacity):
        seen["port"].append((probs.detach().numpy().copy(), k))
        return dispatch(probs, k, capacity)

    def r_spy(probs, k, capacity):
        jax.debug.callback(lambda p: seen["reference"].append(np.array(p)),
                           probs, ordered=True)
        return r_dispatch(probs, k, capacity)

    monkeypatch.setattr(p_moe, "_top_k_dispatch", spy)
    monkeypatch.setattr(r_moe, "_top_k_dispatch", r_spy)
    return seen


def _routed_apart(margins):
    """At every routed layer the port's router probabilities are within
    MOE_MARGIN / 2 of the reference's and its top-k + 1 are more than
    MOE_MARGIN apart: the two packages pick the same experts."""
    jax.effects_barrier()
    assert len(margins["port"]) == len(margins["reference"])
    for i, ((probs, k), want) in enumerate(zip(margins["port"],
                                               margins["reference"])):
        assert probs.shape == want.shape, i
        diff = float(np.abs(probs - want).max())
        assert diff < MOE_MARGIN / 2, (i, diff)
        top = -np.sort(-probs, axis=-1)[..., :k + 1]
        gap = float((top[..., :-1] - top[..., 1:]).min())
        assert gap > MOE_MARGIN, (i, gap)


class _Jitted:
    """The reference model's forward, prefill and decode step, jitted as its
    ``launch/serve.py`` jits its steps (run eagerly, the hybrid's per-layer
    loop compiles each operation on its own, seconds a call)."""

    def __init__(self, rcfg):
        self.cfg = rcfg
        self.forward = jax.jit(r_model.get_model(rcfg).forward)
        self.decode_step = jax.jit(r_model.make_decode_step(rcfg))

    def prefill(self, params, batch, max_len):
        return jax.jit(r_model.make_prefill_step(self.cfg, max_len))(
            params, batch)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    rcfg, pcfg = CASES[request.param]
    assert pcfg == ModelConfig(**{f: getattr(rcfg, f) for f in
                                  rcfg.__dataclass_fields__})
    rm = _Jitted(rcfg)
    rparams = jax.jit(r_model.get_model(rcfg).init_params)(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    pparams = p_model.load_reference_params(pcfg, tree, "cpu")
    pm = p_model.get_model(pcfg, "cpu")
    return rcfg, rm, rparams, pcfg, pm, pparams


def _tokens(cfg, seed, b=2, s=21):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def test_forward_matches_reference(pair, margins):
    rcfg, rm, rparams, pcfg, pm, pparams = pair
    toks = _tokens(pcfg, 1)
    want, want_aux, _ = rm.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux, _ = pm.forward(pparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 21, pcfg.padded_vocab)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert (float(aux) == 0.0) == (not pcfg.num_experts)
    _close(got, want, "forward logits")
    _close(aux, want_aux, "aux loss")
    _routed_apart(margins)


def test_prefill_and_decode_match_reference(pair, margins):
    rcfg, rm, rparams, pcfg, pm, pparams = pair
    toks = _tokens(pcfg, 2)
    p, max_len = 17, 23
    want, rcache = rm.prefill(rparams, {"tokens": jnp.asarray(toks[:, :p])},
                              max_len=max_len)
    got, pcache = pm.prefill(pparams, {"tokens": torch.from_numpy(
        toks[:, :p])}, max_len)
    _close(got, want, "prefill logits")
    for t in range(p, p + 3):
        want, rcache = rm.decode_step(rparams, rcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        got, pcache = pm.decode_step(pparams, pcache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, f"decode logits at {t}")
    assert pcache["pos"] == int(rcache["pos"]) == p + 3
    _routed_apart(margins)
    if pcfg.family == "hybrid":
        # the rec layers' state and conv window, the attention layers' ring
        pairs = [(f"layer {i} {key}", pl[key], rl[key])
                 for i, (pl, rl) in enumerate(zip(pcache["layers"],
                                                  rcache["layers"]))
                 for key in rl]
    else:
        keys = ("s", "shift1", "shift2") if pcfg.family == "ssm" \
            else ("k", "v")
        pairs = [(key, pcache[key], rcache[key]) for key in keys]
    for key, got, want in pairs:
        assert tuple(got.shape) == want.shape, key
        _close(got, want, f"cache {key}")


def test_generate_greedy_logits_match_reference(pair, margins):
    """The port's ``generate`` picks greedily from logits that equal the
    reference's for the same tokens (teacher-forced through the
    reference), and never picks a padded vocab column."""
    rcfg, rm, rparams, pcfg, pm, pparams = pair
    prompts = _tokens(pcfg, 3, s=9)
    rec = {}
    toks = p_serve.generate(pcfg, pparams, prompts, 4, device="cpu",
                            record=rec)
    assert toks.shape == (2, 13) and toks.dtype == np.int32
    assert np.array_equal(toks[:, :9], prompts)
    assert rec["decode_steps"] == 3 and len(rec["logits"]) == 4
    want, cache = rm.prefill(rparams, {"tokens": jnp.asarray(prompts)},
                             max_len=13)
    for i, got in enumerate(rec["logits"]):
        _close(got, want, f"logits of generated token {i}")
        masked = got.clone()
        masked[:, pcfg.vocab_size:] = -torch.inf
        assert np.array_equal(masked.argmax(-1).numpy(), toks[:, 9 + i])
        if i < 3:
            want, cache = rm.decode_step(rparams, cache,
                                         jnp.asarray(toks[:, 9 + i:10 + i]))
    _routed_apart(margins)


def test_generate_greedy_tokens_match_reference_generate(pair, margins):
    rcfg, rm, rparams, pcfg, pm, pparams = pair
    prompts = _tokens(pcfg, 4, s=6)
    got = p_serve.generate(pcfg, pparams, prompts, 3, device="cpu")
    want = r_serve.generate(rcfg, rparams, prompts, 3)
    _routed_apart(margins)
    assert np.array_equal(got, want)


def test_generate_sampling_is_seeded_and_in_vocab():
    cfg = get_smoke("minitron-4b")
    pm = p_model.get_model(cfg, "cpu")
    params = pm.init_params(0)
    prompts = _tokens(cfg, 5, s=8)
    a = p_serve.generate(cfg, params, prompts, 6, temperature=1.0, seed=3,
                         device="cpu")
    b = p_serve.generate(cfg, params, prompts, 6, temperature=1.0, seed=3,
                         device="cpu")
    assert np.array_equal(a, b)
    assert a.max() < cfg.vocab_size and a.min() >= 0


def test_init_params_match_reference_layout():
    """The port's random init has the reference's tree and shapes, and is
    reproducible from its seed."""
    for arch in ARCHS:
        pcfg, rcfg = get_smoke(arch), r_get_smoke(arch)
        rparams = jax.eval_shape(r_model.get_model(rcfg).init_params,
                                 jax.random.PRNGKey(0))
        rshapes = jax.tree.map(lambda x: tuple(x.shape), rparams)
        a = p_model.get_model(pcfg, "cpu").init_params(7)
        b = p_model.get_model(pcfg, "cpu").init_params(
            torch.Generator().manual_seed(7))
        pshapes = jax.tree.map(lambda x: tuple(x.shape), a)
        assert pshapes == rshapes
        assert all(torch.equal(x, y) for x, y in zip(
            jax.tree.leaves(a), jax.tree.leaves(b)))
        assert sum(x.numel() for x in jax.tree.leaves(a)) == sum(
            x.size for x in jax.tree.leaves(rparams))


def test_full_configs_are_the_references():
    from repro.configs import get_config as r_get_config
    for arch in ARCHS:
        r, p = r_get_config(arch), get_config(arch)
        assert p == ModelConfig(**{f: getattr(r, f)
                                   for f in r.__dataclass_fields__})
        assert p.param_count() == r.param_count()


def test_serving_path_launches_no_kernel_on_cpu():
    before = dict(_build.LAUNCHES)
    p_serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "40", "--gen", "3"])
    p_serve.main(["--arch", "minitron-4b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    for arch in ("granite-moe-3b-a800m", "recurrentgemma-2b"):
        p_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert _build.LAUNCHES == before


def test_rwkv6_hands_wkv_views_of_the_projections(monkeypatch):
    """The time mix hands ``ops.wkv_chunked`` the [B, T, H, n] projections
    that ``_rkvgw`` returned as [B, H, T, n] views: each argument shares its
    storage with the projection, no copy is made."""
    from repro_torch.kernels import ops as p_ops
    from repro_torch.models import rwkv6 as p_rwkv6

    cfg = get_smoke("rwkv6-7b")
    params = p_model.get_model(cfg, "cpu").init_params(0)
    made, handed = [], []
    rkvgw, wkv = p_rwkv6._rkvgw, p_ops.wkv_chunked

    def spy_rkvgw(*args):
        out = rkvgw(*args)
        made.append(out)
        return out

    def spy_wkv(r, k, v, log_w, u, s0=None):
        handed.append((r, k, v, log_w))
        return wkv(r, k, v, log_w, u, s0)

    monkeypatch.setattr(p_rwkv6, "_rkvgw", spy_rkvgw)
    monkeypatch.setattr(p_ops, "wkv_chunked", spy_wkv)
    p_model.get_model(cfg, "cpu").prefill(
        params, {"tokens": torch.from_numpy(_tokens(cfg, 3, s=40))}, 44)
    assert len(handed) == len(made) == cfg.num_layers
    for (r, k, v, _g, log_w), args in zip(made, handed):
        for proj, arg in zip((r, k, v, log_w), args):
            assert arg.untyped_storage().data_ptr() == \
                proj.untyped_storage().data_ptr()
            assert arg.shape == (proj.shape[0], proj.shape[2],
                                 proj.shape[1], proj.shape[3])
