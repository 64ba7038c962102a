"""The port's LM serving path against the reference, from the same weights.

The reference's parameters (``init_params`` from a fixed key) are carried
across with ``load_reference_params``; token ids are made with numpy from
explicit seeds.  The port's forward, prefill and three decode steps must
give the reference's logits and caches on the ``DENSE`` and ``SSM`` configs
of ``tests/test_models.py`` and on the minitron-4b and rwkv6-7b smoke
configs, all float32.  On the CPU attention and WKV run their kernels'
plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as r_get_smoke  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models.config import ModelConfig as RConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as p_serve  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

# the DENSE and SSM configs of tests/test_models.py
_DENSE = dict(name="t-dense", family="dense", num_layers=3, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
              head_dim=16, qkv_bias=True, dtype="float32")
_SSM = dict(name="t-ssm", family="ssm", num_layers=3, d_model=32,
            num_heads=0, num_kv_heads=0, d_ff=64, vocab_size=53,
            rwkv_head_dim=8, dtype="float32")

CASES = {
    "dense": (RConfig(**_DENSE), ModelConfig(**_DENSE)),
    "ssm": (RConfig(**_SSM), ModelConfig(**_SSM)),
    "minitron-4b-smoke": (r_get_smoke("minitron-4b"),
                          get_smoke("minitron-4b")),
    "rwkv6-7b-smoke": (r_get_smoke("rwkv6-7b"), get_smoke("rwkv6-7b")),
}
# float32 throughout: the two packages differ only in the order of the
# additions inside products and reductions, ~1e-6 relative per op over a
# few layers on logits of order 1
ATOL, RTOL = 1e-4, 1e-4


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    rcfg, pcfg = CASES[request.param]
    assert pcfg == ModelConfig(**{f: getattr(rcfg, f) for f in
                                  rcfg.__dataclass_fields__})
    rm = r_model.get_model(rcfg)
    rparams = rm.init_params(jax.random.PRNGKey(0))
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


def test_forward_matches_reference(pair):
    rcfg, rm, rparams, pcfg, pm, pparams = pair
    toks = _tokens(pcfg, 1)
    want, _, _ = rm.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux, _ = pm.forward(pparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 21, pcfg.padded_vocab)
    assert float(aux) == 0.0
    _close(got, want, "forward logits")


def test_prefill_and_decode_match_reference(pair):
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
    keys = ("s", "shift1", "shift2") if pcfg.family == "ssm" else ("k", "v")
    for key in keys:
        assert tuple(pcache[key].shape) == rcache[key].shape, key
        _close(pcache[key], rcache[key], f"cache {key}")


def test_generate_greedy_logits_match_reference(pair):
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


def test_generate_greedy_tokens_match_reference_generate(pair):
    rcfg, rm, rparams, pcfg, pm, pparams = pair
    prompts = _tokens(pcfg, 4, s=6)
    got = p_serve.generate(pcfg, pparams, prompts, 3, device="cpu")
    want = r_serve.generate(rcfg, rparams, prompts, 3)
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
    for arch in ("minitron-4b", "rwkv6-7b"):
        pcfg, rcfg = get_smoke(arch), r_get_smoke(arch)
        rparams = r_model.get_model(rcfg).init_params(jax.random.PRNGKey(0))
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
    for arch in ("minitron-4b", "rwkv6-7b"):
        r, p = r_get_config(arch), get_config(arch)
        assert p == ModelConfig(**{f: getattr(r, f)
                                   for f in r.__dataclass_fields__})
        assert p.param_count() == r.param_count()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "recurrentgemma-2b",
                                  "qwen2-vl-7b", "musicgen-medium"])
def test_later_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        p_model.get_model(get_smoke(arch), "cpu")


def test_serving_path_launches_no_kernel_on_cpu():
    before = dict(_build.LAUNCHES)
    p_serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "40", "--gen", "3"])
    p_serve.main(["--arch", "minitron-4b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "12", "--gen", "3"])
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
