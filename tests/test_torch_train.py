"""The port's training pieces against the reference, on the CPU: parameter
trees and their key strings, the losses, AdamW and its schedule, int8
error-feedback compression, the synthetic data, checkpoints in both
directions, and the training entry point (``repro_torch.launch.train`` with
``--device cpu``).  Inputs are made with numpy from explicit seeds and
handed to both packages.  The train step of each family is held to the
reference's in ``tests/test_torch_train_transformers.py`` and
``tests/test_torch_train_recurrent.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointing as r_ckpt  # noqa: E402
from repro.configs import get_smoke as r_get_smoke  # noqa: E402
from repro.configs import shapes as r_shapes  # noqa: E402
from repro.data import pipeline as r_pipeline  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models.config import ModelConfig as RConfig  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.optim import compress as r_compress  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import checkpointing as p_ckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs import shapes as p_shapes  # noqa: E402
from repro_torch.data import pipeline as p_pipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import adamw as p_adamw  # noqa: E402
from repro_torch.optim import compress as p_compress  # noqa: E402

ARCHS = ("minitron-4b", "granite-moe-3b-a800m", "qwen2-vl-7b",
         "musicgen-medium", "recurrentgemma-2b", "rwkv6-7b")
# float32 both sides, the same operations in the same order where the
# reference fixes it (AdamW, the schedule); XLA and torch may still round
# a transcendental (pow, cos, sqrt) an ulp apart
OPT_RTOL = 1e-6
# float32 reductions in another order (logsumexp over 256 columns, sums
# over the positions)
LOSS_RTOL = 1e-5


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(seed):
    """A small parameter tree with a list, as the hybrid's blocks."""
    return {"head": _normal(seed, 3, 4),
            "blocks": [{"w": _normal(seed + 1, 5), "b": _normal(seed + 2, 2)},
                       {"w": _normal(seed + 3, 5), "b": _normal(seed + 4, 2)}],
            "emb": _normal(seed + 5, 2, 2)}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def test_tree_leaves_and_paths_match_jax():
    tree = _tree(0)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert tree_lib.paths(tree) == [jax.tree_util.keystr(p) for p, _ in flat]
    for got, (_, want) in zip(tree_lib.leaves(tree), flat):
        assert got is want
    again = tree_lib.unflatten(tree, tree_lib.leaves(tree))
    assert list(again) == list(tree)
    doubled = tree_lib.map_tree(lambda a, b: a + b, tree, tree)
    np.testing.assert_array_equal(doubled["blocks"][1]["w"],
                                  2 * tree["blocks"][1]["w"])
    with pytest.raises(ValueError, match="more leaves"):
        tree_lib.unflatten(tree, tree_lib.leaves(tree) + [1])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

_CE = dict(name="t-ce", family="dense", num_layers=1, d_model=16,
           num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=100,
           head_dim=8, dtype="float32")


def _labels(seed, b, s, vocab):
    lab = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    lab[:, :5] = -1                     # a masked prefix (the vlm's patches)
    return lab


def test_cross_entropy_matches_reference():
    """Padded vocab columns (100 of 256 real) masked at -1e9, labels < 0
    masked, mean over the valid positions; n as the reference returns it."""
    rcfg, pcfg = RConfig(**_CE), ModelConfig(**_CE)
    logits = _normal(1, 2, 24, pcfg.padded_vocab) * 3
    labels = _labels(2, 2, 24, pcfg.vocab_size)
    got, n = p_model.cross_entropy(pcfg, _t(logits), _t(labels))
    want, rn = r_model.cross_entropy(rcfg, jnp.asarray(logits),
                                     jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert float(n) == float(rn) == 2 * 19
    # all labels masked: n clamps to 1, loss 0
    got0, n0 = p_model.cross_entropy(pcfg, _t(logits),
                                     _t(np.full((2, 24), -1, np.int32)))
    assert float(got0) == 0.0 and float(n0) == 1.0


@pytest.mark.parametrize("s,chunk", [(24, 16), (24, 512), (40, 32)])
def test_chunked_cross_entropy_and_its_gradient_match_reference(s, chunk):
    """The fused unembed + CE over chunks (16 -> 8 for 24 positions, one
    chunk, 32 -> 8 for 40) and its gradients in x and the head, each chunk
    recomputed in the backward."""
    rcfg, pcfg = RConfig(**_CE), ModelConfig(**_CE)
    x = _normal(3, 2, s, 16)
    head = _normal(4, 16, pcfg.padded_vocab)
    labels = _labels(5, 2, s, pcfg.vocab_size)

    def ref(x_, h_):
        return r_model.chunked_cross_entropy(rcfg, h_, x_, jnp.asarray(labels),
                                             r_layers.no_shard, chunk=chunk)

    want, (wx, wh) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx, th = _t(x).requires_grad_(True), _t(head).requires_grad_(True)
    got = p_model.chunked_cross_entropy(pcfg, th, tx, _t(labels),
                                        chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for g, w in ((tx.grad, wx), (th.grad, wh)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * float(np.abs(w).max()))
    with torch.no_grad():
        plain, _ = p_model.cross_entropy(pcfg, _t(x) @ _t(head), _t(labels))
    np.testing.assert_allclose(float(plain), float(got), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    got = p_adamw.cosine_schedule(3e-4, 5, 20)
    want = r_adamw.cosine_schedule(3e-4, 5, 20)
    for step in range(0, 26):
        np.testing.assert_allclose(float(got(torch.tensor(step))),
                                   float(want(jnp.int32(step))),
                                   rtol=OPT_RTOL)
        np.testing.assert_allclose(float(got(step)),
                                   float(want(jnp.int32(step))),
                                   rtol=OPT_RTOL)


@pytest.mark.parametrize("grad_scale", [0.05, 10.0])   # clip off / on
@pytest.mark.parametrize("step0", [0, 3])
def test_adamw_update_matches_reference(grad_scale, step0):
    """One update from a fresh state or from a state at step 3 (positive v),
    with the global-norm clip off and on, and the cosine schedule: params,
    m, v and step."""
    params, grads = _tree(10), _tree(20)
    grads = jax.tree.map(lambda g: g * grad_scale, grads)
    m = jax.tree.map(lambda p: p * 0.01, _tree(30))
    v = jax.tree.map(lambda p: np.abs(p) * 0.001, _tree(40))
    lr = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    ropt = r_adamw.AdamW(lr=r_adamw.cosine_schedule(**lr))
    popt = p_adamw.AdamW(lr=p_adamw.cosine_schedule(**lr))
    rstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.int32(step0)}
    want_p, want_s = ropt.update(jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, grads), rstate)
    conv = lambda tree: tree_lib.map_tree(_t, tree)  # noqa: E731
    pstate = {"m": conv(m), "v": conv(v),
              "step": torch.tensor(step0, dtype=torch.int32)}
    tparams = conv(params)
    got_p, got_s = popt.update(tparams, conv(grads), pstate)
    assert got_p is tparams          # in place, as the reference donates
    np.testing.assert_allclose(float(popt.global_norm(conv(grads))),
                               float(ropt.global_norm(grads)), rtol=OPT_RTOL)
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for g, w in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=OPT_RTOL, atol=1e-9)
    assert int(got_s["step"]) == int(want_s["step"]) == step0 + 1


def test_adamw_init_is_zeros_in_float32():
    params = tree_lib.map_tree(_t, _tree(1))
    state = p_adamw.AdamW().init(params)
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    for m, p in zip(tree_lib.leaves(state["m"]), tree_lib.leaves(params)):
        assert m.dtype == torch.float32 and m.shape == p.shape
        assert float(m.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def test_int8_quantize_matches_reference():
    g = _normal(50, 7, 9) * 3
    q, s = p_compress.int8_quantize(_t(g))
    rq, rs = r_compress.int8_quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8 and float(s) == float(rs)
    np.testing.assert_array_equal(
        p_compress.int8_dequantize(q, s).numpy(),
        np.asarray(r_compress.int8_dequantize(rq, rs)))
    zq, zs = p_compress.int8_quantize(torch.zeros(4))     # all-zero tensor
    assert float(zq.abs().max()) == 0 and float(zs) > 0


def test_ef_compress_mean_matches_reference():
    """Three pods, each with its own scale; the bf16 error buffer."""
    npod = 3
    grads = {"a": _normal(60, npod, 4, 5), "b": [_normal(61, npod, 6)]}
    err = {"a": _normal(62, npod, 4, 5) * 0.01,
           "b": [_normal(63, npod, 6) * 0.01]}
    rerr = jax.tree.map(lambda e: jnp.asarray(e, jnp.bfloat16), err)
    perr = tree_lib.map_tree(lambda e: _t(e).to(torch.bfloat16), err)
    want_m, want_e = r_compress.ef_compress_mean(
        jax.tree.map(jnp.asarray, grads), rerr, npod)
    got_m, got_e = p_compress.ef_compress_mean(
        tree_lib.map_tree(_t, grads), perr, npod)
    # the bf16 error buffers of both packages hold the same bf16 values
    # (rounded identically from the same float32 inputs)
    for g, w in zip(tree_lib.leaves(got_e), tree_lib.leaves(want_e)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    for g, w in zip(tree_lib.leaves(got_m), tree_lib.leaves(want_m)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OPT_RTOL,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="npod"):
        p_compress.ef_compress_mean(tree_lib.map_tree(_t, grads), perr, 2)


# ---------------------------------------------------------------------------
# data and shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("accum,step,seed", [(1, 0, 0), (2, 7, 3)])
def test_make_batch_is_bit_equal_to_reference(arch, accum, step, seed):
    """Tokens, labels (the vlm's -1 prefix), patch embeddings and M-RoPE
    positions, shaped [accum, B / accum, ...]."""
    got = p_pipeline.make_batch(get_smoke(arch), 4, 40, step, seed, accum)
    want = r_pipeline.make_batch(r_get_smoke(arch), 4, 40, step, seed, accum)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if arch == "qwen2-vl-7b":
        assert {"patch_embeds", "positions"} <= set(got)
        assert (got["labels"][..., :16] == -1).all()


def test_synthetic_lm_shards_match_reference():
    got = p_pipeline.SyntheticLM(97, 33, 8, seed=5)
    want = r_pipeline.SyntheticLM(97, 33, 8, seed=5)
    for host in range(4):
        np.testing.assert_array_equal(got.shard_indices(host, 4),
                                      want.shard_indices(host, 4))
        for key, x in want.batch(3, host, 4).items():
            np.testing.assert_array_equal(got.batch(3, host, 4)[key], x)


def test_shapes_are_the_references():
    assert p_shapes.SHAPES.keys() == r_shapes.SHAPES.keys()
    for name, s in r_shapes.SHAPES.items():
        assert dataclass_fields(p_shapes.SHAPES[name]) == dataclass_fields(s)
    for fam in ("dense", "moe", "hybrid", "ssm", "vlm", "audio"):
        assert p_shapes.applicable_shapes(fam) == \
            r_shapes.applicable_shapes(fam)


def dataclass_fields(x):
    return {f: getattr(x, f) for f in x.__dataclass_fields__}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed):
    return {"params": _tree(seed),
            "opt_state": {"m": _tree(seed + 10), "v": _tree(seed + 20),
                          "step": np.int32(4)},
            "data_step": np.int64(8)}


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    state = _state(1)
    pstate = tree_lib.map_tree(
        lambda x: _t(x) if isinstance(x, np.ndarray) and x.ndim else x, state)
    path = p_ckpt.save_checkpoint(str(tmp_path), 8, pstate)
    assert os.path.basename(path) == "step_00000008.npz"
    assert r_ckpt.latest_step(str(tmp_path)) == 8
    template = jax.tree.map(np.zeros_like, state)
    step, got = r_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 8
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    state = _state(2)
    r_ckpt.save_checkpoint(str(tmp_path), 12, jax.tree.map(jnp.asarray,
                                                           state))
    template = tree_lib.map_tree(
        lambda x: torch.zeros(x.shape) if x.ndim else np.zeros_like(x), state)
    step, got = p_ckpt.restore_checkpoint(str(tmp_path), template,
                                          device="cpu")
    assert step == 12 and p_ckpt.latest_step(str(tmp_path)) == 12
    for g, w in zip(tree_lib.leaves(got), tree_lib.leaves(state)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, w)
    assert isinstance(got["data_step"], np.ndarray)
    assert int(got["data_step"]) == 8


def test_checkpoint_restore_checks_the_template(tmp_path):
    p_ckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        p_ckpt.restore_checkpoint(str(tmp_path), {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        p_ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        p_ckpt.restore_checkpoint(str(tmp_path / "none"), {})
    # a bf16 leaf goes out as float32 and comes back in bf16
    x = _t(_normal(3, 5)).to(torch.bfloat16)
    p_ckpt.save_checkpoint(str(tmp_path), 2, {"a": x})
    _, got = p_ckpt.restore_checkpoint(str(tmp_path), {"a": x * 0})
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], x)


def test_checkpointer_keeps_the_newest_and_sweeps_tmp_files(tmp_path):
    ck = p_ckpt.Checkpointer(str(tmp_path), every=2, keep=2)
    (tmp_path / "orphan.tmp").write_bytes(b"x")
    saved = [ck.maybe_save(s, {"x": torch.full((2,), float(s))})
             for s in range(1, 9)]
    assert saved == [s % 2 == 0 for s in range(1, 9)]
    assert sorted(os.listdir(tmp_path)) == ["step_00000006.npz",
                                            "step_00000008.npz"]
    _, got = p_ckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(2)})
    assert float(got["x"][0]) == 8.0


# ---------------------------------------------------------------------------
# the training loop and the entry point
# ---------------------------------------------------------------------------

# tests/test_train_integration.py's CFG
_TI = dict(name="ti", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
           head_dim=16, dtype="float32")


def test_loss_decreases():
    """The reference's test_loss_decreases on the port: 30 steps of the
    same config, schedule and data (weights from a seeded generator)."""
    from repro_torch.data import make_batch
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = ModelConfig(**_TI)
    model = p_model.get_model(cfg, "cpu")
    opt = AdamW(lr=cosine_schedule(3e-3, 5, 30))
    params = model.init_params(0)
    state = opt.init(params)
    step_fn = p_model.make_train_step(cfg, opt, device="cpu")
    losses = []
    for s in range(30):
        params, state, m = step_fn(params, state,
                                   make_batch(cfg, 8, 64, s, 0))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::5]
    assert np.isfinite(losses).all()


_TRAIN_ARGS = ["--arch", "musicgen-medium", "--smoke", "--batch", "4", "--seq",
           "32", "--log-every", "100", "--device", "cpu"]


def test_train_main_resume_bitwise(tmp_path):
    """The reference's resume test (tests/test_train_integration.py) on
    the port's ``main``: 8 steps with checkpoints every 4, a restart to
    12, and a fresh 12-step run end at the same loss; no kernel launches
    on the CPU."""
    from repro_torch.launch import train
    d = str(tmp_path / "ck")
    before = dict(_build.LAUNCHES)
    args = _TRAIN_ARGS + ["--ckpt-dir", d, "--ckpt-every", "4"]
    out1 = train.main(args + ["--steps", "8"])
    assert out1["steps"] == 8
    assert sorted(os.listdir(d)) == ["step_00000004.npz",
                                     "step_00000008.npz"]
    out2 = train.main(args + ["--steps", "12", "--resume"])
    assert out2["steps"] == 4
    rec = {}
    out3 = train.main(_TRAIN_ARGS + ["--steps", "12"], record=rec)
    assert out2["last_loss"] == pytest.approx(out3["last_loss"], abs=1e-5)
    assert len(rec["step_s"]) == 12 and len(rec["grad_norms"]) == 12
    assert rec["param_sums"][0] != rec["param_sums"][1]
    assert _build.LAUNCHES == before


def test_train_main_pod_compress_and_multi_pod(capsys):
    """--pod-compress runs at one pod; --multi-pod builds the production
    mesh, which in a one-process world raises and names the world size it
    needs (512 ranks)."""
    from repro_torch.launch import train
    out = train.main(_TRAIN_ARGS + ["--steps", "2", "--pod-compress",
                                "--accum", "2"])
    assert out["steps"] == 2 and np.isfinite(out["last_loss"])
    assert "done: loss" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs a world of 512 ranks"):
        train.main(_TRAIN_ARGS + ["--steps", "1", "--multi-pod",
                                  "--pod-compress"])
    assert not torch.distributed.is_initialized()
