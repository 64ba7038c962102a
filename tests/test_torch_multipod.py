"""The port's sharded training on a 4-rank gloo world (CPU), held against
the port's one-process step and the reference's.

One spawn of 4 ranks (``tests/_torch_multipod_worker.py``, a timeout on
it) runs everything on two meshes: (pod 2, data 2, model 1) and (pod 1,
data 2, model 2).  While it runs, this process computes the one-process
steps of both packages.  The checks are ``tests/_torch_train_parity.py``'s
A8.2 rules: metrics within rtol 1e-5, gradients within 1e-4 of each
leaf's largest entry, the parameters after one AdamW step under
``check_params`` and the error-feedback buffer under ``check_ef_error``.

* the pod mesh: qwen2.5-14b's smoke config with ``--pod-compress``, accum
  2 (the reference's own multi-device case, ``tests/test_sharding.py``),
  batch 8; ``ef_compress_mean`` on that mesh equals the stacked per-pod
  one bit for bit;
* the model mesh: one smoke config of each family that shards differently
  (dense, moe with EP, ssm, hybrid), and a dense prefill plus one decode
  step with the cache placed by the reference's cache rules;
* heads that do not divide the model axis: on a (pod 1, data 1, model 4)
  mesh, qwen2.5-14b's smoke config with 6 q and 2 kv heads, its step
  against both packages' one-process steps by the same rules, its prefill
  and one decode step against both packages' logits (the reference's
  within ``test_torch_models``' ATOL/RTOL);
* a checkpoint saved on the pod mesh and restored onto the model mesh and
  onto one process, every leaf bit-equal;
* DTensor's slices on both meshes against ``_torch_mesh.gspmd_slices``.
"""
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train_parity as tp  # noqa: E402
from _torch_mesh import (MESHES, SLICE_CASES, UNEVEN_CASES,  # noqa: E402
                         gspmd_slices)
from _torch_multipod_worker import (FAMILIES, LR, POD_ARCH,  # noqa: E402
                                    POD_BATCH, B, S, uneven_config)

from repro.configs import get_smoke as r_get_smoke  # noqa: E402
from repro.data import make_batch as r_make_batch  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.optim import AdamW, ef_compress_mean  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_multipod_worker.py"
WORLD_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pod_reference():
    """The reference's pod-compress step at the pod test's batch."""
    rcfg, _, rparams, _ = tp.setup(POD_ARCH)
    opt = RAdamW(lr=LR)
    state = opt.init(rparams)
    state["ef_error"] = r_model.init_ef_error(rparams, 2)
    step = jax.jit(r_model.make_train_step(rcfg, opt, accum=2,
                                           pod_compress=True, npod=2))
    b = {k: jnp.asarray(v) for k, v in
         r_make_batch(rcfg, POD_BATCH, S, 0, seed=0, accum=2).items()}
    params, state, metrics = step(rparams, state, b)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
            {k: float(v) for k, v in metrics.items()})


def _pod_one_process():
    _, pcfg, _, _ = tp.setup(POD_ARCH)
    params = tp.port_params(POD_ARCH)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    state["ef_error"] = p_model.init_ef_error(params, 2)
    step = p_model.make_train_step(pcfg, opt, accum=2, pod_compress=True,
                                   npod=2, device="cpu")
    params, state, metrics = step(
        params, state, make_batch(pcfg, POD_BATCH, S, 0, seed=0, accum=2))
    return params, state, {k: float(v) for k, v in metrics.items()}


def _uneven_tree():
    """The reference's parameters (numpy) of the uneven-heads variant."""
    rcfg = uneven_config(r_get_smoke(POD_ARCH))
    rparams = jax.jit(r_model.get_model(rcfg).init_params)(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, rparams)


def _uneven_reference(tree):
    """The reference's one-process step of the uneven-heads variant, and
    the gradient of its total loss on microbatch 0."""
    rcfg = uneven_config(r_get_smoke(POD_ARCH))
    rparams = jax.tree.map(jnp.asarray, tree)
    model = r_model.get_model(rcfg)
    b = {k: jnp.asarray(v) for k, v in
         r_make_batch(rcfg, B, S, 0, seed=0).items()}

    def loss(p, mb):
        return r_model._loss_fn(rcfg, model, p, mb, r_layers.no_shard)

    _, grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        rparams, {k: v[0] for k, v in b.items()})
    opt = RAdamW(lr=LR)
    step = jax.jit(r_model.make_train_step(rcfg, opt))
    params, state, metrics = step(rparams, opt.init(rparams), b)
    return (jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state),
            {k: float(v) for k, v in metrics.items()})


def _uneven_one_process(tree):
    """The port's one-process step of the uneven-heads variant, and the
    gradient of its microbatch 0."""
    pcfg = uneven_config(get_smoke(POD_ARCH))
    batch = make_batch(pcfg, B, S, 0, seed=0)
    params = p_model.load_reference_params(pcfg, tree, "cpu")
    mb = p_model._device_batch({k: v[0] for k, v in batch.items()},
                               torch.device("cpu"))
    _, grads = p_model._grads(pcfg, p_model.get_model(pcfg, "cpu"), params,
                              mb)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    step = p_model.make_train_step(pcfg, opt, device="cpu")
    params, state, metrics = step(params, state, batch)
    return grads, params, state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks, compute both packages' one-process results while
    they run, then collect the ranks' results."""
    out = tmp_path_factory.mktemp("multipod")
    for arch in sorted(set(FAMILIES) | {POD_ARCH}):
        torch.save(tp.setup(arch)[3], out / f"params_{arch}.pt")
    uneven_tree = _uneven_tree()
    torch.save(uneven_tree, out / "params_uneven.pt")
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(out)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    one = {"pod_ref": _pod_reference(), "pod_port": _pod_one_process()}
    for arch in FAMILIES:
        one[f"ref/{arch}"] = tp.reference_step(arch)
        one[f"port/{arch}"] = tp.port_step(arch)
        one[f"ref_grads/{arch}"] = tp.reference_grads(arch)
        one[f"port_grads/{arch}"] = tp.port_grads(arch)
    one["uneven"] = _uneven_one_process(uneven_tree)
    one["uneven_ref"] = _uneven_reference(uneven_tree)
    one["uneven_tree"] = uneven_tree
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORLD_TIMEOUT)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * 4, (codes, [e[-3000:] for e in errs])
    res = torch.load(out / "results.pt", weights_only=False)
    return res, one, out


def _numpy(tree):
    return tree_lib.map_tree(lambda x: x.detach().float().numpy(), tree)


def test_dtensor_slices_follow_the_gspmd_rule(world):
    res = world[0]
    for mname, (shape, names) in MESHES.items():
        for i, (spec, tshape) in enumerate(SLICE_CASES + UNEVEN_CASES):
            want = [[(a, b - a) for a, b in box]
                    for box in gspmd_slices(spec, tshape, shape, names)]
            got = [[tuple(d) for d in rank] for rank in
                   res["slices"][f"{mname}|{i}"]]
            assert got == want, (mname, spec, tshape)


def test_pod_mesh_step_matches_one_process_and_reference(world):
    res, one, _ = world
    got = res["pod"]
    rparams, rstate, rmetrics = one["pod_ref"]
    pparams, pstate, pmetrics = one["pod_port"]
    tp.check_metrics(got["metrics"], pmetrics)
    tp.check_metrics(got["metrics"], rmetrics)
    tp.check_params(got["params"], rparams, rstate["m"], tp.POD_NOISE_REL)
    tp.check_params(got["params"], _numpy(pparams), rstate["m"],
                    tp.POD_NOISE_REL)
    tp.check_ef_error(got["ef_error"], rstate["ef_error"])
    tp.check_ef_error(got["ef_error"], _numpy(pstate["ef_error"]))


def test_cross_pod_mean_is_bit_equal_to_stacked_per_pod(world):
    ef = world[0]["ef"]
    means, new_err = ef_compress_mean(ef["grads"], ef["err"], 2)
    for name, g, w in zip(tree_lib.paths(means), tree_lib.leaves(ef["means"]),
                          tree_lib.leaves(means)):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    for name, g, w in zip(tree_lib.paths(new_err),
                          tree_lib.leaves(ef["new_err"]),
                          tree_lib.leaves(new_err)):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("arch", FAMILIES, ids=str)
def test_model_mesh_step_matches_one_process_and_reference(world, arch):
    res, one, _ = world
    got = res[f"step/{arch}"]
    rparams, rstate, rmetrics = one[f"ref/{arch}"]
    _, _, pmetrics = one[f"port/{arch}"]
    tp.check_metrics(got["metrics"], pmetrics)
    tp.check_metrics(got["metrics"], rmetrics)
    tp.check_grads(got["grads"], one[f"ref_grads/{arch}"])
    ptree = tree_lib.unflatten(tp.port_params(arch),
                               [g.numpy() for g in one[f"port_grads/{arch}"]])
    tp.check_grads(got["grads"], ptree)
    tp.check_params(got["params"], rparams, rstate["m"])
    tp.check_params(got["params"], _numpy(one[f"port/{arch}"][0]),
                    rstate["m"])


def test_serving_on_the_model_mesh_matches_one_process(world):
    """A dense prefill and one decode step at model 2, the cache's
    sequence sharded over "model" (the reference's c_kv rule)."""
    got = world[0]["serve"]
    assert got["cache_k"] == ["(Shard(dim=1), Shard(dim=1), Shard(dim=2))"]
    _, pcfg, _, _ = tp.setup(POD_ARCH)
    params = tp.port_params(POD_ARCH)
    logits, cache = p_model.make_prefill_step(pcfg, 20, "cpu")(
        params, {"tokens": got["prompt"]})
    logits2, _ = p_model.make_decode_step(pcfg, "cpu")(params, cache,
                                                       got["next"])
    for name, g, w in (("prefill", got["prefill"], logits),
                       ("decode", got["decode"], logits2)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_uneven_heads_step_matches_one_process(world):
    """6 q and 2 kv heads over a model axis of 4 (the ranks hold 2, 2, 2
    and 0 q heads; 1, 1, 0 and 0 kv heads): the A8.2 rules against the
    port's one-process step."""
    res, one, _ = world
    got = res["uneven"]["step"]
    grads, params, state, metrics = one["uneven"]
    tp.check_metrics(got["metrics"], metrics)
    tp.check_grads(got["grads"], tree_lib.unflatten(
        params, [g.numpy() for g in grads]))
    tp.check_params(got["params"], _numpy(params), _numpy(state["m"]))


def test_uneven_heads_serving_matches_one_process(world):
    """The uneven-heads variant's prefill and one decode step on the
    (1, 1, 4) mesh against one process's logits."""
    res, one, _ = world
    got = res["uneven"]["serve"]
    assert got["cache_k"] == ["(Shard(dim=1), Shard(dim=1), Shard(dim=2))"]
    pcfg = uneven_config(get_smoke(POD_ARCH))
    params = p_model.load_reference_params(pcfg, one["uneven_tree"], "cpu")
    logits, cache = p_model.make_prefill_step(pcfg, 20, "cpu")(
        params, {"tokens": got["prompt"]})
    logits2, _ = p_model.make_decode_step(pcfg, "cpu")(params, cache,
                                                       got["next"])
    for name, g, w in (("prefill", got["prefill"], logits),
                       ("decode", got["decode"], logits2)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_uneven_heads_step_matches_reference(world):
    """The uneven-heads step on the (1, 1, 4) mesh against the reference's
    one-process step and microbatch-0 gradient, by the A8.2 rules."""
    res, one, _ = world
    got = res["uneven"]["step"]
    grads, rparams, rstate, rmetrics = one["uneven_ref"]
    tp.check_metrics(got["metrics"], rmetrics)
    tp.check_grads(got["grads"], grads)
    tp.check_params(got["params"], rparams, rstate["m"])


# the port's logits against the reference's (tests/test_torch_models.py)
REF_ATOL, REF_RTOL = 1e-4, 1e-4


def test_uneven_heads_serving_matches_reference(world):
    """The uneven-heads prefill and one decode step on the (1, 1, 4) mesh
    against the reference's on the same tokens."""
    res, one, _ = world
    got = res["uneven"]["serve"]
    rcfg = uneven_config(r_get_smoke(POD_ARCH))
    rparams = jax.tree.map(jnp.asarray, one["uneven_tree"])
    logits, cache = jax.jit(r_model.make_prefill_step(rcfg, 20))(
        rparams, {"tokens": jnp.asarray(got["prompt"].numpy(), jnp.int32)})
    logits2, _ = jax.jit(r_model.make_decode_step(rcfg))(
        rparams, cache, jnp.asarray(got["next"].numpy(), jnp.int32))
    for name, g, w in (("prefill", got["prefill"], logits),
                       ("decode", got["decode"], logits2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=REF_ATOL,
                                   rtol=REF_RTOL, err_msg=name)


def test_checkpoint_from_the_pod_mesh_restores_anywhere(world):
    """Saved on (2, 2, 1): restored onto (1, 2, 2) in the world (checked
    there) and onto one process here, every leaf bit-equal."""
    res, _, out = world
    assert res["pod"]["ckpt_equal"]
    _, pcfg, _, _ = tp.setup(POD_ARCH)
    params = tp.port_params(POD_ARCH)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    state["ef_error"] = p_model.init_ef_error(params, 2)
    step, back = restore_checkpoint(str(out / "ckpt"),
                                    {"params": params, "opt_state": state})
    assert step == 1
    for name, want in (("params", res["pod"]["params"]),
                       ("m", res["pod"]["m"]),
                       ("ef_error", res["pod"]["ef_error"])):
        tree = back["params"] if name == "params" else back["opt_state"][name]
        for path, g, w in zip(tree_lib.paths(tree), tree_lib.leaves(tree),
                              tree_lib.leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, path)
