"""One rank of ``tests/test_torch_multipod.py``'s 4-rank gloo world.

Run as ``python tests/_torch_multipod_worker.py OUT_DIR`` with ``RANK``,
``WORLD_SIZE`` (4), ``MASTER_ADDR`` and ``MASTER_PORT`` set.  It imports
the port only (no jax): the parameters come from ``OUT_DIR/params_<arch>
.pt`` (the reference's numpy trees, written by the test), carried across
with ``load_reference_params``.  Rank 0 writes ``OUT_DIR/results.pt``,
every DTensor gathered whole:

* ``slices``: each rank's (offset, length) per dim of DTensors placed by
  ``_torch_mesh``'s cases, on both meshes;
* ``pod``: qwen2.5-14b's smoke step on the (pod 2, data 2, model 1) mesh
  with ``--pod-compress``, accum 2, batch 8 (metrics, parameters, first
  moment, ef_error), its state saved to ``OUT_DIR/ckpt`` and restored onto
  the (pod 1, data 2, model 2) mesh (``ckpt_equal``);
* ``ef``: ``ef_compress_mean`` of seeded [2, ...] gradients on the pod mesh;
* ``step/<arch>``: each family's smoke step on the model mesh (metrics,
  microbatch 0's gradients, parameters, first moment);
* ``serve``: qwen2.5-14b's prefill and one decode step on the model mesh,
  the cache placed by the reference's cache rules;
* ``uneven``: on the (pod 1, data 1, model 4) mesh, qwen2.5-14b's smoke
  config with 6 q and 2 kv heads (``UNEVEN_HEADS``; neither divides the
  model axis: the ranks hold 2, 2, 2 and 0 q heads), its step as
  ``step/<arch>`` and its prefill and decode step as ``serve`` (parameters
  from ``OUT_DIR/params_uneven.pt``).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from _torch_mesh import MESHES, SLICE_CASES, UNEVEN_CASES  # noqa: E402

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import expert_parallel_ok, get_smoke  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.optim import AdamW, ef_compress_mean  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

LR = 1e-3
B, S = 4, 32
POD_ARCH, POD_BATCH = "qwen2.5-14b", 8
FAMILIES = ("qwen2.5-14b", "granite-moe-3b-a800m", "rwkv6-7b",
            "recurrentgemma-2b")
UNEVEN_HEADS = {"num_heads": 6, "num_kv_heads": 2}
UNEVEN_MESH = ((1, 1, 4), ("pod", "data", "model"))


def uneven_config(cfg):
    """``cfg`` (either package's ``ModelConfig``) with ``UNEVEN_HEADS``."""
    return dataclasses.replace(cfg, **UNEVEN_HEADS)


def whole(tree):
    return tree_lib.map_tree(
        lambda x: x.full_tensor() if sh.is_dtensor(x) else x, tree)


def slices(meshes):
    out = {}
    for mname, mesh in meshes.items():
        for i, (spec, shape) in enumerate(SLICE_CASES + UNEVEN_CASES):
            t = sh.from_whole(torch.zeros(shape), mesh,
                              sh.placements(spec, mesh, shape))
            mine = list(zip(sh.global_offset(t), t.to_local().shape))
            got = [None] * dist.get_world_size()
            dist.all_gather_object(got, mine)
            out[f"{mname}|{i}"] = got
    return out


def params_of(out_dir, arch, cfg=None):
    tree = torch.load(os.path.join(out_dir, f"params_{arch}.pt"),
                      weights_only=False)
    return p_model.load_reference_params(cfg or get_smoke(arch), tree, "cpu")


def placed_state(cfg, params, mesh, npod=0):
    ep = bool(cfg.num_experts) and expert_parallel_ok(
        cfg, sh.mesh_axes(mesh).shape["model"])
    opt = AdamW(lr=LR)
    state = opt.init(params)
    if npod:
        state["ef_error"] = p_model.init_ef_error(params, npod)
    p_specs = sh.state_specs(params, mesh, "param", ep)
    o_specs = sh.state_specs(state, mesh, "opt", ep)
    return (opt, sh.distribute(params, p_specs, mesh),
            sh.distribute(state, o_specs, mesh), p_specs, o_specs)


def pod_step(out_dir, meshes):
    mesh = meshes["pod"]
    cfg = get_smoke(POD_ARCH)
    opt, params, state, p_specs, o_specs = placed_state(
        cfg, params_of(out_dir, POD_ARCH), mesh, npod=2)
    shard = sh.make_shard_fn(mesh, sh.ShardingRules.default(("data",)))
    step = p_model.make_train_step(cfg, opt, shard, accum=2,
                                   pod_compress=True, npod=2,
                                   unshard_pod=sh.unshard_pod, device="cpu")
    params, state, metrics = step(
        params, state, make_batch(cfg, POD_BATCH, S, 0, seed=0, accum=2))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": whole(params), "m": whole(state["m"]),
           "ef_error": whole(state["ef_error"])}
    # save from the pod mesh, restore onto the model mesh
    ckpt = os.path.join(out_dir, "ckpt")
    saved = {"params": params, "opt_state": state}
    save_checkpoint(ckpt, 1, saved)
    dist.barrier()
    target = meshes["model"]
    shardings = {
        "params": sh.named(sh.state_specs(params, target, "param"), target,
                           params),
        "opt_state": sh.named(sh.state_specs(state, target, "opt"), target,
                              state)}
    _, back = restore_checkpoint(ckpt, saved, shardings=shardings)
    on_target = all(x.device_mesh is target for x in tree_lib.leaves(back)
                    if sh.is_dtensor(x))
    want = tree_lib.leaves(whole(saved))
    got = tree_lib.leaves(whole(back))
    out["ckpt_equal"] = on_target and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    return out


def ef_on_pods(meshes):
    mesh = meshes["pod"]
    rng = np.random.default_rng(24)
    def normal(*shape):
        return torch.from_numpy(rng.standard_normal((2,) + shape)
                                .astype(np.float32))

    grads = {"emb": normal(256, 64),
             "blocks": {"wq": normal(2, 64, 64), "ln1": normal(2, 64)}}
    err = tree_lib.map_tree(
        lambda g: (torch.from_numpy(rng.standard_normal(tuple(g.shape))
                                    .astype(np.float32)) * 0.01)
        .to(torch.bfloat16), grads)
    specs = sh.state_specs({"ef_error": grads}, mesh, "opt")["ef_error"]
    g_d = sh.distribute(grads, specs, mesh)
    e_d = sh.distribute(err, specs, mesh)
    means, new_e = ef_compress_mean(g_d, e_d, 2, sh.unshard_pod)
    return {"grads": grads, "err": err, "means": whole(means),
            "new_err": whole(new_e)}


def family_step(out_dir, meshes, arch, mesh_name="model", cfg=None,
                params_name=None):
    mesh = meshes[mesh_name]
    cfg = cfg or get_smoke(arch)
    opt, params, state, _, _ = placed_state(
        cfg, params_of(out_dir, params_name or arch, cfg), mesh)
    shard = sh.make_shard_fn(mesh)
    batch = make_batch(cfg, B, S, 0, seed=0)
    model = p_model.get_model(cfg, "cpu")
    sub = p_model._sub_mesh(mesh, ())
    mb = p_model._device_batch({k: v[0] for k, v in batch.items()},
                               torch.device("cpu"))
    with sh.mesh_context(params):
        _, grads = p_model._grads(cfg, model, p_model._on_mesh_of(params, sub),
                                  p_model._place_batch(mb, sub), shard)
    grads = [g.full_tensor() for g in grads]
    step = p_model.make_train_step(cfg, opt, shard, device="cpu")
    params, state, metrics = step(params, state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "params": whole(params), "m": whole(state["m"])}


def serve(out_dir, meshes, mesh_name="model", cfg=None, params_name=None):
    mesh = meshes[mesh_name]
    cfg = cfg or get_smoke(POD_ARCH)
    whole_params = params_of(out_dir, params_name or POD_ARCH, cfg)
    params = sh.distribute(whole_params,
                           sh.state_specs(whole_params, mesh, "param"), mesh)
    shard = sh.make_shard_fn(mesh)
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
    prefill = p_model.make_prefill_step(cfg, 20, "cpu", shard)
    decode = p_model.make_decode_step(cfg, "cpu", shard)
    logits, cache = prefill(params, {"tokens": prompt})
    cache = sh.distribute(cache, sh.state_specs(cache, mesh, "cache"), mesh)
    placed = [str(cache["k"].placements)]
    logits2, cache = decode(params, cache, nxt)
    return {"prompt": prompt, "next": nxt, "prefill": logits.full_tensor(),
            "decode": logits2.full_tensor(), "cache_k": placed}


def main(out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    from torch.distributed.device_mesh import init_device_mesh
    meshes = {name: init_device_mesh("cpu", shape, mesh_dim_names=names)
              for name, (shape, names) in MESHES.items()}
    meshes["uneven"] = init_device_mesh("cpu", UNEVEN_MESH[0],
                                        mesh_dim_names=UNEVEN_MESH[1])
    res = {"slices": slices(meshes), "pod": pod_step(out_dir, meshes),
           "ef": ef_on_pods(meshes)}
    for arch in FAMILIES:
        res[f"step/{arch}"] = family_step(out_dir, meshes, arch)
    res["serve"] = serve(out_dir, meshes)
    cfg = uneven_config(get_smoke(POD_ARCH))
    res["uneven"] = {
        "step": family_step(out_dir, meshes, POD_ARCH, "uneven", cfg,
                            "uneven"),
        "serve": serve(out_dir, meshes, "uneven", cfg, "uneven")}
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(out_dir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
