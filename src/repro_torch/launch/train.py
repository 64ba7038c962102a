"""End-to-end training entry point (the port of ``repro.launch.train``):
checkpoint, restart, and the reference's flags, loop and printed lines.

  * deterministic counter-based data (``data.make_batch``: any host can
    build any step's batch),
  * gradient accumulation and per-layer remat (``models.model``),
  * AdamW + cosine schedule + clipping (``optim``),
  * atomic checkpoints every ``--ckpt-every`` steps; ``--resume`` restarts
    from the newest complete checkpoint (the reference's file format, so
    either package resumes the other's),
  * int8 error-feedback gradient compression (``--pod-compress``): at one
    pod without ``--multi-pod``, as the reference runs it; across the pods
    of the production mesh with it,
  * ``--multi-pod``: the production mesh (2, 16, 16) over ("pod", "data",
    "model") (``launch.mesh``), the reference's rules with the batch over
    "data" only (``ShardingRules.default(dp_axes=("data",))``): each pod
    computes its own gradient, and ``--pod-compress`` makes the int8
    all-gather of ``optim.compress`` the only collective between pods.
    Run it under ``torchrun``, one rank a card (NCCL; ``--device cpu``
    takes gloo); every rank makes the whole parameters from ``--seed`` and
    keeps its slice (``parallel.sharding.state_specs``).  In a world of
    other than 512 ranks it raises, naming the size it needs.

It runs on the card unless ``--device cpu``; the parameters come from an
explicit generator seeded with ``--seed`` (their draws differ from the
reference's ``jax.random``).

Example (one card, musicgen-medium at full width and depth):

    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
        --batch 8 --seq 1024 --steps 6 --warmup 2

and on the CPU with the small config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
        --smoke --device cpu --steps 30 --batch 8 --seq 64
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs import expert_parallel_ok
from repro_torch.data import make_batch
from repro_torch.models import layers as mlayers
from repro_torch.models import model as model_lib
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import sharding as shrules


def _leaf_sums(params) -> list[float]:
    return [float(p.double().sum()) for p in tree_lib.leaves(params)]


def main(argv=None, record: dict | None = None) -> dict:
    """Train as the flags say; returns ``{"first_loss", "last_loss",
    "steps"}``.  ``record``, when given, receives ``losses``,
    ``grad_norms``, ``step_s`` (host seconds of each step, synchronised)
    and ``param_sums`` (each leaf's sum in float64) before the first step
    and after the last."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--pod-compress", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production multi-pod mesh (under torchrun)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = args.device
    mesh = None
    shard = mlayers.no_shard
    npod = 1
    unshard_pod = None
    if args.multi_pod:
        from repro_torch.launch.mesh import make_production_mesh
        device = _join_world(args.device)
        mesh = make_production_mesh(multi_pod=True,
                                    device_type=torch.device(device).type)
        npod = shrules.mesh_axes(mesh).shape["pod"]
        rules = shrules.ShardingRules.default(dp_axes=("data",))
        shard = shrules.make_shard_fn(mesh, rules)
        if args.pod_compress:
            unshard_pod = shrules.unshard_pod

    model = model_lib.get_model(cfg, device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(args.seed))
    opt_state = opt.init(params)
    if args.pod_compress:
        opt_state["ef_error"] = model_lib.init_ef_error(params, npod)
    shardings = None
    if mesh is not None:
        ep = expert_parallel_ok(cfg, shrules.mesh_axes(mesh).shape["model"])
        p_specs = shrules.state_specs(params, mesh, "param", ep)
        o_specs = shrules.state_specs(opt_state, mesh, "opt", ep)
        params = shrules.distribute(params, p_specs, mesh)
        opt_state = shrules.distribute(opt_state, o_specs, mesh)
        shardings = {"params": shrules.named(p_specs, mesh, params),
                     "opt_state": shrules.named(o_specs, mesh, opt_state),
                     "data_step": None}

    train_step = model_lib.make_train_step(
        cfg, opt, shard, accum=args.accum, pod_compress=args.pod_compress,
        npod=npod, unshard_pod=unshard_pod, device=model.device)

    start = 0
    ckpt = Checkpointer(args.ckpt_dir, args.ckpt_every) if args.ckpt_dir \
        else None
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        template = {"params": params, "opt_state": opt_state,
                    "data_step": np.zeros((), np.int64)}
        start, state = restore_checkpoint(args.ckpt_dir, template,
                                          shardings=shardings)
        params, opt_state = state["params"], state["opt_state"]
        start = int(state["data_step"])
        print(f"resumed from step {start}")

    losses = []
    if record is not None:
        record.update(losses=losses, grad_norms=[], step_s=[],
                      param_sums=[_leaf_sums(params)])
    t0 = time.time()
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = make_batch(cfg, args.batch, args.seq, step, args.seed,
                           accum=args.accum)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if record is not None:      # the loss's read has synchronised
            record["step_s"].append(time.perf_counter() - t_step)
            record["grad_norms"].append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({dt:.1f}s)", flush=True)
        if ckpt is not None:
            ckpt.maybe_save(step + 1, {"params": params,
                                       "opt_state": opt_state,
                                       "data_step": np.int64(step + 1)})
    if record is not None:
        record["param_sums"].append(_leaf_sums(params))
    out = {"first_loss": losses[0], "last_loss": losses[-1],
           "steps": len(losses)}
    print(f"done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")
    return out


def _join_world(device: str) -> str:
    """Under ``torchrun`` (``WORLD_SIZE`` set): join the process group
    (NCCL on the card, gloo on the CPU) and return this rank's device;
    otherwise ``device`` as given (a world of one)."""
    dist = torch.distributed
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    on_card = torch.device(device).type == "cuda"
    if on_card:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("nccl" if on_card else "gloo")
    return device


if __name__ == "__main__":
    main()
