"""Multi-pod dry run: trace every (arch x shape x mesh) cell as rank 0 of a
production world (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for the 256- and 512-chip
meshes on forced host devices.  The port has no compiler to ask, so it
runs one rank of the world instead: a fake process group
(``torch.testing._internal.distributed.fake_pg``, whose collectives move
no data) of 256 or 512 ranks in one process, the production
``DeviceMesh`` over it, and the cell's step called once as rank 0 under
``FakeTensorMode`` (tensors with shapes, dtypes and devices and no
storage).  For each cell this gives:

  * proof of coherence: the step traces through every DTensor sharding
    propagation and collective of rank 0 at the full widths;
  * per-chip bytes: rank 0's local shards of the arguments exactly, and
    the peak of the live bytes the step allocates (``MemTracker``);
  * roofline terms: FLOPs (``FlopCounterMode``'s formulas: products and
    attention, not XLA's elementwise work), bytes (each op's operands and
    results, an unfused count where XLA's "bytes accessed" is fused) and
    collective wire bytes per chip (``hlostats.collective_stats``), from
    probes at one and two layer cycles extrapolated linearly in
    (num_layers, accum[, seq for the attention-free ssm]), as the
    reference extrapolates its unrolled compiles; exact for homogeneous
    stacks.

The attention and WKV kernels (K4/K4b, K5/K5b) are traced as the card
runs them (``_kernels_as_on_card``): their outputs are what they allocate,
their bytes are their inputs and outputs once each and their FLOPs are
their plain versions' products, so no plain [B, H, Lq, Lk] score tensor
enters the bytes or the peak.

A process holds one default group, so one process runs one mesh;
``main --mesh both`` runs each mesh in a process of its own.

CLI:  python -m repro_torch.launch.dryrun --arch qwen2.5-14b \
          --shape train_4k --mesh both --out experiments/dryrun_torch
      python -m repro_torch.launch.dryrun --all --skip-probes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 expert_parallel_ok, get_config)
from repro_torch.launch import hlostats
from repro_torch.launch.mesh import (dp_size, make_production_mesh,
                                     model_axis_size)
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import sharding as shrules

MICRO_TOKENS_PER_DP = 8_192      # grad-accum sizing target


def pick_accum(shape, dp: int) -> int:
    if shape.kind != "train":
        return 1
    per_dp = max(shape.global_batch // dp, 1)
    micro_per_dp = max(1, MICRO_TOKENS_PER_DP // shape.seq_len)
    return max(1, per_dp // micro_per_dp)


# --------------------------------------------------------------------------
# input tensors + their specs
# --------------------------------------------------------------------------

def batch_struct(cfg: ModelConfig, shape, accum: int,
                 device: str | torch.device = "cpu") -> dict:
    """Zero tensors of the reference's batch shapes and dtypes (fake ones
    under ``FakeTensorMode``)."""
    b, s = shape.global_batch, shape.seq_len
    lead = (accum, b // accum) if shape.kind == "train" else (b,)
    i32, f32 = torch.int32, torch.float32

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if shape.kind == "decode":
        return {"tokens": zeros((b, 1), i32)}
    if cfg.frontend == "patch":
        p = cfg.frontend_len
        out = {"tokens": zeros(lead + (s - p,), i32),
               "patch_embeds": zeros(lead + (p, cfg.frontend_dim), f32)}
        if cfg.mrope_sections is not None:
            out["positions"] = zeros(lead + (3, s), i32)
    else:
        out = {"tokens": zeros(lead + (s,), i32)}
    if shape.kind == "train":
        out["labels"] = zeros(lead + (s,), i32)
    return out


def batch_shardings(batch, mesh, kind: str, with_model: bool = False):
    """The reference's specs of ``batch``: its batch dim over the
    data-parallel axes when it divides them."""
    mesh = shrules.mesh_axes(mesh)
    axes = ("pod", "data", "model") if with_model else ("pod", "data")
    dp = tuple(a for a in axes if a in mesh.axis_names)

    def one(leaf):
        bdim = 1 if kind == "train" else 0   # [accum, B, ...] vs [B, ...]
        spec = [None] * leaf.dim()
        if leaf.shape[bdim] % math.prod(mesh.shape[a] for a in dp) == 0:
            spec[bdim] = dp
        return tuple(spec)

    return tree_lib.map_tree(one, batch)


# --------------------------------------------------------------------------
# cell construction
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    fn: object
    args: tuple      # this rank's shards (the train step writes 0, 1 in place)
    accum: int


def effective_dp(cfg: ModelConfig, shape, mesh) -> int:
    if shape.kind == "train" and cfg.sharding_profile == "fsdp":
        return shrules.mesh_axes(mesh).size   # batch over every axis
    return dp_size(mesh)


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """Serving weights are bf16 (standard practice; halves weight memory);
    the fsdp profile applies to training only (the serving cache needs the
    model axis for its seq dim)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               sharding_profile="2d")


def _state(cfg: ModelConfig, shape, mesh, accum: int, device):
    """({name: whole tree}, {name: its specs}) of a cell's arguments, made
    in the current tensor mode: "params", "opt" (train) or "cache"
    (decode), and "batch"."""
    ep = expert_parallel_ok(cfg, model_axis_size(mesh))
    model = model_lib.get_model(cfg, device)
    params = model.init_params(0)
    trees = {"params": params}
    specs = {"params": shrules.state_specs(params, mesh, "param",
                                           expert_parallel=ep)}
    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        trees["opt"] = opt.init(params)
        specs["opt"] = shrules.state_specs(trees["opt"], mesh, "opt",
                                           expert_parallel=ep)
    elif shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        # the new token at the cache's last position: attention over all
        # of it, as the reference's masked program computes
        cache["pos"] = shape.seq_len - 1
        trees["cache"] = cache
        specs["cache"] = shrules.state_specs(cache, mesh, "cache")
    batch = batch_struct(cfg, shape, accum, model.device)
    trees["batch"] = batch
    specs["batch"] = batch_shardings(
        batch, mesh, shape.kind, with_model=(cfg.sharding_profile == "fsdp"
                                             and shape.kind == "train"))
    return trees, specs


def build_cell(cfg: ModelConfig, shape, mesh, accum: int | None = None,
               device: str | torch.device = "cpu") -> Cell:
    """The cell's step and its arguments placed on ``mesh`` (a
    ``DeviceMesh``) as this rank's shards: fake under ``FakeTensorMode``,
    real otherwise (each whole leaf made, cut and dropped in turn).

    The train step takes whole [accum, B / accum, ...] batch leaves and
    places each microbatch by ``sharding.batch_spec`` (the batch rule
    without the leading accum dim); serving batches are placed by
    ``batch_shardings``."""
    if shape.kind != "train":
        cfg = serving_config(cfg)
    profile = cfg.sharding_profile if shape.kind == "train" else "2d"
    rules = shrules.ShardingRules.profile(profile)
    shard = shrules.make_shard_fn(mesh, rules)
    accum = pick_accum(shape, effective_dp(cfg, shape, mesh)) \
        if accum is None else accum
    trees, specs = _state(cfg, shape, mesh, accum, device)
    params = shrules.distribute(trees.pop("params"), specs["params"], mesh)
    batch = trees.pop("batch")

    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        step = model_lib.make_train_step(cfg, opt, shard, accum=accum,
                                         device=device)
        opt_state = shrules.distribute(trees.pop("opt"), specs["opt"], mesh)
        return Cell(step, (params, opt_state, batch), accum)
    batch = shrules.distribute(batch, specs["batch"], mesh)
    if shape.kind == "prefill":
        step = model_lib.make_prefill_step(cfg, max_len=shape.seq_len,
                                           device=device, shard=shard)
        return Cell(step, (params, batch), accum)
    # decode: one new token against a cache of seq_len
    step = model_lib.make_decode_step(cfg, device=device, shard=shard)
    cache = shrules.distribute(trees.pop("cache"), specs["cache"], mesh)
    return Cell(step, (params, cache, batch["tokens"]), accum)


# --------------------------------------------------------------------------
# the fake world and the traced step
# --------------------------------------------------------------------------

def fake_world(multi_pod: bool, device_type: str = "cpu"):
    """The production mesh over a fake process group of its size, this
    process rank 0 (the group is made on the first call; a process holds
    one, so a later call must ask for the same size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    need = 512 if multi_pod else 256
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=need,
                                store=FakeStore())
    elif dist.get_world_size() != need:
        raise RuntimeError(f"fake_world: this process's group has "
                           f"{dist.get_world_size()} ranks, not {need}: "
                           f"run each mesh in a process of its own")
    return make_production_mesh(multi_pod=multi_pod, device_type=device_type)


def _functional_group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _unbox(pg):
    if isinstance(pg, torch.distributed.ProcessGroup):
        return pg
    return torch.distributed.ProcessGroup.unbox(pg)


def _group_ranks(pg) -> tuple:
    return tuple(torch.distributed.get_process_group_ranks(pg))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


# the collectives a traced step issues: DTensor's functional ones, and the
# c10d ones the port calls itself (AdamW's norm, the pods' metrics), as
# (the reference's name, the argument that holds the process group)
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": ("all-reduce", 1), "allgather_": ("all-gather", 2)}
_NOT_COLLECTIVES = {"wait_tensor", "barrier"}


def _collective(func, args, out):
    """The ``hlostats.Collective`` of one collective op (its result bytes
    on this rank, its group's ranks), None for any other op; a collective
    it does not know raises rather than go uncounted."""
    ns, name = func.namespace, func._opname
    if ns not in ("_c10d_functional", "c10d") or name in _NOT_COLLECTIVES:
        return None
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        return hlostats.Collective(_FUNCTIONAL[name], float(_nbytes(out)),
                                   _group_ranks(_functional_group(args[-1])))
    if ns == "c10d" and name in _C10D:
        op, pg_at = _C10D[name]
        # the tensors it writes in place are its first argument
        return hlostats.Collective(op, float(_nbytes(args[0])),
                                   _group_ranks(_unbox(args[pg_at])))
    raise NotImplementedError(f"dry run: collective {ns}.{name} is not "
                              f"counted")


def _recorder_class():
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    no_bytes = {"wait_tensor", "empty", "empty_strided", "empty_like",
                "new_empty", "new_empty_strided"}

    class Recorder(MemTracker):
        """One dispatch mode over a traced step: DTensor ops are let
        through (``NotImplemented``) so that it sees each rank-local op;
        per local op it adds FlopCounterMode's FLOPs, the bytes of the
        operands and results of every op that is not a view, and the
        collectives; ``MemTracker`` keeps the live bytes.  The ops that
        DTensor's sharding propagation runs on global shapes to learn an
        output's metadata are not the rank's work: ``paused`` skips them."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.collectives: list = []
            self.paused = 0
            self._flop_of = FlopCounterMode(display=False).flop_registry

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            if self.paused:
                return func(*args, **kwargs)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.namespace == "prim":
                return out
            formula = self._flop_of.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if not func.is_view and func._opname not in no_bytes:
                self.bytes += _nbytes(list(args)) + _nbytes(
                    list(kwargs.values())) + _nbytes(
                    out if isinstance(out, (list, tuple)) else [out])
            coll = _collective(func, args, out)
            if coll is not None:
                self.collectives.append(coll)
            return out

        def peak(self) -> int:
            return int(sum(self._peak_mem.values()))

    return Recorder


@contextlib.contextmanager
def _propagation_paused(rec):
    """``rec.paused`` while DTensor computes an output's global metadata
    (it runs the op on global-shape fake tensors)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def paused(self, *a, **k):
        rec.paused += 1
        try:
            return orig(self, *a, **k)
        finally:
            rec.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _kernels_as_on_card(rec):
    """K4, K4b, K5 and K5b traced as the card runs them: the wrappers'
    dispatch (``flash_attention._flash_forward``, ``flash_attention_bwd``,
    ``wkv._wkv_forward``, ``wkv_chunked_bwd``) is swapped, for CPU tensors,
    for one that allocates the kernel's outputs under ``rec`` (so that
    ``MemTracker`` holds what the card holds: no plain [B, H, Lq, Lk]
    scores), adds the kernel's bytes (each tensor argument read once, each
    output written once; its scratch not counted) and the FLOPs of the
    plain version's products (the plain version run with ``rec`` paused,
    under a ``FlopCounterMode`` of its own: the kernels run the same
    products).  CUDA tensors go to the kernels themselves."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import wkv as kwkv

    def like(x):
        if isinstance(x, (list, tuple)):
            return type(x)(like(y) for y in x)
        return torch.empty_like(x) if isinstance(x, torch.Tensor) else x

    def as_on_card(orig):
        def run(*args, **kwargs):
            if args[0].is_cuda:
                return orig(*args, **kwargs)
            fc = FlopCounterMode(display=False)
            rec.paused += 1
            try:
                with fc:
                    plain = orig(*args, **kwargs)
            finally:
                rec.paused -= 1
            out = like(plain)
            rec.flops += fc.get_total_flops()
            rec.bytes += _nbytes(list(args)) + _nbytes(
                list(kwargs.values())) + _nbytes(
                list(out) if isinstance(out, tuple) else [out])
            return out
        return run

    swapped = [(kfa, "_flash_forward"), (kfa, "flash_attention_bwd"),
               (kwkv, "_wkv_forward"), (kwkv, "wkv_chunked_bwd")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in swapped]
    for mod, name, orig in saved:
        setattr(mod, name, as_on_card(orig))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def _locals(tree) -> list:
    return [x.to_local() if shrules.is_dtensor(x) else x
            for x in tree_lib.leaves(list(tree)) if isinstance(x,
                                                               torch.Tensor)]


def trace_cell(cell: Cell) -> dict:
    """One call of ``cell``'s step (built under the caller's
    ``FakeTensorMode`` in a ``fake_world``), recorded: {"flops", "bytes",
    "collectives" (``hlostats.Collective``s), "temp" (the peak of the
    live bytes above the arguments), "output" (the step's new local
    bytes), "seconds"}.  A successful trace is the proof that every
    sharding propagation of the step composes."""
    rec = _recorder_class()()
    args = _locals(cell.args)
    rec.track_external(*args)
    held = {x.untyped_storage()._cdata: x for x in args}
    base = sum(_nbytes(x) for x in held.values())
    t0 = time.perf_counter()
    with _propagation_paused(rec), _kernels_as_on_card(rec), rec:
        out = cell.fn(*cell.args)
    seconds = time.perf_counter() - t0
    new = [x for x in _locals(out) if x.untyped_storage()._cdata not in held]
    return {"flops": float(rec.flops), "bytes": float(rec.bytes),
            "collectives": rec.collectives,
            "temp": float(max(rec.peak() - base, 0)),
            "output": float(sum(_nbytes(x) for x in new)),
            "seconds": seconds}


def argument_bytes(cfg: ModelConfig, shape, mesh,
                   accum: int | None = None) -> int:
    """Bytes of this rank's shards of a cell's arguments (parameters,
    optimizer state or cache, batch) at the config's depth, from fake
    whole trees (no step is run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if shape.kind != "train":
        cfg = serving_config(cfg)
    accum = pick_accum(shape, effective_dp(cfg, shape, mesh)) \
        if accum is None else accum
    with FakeTensorMode():
        trees, specs = _state(cfg, shape, mesh, accum, "cpu")
    total = 0
    for key, tree in trees.items():
        for x, spec in zip(tree_lib.leaves(tree),
                           shrules.spec_leaves(tree, specs[key])):
            if not isinstance(x, torch.Tensor):
                continue
            local, _ = shrules._local_box(
                x.shape, mesh, shrules.placements(spec, mesh, x.shape))
            total += math.prod(local) * x.element_size()
    return int(total)


# --------------------------------------------------------------------------
# cost probes (small L [, small T for ssm], extrapolated)
# --------------------------------------------------------------------------

def _probe_cfg(cfg: ModelConfig, num_layers: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=num_layers)


def _probe_shape(shape, seq_len: int | None = None):
    if seq_len is None:
        return shape
    return dataclasses.replace(shape, seq_len=seq_len)


def _trace(cfg, shape, mesh, accum) -> dict:
    """``trace_cell`` of a cell built and run under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        cell = build_cell(cfg, shape, mesh, accum=accum)
        return trace_cell(cell)


def _trace_cost(cfg, shape, mesh, accum):
    return _costs(_trace(cfg, shape, mesh, accum))


def _costs(got: dict) -> dict:
    """A trace's {flops, bytes, ici, dcn, temp}."""
    coll = hlostats.collective_stats(got["collectives"])
    return {
        "flops": got["flops"],
        "bytes": got["bytes"],
        "ici": coll.ici_bytes,
        "dcn": coll.dcn_bytes,
        "temp": got["temp"],
    }


def _lincombine(c_small, c_big, x_small, x_big, x_target):
    """Linear extrapolation per metric dict."""
    out = {}
    for k in c_small:
        slope = (c_big[k] - c_small[k]) / (x_big - x_small)
        out[k] = c_small[k] + slope * (x_target - x_small)
    return out


def probe_costs(cfg: ModelConfig, shape, mesh) -> dict:
    """Per-chip {flops, bytes, ici, dcn, temp} for the full cell, via
    traced probes + linear extrapolation in (L, accum[, T]).

    Train probes run at accum=1 with global_batch reduced to ONE microbatch
    (B/accum), so "micro" costs are measured at the real microbatch size;
    the accum pair (A=1 vs A=2 at small L) isolates the optimizer/fixed
    part, and the total is opt + accum * micro(L_full).  ``temp`` (the
    peak of live bytes) is extrapolated in L (and T) only; with accum > 1
    it adds the rise from one microbatch to two (the gradient
    accumulators), which further microbatches do not repeat."""
    accum = pick_accum(shape, effective_dp(cfg, shape, mesh))
    cycle = max(len(cfg.block_pattern), 1)
    l1, l2 = 1 * cycle, 2 * cycle
    if shape.kind == "train":
        mshape = dataclasses.replace(shape, global_batch=shape.global_batch
                                     // accum)
    else:
        mshape = shape
    if cfg.family == "ssm" and shape.kind != "decode":
        # attention-free: costs are linear in T as well -> probe small T
        t1, t2 = 256, 512
        c11 = _trace_cost(_probe_cfg(cfg, l1), _probe_shape(mshape, t1), mesh, 1)
        c21 = _trace_cost(_probe_cfg(cfg, l2), _probe_shape(mshape, t1), mesh, 1)
        c12 = _trace_cost(_probe_cfg(cfg, l1), _probe_shape(mshape, t2), mesh, 1)
        c22 = _trace_cost(_probe_cfg(cfg, l2), _probe_shape(mshape, t2), mesh, 1)
        ct1 = _lincombine(c11, c21, l1, l2, cfg.num_layers)
        ct2 = _lincombine(c12, c22, l1, l2, cfg.num_layers)
        micro = _lincombine(ct1, ct2, t1, t2, mshape.seq_len)
        a1 = c11
    else:
        c1 = _trace_cost(_probe_cfg(cfg, l1), mshape, mesh, 1)
        c2 = _trace_cost(_probe_cfg(cfg, l2), mshape, mesh, 1)
        micro = _lincombine(c1, c2, l1, l2, cfg.num_layers)
        a1 = c1
    if shape.kind != "train" or accum == 1:
        return micro
    # split out the optimizer/fixed part: F(A) = opt + A*micro, probed at
    # (l1, same microbatch, A=2) -> opt = 2*F(A=1) - F(A=2)
    a1_shape = _probe_shape(mshape, 256 if cfg.family == "ssm" else None)
    a2_shape = dataclasses.replace(a1_shape,
                                   global_batch=2 * a1_shape.global_batch)
    a2 = _trace_cost(_probe_cfg(cfg, l1), a2_shape, mesh, 2)
    out = {}
    for k in micro:
        if k == "temp":
            out[k] = micro[k] + max(a2[k] - a1[k], 0.0)
            continue
        d_micro = a2[k] - a1[k]                 # one extra microbatch (l1)
        opt_k = max(a1[k] - d_micro, 0.0)       # optimizer + fixed part
        out[k] = opt_k + accum * max(micro[k] - opt_k, 0.0)
    return out


# --------------------------------------------------------------------------
# cell report
# --------------------------------------------------------------------------

def analytic_memory(cfg: ModelConfig, shape, mesh, accum: int) -> dict:
    """Per-chip memory estimate in the true dtypes (the reference's
    accounting, term for term).  All model/optimizer state is fully
    sharded over the whole mesh (2D param sharding), saved activations are
    seq-sharded over "model"."""
    mesh = shrules.mesh_axes(mesh)
    chips = mesh.size
    dp, tp = dp_size(mesh), model_axis_size(mesh)
    n = cfg.param_count()
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    out = {}
    if shape.kind == "train":
        # f32 params + grads + adam m,v = 16 bytes/param, fully sharded
        out["state"] = 16.0 * n / chips
        mb = max(b // accum // dp, 1)               # seqs per dp-row
        out["saved_acts"] = cfg.num_layers * mb * s * d * 2.0 / tp
        # per-layer working set: ~6 full-seq activation copies (bf16) +
        # one attention panel (f32) for attention archs
        work = 6.0 * mb * s * d * 2.0
        if cfg.num_heads:
            heads_eff = -(-cfg.num_kv_heads // tp) * \
                (cfg.num_heads // cfg.num_kv_heads)
            work += 2.0 * mb * heads_eff * min(s, 1024) * s * 4.0
        out["workspace"] = work
        out["cache"] = 0.0
    else:
        out["state"] = 2.0 * n / chips              # bf16 serving weights
        mb = max(b // dp, 1)
        if cfg.family == "ssm":
            hn = cfg.num_rwkv_heads * cfg.rwkv_head_dim ** 2
            out["cache"] = cfg.num_layers * mb * (hn // tp * 4.0 + 2 * d * 2.0)
        elif cfg.family == "hybrid":
            rec = sum(k == "rec" for k in cfg.layer_kinds)
            attn = cfg.num_layers - rec
            out["cache"] = mb * (
                rec * (cfg.d_rnn_ * 4.0 + 3 * cfg.d_rnn_ * 2.0)
                + attn * cfg.local_window * cfg.num_kv_heads
                * cfg.head_dim_ * 2 * 2.0)
        else:
            out["cache"] = (cfg.num_layers * mb * (s / tp)
                            * cfg.num_kv_heads * cfg.head_dim_ * 2 * 2.0)
        if shape.kind == "prefill":
            out["saved_acts"] = 0.0
            out["workspace"] = 8.0 * mb * s * d * 2.0 / tp + \
                2.0 * mb * s * 1024 * 4.0
        else:
            out["saved_acts"] = 0.0
            out["workspace"] = 64.0 * mb * d * 2.0 + mb * (s / tp) * 4.0 * 64
    out["total"] = sum(out.values()) + 1.0e9        # +1GB runtime slack
    return out


def model_flops(cfg: ModelConfig, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts 2*N_active per
    token (forward only)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch        # decode: one token per seq


def t_extrapolation_error(cfg: ModelConfig, shape, mesh,
                          direct: dict) -> dict:
    """The ssm's probes in T checked at one layer cycle: the costs at T
    256 and 512 extrapolated to the shape's T, against ``direct`` (the
    coherence trace's, there), as relative errors.  DTensor picks each
    op's plan by a cost that weighs tensor sizes, so the extrapolation is
    exact only where the plan does not change between the probes and the
    target."""
    accum = pick_accum(shape, effective_dp(cfg, shape, mesh))
    mshape = shape if shape.kind != "train" else dataclasses.replace(
        shape, global_batch=shape.global_batch // accum)
    l1 = _probe_cfg(cfg, max(len(cfg.block_pattern), 1))
    c1 = _trace_cost(l1, _probe_shape(mshape, 256), mesh, 1)
    c2 = _trace_cost(l1, _probe_shape(mshape, 512), mesh, 1)
    ext = _lincombine(c1, c2, 256, 512, mshape.seq_len)
    return {k: (ext[k] - direct[k]) / direct[k] if direct[k]
            else ext[k] - direct[k] for k in ("flops", "bytes", "ici", "dcn")}


def coherence_trace(cfg: ModelConfig, shape, mesh) -> dict:
    """The coherence proof of a cell: one microbatch (accum 1) of one
    layer cycle at the full widths and sequence length, traced."""
    accum = pick_accum(shape, effective_dp(cfg, shape, mesh))
    cycle = max(len(cfg.block_pattern), 1)
    mshape = shape if shape.kind != "train" else dataclasses.replace(
        shape, global_batch=shape.global_batch // accum)
    return _trace(_probe_cfg(cfg, cycle), mshape, mesh, 1)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                skip_probes: bool = False, profile: str | None = None) -> dict:
    cfg = get_config(arch)
    if profile:
        cfg = dataclasses.replace(cfg, sharding_profile=profile)
    shape = SHAPES[shape_name]
    mesh = fake_world(multi_pod)
    nchips = mesh.size()
    accum = pick_accum(shape, effective_dp(cfg, shape, mesh))

    t0 = time.time()
    direct = _costs(coherence_trace(cfg, shape, mesh))
    trace_s = time.time() - t0
    args = argument_bytes(cfg, shape, mesh, accum)
    report = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": nchips, "accum": accum,
        "trace_s": round(trace_s, 1),
        "bytes_per_chip": {"arguments": args},
    }
    am = analytic_memory(cfg, shape, mesh, accum)
    report["analytic_bytes_per_chip"] = {k: int(v) for k, v in am.items()}
    report["fits_80g"] = bool(am["total"] < 80e9)
    if not skip_probes:
        costs = probe_costs(cfg, shape, mesh)      # per chip
        temp = int(max(costs.pop("temp"), 0.0))
        report["bytes_per_chip"].update(temp=temp, peak=args + temp)
        terms = hlostats.roofline_terms(costs["flops"], costs["bytes"],
                                        hlostats.CollectiveStats(
                                            ici_bytes=costs["ici"],
                                            dcn_bytes=costs["dcn"]))
        mf = model_flops(cfg, shape)
        traced_total = costs["flops"] * nchips
        report.update({
            "per_chip": {k: float(v) for k, v in costs.items()},
            "roofline": {k: (v if isinstance(v, str) else float(v))
                         for k, v in terms.items()},
            "model_flops": mf,
            "useful_flops_ratio": mf / traced_total if traced_total else 0.0,
        })
        if cfg.family == "ssm" and shape.kind != "decode":
            report["t_extrapolation_rel_err"] = t_extrapolation_error(
                cfg, shape, mesh, direct)
    return report


def iter_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg.family):
            yield arch, shape_name


def _run_mesh(cells, multi_pod: bool, args) -> None:
    os.makedirs(args.out, exist_ok=True)
    for arch, shape_name in cells:
        tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}"
        try:
            rep = dryrun_cell(arch, shape_name, multi_pod,
                              skip_probes=args.skip_probes,
                              profile=args.profile)
        except Exception as e:  # noqa: BLE001 - report and continue
            rep = {"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if multi_pod else "16x16",
                   "error": f"{type(e).__name__}: {e}"}
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rep, f, indent=2)
        ok = "FAIL" if "error" in rep else "ok"
        extra = rep.get("error", "")[:120] if "error" in rep else (
            f"args={rep['bytes_per_chip']['arguments']/1e9:.3f}GB "
            f"trace={rep['trace_s']}s"
            + (f" peak={rep['bytes_per_chip']['peak']/1e9:.2f}GB "
               f"bottleneck={rep['roofline']['bottleneck']}"
               if "roofline" in rep else ""))
        print(f"[{ok}] {tag}: {extra}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--profile", default=None, choices=[None, "2d", "fsdp"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    if args.mesh != "both":
        _run_mesh(cells, args.mesh == "pod2", args)
        return
    # one process a mesh (a process holds one default group), both at once
    argv = list(sys.argv[1:] if argv is None else argv)
    at = argv.index("--mesh") if "--mesh" in argv else None
    if at is not None:
        del argv[at:at + 2]
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name,
                               "--mesh", m] + argv) for m in ("pod1", "pod2")]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(max(codes))


if __name__ == "__main__":
    main()
