#!/usr/bin/env python3
"""Split where rwkv6-7b's float32 gradients on the card part from the
plain path's: K5's forward or K5b's backward.

    python3 tools/wkv_grad_split.py

rwkv6-7b at full width and 4 layers, 8 x 1024 tokens, float32 with TF32
off, the weights and batch of ``chip_smoke.py`` phase 17c (seed 12,
``decay_b`` drawn so that ``decay_a`` has a gradient).  Each leaf's
gradient (``models.model._grads``) is taken four ways: the kernel path
(K5 + K5b), the plain path (plain forward and backward, phase 17c's
``plain_path``), K5's forward with the plain backward, and the plain
path again.  Prints one JSON line with each pair's rel L2 per leaf: the
kernel path against the plain one, K5 forward + plain backward against the
plain path (what K5's forward alone moves), the kernel path against K5
forward + plain backward (what K5b alone moves), and the plain path
against itself (it is deterministic).  Needs a card.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wkv_grad_split: needs a CUDA card")
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wkv as kwkv
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    arch, seq, seed = next(f for f in cs.TRAIN_FAMILIES if f[0] == "rwkv6-7b")
    cfg = dataclasses.replace(get_config(arch), num_layers=4,
                              dtype="float32")
    model = model_lib.get_model(cfg)
    params = model.init_params(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    db = params["blocks"]["decay_b"]
    db.copy_(torch.randn(db.shape, generator=gen, device="cuda") * 0.01)
    names = tree_lib.paths(params)
    batch = make_batch(cfg, cs.TRAIN_BATCH, seq, 0, seed)
    mb = model_lib._device_batch({k: x[0] for k, x in batch.items()},
                                 torch.device("cuda"))

    def grads():
        return model_lib._grads(cfg, model, params, mb)[1]

    class KernelForwardPlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, log_w, u, s0):
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(r, k, v, log_w, u, s0)
            return kwkv._wkv_forward(r, k, v, log_w, u, s0)

        @staticmethod
        def backward(ctx, do, ds):
            return kwkv.wkv_chunked_bwd_plain(*ctx.saved_tensors, do, ds)

    kernel = grads()
    with cs.plain_path(kops, kfa, kwkv):
        plain = grads()
    saved = kops.wkv_chunked
    kops.wkv_chunked = KernelForwardPlainBackward.apply
    try:
        mixed = grads()
    finally:
        kops.wkv_chunked = saved
    with cs.plain_path(kops, kfa, kwkv):
        again = grads()
    print(json.dumps({
        "card": cs.card_line(), "arch": arch, "layers": 4, "seq": seq,
        "kernel_vs_plain": dict(zip(names, cs.leaf_rel(kernel, plain))),
        "k5_forward_plain_backward_vs_plain": dict(zip(
            names, cs.leaf_rel(mixed, plain))),
        "kernel_vs_k5_forward_plain_backward": dict(zip(
            names, cs.leaf_rel(kernel, mixed))),
        "plain_vs_plain": dict(zip(names, cs.leaf_rel(again, plain)))}))


if __name__ == "__main__":
    main()
