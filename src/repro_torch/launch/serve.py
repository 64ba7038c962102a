"""Batched serving: prefill a prompt batch, then decode (the port of
``repro.launch.serve``).

Prefill runs the prompt through the model in one pass (K4 in every
attention layer of the dense, moe, vlm and audio families and in the
hybrid's local-window layers, K5 in every time-mixing layer of the ssm
family) and builds the cache; decode runs one step per token over the
preallocated KV cache, the hybrid's ring of its window (K4 with one query
row) or the recurrent state.  ``generate`` takes token prompts, as the
reference's does; the vlm's patch prefix is served through
``models.model.make_prefill_step``/``make_decode_step`` with
``{"tokens", "patch_embeds", "positions"}``.

Example (one card, full width and depth):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --batch 8 --prompt-len 1000 --gen 16

``--smoke`` takes the architecture's small config and ``--device cpu``
runs the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts: np.ndarray, gen: int,
             temperature: float = 0.0, seed: int = 0,
             device: str | torch.device = "cuda",
             record: dict | None = None) -> np.ndarray:
    """prompts [B, P] -> tokens [B, P+gen].  Greedy if temperature == 0;
    otherwise sampled with a ``torch.Generator`` seeded with ``seed`` (its
    draws differ from the reference's ``jax.random``).  Padded vocab
    columns are never picked.

    ``record``, when given, receives ``logits`` (the [B, Vp] logits each
    token was picked from, prefill first), ``prefill_s`` and ``decode_s``
    (host seconds around synchronised work) and ``decode_steps``."""
    dev = resolve_device(device)
    p = prompts.shape[1]
    prefill = model_lib.make_prefill_step(cfg, p + gen, dev)
    decode = model_lib.make_decode_step(cfg, dev)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    col_ok = torch.arange(cfg.padded_vocab, device=dev) < cfg.vocab_size

    def pick(logits):
        lg = torch.where(col_ok, logits.float(), -torch.inf)
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen_)[:, 0]
        return torch.argmax(lg, dim=-1)

    kept = []
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    if record is not None:
        _sync(dev)
        record["prefill_s"] = time.perf_counter() - t0
        kept.append(logits)
    t0 = time.perf_counter()
    out = [toks]
    tok = pick(logits)
    steps = 0
    for i in range(gen):
        out.append(tok[:, None])
        if i == gen - 1:
            break
        logits, cache = decode(params, cache, tok[:, None])
        steps += 1
        if record is not None:
            kept.append(logits)
        tok = pick(logits)
    tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    if record is not None:
        _sync(dev)
        record.update(logits=kept, decode_s=time.perf_counter() - t0,
                      decode_steps=steps)
    return tokens


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = model_lib.get_model(cfg, args.device)
    params = model.init_params(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    rec: dict = {}
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen, args.temperature,
                    args.seed, model.device, record=rec)
    dt = time.perf_counter() - t0
    tps = args.batch * args.gen / dt
    print(f"generated {toks.shape} in {dt:.2f}s ({tps:.1f} tok/s) on "
          f"{model.device}: prefill {rec['prefill_s']:.3f}s, "
          f"{rec['decode_steps']} decode steps {rec['decode_s']:.3f}s")
    print("sample:", toks[0, -min(16, args.gen):].tolist())
    return {"tokens": toks, "tok_per_s": tps}


if __name__ == "__main__":
    main()
