"""Deterministic, shard-aware synthetic token pipeline (a numpy copy of
``repro.data.pipeline``: its arrays equal the reference's bit for bit).

Design goals (the large-scale runnability story):

* **Counter-based determinism** — batch(step, example_index) is a pure
  function of (seed, step, example_index) via numpy Philox streams.  There
  is no shared cursor: any host can materialise any example of any step.
* **Straggler / elastic friendliness** — because assignment is
  step-indexed, a restarted or re-sharded job (different host count, or a
  backup host covering a straggler) regenerates exactly the stream it needs;
  the only checkpoint state is the integer ``step``.
* **Learnable structure** — tokens follow a noisy order-1 autoregression
  over a hashed alphabet, so the LM loss decreases measurably within a few
  hundred steps (used by examples/train_lm.py), while stats stay stationary.

The VLM/audio frontends are stubs per the assignment: ``make_batch``
supplies precomputed patch/frame embeddings drawn from the same counter
streams (the backbone is what we build; the encoder is out of scope).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLM", "make_batch"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _rng(self, step: int, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, index]))

    def example(self, step: int, index: int) -> np.ndarray:
        """One sequence of ``seq_len + 1`` tokens (inputs + shifted labels)."""
        rng = self._rng(step, index)
        v = self.vocab_size
        x = np.empty(self.seq_len + 1, np.int32)
        x[0] = rng.integers(v)
        # noisy affine AR(1) over the vocab ring: learnable but non-trivial
        mult = 6364136223846793005 % v or 1
        noise = rng.integers(0, max(v // 64, 2), size=self.seq_len)
        for t in range(self.seq_len):
            x[t + 1] = (x[t] * mult + 17 + noise[t]) % v
        return x

    def shard_indices(self, host_id: int, num_hosts: int) -> np.ndarray:
        """The example indices this host owns (contiguous blocks)."""
        per = self.global_batch // num_hosts
        return np.arange(host_id * per, (host_id + 1) * per)

    def batch(self, step: int, host_id: int = 0,
              num_hosts: int = 1) -> dict[str, np.ndarray]:
        idx = self.shard_indices(host_id, num_hosts)
        seqs = np.stack([self.example(step, int(i)) for i in idx])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def make_batch(cfg: ModelConfig, batch_size: int, seq_len: int, step: int,
               seed: int = 0, accum: int = 1) -> dict[str, np.ndarray]:
    """Full train batch for an architecture, including frontend stubs.
    Leaves are shaped [accum, batch_size/accum, ...]."""
    mb = batch_size // accum
    pipe = SyntheticLM(cfg.vocab_size, seq_len, batch_size, seed)
    out = pipe.batch(step)

    if cfg.frontend == "patch":
        # VLM: a patch-embedding prefix replaces part of the text sequence
        p = cfg.frontend_len
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 977]))
        out["tokens"] = out["tokens"][:, : seq_len - p]
        patch = rng.standard_normal(
            (batch_size, p, cfg.frontend_dim)).astype(np.float32)
        out["patch_embeds"] = patch
        labels = np.concatenate(
            [np.full((batch_size, p), -1, np.int32),
             out["labels"][:, : seq_len - p]], axis=1)
        out["labels"] = labels
        if cfg.mrope_sections is not None:
            out["positions"] = _mrope_positions(batch_size, p, seq_len)

    def resh(x):
        return x.reshape((accum, mb) + x.shape[1:])

    return {k: resh(v) for k, v in out.items()}


def _mrope_positions(batch: int, prefix: int, seq_len: int) -> np.ndarray:
    """Qwen2-VL style (t, h, w) position ids: the patch prefix is a square
    grid at t=0; text tokens advance t with h = w = t."""
    side = max(int(np.sqrt(prefix)), 1)
    t = np.zeros(seq_len, np.int32)
    h = np.zeros(seq_len, np.int32)
    w = np.zeros(seq_len, np.int32)
    for i in range(prefix):
        h[i], w[i] = divmod(i, side)
    text = np.arange(seq_len - prefix, dtype=np.int32) + side
    t[prefix:] = text
    h[prefix:] = text
    w[prefix:] = text
    pos = np.stack([t, h, w])                       # [3, S]
    return np.broadcast_to(pos, (batch, 3, seq_len)).copy()
