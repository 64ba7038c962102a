"""Atomic checkpoints (the port of ``repro.checkpoint.checkpointing``), in
the reference's file format, so that each package restores the other's.

* **Format** — ``step_XXXXXXXX.npz`` holding one array per leaf of the
  state tree, named by the leaf's ``jax.tree_util.keystr``
  (``['params']['blocks']['wq']``, ``[0]`` for a list item;
  ``repro_torch.tree.paths``), each in its full shape on the host.  A
  bf16 leaf (the error-feedback buffer) is stored as float32, which holds
  it exactly (numpy has no bf16), and cast back on restore.
* **Atomicity** — the state is written to a temp file in the checkpoint
  directory and ``os.replace``'d into place; partial files are never read
  and are swept after the next successful write.
* **Complete state** — params, optimizer state and the data cursor (an
  int: the pipeline is counter-based) live in one tree, so a restore
  resumes bit for bit.
* **One writer** — only rank 0 of an initialised ``torch.distributed``
  group writes (every process restores).  A DTensor leaf (a state placed on
  a mesh) is written in its full shape: every rank gathers it (a
  collective, so every rank calls ``save_checkpoint``), rank 0 writes.
* **Re-sharding** — ``restore_checkpoint(..., shardings=)`` places each
  leaf on a (new) mesh: the reference's elastic path, here a tree of
  ``parallel.sharding.Placed`` (a mesh and a spec) or None leaves.

Retention keeps the last ``keep`` checkpoints and deletes older ones after
a successful write, never before.
"""
from __future__ import annotations

import dataclasses
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel import sharding as shlib

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "Checkpointer"]

_FILE_RE = re.compile(r"^step_(\d{8})\.npz$")


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _host(x) -> np.ndarray:
    if shlib.is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(state) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in zip(tree_lib.paths(state),
                                                  tree_lib.leaves(state))}


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Atomically write ``state`` (a tree of tensors, DTensors and numpy
    values) for ``step``; returns the file's path ('' on a rank other than
    0)."""
    flat = _flatten(state)      # every rank: a DTensor gathers
    if _rank() != 0:
        return ""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _FILE_RE.match(n))]
    return max(steps) if steps else None


def _restore_leaf(key: str, arr: np.ndarray, leaf, device):
    want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(arr.shape) != want:
        raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                         f"template wants {want}")
    if isinstance(leaf, torch.Tensor):
        if shlib.is_dtensor(leaf):
            leaf = leaf.to_local()
        dev = leaf.device if device is None else torch.device(device)
        return torch.as_tensor(arr).to(device=dev, dtype=leaf.dtype)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def restore_checkpoint(ckpt_dir: str, template, step: int | None = None,
                       device: str | torch.device | None = None,
                       shardings=None):
    """Restore into the structure of ``template``: ``(step, state)``.  A
    tensor leaf comes back in the template leaf's dtype on ``device`` (the
    template leaf's device when None, a DTensor's local device), a numpy
    leaf as numpy.  ``shardings`` (a tree like ``template`` of
    ``parallel.sharding.Placed`` or None leaves, e.g. for a new mesh)
    places each tensor leaf as a DTensor (every rank reads the file and
    keeps its slice)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    new = []
    for key, leaf in zip(tree_lib.paths(template), tree_lib.leaves(template)):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        new.append(_restore_leaf(key, arrays[key], leaf, device))
    state = tree_lib.unflatten(template, new)
    if shardings is not None:
        state = tree_lib.map_tree(
            lambda x, s: s.place(x) if s is not None
            and isinstance(x, torch.Tensor) else x, state, shardings)
    return step, state


@dataclasses.dataclass
class Checkpointer:
    """save-every-N with retention; wraps the functions above."""
    ckpt_dir: str
    every: int = 100
    keep: int = 3

    def maybe_save(self, step: int, state) -> bool:
        if step % self.every != 0:
            return False
        save_checkpoint(self.ckpt_dir, step, state)
        self._gc()
        return True

    def _gc(self) -> None:
        if _rank() != 0 or not os.path.isdir(self.ckpt_dir):
            return
        entries = sorted(
            (int(m.group(1)), n) for n in os.listdir(self.ckpt_dir)
            if (m := _FILE_RE.match(n)))
        for _, name in entries[:-self.keep]:
            os.unlink(os.path.join(self.ckpt_dir, name))
        # sweep orphaned tmp files from crashed writes
        for n in os.listdir(self.ckpt_dir):
            if n.endswith(".tmp"):
                os.unlink(os.path.join(self.ckpt_dir, n))
