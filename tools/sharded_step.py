"""The sharded train step on four ranks, held against one process.

    python3 tools/sharded_step.py            # four cards, NCCL
    python3 tools/sharded_step.py --cpu      # four CPU processes, gloo

Four ranks (one a card) run ``chip_smoke.py``'s phase-18 step, the
musicgen-medium configuration at full width and 4 layers in float32 over 8
x 1024 tokens (``--cpu``: its smoke configuration over 8 x 32), on the two
meshes of ``tests/test_torch_multipod.py``: (pod 2, data 2, model 1) with
``--pod-compress`` at npod 2, the batch over "data" inside a pod; and
(pod 1, data 2, model 2) with it at npod 1, each rank running K4 and K4b
on its 12 of the 24 heads.  Rank 0 holds each against the one-process
step on the same parameters (phase 18's rules: ``chip_smoke.check_a82``)
and prints one JSON line a mesh: metrics, bit equality, the largest
parameter difference, each rank's launches and the step's seconds (the
first call, DTensor's planning included, and a second on the same
inputs).
"""
from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORLD = 4
MESHES = (("pod", (2, 2, 1), 2), ("model", (1, 2, 2), 1))


def rank_main(rank: int, port: str, on_cpu: bool) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import _build
    from repro_torch.parallel import sharding as sh
    kind = "cpu" if on_cpu else "cuda"
    if not on_cpu:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load()
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        device = "cpu" if on_cpu else f"cuda:{rank}"
        cfg, params, batch = cs.shard_inputs(device, smoke=on_cpu)
        for name, shape, npod in MESHES:
            mesh = init_device_mesh(kind, shape,
                                    mesh_dim_names=("pod", "data", "model"))
            rules = sh.ShardingRules.default(
                dp_axes=("data",) if npod > 1 else sh.DP)
            runs = []
            for _ in range(2):
                got = cs.sharded_step(cfg, tree_lib.map_tree(torch.clone,
                                                             params),
                                      batch, mesh, rules, npod)
                runs.append(got)
            gp, gs, gm, counts, sites, _ = runs[0]
            launches = [None] * WORLD
            dist.all_gather_object(launches, (counts, sites))
            if rank == 0:
                want = cs.one_process_step(
                    cfg, tree_lib.map_tree(torch.clone, params), batch, npod)
                label = f"{name} mesh {shape}, npod {npod}"
                res = cs.check_a82(label, (gp, gs, gm), want)
                if not on_cpu:
                    for r, (c, st) in enumerate(launches):
                        cs.check_shard_launches(f"{label}, rank {r}", c, st)
                print(json.dumps({
                    "mesh": name, "shape": shape, "npod": npod,
                    "device": kind if on_cpu else
                    torch.cuda.get_device_name(rank),
                    "step_s": [r[5] for r in runs],
                    "launches": [c for c, _ in launches],
                    **res}), flush=True)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    on_cpu = "--cpu" in sys.argv
    if not on_cpu:
        if torch.cuda.device_count() < WORLD:
            raise SystemExit(f"sharded_step: needs {WORLD} cards")
        print(cs.card_line(), flush=True)
        from repro_torch.kernels import _build
        _build.load()               # once, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), port]
        + (["--cpu"] if on_cpu else []),
        env=dict(os.environ, OMP_NUM_THREADS="1")) for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(json.dumps({"wall_s": time.perf_counter() - t0, "rcs": codes}))
    if any(codes):
        raise SystemExit(1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], "--cpu" in sys.argv)
    else:
        main()
