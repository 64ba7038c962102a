"""Which collectives gloo takes on CUDA tensors: two ranks on one card.

    python3 tools/gloo_cuda_probe.py [--no-nccl]

NCCL takes one rank a GPU, so two ranks on one card can only talk over
gloo.  Each case (c10d's collectives, the functional collectives that
DTensor issues, and DTensor redistributions) runs in its own pair of
processes with a 30 s collective timeout and a 150 s wall, so a crash or
a hang in one does not stop the others; a crashed rank shows as its exit
code (-11 is a segfault).  Then, unless ``--no-nccl``, a one-rank NCCL
world with a (1, 1, 1) DTensor mesh.  Prints one JSON object a part.
Needs a card.
"""
import datetime
import json
import socket
import subprocess
import sys
import time

import torch

TESTS = ["scatter", "funcol_all_gather", "funcol_all_gather_int8",
         "funcol_all_to_all", "dt_from_local_shard_full_tensor",
         "dt_distribute_shard_only", "dt_from_local_shard0_to_shard1",
         "all_reduce", "all_gather_into_tensor", "all_gather_list",
         "all_gather_into_tensor_int8", "reduce_scatter_tensor",
         "reduce_scatter_list", "all_to_all_single", "broadcast",
         "dt_shard_to_replicate", "dt_partial_to_replicate",
         "dt_partial_to_shard", "dt_shard0_to_shard1", "dt_matmul_partial",
         "dt_int8_shard_to_replicate"]


def rank_main(rank, port, name):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    full = torch.arange(24., device=dev).reshape(4, 6)
    if name.startswith("dt_") or name.startswith("funcol"):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (distribute_tensor, Shard,
                                              Replicate, Partial, DTensor)
        mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    if name == "scatter":
        out = torch.empty(8, device=dev)
        dist.scatter(out, [x.clone(), x.clone()] if rank == 0 else None, src=0)
    elif name == "funcol_all_gather":
        from torch.distributed import _functional_collectives as fc
        y = fc.all_gather_tensor(x, 0, dist.group.WORLD)
        y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
        assert y.shape[0] == 16
    elif name == "funcol_all_gather_int8":
        from torch.distributed import _functional_collectives as fc
        y = fc.all_gather_tensor(x.to(torch.int8), 0, dist.group.WORLD)
        y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
    elif name == "funcol_all_to_all":
        from torch.distributed import _functional_collectives as fc
        y = fc.all_to_all_single(x, None, None, dist.group.WORLD)
        y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
    elif name == "dt_from_local_shard_full_tensor":
        d = DTensor.from_local(full.chunk(2)[rank].contiguous(), mesh, [Replicate(), Shard(0)])
        assert torch.equal(d.full_tensor(), full)
    elif name == "dt_distribute_shard_only":
        d = distribute_tensor(full, mesh, [Replicate(), Shard(0)])
        assert torch.equal(d.to_local(), full.chunk(2)[rank])
    elif name == "dt_from_local_shard0_to_shard1":
        d = DTensor.from_local(full.chunk(2)[rank].contiguous(), mesh, [Replicate(), Shard(0)])
        r = d.redistribute(mesh, [Replicate(), Shard(1)])
        assert torch.equal(r.to_local(), full.chunk(2, dim=1)[rank])
    elif name == "all_reduce":
        y = x.clone(); dist.all_reduce(y)
        assert torch.equal(y.cpu(), 2 * torch.arange(8.) + 1)
    elif name == "all_gather_into_tensor":
        out = torch.empty(16, device=dev); dist.all_gather_into_tensor(out, x)
        assert torch.equal(out.cpu(), torch.cat([torch.arange(8.), torch.arange(8.) + 1]))
    elif name == "all_gather_list":
        outs = [torch.empty(8, device=dev) for _ in range(2)]; dist.all_gather(outs, x)
        assert torch.equal(outs[1].cpu(), torch.arange(8.) + 1)
    elif name == "all_gather_into_tensor_int8":
        xi = (torch.arange(8, device=dev) + rank).to(torch.int8)
        out = torch.empty(16, dtype=torch.int8, device=dev); dist.all_gather_into_tensor(out, xi)
    elif name == "reduce_scatter_tensor":
        out = torch.empty(4, device=dev); dist.reduce_scatter_tensor(out, x)
        assert torch.equal(out.cpu(), (2 * torch.arange(8.) + 1)[4 * rank:4 * rank + 4])
    elif name == "reduce_scatter_list":
        out = torch.empty(4, device=dev); dist.reduce_scatter(out, list(x.chunk(2)))
    elif name == "all_to_all_single":
        out = torch.empty(8, device=dev); dist.all_to_all_single(out, x)
    elif name == "broadcast":
        y = x.clone(); dist.broadcast(y, 0)
        assert torch.equal(y.cpu(), torch.arange(8.))
    elif name == "dt_shard_to_replicate":
        d = distribute_tensor(full, mesh, [Replicate(), Shard(0)])
        assert torch.equal(d.full_tensor(), full)
    elif name == "dt_partial_to_replicate":
        d = DTensor.from_local(full, mesh, [Replicate(), Partial()])
        assert torch.equal(d.full_tensor(), 2 * full)
    elif name == "dt_partial_to_shard":
        d = DTensor.from_local(full, mesh, [Replicate(), Partial()])
        r = d.redistribute(mesh, [Replicate(), Shard(0)])
        assert torch.equal(r.to_local(), 2 * full.chunk(2)[rank])
    elif name == "dt_shard0_to_shard1":
        d = distribute_tensor(full, mesh, [Replicate(), Shard(0)])
        r = d.redistribute(mesh, [Replicate(), Shard(1)])
        assert torch.equal(r.full_tensor(), full)
    elif name == "dt_matmul_partial":
        a = distribute_tensor(full, mesh, [Replicate(), Shard(1)])
        b = distribute_tensor(torch.ones(6, 3, device=dev), mesh, [Replicate(), Shard(0)])
        assert torch.allclose((a @ b).full_tensor(), full @ torch.ones(6, 3, device=dev))
    elif name == "dt_int8_shard_to_replicate":
        d = distribute_tensor(full.to(torch.int8), mesh, [Replicate(), Shard(0)])
        assert torch.equal(d.full_tensor(), full.to(torch.int8))
    torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_one():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor, Replicate
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    a = distribute_tensor(torch.randn(64, 64, device="cuda"), mesh,
                          [Replicate()] * 3)
    out = (a @ a).full_tensor()
    dist.destroy_process_group()
    return "ok" if out.is_cuda else "not on the card"


def main():
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.time()
    procs = {}
    for name in TESTS:
        port = str(free_port())
        procs[name] = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), port, name],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
    res = {}
    for name, ps in procs.items():
        outs = []
        for p in ps:
            try:
                outs.append(p.communicate(
                    timeout=max(5, 150 - (time.time() - t0)))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append((p.communicate()[0] or "") + " TIMEOUT")
        ok = all(p.returncode == 0 for p in ps)
        err = [line for o in outs for line in o.splitlines()
               if "Error" in line or "TIMEOUT" in line]
        res[name] = "ok" if ok else ("; ".join(err[-2:])[:300] or
                                     f"rc {[p.returncode for p in ps]}")
    print(json.dumps({"gloo_cuda": res}, indent=1), flush=True)
    if "--no-nccl" not in sys.argv:
        print(json.dumps({"nccl_world_1": nccl_one()}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
