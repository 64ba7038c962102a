"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.hlostats``)
against the reference's.

* arithmetic: ``pick_accum``, ``effective_dp``, ``analytic_memory`` and
  ``model_flops`` for every arch x applicable shape x both production
  meshes (and both sharding profiles), float for float; the reference runs
  in ONE subprocess, since importing ``repro/launch/dryrun.py`` sets
  ``XLA_FLAGS`` to 512 host devices;
* ``roofline_terms`` over a grid, with the reference's ``V5E`` read here
  and passed as a port ``Hardware``;
* ``collective_stats`` against ``parse_collectives`` on the same
  collectives written both ways (HLO lines with list and iota replica
  groups and a ``collective-permute``; records with their groups' ranks),
  inside and across pods;
* the recorder on a fake 4-rank world: rank-local FLOPs and a collective
  with its group's ranks; K4/K4b and K5 traced as the card runs them
  (their inputs and outputs once each, no plain score tensor in the peak);
* extrapolation: ``probe_costs`` on smoke configs equals a direct trace at
  3 layer cycles (FLOPs, bytes, collective bytes within rel 1e-9);
* the repair: smoke variants with 6 q / 2 kv and 8 q / 2 kv heads take a
  train step on a fake (data 1, model 4) world with real CPU tensors
  (before it, DTensor refused the q/k/v views);
* coherence: production cells traced at one layer cycle as rank 0 of the
  256- and 512-rank worlds (one subprocess a mesh, both started at import
  of the first test, beside the others): every arch, every shape, both
  meshes.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import FakeMesh  # noqa: E402

from repro.launch import hlostats as r_hl  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES,  # noqa: E402
                                 applicable_shapes, get_config, get_smoke)
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlostats  # noqa: E402
from repro_torch.launch import mesh as p_mesh  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 600
PROFILES = (None, "fsdp")

_REFERENCE = textwrap.dedent("""
    import dataclasses, json
    from repro.launch import dryrun as rd     # sets XLA_FLAGS on import
    from repro.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
    from repro.launch.mesh import make_production_mesh

    meshes = {"pod1": make_production_mesh(),
              "pod2": make_production_mesh(multi_pod=True)}
    out = {}
    for arch in sorted(ARCH_IDS):
        for profile in (None, "fsdp"):
            cfg = get_config(arch)
            if profile:
                cfg = dataclasses.replace(cfg, sharding_profile=profile)
            for name in applicable_shapes(cfg.family):
                shape = SHAPES[name]
                for mname, mesh in meshes.items():
                    dp = rd.effective_dp(cfg, shape, mesh)
                    accum = rd.pick_accum(shape, dp)
                    out[f"{arch}|{profile}|{name}|{mname}"] = {
                        "effective_dp": dp, "accum": accum,
                        "memory": rd.analytic_memory(cfg, shape, mesh, accum),
                        "model_flops": rd.model_flops(cfg, shape)}
    print(json.dumps(out))
""")

_COHERENCE = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, hlostats
    mesh = dryrun.fake_world(sys.argv[1] == "pod2")
    out = {}
    for arch, shape in json.loads(sys.argv[2]):
        got = dryrun.coherence_trace(get_config(arch), SHAPES[shape], mesh)
        coll = hlostats.collective_stats(got["collectives"])
        out[f"{arch}|{shape}"] = {"flops": got["flops"],
                                  "bytes": got["bytes"],
                                  "collectives": coll.count,
                                  "ici": coll.ici_bytes,
                                  "dcn": coll.dcn_bytes}
    print(json.dumps(out))
""")

# every arch and every shape at least once, both meshes; the heaviest
# traces on the single pod, whose traces run faster
COHERENCE = {
    "pod1": [("minitron-4b", "train_4k"), ("mistral-large-123b", "decode_32k"),
             ("granite-moe-3b-a800m", "train_4k"),
             ("recurrentgemma-2b", "long_500k"), ("rwkv6-7b", "decode_32k"),
             ("qwen2-vl-7b", "prefill_32k"), ("musicgen-medium", "train_4k")],
    "pod2": [("mistral-large-123b", "train_4k"), ("minitron-4b", "prefill_32k"),
             ("qwen2.5-14b", "decode_32k"), ("granite-20b", "prefill_32k"),
             ("llama4-scout-17b-a16e", "decode_32k"),
             ("rwkv6-7b", "long_500k")],
}


def _spawn(code: str, *args: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def procs():
    """The reference's arithmetic and the two coherence sweeps, started
    together when the module's first test runs."""
    started = {"reference": _spawn(_REFERENCE)}
    for mname, cells in COHERENCE.items():
        started[mname] = _spawn(_COHERENCE, mname, json.dumps(cells))
    yield started
    for p in started.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference(procs):
    return _result(procs["reference"])


@pytest.fixture(scope="module")
def world4():
    """A fake 4-rank world in this process, this process rank 0, and its
    (data 2, model 2) and (data 1, model 4) meshes; torn down after the
    module, so that no later test sees a default group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        yield {"2x2": init_device_mesh("cpu", (2, 2),
                                       mesh_dim_names=("data", "model")),
               "1x4": init_device_mesh("cpu", (1, 4),
                                       mesh_dim_names=("data", "model"))}
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# arithmetic, roofline, collectives
# --------------------------------------------------------------------------

def _cells():
    for arch in sorted(ARCH_IDS):
        for profile in PROFILES:
            for name in applicable_shapes(get_config(arch).family):
                yield arch, profile, name


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_arithmetic_matches_reference(reference, multi_pod):
    mname = "pod2" if multi_pod else "pod1"
    mesh = FakeMesh(*p_mesh.production_shape(multi_pod=multi_pod))
    n = 0
    for arch, profile, name in _cells():
        cfg = get_config(arch)
        if profile:
            cfg = dataclasses.replace(cfg, sharding_profile=profile)
        shape = SHAPES[name]
        want = reference[f"{arch}|{profile}|{name}|{mname}"]
        dp = dryrun.effective_dp(cfg, shape, mesh)
        accum = dryrun.pick_accum(shape, dp)
        got = {"effective_dp": dp, "accum": accum,
               "memory": dryrun.analytic_memory(cfg, shape, mesh, accum),
               "model_flops": dryrun.model_flops(cfg, shape)}
        assert got == want, (arch, profile, name, mname)
        n += 1
    assert n == len(reference) // 2 == 64


def test_roofline_terms_match_reference():
    hw = hlostats.Hardware(**dataclasses.asdict(r_hl.V5E))
    for flops in (0.0, 1.5e12, 3.3e15, 7.77e17):
        for nbytes in (0.0, 7e9, 2.5e12):
            for ici, dcn in ((0.0, 0.0), (1e9, 0.0), (3e8, 5e7),
                             (4.4e12, 9e10)):
                got = hlostats.roofline_terms(
                    flops, nbytes,
                    hlostats.CollectiveStats(ici_bytes=ici, dcn_bytes=dcn), hw)
                want = r_hl.roofline_terms(
                    flops, nbytes,
                    r_hl.CollectiveStats(ici_bytes=ici, dcn_bytes=dcn),
                    r_hl.V5E)
                assert got == want, (flops, nbytes, ici, dcn)


def test_h100_is_the_default_hardware():
    h = hlostats.H100
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.dcn_bw) == \
        (989e12, 3.35e12, 450e9, 50e9)
    coll = hlostats.CollectiveStats(ici_bytes=4.5e9, dcn_bytes=5e8)
    assert hlostats.roofline_terms(9.89e14, 3.35e12, coll) == \
        hlostats.roofline_terms(9.89e14, 3.35e12, coll, h)
    assert not hasattr(hlostats, "V5E")


_DTYPES = {"bf16": 2, "f32": 4, "s32": 4, "s8": 1}


def _iota_first(g, s, dims, perm):
    arr = np.arange(math.prod(dims)).reshape(dims)
    if perm:
        arr = arr.transpose(perm)
    return [int(x) for x in arr.reshape(g, s)[0]]


def _collective_cases():
    """(HLO line, Collective) pairs: the same op written both ways."""
    def line(op, dt, dims, attrs):
        shape = ",".join(str(d) for d in dims)
        return (f"  %x.1 = {dt}[{shape}]{{0}} {op}({dt}[{shape}]{{0}} %p), "
                f"channel_id=1, {attrs}")

    def groups(gs):
        return "replica_groups={" + ",".join(
            "{" + ",".join(str(r) for r in g) + "}" for g in gs) + "}"

    def iota(g, s, dims, perm=None):
        txt = f"replica_groups=[{g},{s}]<=[{','.join(map(str, dims))}]"
        if perm:
            txt += f"T({','.join(map(str, perm))})"
        return txt, _iota_first(g, s, dims, perm)

    out = []

    def add(op, dt, dims, attrs, ranks):
        nbytes = float(math.prod(dims) * _DTYPES[dt])
        out.append((line(op, dt, dims, attrs),
                    hlostats.Collective(op, nbytes, tuple(ranks))))

    model = [list(range(16)), list(range(16, 32))]
    add("all-gather", "bf16", (16, 4096), groups(model), model[0])
    add("all-to-all", "bf16", (64, 64), groups(model), model[0])
    add("all-reduce", "f32", (1024,), groups([[0, 256], [1, 257]]), [0, 256])
    add("all-reduce", "f32", (3,), groups([[5, 9]]), [5, 9])
    for g, s, dims, perm in ((16, 16, [256], None),         # model axis
                             (16, 16, [16, 16], [1, 0]),    # data axis
                             (256, 2, [2, 256], [1, 0]),    # pod axis
                             (16, 32, [2, 16, 16], [2, 0, 1])):  # pod x data
        for op, dt, dims_ in (("reduce-scatter", "bf16", (8, 128)),
                              ("all-gather", "s32", (2, 8)),
                              ("all-reduce", "s8", (77,))):
            attrs, first = iota(g, s, dims, perm)
            add(op, dt, dims_, attrs, first)
    add("collective-permute", "f32", (512,),
        "source_target_pairs={{0,1},{1,2}}", [0, 1])
    add("collective-permute", "bf16", (512, 2),
        "source_target_pairs={{3,259},{4,260}}", [3, 259])
    return out


def test_collective_stats_match_parse_collectives():
    cases = _collective_cases()
    hlo = "\n".join([line for line, _ in cases] + [
        "  %y = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)"])
    for stride in (256, 16):
        want = r_hl.parse_collectives(hlo, pod_stride=stride)
        got = hlostats.collective_stats([c for _, c in cases],
                                        pod_stride=stride)
        assert got.count == want.count == len(cases)
        assert got.by_op == want.by_op
        assert (got.ici_bytes, got.dcn_bytes) == \
            (want.ici_bytes, want.dcn_bytes), stride
        assert got.dcn_bytes > 0 and got.ici_bytes > 0
    with pytest.raises(ValueError, match="unknown op"):
        hlostats.collective_stats([hlostats.Collective("send", 1.0, (0,))])


def test_recorder_counts_rank_local_work(world4):
    """A DTensor product and a gather on the (2, 2) mesh: the FLOPs of
    rank 0's local product (half the global ones), and one all-gather over
    rank 0's "data" group (ranks 0 and 2) of its result's bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = world4["2x2"]

    def fn(x, w):
        return (x @ w).redistribute(mesh, [Replicate(), Replicate()])

    with FakeTensorMode():
        x = DTensor.from_local(torch.zeros(4, 4), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(8, 4), stride=(4, 1))
        w = DTensor.from_local(torch.zeros(4, 6), mesh,
                               [Replicate(), Replicate()], run_check=False,
                               shape=(4, 6), stride=(6, 1))
        got = dryrun.trace_cell(dryrun.Cell(fn, (x, w), 1))
    assert got["flops"] == 2 * 4 * 4 * 6
    assert got["collectives"] == [hlostats.Collective("all-gather",
                                                      8 * 6 * 4.0, (0, 2))]
    assert got["temp"] >= 8 * 6 * 4 and got["output"] == 8 * 6 * 4


def _fake_kernel_inputs(b, t, h, hkv, d, grad):
    def zeros(*shape):
        return torch.zeros(*shape, requires_grad=grad)
    return zeros(b, t, h, d), zeros(b, t, hkv, d), zeros(b, t, hkv, d)


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_attention_is_traced_as_the_card_runs_it(grad):
    """K4 (and K4b) on fake CPU tensors: the FLOPs of the plain version's
    two products, the bytes of q, k, v and o once each, and no plain
    [B, H, L, L] score tensor in the peak; the backward's peak too."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    b, t, h, hkv, d = 2, 256, 4, 2, 16
    scores = b * h * t * t * 4

    def fn(q, k, v):
        o = ops.flash_attention(q, k, v, causal=True)
        if grad:
            o.sum().backward()
        return o

    with FakeTensorMode():
        q, k, v = _fake_kernel_inputs(b, t, h, hkv, d, grad)
        got = dryrun.trace_cell(dryrun.Cell(fn, (q, k, v), 1))
    assert got["temp"] < scores / 4
    if not grad:
        assert got["flops"] == 4 * b * h * t * t * d
        assert got["bytes"] == 4 * (2 * q.numel() + 2 * k.numel())


def test_wkv_is_traced_as_the_card_runs_it():
    """K5 on fake CPU tensors: the bytes of r, k, v, log_w, u in and o and
    the final state out, once each, and the plain version's FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv as kwkv
    b, h, t, n = 2, 3, 128, 16

    def fn(r, k, v, w, u):
        return ops.wkv_chunked(r, k, v, w, u)

    with FakeTensorMode():
        r, k, v, w = (torch.zeros(b, h, t, n) for _ in range(4))
        u = torch.zeros(n)
        got = dryrun.trace_cell(dryrun.Cell(fn, (r, k, v, w, u), 1))
        with FlopCounterMode(display=False) as fc:
            kwkv.wkv_chunked_plain(r, k, v, w, u)
    assert got["flops"] == fc.get_total_flops() > 0
    assert got["bytes"] == 4 * (5 * r.numel() + n + b * h * n * n)


# --------------------------------------------------------------------------
# probes, the repair, coherence
# --------------------------------------------------------------------------

_EXTRAPOLATED = [
    ("minitron-4b", ShapeConfig("train_s", 64, 4, "train")),
    ("granite-moe-3b-a800m", ShapeConfig("decode_s", 64, 4, "decode")),
    ("recurrentgemma-2b", ShapeConfig("prefill_s", 64, 4, "prefill")),
    ("rwkv6-7b", ShapeConfig("decode_s", 64, 4, "decode")),
]


@pytest.mark.parametrize("arch,shape", _EXTRAPOLATED,
                         ids=[f"{a}-{s.kind}" for a, s in _EXTRAPOLATED])
def test_probe_costs_equal_a_direct_trace(world4, arch, shape):
    """Probes at one and two layer cycles extrapolated to 3 cycles against
    one trace there: exact for a homogeneous stack.  (The ssm's probes in
    T are exact only where DTensor keeps one plan from T 256 to the
    target: its cost model weighs tensor sizes, and at these widths it
    gathers other operands at T 256 than at T 512 and up; the dry run
    reports that check for its ssm cells.)"""
    mesh = world4["2x2"]
    cfg = get_smoke(arch)
    cycle = max(len(cfg.block_pattern), 1)
    cfg = dataclasses.replace(cfg, num_layers=3 * cycle)
    accum = dryrun.pick_accum(shape, dryrun.effective_dp(cfg, shape, mesh))
    assert accum == 1
    got = dryrun.probe_costs(cfg, shape, mesh)
    want = dryrun._trace_cost(cfg, shape, mesh, accum)
    for key in ("flops", "bytes", "ici"):
        assert want[key] > 0, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    assert got["dcn"] == want["dcn"] == 0.0


@pytest.mark.parametrize("heads", [(6, 2), (8, 2)], ids=["6q2kv", "8q2kv"])
def test_uneven_heads_step_on_a_model_axis_of_four(world4, heads):
    """Real CPU tensors on the fake (data 1, model 4) world (collectives
    move no data, so no value is checked): the step completes with every
    leaf placed as before.  DTensor refused the q/k/v views of these heads
    until the repair."""
    mesh = world4["1x4"]
    cfg = dataclasses.replace(get_smoke("qwen2.5-14b"), num_heads=heads[0],
                              num_kv_heads=heads[1])
    params = p_model.get_model(cfg, "cpu").init_params(0)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    p_specs = sh.state_specs(params, mesh, "param")
    params = sh.distribute(params, p_specs, mesh)
    state = sh.distribute(state, sh.state_specs(state, mesh, "opt"), mesh)
    before = [tuple(x.placements) for x in tree_lib.leaves(params)]
    step = p_model.make_train_step(cfg, opt, sh.make_shard_fn(mesh),
                                   device="cpu")
    batch = {"tokens": np.zeros((1, 4, 32), np.int64),
             "labels": np.zeros((1, 4, 32), np.int64)}
    params, state, metrics = step(params, state, batch)
    assert sorted(metrics) == ["aux_loss", "grad_norm", "loss"]
    assert [tuple(x.placements) for x in
            tree_lib.leaves(params)] == before


@pytest.mark.parametrize("mname", sorted(COHERENCE))
def test_production_cells_trace_as_rank_zero(procs, mname):
    """One layer cycle of each cell at its full widths, traced as rank 0
    of the 256- or 512-rank world: the proof that every sharding
    propagation composes.  Rank 0 does local work and talks to its
    groups: never across pods on one pod, and in training on two (the
    gradient's reduction over "pod")."""
    got = _result(procs[mname])
    assert sorted(got) == sorted(f"{a}|{s}" for a, s in COHERENCE[mname])
    for key, rec in got.items():
        assert rec["flops"] > 0 and rec["bytes"] > 0, key
        assert rec["collectives"] > 0 and rec["ici"] > 0, key
        if mname == "pod1":
            assert rec["dcn"] == 0, key
        elif key.endswith("train_4k"):
            assert rec["dcn"] > 0, key     # the gradient's pod reduction


def test_coherence_cells_cover_every_arch_and_shape():
    cells = [c for cs in COHERENCE.values() for c in cs]
    assert {a for a, _ in cells} == set(ARCH_IDS)
    assert {s for _, s in cells} == set(SHAPES)
    for arch, shape in cells:
        assert shape in applicable_shapes(get_config(arch).family)
