"""The port's sharding rules (``repro_torch.parallel.sharding``) and
production mesh (``repro_torch.launch.mesh``) against the reference's.

* ``_resolve`` on a ``FakeMesh`` for every rule of both profiles, over
  shapes that divide, drop and (``UNEVEN_OK``) keep an uneven axis;
* ``make_param_rule`` (with and without EP) and ``cache_rule`` over every
  arch's parameter and cache trees;
* ``state_specs`` (param, opt, cache) for every arch's FULL config on both
  production meshes, spec by spec: shapes only (fake tensors on the port's
  side, ``jax.eval_shape`` on the reference's), the reference in ONE
  subprocess that forces 512 host devices (as ``repro/launch/dryrun.py``
  does), so that no test worker's jax changes its device count;
* the reference's placement of rows on a 4-device mesh
  (``devices_indices_map``) against ``_torch_mesh.gspmd_slices``, the rule
  the multi-rank test holds DTensor's slices to.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_smoke as r_get_smoke  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.parallel import sharding as r_sh  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import (ARCH_IDS, expert_parallel_ok,  # noqa: E402
                                 get_config, get_smoke)
from repro_torch.launch import mesh as p_mesh  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import model as p_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

from _torch_mesh import MESHES, SLICE_CASES, FakeMesh, gspmd_slices  # noqa: E402,E501

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAKE = FakeMesh((2, 4, 4), ("pod", "data", "model"))

# per template length: shapes whose dims divide the FakeMesh's axes, fall
# short of them (dropped) and miss them by a little (kept when uneven is
# allowed: dim >= axis / 2)
_SHAPES = {
    0: [()],
    1: [(32,), (7,), (6,), (1,)],
    2: [(32, 64), (7, 5), (10, 6), (3, 1), (16, 2)],
    3: [(8, 12, 5), (7, 5, 5), (32, 10, 6), (16, 3, 2), (2, 8, 16)],
    4: [(8, 12, 4, 16), (7, 5, 3, 2), (32, 64, 10, 6), (16, 16, 2, 3)],
    5: [(8, 16, 4, 4, 16), (3, 7, 5, 3, 2), (32, 8, 10, 6, 2)],
}


def _rules():
    out = []
    for profile in ("2d", "fsdp"):
        for name in sorted(sh.ShardingRules.profile(profile).rules):
            out.append((profile, name))
    return out


def _spec(entries) -> list:
    """A spec (the port's tuple or the reference's PartitionSpec) as JSON
    would hold it."""
    return [list(e) if isinstance(e, tuple) else e for e in entries]


def test_rule_tables_are_the_references():
    for profile in ("2d", "fsdp"):
        for dp in (sh.DP, ("data",)):
            got = sh.ShardingRules.profile(profile, dp).rules
            want = r_sh.ShardingRules.profile(profile, dp).rules
            assert dict(got) == dict(want), (profile, dp)
    assert sh.UNEVEN_OK == r_sh.UNEVEN_OK
    assert sh.DP == r_sh.DP


@pytest.mark.parametrize("profile,name", _rules(),
                         ids=lambda x: str(x))
def test_resolve_matches_reference(profile, name):
    template = sh.ShardingRules.profile(profile).rules[name]
    uneven = name in sh.UNEVEN_OK
    for shape in _SHAPES[len(template)]:
        for leading in (0, 1) if shape else (0,):
            full = (3,) * leading + shape
            got = sh._resolve(template, full, FAKE, uneven, leading)
            want = r_sh._resolve(template, full, FAKE, uneven, leading)
            assert _spec(got) == _spec(tuple(want)), (name, full, leading)
        for mesh in (FakeMesh((16, 16), ("data", "model")),
                     FakeMesh((2, 16, 16), ("pod", "data", "model"))):
            got = sh._resolve(template, shape, mesh, uneven)
            want = r_sh._resolve(template, shape, mesh, uneven)
            assert _spec(got) == _spec(tuple(want)), (name, shape,
                                                      mesh.shape)


def test_resolve_divisible_drop_and_uneven():
    """The reference's own cases (``tests/test_sharding.py``)."""
    assert sh._resolve((("pod", "data"), "model", None), (8, 12, 5), FAKE,
                       uneven_ok=False) == (("pod", "data"), "model", None)
    assert sh._resolve((("pod", "data"), "model", None), (7, 5, 5), FAKE,
                       uneven_ok=False) == (None, None, None)
    assert sh._resolve((None, "model"), (3, 10), FAKE,
                       uneven_ok=True) == (None, "model")
    assert sh._resolve((None, "model"), (3, 1), FAKE,
                       uneven_ok=True) == (None, None)


def _port_smoke_tree(arch: str, kind: str):
    cfg = get_smoke(arch)
    model = p_model.get_model(cfg, "cpu")
    if kind == "cache":
        return model.init_cache(2, 16)
    return model.init_params(0)


def _ref_smoke_flat(arch: str, kind: str):
    cfg = r_get_smoke(arch)
    model = r_model.get_model(cfg)
    if kind == "cache":
        tree = jax.eval_shape(lambda: model.init_cache(2, 16))
    else:
        tree = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("arch", sorted(ARCH_IDS), ids=str)
def test_param_rule_matches_reference(arch):
    tree = _port_smoke_tree(arch, "param")
    ref = _ref_smoke_flat(arch, "param")
    paths = tree_lib.paths(tree)
    assert paths == [jax.tree_util.keystr(p) for p, _ in ref]
    for ep in (False, True):
        got_of, want_of = sh.make_param_rule(ep), r_sh.make_param_rule(ep)
        for path, (rpath, _) in zip(paths, ref):
            assert got_of(path) == want_of(rpath), (arch, path, ep)


@pytest.mark.parametrize("arch", sorted(ARCH_IDS), ids=str)
def test_cache_rule_matches_reference(arch):
    tree = _port_smoke_tree(arch, "cache")
    ref = _ref_smoke_flat(arch, "cache")
    paths = tree_lib.paths(tree)
    assert paths == [jax.tree_util.keystr(p) for p, _ in ref]
    for path, (rpath, _) in zip(paths, ref):
        assert sh.cache_rule(path) == r_sh.cache_rule(rpath), (arch, path)


def test_path_keys_tell_list_indices_from_dict_keys():
    assert sh._path_keys("['blocks']['wq']") == ["blocks", "wq"]
    assert sh._path_keys("['blocks'][2]['w_a']") == ["blocks", 2, "w_a"]
    assert sh._path_keys("['m']['blocks']['mu']") == ["m", "blocks", "mu"]
    rule = sh.make_param_rule()
    assert rule("['blocks']['wq']") == ("p_df", 1)      # stacked on L
    assert rule("['blocks'][0]['wq']") == ("p_df", 0)   # per-layer list


# --------------------------------------------------------------------------
# full configs on the production meshes: the reference in a subprocess
# --------------------------------------------------------------------------

_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCH_IDS, expert_parallel_ok, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.models import model as model_lib
    from repro.optim import AdamW
    from repro.parallel import sharding as sh

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    out = {"specs": {}, "slices": {}}
    meshes = {"single": make_production_mesh(),
              "multi": make_production_mesh(multi_pod=True)}
    for arch in sorted(ARCH_IDS):
        cfg = get_config(arch)
        model = model_lib.get_model(cfg)
        params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        opt = jax.eval_shape(lambda p: dict(
            AdamW().init(p), ef_error=model_lib.init_ef_error(p, 2)), params)
        cache = jax.eval_shape(lambda: model.init_cache(32, 4096))
        for mname, mesh in meshes.items():
            ep = expert_parallel_ok(cfg, mesh.shape["model"])
            for kind, tree in (("param", params), ("opt", opt),
                               ("cache", cache)):
                specs = sh.state_specs(tree, mesh, kind, expert_parallel=ep)
                flat = jax.tree_util.tree_flatten_with_path(specs)[0]
                out["specs"][f"{arch}|{mname}|{kind}"] = [
                    [jax.tree_util.keystr(p), spec(s)] for p, s in flat]
    devs = np.array(jax.devices()[:4])
    for mname, (shape, names) in MESHES.items():
        mesh = jax.sharding.Mesh(devs.reshape(shape), names)
        for i, (entries, tshape) in enumerate(CASES):
            spec_ = P(*[tuple(e) if isinstance(e, list) else e
                        for e in entries])
            idx = NamedSharding(mesh, spec_).devices_indices_map(
                tuple(tshape))
            out["slices"][f"{mname}|{i}"] = [
                [[s.start or 0, tshape[d] if s.stop is None else s.stop]
                 for d, s in enumerate(idx[dev])]
                for dev in mesh.devices.flat]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_specs():
    cases = [[[list(e) if isinstance(e, tuple) else e for e in spec],
              list(shape)] for spec, shape in SLICE_CASES]
    meshes = {k: [list(s), list(n)] for k, (s, n) in MESHES.items()}
    code = (f"MESHES = {json.dumps(meshes)}\n"
            f"CASES = {json.dumps(cases).replace('null', 'None')}\n"
            + _REFERENCE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_full_trees(arch: str):
    cfg = get_config(arch)
    with FakeTensorMode():
        model = p_model.get_model(cfg, "cpu")
        params = model.init_params(0)
        opt = dict(AdamW().init(params),
                   ef_error=p_model.init_ef_error(params, 2))
        cache = model.init_cache(32, 4096)
    return cfg, {"param": params, "opt": opt, "cache": cache}


@pytest.mark.parametrize("arch", sorted(ARCH_IDS), ids=str)
def test_state_specs_match_reference_on_production_meshes(arch,
                                                          reference_specs):
    cfg, trees = _port_full_trees(arch)
    for mname, multi in (("single", False), ("multi", True)):
        shape, names = p_mesh.production_shape(multi_pod=multi)
        mesh = FakeMesh(shape, names)
        ep = expert_parallel_ok(cfg, p_mesh.model_axis_size(mesh))
        for kind, tree in trees.items():
            specs = sh.state_specs(tree, mesh, kind, expert_parallel=ep)
            got = [[p, _spec(s)] for p, s in zip(
                tree_lib.paths(tree), sh.spec_leaves(tree, specs))]
            want = reference_specs["specs"][f"{arch}|{mname}|{kind}"]
            assert [p for p, _ in got] == [p for p, _ in want], (arch, kind)
            for (path, g), (_, w) in zip(got, want):
                assert g == w, (arch, mname, kind, path)


def test_reference_slices_follow_the_gspmd_rule(reference_specs):
    for mname, (shape, names) in MESHES.items():
        for i, (spec, tshape) in enumerate(SLICE_CASES):
            want = gspmd_slices(spec, tshape, shape, names)
            got = [[tuple(b) for b in box]
                   for box in reference_specs["slices"][f"{mname}|{i}"]]
            assert got == want, (mname, spec, tshape)


# --------------------------------------------------------------------------
# mesh helpers, placements, the shard function without a mesh
# --------------------------------------------------------------------------

def test_production_mesh_shapes_and_axis_sizes():
    assert p_mesh.production_shape() == ((16, 16), ("data", "model"))
    assert p_mesh.production_shape(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    single = FakeMesh(*p_mesh.production_shape())
    multi = FakeMesh(*p_mesh.production_shape(multi_pod=True))
    assert p_mesh.dp_size(single) == 16 and p_mesh.dp_size(multi) == 32
    assert p_mesh.model_axis_size(single) == 16 == \
        p_mesh.model_axis_size(multi)
    assert p_mesh.dp_size(FAKE) == 8 and p_mesh.model_axis_size(FAKE) == 4


def test_production_mesh_raises_outside_its_world():
    """Importing ``launch.mesh`` touches no process group; building the
    mesh in a world of one raises and names the size it needs."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs a world of 512 ranks"):
        p_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs a world of 256 ranks"):
        p_mesh.make_production_mesh(device_type="cpu")
    assert not torch.distributed.is_initialized()


class _DeviceMeshLike:
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 2, 2)


def test_placements_of_resolved_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = _DeviceMeshLike()
    assert sh.placements((("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.placements((None, ("data", "model")), m) == \
        [Replicate(), Shard(1), Shard(1)]
    assert sh.placements((), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements((("model", "data"),), m)
    with pytest.raises(ValueError, match="does not divide"):
        sh.placements((("pod", "data"),), m, shape=(6,))


def test_shard_fn_without_a_mesh_is_the_identity():
    x = torch.ones(2, 3)
    assert sh.make_shard_fn(None)(x, "act_btd") is x
    assert p_layers.no_shard(x, "heads") is x
    assert sh.param_specs({"a": x}, None, sh.make_param_rule()) == \
        {"a": None}
    assert sh.batch_spec(None) is None
    assert sh.batch_spec(FAKE, 3) == (("pod", "data"), None, None)
