"""Port hygiene: ``repro_torch`` (``design/``, ``lifecycle/``,
``core/adversarial.py`` and ``core/routing.py`` included) and
``chip_smoke.py`` never import jax or the reference package,
importing the port builds nothing, and entry points refuse to run quietly
on the CPU when no card is present."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import design, lifecycle  # noqa: E402
from repro_torch.core import (get_engine, graphs, heterogeneous, mcf,  # noqa: E402,E501
                              routing, traffic)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ell as kell  # noqa: E402
from repro_torch.launch import figures  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & set(_FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_leaves_jax_out_of_the_process():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "ell, repro_torch.kernels.fw, repro_torch.kernels.ops, "
            "repro_torch.core.primal, repro_torch.core.heterogeneous, "
            "repro_torch.core.vl2, repro_torch.core.fabric, "
            "repro_torch.core.decompose, repro_torch.launch.figures, "
            "repro_torch.core.adversarial, repro_torch.design, "
            "repro_torch.design.optimizer, repro_torch.core.routing, "
            "repro_torch.kernels.paths, repro_torch.lifecycle, "
            "repro_torch.lifecycle.degradation, "
            "repro_torch.lifecycle.expansion, repro_torch.parallel, "
            "repro_torch.parallel.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.models.model, "
            "repro_torch.launch.hlostats, repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build.load.cache_info().currsize == 0, 'built on import'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = graphs.random_regular_graph(8, 3, seed=0, servers=2)
    dem = traffic.make("permutation", topo.servers, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_engine("dual").solve(topo, dem)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_engine("dual").solve_batch([topo], [dem])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mcf.aspl(topo)
    for name in ("primal", "certified"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_engine(name).solve(topo, dem)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_engine(name).solve_batch([topo], [dem])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        figures.main(["--only", "fig5", "--engine", "certified"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_engine("adversarial").solve(topo, dem)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic.make("adversarial", topo.servers, seed=1, topo=topo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mcf.solve_dual_demgrad_batch([topo.cap], [dem])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        design.optimize(design.TwoClassSpace(heterogeneous.TwoClassSpec(
            n_large=3, k_large=12, n_small=7, k_small=5, num_servers=25)),
            rounds=0, fleet=1)
    for solve in (routing.solve_ecmp_batch, routing.solve_ksp_batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve([topo.cap], [dem])
    for name in ("ecmp", "ksp"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_engine(name).solve(topo, dem)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_engine(name).solve_batch([topo], [dem])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lifecycle.degradation_surface({"rrg": topo}, fractions=(0.1,),
                                      trials=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lifecycle.plan_expansion(topo, [[2]], rounds=0, fleet=1, elite=1,
                                 runs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kell.ell_bf_apsp_streamed(np.zeros((4, 1), np.int32),
                                  np.zeros((4, 1), np.float32))
    assert mcf.resolve_device("cpu") == torch.device("cpu")
    assert mcf.aspl(topo, device="cpu") > 1.0


def test_kernel_sources_and_bindings_agree():
    names = {p.name for p in _build.SOURCES}
    assert names == {"minplus.cu", "fw_pivot.cu", "ell.cu",
                     "flash_attention.cu", "flash_attention_mma.cu",
                     "flash_decode.cu", "wkv.cu", "flash_attention_bwd.cu",
                     "flash_attention_bwd_mma.cu", "wkv_bwd.cu"}
    text = "".join(p.read_text() for p in _build.SOURCES)
    for entry in _build._SIGNATURES:
        assert f'extern "C" int {entry}(' in text, entry
    for src in _build.SOURCES:
        # every source says which TPU kernel it replaces (the two backwards:
        # none, the reference's XLA differentiates its jnp functions) and
        # what bounds it
        head = src.read_text()[:3000]
        backward = src.name in ("flash_attention_bwd.cu",
                                "flash_attention_bwd_mma.cu", "wkv_bwd.cu")
        assert ("Replaces no TPU kernel" if backward
                else "Replaces the TPU kernel") in head, src.name
        assert "bounds it on Hopper" in head, src.name
    assert set(_build.LAUNCHES) == {"minplus_acc", "fw_pivot",
                                    "ell_relax_round", "flash_attention",
                                    "wkv_chunked", "flash_attention_bwd",
                                    "wkv_chunked_bwd"}
    assert _build.BUILD_DIR.relative_to(ROOT) == pathlib.Path("build/kernels")
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_cpu_tensors_never_launch_kernels():
    before = dict(_build.LAUNCHES)
    sites = dict(_build.SITE_LAUNCHES)
    t = graphs.random_regular_graph(12, 3, seed=2, servers=2)
    dem = traffic.make("permutation", t.servers, seed=3)
    for backend in ("squaring", "squaring-pallas", "blocked-fw", "ell-bf"):
        r = get_engine("dual", iters=5, backend=backend,
                       device="cpu").solve(t, dem)
        assert np.isfinite(r.throughput) and r.throughput > 0
    assert _build.LAUNCHES == before
    assert dict(_build.SITE_LAUNCHES) == sites


def test_importing_lm_modules_builds_nothing():
    code = ("import sys, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.wkv, repro_torch.models, "
            "repro_torch.models.rwkv6, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build.load.cache_info().currsize == 0, 'built on import'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import model, rwkv6, transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dense, ssm = get_smoke("minitron-4b"), get_smoke("rwkv6-7b")
    prompts = np.zeros((1, 4), np.int32)
    for cfg in (dense, ssm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.get_model(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.generate(cfg, {}, prompts, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(dense, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rwkv6.init_params(ssm, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "minitron-4b", "--smoke", "--gen", "2"])
    # asked for the CPU, they run
    params = model.get_model(dense, "cpu").init_params(0)
    toks = serve.generate(dense, params, prompts, 2, device="cpu")
    assert toks.shape == (1, 6)
