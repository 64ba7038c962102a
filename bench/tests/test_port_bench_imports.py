"""The import check: a cell's whole import path loads neither JAX nor the
JAX package (``repro``), and the plain reference loads no ``repro_torch``
either.  Names are compared by their whole top-level part: ``repro_torch``
begins with ``repro`` and is not it.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import guard  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _loaded_after(code: str) -> list[str]:
    probe = (f"import sys\nsys.path[:0] = [{str(BENCH)!r}, "
             f"{str(ROOT / 'src')!r}]\n{code}\n"
             "print('\\n'.join(sorted({m.split('.')[0] "
             "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_guard_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1,
            "harness.repro": 1}
    assert guard.loaded(modules=mods) == []
    assert guard.loaded(modules={**mods, "repro.core": 1, "jax": 1}) == [
        "jax", "repro.core"]


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_import_path_loads_no_jax(w):
    code = ("from harness import cell, spec, sut, check, trace, readers\n"
            f"c = spec.cell({w['name']!r})\n"
            "p = sut.Program(c.mix, 'cpu')\n"
            "c.family()\n"
            "for m in c.per_layer: spec.metric_reader(m['name'])\n")
    roots = set(_loaded_after(code))
    assert "repro_torch" in roots          # the program did load
    assert not roots & set(guard.FORBIDDEN), sorted(roots & {*guard.FORBIDDEN})


def test_reference_loads_no_program():
    code = ("from harness import reference, traffic, roofline, bounds\n"
            "from families import random_regular, rewired_vl2\n")
    roots = set(_loaded_after(code))
    assert not roots & (set(guard.FORBIDDEN) | {"repro_torch"})


def test_reference_sources_import_no_program():
    import ast
    files = [BENCH / "harness" / f for f in
             ("reference.py", "traffic.py", "roofline.py", "bounds.py",
              "check.py")] + sorted((BENCH / "families").glob("*.py"))
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (*guard.FORBIDDEN,
                                               "repro_torch"), (path, n)
