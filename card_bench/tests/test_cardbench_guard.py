"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (tpu_yolo_torch is not tpu_yolo), and the
reference imports nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from card_bench import run
from card_bench.harness import ROOT

BENCH = os.path.join(ROOT, "card_bench")


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("tpu_yolo_torch", "tpu_yolo_torch.serve", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("tpu_yolo", "tpu_yolo.ops.nms", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["flax", "jaxlib.xla_client", "tpu_yolo", "tpu_yolo.ops.nms"]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    sources = [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
               if os.sep + "tests" + os.sep not in p]
    assert sources
    for path in sources:
        assert not top_level_imports(path) & set(run.FORBIDDEN), path
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert not top_level_imports(path) & {"tpu_yolo_torch", *run.FORBIDDEN}, path


@pytest.mark.parametrize("cell", ["n_serve_bs128", "x_serve_bs128"])
def test_a_run_loads_no_jax(cell):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from card_bench.tests.small import small_cell, manifest\n"
            "from card_bench.run import execute, forbidden_modules\n"
            "execute(small_cell(%r, seconds=0.2, trace=True, size=128), manifest(), device_check=False)\n"
            "print('FOUND', forbidden_modules())\n") % (ROOT, cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
