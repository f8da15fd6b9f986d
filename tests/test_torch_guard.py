"""Rules of the port that its code must keep: no JAX and no tpu_yolo in
tpu_yolo_torch or chip_smoke.py, and chip_smoke.py refuses to run
without a CUDA card or without the package beside it."""
import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_yolo_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = {"jax", "jaxlib", "tpu_yolo"} & set(_imported_roots(path))
    assert not banned, f"{path.relative_to(ROOT)} imports {sorted(banned)}"


def _writes_allow_tf32(path):
    """Assignments to an `allow_tf32` attribute, and setattr calls that
    name it, in one file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign))
                   else [])
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "allow_tf32":
                yield node.lineno
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "setattr" and len(node.args) > 1
                and isinstance(node.args[1], ast.Constant)
                and node.args[1].value == "allow_tf32"):
            yield node.lineno


@pytest.mark.parametrize("path", PORT_FILES[:-1], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_writes_the_tf32_flag(path):
    """The process-global TF32 flags are the caller's: no module of the
    package sets them (the letterbox's products choose their precision
    per call, ops/letterbox.py::batched_products)."""
    lines = list(_writes_allow_tf32(path))
    assert not lines, f"{path.relative_to(ROOT)} writes allow_tf32 at lines {lines}"


def test_the_tf32_scan_sees_a_write():
    src = ROOT / "chip_smoke.py"     # sets the flags around its f32 checks
    assert list(_writes_allow_tf32(src))


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs in full there")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
