"""Rules of the port that its code must keep: no JAX, no tpu_yolo and
none of the JAX package's tools/ in tpu_yolo_torch (its parity harness
and roofline included) or chip_smoke.py, no path into the JAX package's
directories (native/, tpu_yolo/) and no `make -C native` there either,
and chip_smoke.py refuses to run without a CUDA card or without the
package beside it."""
import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_yolo_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_the_port_has_its_own_tools():
    """The counterparts of tools/parity_check.py and tools/roofline.py are
    modules of the package, so the scans below cover them."""
    for name in ("parity_check.py", "roofline.py"):
        assert ROOT / "tpu_yolo_torch" / name in PORT_FILES


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = {"jax", "jaxlib", "tpu_yolo", "tools"} & set(_imported_roots(path))
    assert not banned, f"{path.relative_to(ROOT)} imports {sorted(banned)}"


# calls that take a file system path or run a program
_PATH_CALLS = {"join", "open", "Path", "PurePath", "exists", "isfile", "isdir",
               "listdir", "glob", "rglob", "CDLL", "LoadLibrary", "run", "Popen",
               "call", "check_call", "check_output", "chdir", "makedirs", "copy",
               "copytree", "load", "build", "build_host", "abspath", "realpath"}
_REFERENCE_DIRS = ("native", "tpu_yolo")


def _into_reference(value) -> bool:
    """A string that names native/ or tpu_yolo/ as a path (not
    tpu_yolo_torch/)."""
    return isinstance(value, str) and any(
        value == d or value.startswith(d + "/") or f"/{d}/" in value
        for d in _REFERENCE_DIRS)


def _paths_into_reference(source: str, name: str = "<source>"):
    """Lines that build or open a path into native/ or tpu_yolo/: a
    string naming one given to a call that takes a path or runs a
    program, or joined with `/`; and lines that run `make -C native` or
    name the JAX package's host library."""
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Call):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if fname in _PATH_CALLS:
                for arg in [*node.args, *(k.value for k in node.keywords)]:
                    if any(isinstance(c, ast.Constant) and _into_reference(c.value)
                           for c in ast.walk(arg)):
                        yield node.lineno
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if any(isinstance(c, ast.Constant) and _into_reference(c.value)
                   for c in (node.left, node.right)):
                yield node.lineno
    for i, line in enumerate(source.splitlines(), 1):
        if "make -C native" in line or "libtpuyolo_data" in line:
            yield i


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reaches_no_reference_directory(path):
    """The port keeps its own copy of what it needs from the JAX package's
    directories: no module of it, and not chip_smoke.py, opens, loads,
    builds or runs anything under native/ or tpu_yolo/."""
    lines = sorted(set(_paths_into_reference(path.read_text(), str(path))))
    assert not lines, f"{path.relative_to(ROOT)} reaches native/ or tpu_yolo/ " \
                      f"at lines {lines}"


@pytest.mark.parametrize("snippet,flagged", [
    ('os.path.join(root, "native", "libx.so")', True),
    ('ctypes.CDLL(os.path.join(here, "native/libx.so"))', True),
    ('subprocess.run(["make", "-C", "native"])', True),
    ('open("tpu_yolo/ops/nms_pallas.py")', True),
    ('pathlib.Path(root) / "tpu_yolo" / "serve.py"', True),
    ('x = "make -C native"', True),
    ('os.path.join(root, "tpu_yolo_torch", "csrc")', False),
    ('row = dict(replaces="tpu_yolo/ops/topk_pallas.py:78")', False),
    ('cuda_build.build("image_card")', False)])
def test_the_reference_scan_sees_a_path(snippet, flagged):
    assert bool(list(_paths_into_reference(snippet))) == flagged


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
