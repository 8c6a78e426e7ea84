"""Rules of the PyTorch port that no other test holds.

* Nothing under ``rlinf_tpu_torch/`` or in ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``rlinf_tpu``.
* Every module of the port imports on a machine without ``nvcc`` or a
  card, and importing them loads no JAX.
* A kernel's launch count rises only for a launch the CUDA runtime
  accepted.
* No kernel launch sits inside a ``try`` (no fallback), and the CUDA
  sources under ``csrc/`` neither throw nor catch: they return the CUDA
  error code, and the wrapper raises.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from rlinf_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rlinf_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "rlinf_tpu", "flax", "optax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if m and _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_nvcc_or_jax(tmp_path):
    """Import every module of the port in a fresh interpreter whose PATH has
    no nvcc; no module may load jax or build a kernel."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from rlinf_tpu_torch.ops.cuda import kernels\n"
        "assert all(k.launches == 0 for k in kernels().values())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'rlinf_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(kernels()))\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok 8"


def test_launch_count_rises_only_on_accepted_launches():
    k = _build.CudaKernel("sampler.cu", "fake", [])
    k._lib = type("Lib", (), {"rlinf_cuda_error_string": staticmethod(lambda e: b"bad launch")})
    k._fn = lambda *a: 0
    k()
    k()
    assert k.launches == 2
    k._fn = lambda *a: 9
    with pytest.raises(RuntimeError, match="bad launch"):
        k()
    assert k.launches == 2


def test_library_name_follows_the_source_hash():
    paths = {_build._library_path(s) for s in _build.SOURCES}
    assert len(paths) == len(_build.SOURCES)
    assert all(p.parent == _build.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert all((_build.CSRC / s).exists() for s in _build.SOURCES)


def _launches_in(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
            if name.startswith("KERNEL"):
                yield sub.lineno


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_kernel_launch_inside_try(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [ln for node in ast.walk(tree) if isinstance(node, ast.Try)
           for ln in _launches_in(node)]
    assert not bad, f"{path.relative_to(ROOT)}: kernel launch inside try at lines {bad}"
    if path.parent.name == "cuda":
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


@pytest.mark.parametrize("source", _build.SOURCES + ("common.cuh",))
def test_csrc_sources_are_plain_c_interfaces(source):
    text = (_build.CSRC / source).read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for word in ("try", "catch", "throw"):
        assert not re.search(rf"\b{word}\b", code), f"{source} uses {word}"
    for banned in ("#include <torch", "#include <ATen", "cublas", "cudnn", "cutlass"):
        assert banned not in code, f"{source} includes {banned}"
    if source.endswith(".cu"):
        assert 'extern "C" int' in code
