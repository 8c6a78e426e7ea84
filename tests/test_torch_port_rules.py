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
* Every source under ``csrc/`` is built and every kernel is registered; a
  wrapper given a CUDA tensor goes to its kernel and raises where that
  cannot be built, it does not take the plain version.
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
    assert res.stdout.strip() == "ok 10"


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


def test_every_source_is_built_and_every_kernel_registered():
    from rlinf_tpu_torch.ops.cuda import kernels

    on_disk = {p.name for p in _build.CSRC.glob("*.cu")}
    assert on_disk == set(_build.SOURCES)
    assert {"paged_attention.cu", "decode_megakernel.cu"} <= on_disk
    kerns = kernels()
    assert {"decode_megakernel", "paged_attention"} <= set(kerns) and len(kerns) == 10
    assert {k.source for k in kerns.values()} == set(_build.SOURCES)
    symbols = [k.symbol for k in kerns.values()]
    assert len(set(symbols)) == len(symbols)
    for k in kerns.values():
        assert f'extern "C" int {k.symbol}(' in (_build.CSRC / k.source).read_text()


def _paged_call(dev):
    import torch

    from rlinf_tpu_torch.ops.cuda import paged_attention as PA

    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=dev)
    pages = torch.zeros((3, 2, 8, 64), dtype=torch.bfloat16, device=dev)
    table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    return PA, "paged_attention_xla", lambda: PA.paged_attention(q, pages, pages, table, lengths)


def _mega_call(dev):
    import torch

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.rope import rope_frequencies

    cfg = LLMConfig(vocab_size=64, hidden_size=128, num_layers=1, num_heads=2, num_kv_heads=1,
                    head_dim=64, intermediate_size=128, max_seq_len=128)
    plan, mw = MK.pack_decode_weights(quantize_params(M.init_params(cfg, 0)), cfg)
    mw = type(mw)(*(t.to(dev) for t in mw))
    B, S = 8, 128
    cache = (torch.zeros((1, B, S, 64), dtype=torch.int8, device=dev),
             torch.zeros((1, B, S, 64), dtype=torch.int8, device=dev),
             torch.ones((1, B, S), device=dev), torch.ones((1, B, S), device=dev))
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    cos, sin = rope_frequencies(64, 128, cfg.rope_theta, dev)
    x0 = torch.zeros((B, 128), dtype=torch.bfloat16, device=dev)
    return MK, "decode_step_mega_plain", lambda: MK.decode_step_mega(
        plan, mw, x0, *cache, z + 3, z + 3, z, cos, sin)


@pytest.mark.parametrize("make", [_paged_call, _mega_call],
                         ids=["paged_attention", "decode_megakernel"])
def test_new_wrappers_take_the_plain_version_for_cpu_tensors_only(make, monkeypatch):
    """Tensors that do not lie on the CPU (here on the ``meta`` device, which
    holds no data) never reach the plain version: the wrapper goes to its
    kernel's argument checks, which raise for want of a CUDA tensor."""
    from rlinf_tpu_torch.ops.cuda import kernels

    mod, plain, call = make("cpu")
    call()                                     # CPU tensors: the plain version runs
    mod, plain, call = make("meta")

    def never(*a, **kw):
        raise AssertionError("the plain version was called for a tensor off the CPU")

    monkeypatch.setattr(mod, plain, never)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call()
    assert all(k.launches == 0 for k in kernels().values())


def test_megakernel_wrapper_and_source_agree_on_their_constants():
    """The wrapper sizes the K-slice workspace and refuses geometries by
    constants the CUDA source holds too."""
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK

    text = (_build.CSRC / "decode_megakernel.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("KS_MAX") == MK.MAX_SLICES
    assert const("KBLK") == MK.K_BLOCK and const("NTILE") == MK.ITEM_COLS
    assert const("MAXG") == MK.MAX_GROUP
    # 64 staged rows of MAX_STAGED_DEPTH (+ padding) and the reduce buffer fit a CTA
    staged = const("MROWS") * (MK.MAX_STAGED_DEPTH + const("APAD")) * 2 + 4 * 2 * const("NW") * 16 * 32
    assert staged <= const("SMEM_CAP") < staged + const("MROWS") * MK.K_BLOCK * 2
    assert text.count("stamp(a.clock") == len(MK.PHASES) + 2
