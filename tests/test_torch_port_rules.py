"""Rules of the PyTorch port that no other test holds.

* Nothing under ``rlinf_tpu_torch/`` or in ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``rlinf_tpu``, and ``chip_smoke.py`` imports
  nothing of the repo but the port.
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
* A public ``device`` parameter defaults to ``"cuda"`` (or has no default).
* Nothing of the port, ``chip_smoke.py`` or the port's scripts imports
  ``transformers``, ``safetensors``, ``tokenizers``, ``orbax`` or ``regex``
  (the card's machine has none of them), at any level: not in the source,
  and not by importing every module of the port.
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
# the port, its smoke run and its measurement scripts
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted(ROOT.glob("scripts/torch_*.py")))


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


#: packages the card's machine lacks: the port reads HF files itself
HF_PACKAGES = ("transformers", "safetensors", "tokenizers", "orbax", "regex")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_hf_package_imports(path):
    bad = [m for m in _imported_modules(path) if m and m.split(".")[0] in HF_PACKAGES]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_hf_package(tmp_path):
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {HF_PACKAGES!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py stands alone beside the port: it loads no script of
    the repo by path and imports no module of the repo but the port's."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert "spec_from_file_location" not in src and "scripts" not in src
    local = {p.stem for p in ROOT.glob("*.py")} | {p.name for p in ROOT.iterdir() if p.is_dir()}
    mods = {m.split(".")[0] for m in _imported_modules(ROOT / "chip_smoke.py") if m}
    assert mods & local <= {"rlinf_tpu_torch"}, mods & local


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_reads_k6_passes_by_the_source_names():
    """chip_smoke.py reads K6's pass A, pass B and merge (and K5's product
    and combine) from a profiler trace by kernel name: each name it looks
    for is a kernel of csrc/linear_ce.cu (pass A, pass B and K5 the
    template's PASS 0, 1 and 2), and K5's kernels match no K6 pass."""
    cs = _chip_smoke()
    cu = (PORT / "csrc" / "linear_ce.cu").read_text()
    assert re.search(r"template <int PASS, bool B_MN>\s*__global__ .*ce_gemm_kernel\(", cu)
    assert re.search(r"__global__ .*dh_merge_kernel\(", cu)
    assert re.search(r"__global__ .*ce_fwd_combine_kernel\(", cu)
    names = dict(cs.K6_PASSES)
    assert names == {"pass_a": "ce_gemm_kernel<0", "pass_b": "ce_gemm_kernel<1",
                     "merge": "dh_merge_kernel"}
    assert cs.K5_KERNELS == ("ce_gemm_kernel<2", "ce_fwd_combine_kernel")
    trace = {"void (anonymous namespace)::ce_gemm_kernel<0, false>(CUtensorMap, ...)": 3.0,
             "void (anonymous namespace)::ce_gemm_kernel<1, true>(CUtensorMap, ...)": 4.0,
             "void (anonymous namespace)::dh_merge_kernel(float const*, ...)": 0.5,
             "void (anonymous namespace)::ce_gemm_kernel<2, false>(CUtensorMap, ...)": 9.0}
    got = cs.k6_passes(trace, 6e12)
    assert (got["pass_a_ms"], got["pass_b_ms"], got["merge_ms"]) == (3.0, 4.0, 0.5)
    assert got["pass_a_tflops"] == pytest.approx(2000.0)
    with pytest.raises(AssertionError, match="no time for K6"):
        cs.k6_passes({"void (anonymous namespace)::ce_gemm_kernel<2, false>(...)": 9.0})


def test_chip_smoke_reads_k7_and_k8_by_the_source_names():
    """chip_smoke.py reads K7's and K8's time a train step from the
    profiler trace by kernel name: each name it looks for is a __global__
    kernel of csrc/flash_attention_bwd.cu, and neither name matches the
    other kernel."""
    cs = _chip_smoke()
    cu = (PORT / "csrc" / "flash_attention_bwd.cu").read_text()
    names = dict(cs.FLASH_BWD_KERNELS)
    assert set(names) == {"dq", "dkv"}
    for name in names.values():
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) {name}\(", cu), name
    trace = [type("E", (), dict(key=f"void (anonymous namespace)::{k}<128, {w}>(CUtensorMap, ...)",
                                device_time_total=t, count=n))
             for k, w, t, n in (("flash_bwd_dq_kernel", 1, 3000.0, 4),
                                ("flash_bwd_dkv_kernel", 2, 5000.0, 4),
                                ("flash_fwd_kernel", 1, 9000.0, 8))]
    got = cs.flash_bwd_step(trace)
    assert got == {"dq_ms": 3.0, "dq_launches_traced": 4, "dkv_ms": 5.0, "dkv_launches_traced": 4}
    with pytest.raises(AssertionError, match="no time for flash_bwd_dkv_kernel"):
        cs.flash_bwd_step(trace[:1])


def test_chip_smoke_reports_k1_k3_k5_and_k10_by_the_source_names():
    """chip_smoke.py prints ptxas's registers and spills and the SASS
    instruction counts of K1, K2, K3, K5, K9 and K10 by kernel name: each
    name is a __global__ kernel of its source, and the reports read the
    compiler's and cuobjdump's output by those names (template arguments
    kept, so K5's two layouts and K6's passes stay apart). check_reports
    holds K5 and K9 to wgmma, K2 and K3 to mma.sync, with no spill."""
    cs = _chip_smoke()
    assert set(cs.REPORTED_KERNELS) == {"flash_attention_fwd.cu", "paged_attention.cu",
                                        "linear_ce.cu", "decode_attention.cu",
                                        "decode_megakernel.cu"}
    for src, names in cs.REPORTED_KERNELS.items():
        cu = (PORT / "csrc" / src).read_text()
        for name in names:
            assert re.search(rf"__global__ void (?:__launch_bounds__\([^)]*\) )?{name}\(", cu), name
    gemm = "_ZN45_GLOBAL__N__8b09aa19_12_linear_ce_cu_44c3199414ce_gemm_kernelILi2ELb1EEEv14CUtensorMap_stS1_NS_8GemmArgsE"
    k3 = "_ZN52_GLOBAL__N__f7dde9ef_19_decode_attention_cu_44c3199422decode_q8_split_kernelILi128EEEvNS_6Q8ArgsE"
    names = cs.REPORTED_KERNELS["linear_ce.cu"] + cs.REPORTED_KERNELS["decode_attention.cu"]
    assert cs._kernel_key(gemm, names) == "ce_gemm_kernel<2, 1>"
    assert cs._kernel_key(gemm.replace("Li2ELb1E", "Li0ELb0E"), names) == "ce_gemm_kernel<0, 0>"
    assert cs._kernel_key(k3, names) == "decode_q8_split_kernel<128>"

    def reports(k5_hmma=0, k3_hmma=48, k2_hmma=96, k9_hgmma=32, k9_spill=0, spill=0):
        sass = lambda hg, hm: {"HGMMA": hg, "WARPGROUP.DEPBAR": 2, "HMMA": hm, "MOVM": 0}
        return {"linear_ce.cu": {
                    "ptxas": {"ce_gemm_kernel<2, 0>": {"registers": 168, "spill_stores": spill}},
                    "sass": {"ce_gemm_kernel<2, 0>": sass(8, k5_hmma),
                             "ce_gemm_kernel<2, 1>": sass(8, k5_hmma)}},
                "decode_attention.cu": {
                    "ptxas": {}, "sass": {"decode_q8_split_kernel<64>": sass(0, k3_hmma),
                                          "decode_q8_split_kernel<128>": sass(0, k3_hmma),
                                          "decode_bf16_split_kernel<64>": sass(0, k2_hmma),
                                          "decode_bf16_split_kernel<128>": sass(0, k2_hmma)}},
                "decode_megakernel.cu": {
                    "ptxas": {"mega_kernel<128>": {"registers": 168, "spill_loads": k9_spill}},
                    "sass": {"mega_kernel<64>": sass(k9_hgmma, 48),
                             "mega_kernel<128>": sass(k9_hgmma, 48)}}}

    cs.check_reports(reports())
    for bad in (dict(k5_hmma=4), dict(k3_hmma=0), dict(k2_hmma=0), dict(k9_hgmma=0),
                dict(k9_spill=4), dict(spill=8)):
        with pytest.raises(AssertionError, match="kernel reports"):
            cs.check_reports(reports(**bad))
    fwd = "_ZN55_GLOBAL__N__c3_22_flash_attention_fwd_cu_44c3199416flash_fwd_kernelILi128EEEv14CUtensorMap_st"
    merge = "_ZN51_GLOBAL__N__26_18_paged_attention_cu_44c3199418paged_merge_kernelENS_4ArgsEi"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized",
        "ptxas info    : Used 168 registers, used 16 barriers, 1120 bytes smem",
        f"ptxas info    : Compiling entry function '{merge}' for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    names = cs.REPORTED_KERNELS["flash_attention_fwd.cu"] + cs.REPORTED_KERNELS["paged_attention.cu"]
    got = cs.ptxas_report(log, names)
    assert got["flash_fwd_kernel<128>"]["registers"] == 168
    assert got["flash_fwd_kernel<128>"]["spill_stores"] == 8
    assert len(got["flash_fwd_kernel<128>"]["notes"]) == 1
    assert got["paged_merge_kernel"] == {"notes": [], "registers": 32}
    sass = (f"\n\tFunction : {fwd}\n HGMMA.64x64x16 ;\n HGMMA.64x128x16 ;\n WARPGROUP.DEPBAR.LE gsb0 ;"
            f"\n\tFunction : {merge}\n FFMA ;")
    counts = cs.sass_counts(sass, names)
    assert counts["flash_fwd_kernel<128>"]["HGMMA"] == 2
    assert counts["flash_fwd_kernel<128>"]["WARPGROUP.DEPBAR"] == 1
    assert counts["paged_merge_kernel"]["HMMA"] == 0


def _header_functions(text):
    """Names of the functions a header defines."""
    return set(re.findall(
        r"^(?:template <[^>]*>\s*)?(?:__device__ __forceinline__|inline)\s+[\w:<>]+[\s*&]+(\w+)\(",
        text, re.M))


@pytest.mark.parametrize("source", ["linear_ce.cu", "flash_attention_bwd.cu", "sampler.cu",
                                    "flash_attention_fwd.cu", "paged_attention.cu",
                                    "decode_attention.cu", "decode_megakernel.cu"])
def test_hopper_primitives_live_in_one_header(source):
    """csrc/hopper.cuh holds the TMA, bulk-copy, mbarrier, wgmma and
    mma.sync primitives (and the attention operands' tensor map, masks and
    tile descriptors that K1, K7 and K8 share); the sources that run on
    them include it and define none of them again."""
    header = (_build.CSRC / "hopper.cuh").read_text()
    shared = _header_functions(header)
    assert {"smem_u32", "mbar_wait", "tma_load", "tma_load_3d", "gmma_desc", "wgmma_ss",
            "wgmma_rs", "fence_regs", "encode_tiled", "make_map", "bulk_load", "head_map",
            "key_pos", "query_pos", "kmajor", "kstep", "mnmajor", "mnstep", "mma_bf16",
            "movmatrix_t"} <= shared
    text = (_build.CSRC / source).read_text()
    assert '#include "hopper.cuh"' in text
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    again = [n for n in shared
             if re.search(rf"^\s*(?:template <[^>]*>\s*)?(?!return\b|else\b)(?:[A-Za-z_][\w:<>]*[\s*&]+)+{n}\s*\(",
                          code, re.M)]
    assert not again, f"{source} defines {again} again"


def test_kernel_argtypes_match_their_c_entry_points():
    """Each wrapper's ctypes argument list has as many entries as its C
    entry point has parameters (ctypes would pass a wrong count unchecked)."""
    from rlinf_tpu_torch.ops.cuda import kernels

    for k in kernels().values():
        text = (_build.CSRC / k.source).read_text()
        params = re.search(rf'extern "C" int {k.symbol}\(([^)]*)\)', text).group(1)
        assert len(params.split(",")) == len(k.argtypes), k.symbol


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


@pytest.mark.parametrize("source", _build.SOURCES + _build.HEADERS)
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
    plan, mw = MK.pack_decode_weights(quantize_params(M.init_params(cfg, 0, device="cpu")), cfg)
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


def _flash_bwd_call(dev):
    import torch

    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    B, S, H, K, D = 1, 8, 2, 1, 64
    q = torch.zeros((B, S, H, D), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((B, S, K, D), dtype=torch.bfloat16, device=dev)
    pos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    valid = torch.ones((B, S), dtype=torch.uint8, device=dev)
    lse = torch.zeros((B, H, S), device=dev)
    return FA, "flash_attention_bwd_plain", lambda: FA.flash_attention_bwd(
        q, kv, kv, pos, pos, valid, q, lse, q, D**-0.5)


@pytest.mark.parametrize("make", [_paged_call, _mega_call, _flash_bwd_call],
                         ids=["paged_attention", "decode_megakernel", "flash_attention_bwd"])
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
    """The wrapper plans the launch (tile shapes, the ring, the K-slices'
    staging, attention's blocks) and binds the C entry by constants and an
    argument list the CUDA source holds too; the kernel's shared memory
    (barriers, ring, staged activations or attention) fits a CTA."""
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK

    text = (_build.CSRC / "decode_megakernel.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("UNIT") == MK.UNIT and const("KBLK") == MK.K_BLOCK and const("ROWS") == MK.ROWS
    assert const("RING") == MK.RING_TILES and const("KBS_MAX") == MK.KBS_MAX
    assert const("NCW") == MK.CONSUMER_WARPS and const("KEYS") == MK.KEY_BLOCK
    assert const("MAXG") == MK.MAX_GROUP
    for hd in (64, 128):   # a warp's attention ring and its query fragments
        att = const("NCW") * (const("ATT_RING") * (4 * (hd // 64) + 2) * 32 * 16
                              + 32 * 4 * (hd // 64) * 16)
        staged = const("KBS_MAX") * const("ROWS") * const("KBLK") * 2
        total = (1024 + const("MISC_BYTES") + const("RING") * const("UNIT") * const("KBLK")
                 + max(staged, att))
        assert total <= const("SMEM_CAP"), hd
    params = re.search(r'extern "C" int decode_megakernel\(([^)]*)\)', text).group(1)
    assert len(params.split(",")) == len(MK.KERNEL.argtypes)
    assert text.count("stamp(a.clock") == len(MK.PHASES) + 2


# Public functions whose ``device`` may default elsewhere than the card, by
# (file, name): the rope tables are internal, and every caller passes a device.
DEVICE_DEFAULT_EXCEPTIONS = {("ops/rope.py", "rope_frequencies")}


def _device_defaults(tree):
    """(function name, line, default source or None) of every ``device``
    parameter of a public function or of a public class's ``__init__``."""
    public_classes = {id(f) for c in ast.walk(tree) if isinstance(c, ast.ClassDef)
                      and not c.name.startswith("_") for f in c.body}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name.startswith("_") and not (node.name == "__init__" and id(node) in public_classes):
            continue
        a = node.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos, [None] * (len(pos) - len(a.defaults)) + list(a.defaults)))
        for arg, default in pairs + list(zip(a.kwonlyargs, a.kw_defaults)):
            if arg.arg == "device":
                yield node.name, node.lineno, None if default is None else ast.unparse(default)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_public_device_parameters_default_to_the_card(path):
    """The port's entry points run on the card unless the caller asks for the
    CPU: a public ``device`` parameter defaults to "cuda" or has no default."""
    rel = str(path.relative_to(PORT))
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line, d) for name, line, d in _device_defaults(tree)
           if d is not None and d != "'cuda'" and (rel, name) not in DEVICE_DEFAULT_EXCEPTIONS]
    assert not bad, f"{rel}: device defaults other than 'cuda': {bad}"


def _tensor_makers():
    from rlinf_tpu_torch.models.llm import convert as C
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.rollout import paged_cache as PC
    import numpy as np

    cfg = LLMConfig(vocab_size=16, hidden_size=8, num_layers=1, num_heads=1, num_kv_heads=1,
                    head_dim=8, intermediate_size=16, max_seq_len=8)
    tree = {"embed": np.zeros((16, 8), np.float32)}
    return {
        "init_params": lambda: M.init_params(cfg, 0),
        "init_kv_cache_packed": lambda: M.init_kv_cache_packed(cfg, 1, 8),
        "init_kv_cache_packed_q8": lambda: M.init_kv_cache_packed_q8(cfg, 1, 8),
        "init_page_pool_cache": lambda: PC.init_page_pool_cache(1, 2, 4, 1, 8),
        "tensor_from_numpy": lambda: C.tensor_from_numpy(np.zeros(3, np.float32)),
        "params_from_numpy": lambda: C.params_from_numpy(tree, cfg),
        "cache_from_numpy": lambda: C.cache_from_numpy((np.zeros(3, np.float32),)),
    }


@pytest.mark.parametrize("name", ["cache_from_numpy", "init_kv_cache_packed",
                                  "init_kv_cache_packed_q8", "init_page_pool_cache",
                                  "init_params", "params_from_numpy", "tensor_from_numpy"])
def test_tensor_makers_default_to_the_card(name, monkeypatch):
    """With no device given, the functions that make tensors ask for the
    card, and raise where there is none (instead of making CPU tensors that
    a later call on the card would not find)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tensor_makers()[name]()


def test_main_grpo_runs_on_the_card_by_default():
    """The port's entry point takes ``--device`` and it defaults to the card."""
    from rlinf_tpu_torch import main_grpo

    assert main_grpo.parse_args(["--config", "c.yaml"]).device == "cuda"
    assert main_grpo.parse_args(["--config", "c.yaml", "--device", "cpu", "a.b=1"]).overrides == [
        "a.b=1"]


# the server-mode and agentic slice: its modules, as the JAX package names them
SERVING_AND_AGENT_MODULES = (
    "rollout/server.py", "serve_openai.py", "algorithms/rewards/code_verifier.py",
    "algorithms/rewards/api_reward.py", "runners/coding_online_runner.py",
    "algorithms/toolcall_parsers.py", "agents/tools.py", "agents/agent_loop.py",
    "agents/__init__.py", "runners/agent_runner.py", "main_agent_grpo.py",
    "runners/eval_runner.py")


@pytest.mark.parametrize("rel", SERVING_AND_AGENT_MODULES)
def test_serving_and_agent_modules_are_held_by_the_rules(rel):
    """Each module of the slice exists, is among the files the import and
    device rules above walk, and imports no JAX and nothing of the JAX
    package (the rules above, on this file by name)."""
    path = PORT / rel
    assert path in FILES and path in sorted(PORT.rglob("*.py"))
    test_no_jax_or_reference_imports(path)
    test_public_device_parameters_default_to_the_card(path)


def test_chip_smoke_reads_k1_and_k2_from_a_step_trace_by_the_source_names(tmp_path):
    """Phase 25 counts K1's and K2's launches in a StepProfiler trace by
    kernel name: each name is a __global__ kernel of its source, and the
    trace reader counts a Kineto-style file's kernel records by them (and
    no runtime record)."""
    import json

    cs = _chip_smoke()
    sources = {"flash_attention_fwd": "flash_attention_fwd.cu",
               "decode_attention_bf16": "decode_attention.cu"}
    assert set(cs.PROFILED_KERNELS) == set(sources)
    for name, kernel in cs.PROFILED_KERNELS.items():
        cu = (PORT / "csrc" / sources[name]).read_text()
        assert re.search(rf"__global__ void (?:__launch_bounds__\([^)]*\) )?{kernel}\(", cu), kernel

    def ev(cat, name, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 1.5, "dur": dur,
                "args": {"grid": [1, 2, 3], "external id": 9}}

    events = [ev("kernel", "void (anonymous namespace)::flash_fwd_kernel<64, false>(A)", 10.5),
              ev("cuda_runtime", "cudaLaunchKernel flash_fwd_kernel", 3.0),
              ev("kernel", "void (anonymous namespace)::decode_bf16_split_kernel<64>(A)", 2.0),
              ev("kernel", "void (anonymous namespace)::decode_bf16_split_kernel<64>(A)", 4.25),
              ev("kernel", "void at::native::elementwise_kernel<128, 4>(int)", 1.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}, indent=4))
    got = cs.traced_kernels(str(path))
    assert got["kernels_traced"] == 4
    assert got["flash_attention_fwd"]["launches_traced"] == 1
    assert got["flash_attention_fwd"]["device_ms"] == pytest.approx(0.0105)
    assert got["decode_attention_bf16"]["launches_traced"] == 2
    assert got["decode_attention_bf16"]["device_ms"] == pytest.approx(0.00625)


# the agent-recipe slice and the small LLM-side modules, as the JAX package
# names them
RECIPE_AND_SMALL_MODULES = (
    "algorithms/rewards/qa_metrics.py", "algorithms/rewards/rstar2_score.py",
    "algorithms/registry.py", "algorithms/loss_scales.py", "data/datasets.py",
    "data/down_sampling.py", "data/priority_store.py", "agents/retrieval.py",
    "agents/rstar2.py", "agents/recipes.py", "runners/agentlightning_runner.py",
    "models/__init__.py", "ops/__init__.py", "data/__init__.py", "ops/logprobs.py",
    "utils/flops.py", "utils/profiler.py", "utils/parity.py", "utils/metrics.py")


@pytest.mark.parametrize("rel", RECIPE_AND_SMALL_MODULES)
def test_recipe_and_small_modules_are_held_by_the_rules(rel):
    """Each module exists, is among the files the import and device rules
    walk, imports no JAX, nothing of the JAX package and no HF package, and
    its public ``device`` parameters default to the card."""
    path = PORT / rel
    assert path in FILES and path in sorted(PORT.rglob("*.py"))
    test_no_jax_or_reference_imports(path)
    test_no_hf_package_imports(path)
    test_public_device_parameters_default_to_the_card(path)


def test_agentlightning_runner_takes_the_card_by_default():
    """The runner's ``device`` is the card unless the caller asks for the CPU."""
    import inspect

    from rlinf_tpu_torch.runners.agentlightning_runner import AgentLightningRunner

    assert inspect.signature(AgentLightningRunner).parameters["device"].default == "cuda"


@pytest.mark.parametrize("module", ["main_agent_grpo", "serve_openai"])
def test_new_entry_points_run_on_the_card_by_default(module):
    import importlib

    mod = importlib.import_module(f"rlinf_tpu_torch.{module}")
    assert mod.parse_args([]).device == "cuda"
    assert mod.parse_args(["--device", "cpu"]).device == "cpu"


def test_code_verifier_execs_each_candidate_in_a_fresh_interpreter():
    """The verifier runs from a process that holds a CUDA context: each
    candidate is a ``subprocess.run`` of the interpreter (exec at once), never
    a forked pool."""
    path = PORT / "algorithms" / "rewards" / "code_verifier.py"
    mods = set(_imported_modules(path))
    assert "subprocess" in mods and not mods & {"multiprocessing", "concurrent.futures", "os"}
    assert "subprocess.run(" in path.read_text()


def test_every_activation_kernel_takes_a_dtype_code():
    """The C entries of every kernel that reads activations take the
    element type's code (0 bf16, 1 f16, 2 f32; K4's ``hdt``), and the
    wrappers compute it from the tensor: any other dtype is refused before
    a launch. K9 computes in bf16 whatever the model's dtype and takes
    none."""
    import torch

    from rlinf_tpu_torch.ops.cuda import kernels

    assert _build.DTYPE_CODES == {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
    for name, k in kernels().items():
        text = (_build.CSRC / k.source).read_text()
        params = re.search(rf'extern "C" int {k.symbol}\(([^)]*)\)', text).group(1)
        want = "int hdt" if name == "fused_lmhead_sample" else "int dtype"
        assert (want in params) == (name != "decode_megakernel"), name
    assert _build.dtype_code("q", torch.zeros(1, dtype=torch.float16)) == 1
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        _build.dtype_code("q", torch.zeros(1, dtype=torch.float64))
