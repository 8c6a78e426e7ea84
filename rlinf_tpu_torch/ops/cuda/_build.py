"""Build the CUDA sources under ``rlinf_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, under
``<checkout>/build/kernels`` (listed in ``.gitignore``). The file name holds
a hash of the source, the shared headers and the flags, so an edit rebuilds
and an unchanged source is loaded as it is. The library is bound with
``ctypes``: every entry point takes device pointers, sizes and the CUDA
stream, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``. ``ptxas -v``'s report of each kernel (registers,
spills, shared memory) is kept beside its library (``build_log``).

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = (
    "flash_attention_fwd.cu", "decode_attention.cu", "sampler.cu",
    "linear_ce.cu", "flash_attention_bwd.cu", "paged_attention.cu",
    "decode_megakernel.cu",
)

HEADERS = ("common.cuh", "hopper.cuh")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "rlinf_tpu_torch/csrc at first use and need the CUDA toolkit")


def _library_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _compile_cmd(source: str, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build(sources: Sequence[str] = SOURCES) -> float:
    """Compile every source not built yet, all ``nvcc`` processes at once.

    Returns the seconds spent. Raises with the compiler's output if one
    fails. Each library is written under a temporary name and renamed into
    place, so a concurrent loader never sees half a file.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp.so"
        p = subprocess.Popen(
            _compile_cmd(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append((src, p, tmp, out))
    failed = []
    for src, p, tmp, out in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- nvcc {src} (exit {p.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(source: str) -> str:
    """The compiler's output for the built library of ``source``: ``ptxas
    -v``'s registers, spills and shared memory of each kernel."""
    return _library_path(source).with_suffix(".log").read_text()


def load_library(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_library_path(source)))
            lib.rlinf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rlinf_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def stream_handle() -> int:
    """The current device's current CUDA stream, as the C entries take it:
    the value of ``torch.cuda.current_stream().cuda_stream``, read without
    building a Stream object: 0.5 against 4.5 us of host time, on an H100
    machine with torch 2.11 (``scripts/torch_k3_ab.py``), paid by every
    wrapper on every call."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the persistent
    kernels launch one CTA on each."""
    return torch.cuda.get_device_properties(index).multi_processor_count


class CudaKernel:
    """One C entry point of one source, with a count of its launches.

    ``launches`` rises by one for each call of the entry point that the
    CUDA runtime accepted, and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
            self._lib = lib
        err = self._fn(*args)
        if err != 0:
            msg = self._lib.rlinf_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err} ({msg})")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int]) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U32 = ctypes.c_uint32
