"""Build and load the port's CUDA kernels.

Each source under ``lit_llama_ja_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, all sources at once (one ``nvcc`` process each,
started together), into ``build/kernels/`` at the root of the checkout. A library's
file name carries a hash of its source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is reused. A missing ``nvcc`` or a failed build raises with the
compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quant_matmul_int4", "flash_attention_fwd", "flash_attention_bwd",
           "quant_matmul_int8", "quant_matmul_sub4", "paged_attention", "quant_matmul_w4a8",
           "quant_matmul_a8", "quant_matmul_sub4_a8")
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)  # where the toolkit puts it off PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        nvcc = next((p for p in NVCC_FALLBACKS if Path(p).exists()), None)
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {', '.join(NVCC_FALLBACKS)}): the "
            "CUDA kernels of lit_llama_ja_tpu_torch are built from source at first use"
        )
    return nvcc


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> List[str]:
    """Compile every source whose library is missing, in parallel; returns the names
    built. Raises ``RuntimeError`` with the compiler's output if any build fails."""
    todo = [n for n in SOURCES if not _library_path(n).exists()]
    if not todo:
        return []
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def load(name: str, bind_all: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of source ``name``, building all sources first if needed.
    ``bind_all`` declares the library's entry points (see `bind`) once, at load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.lljt_error_string.argtypes = [ctypes.c_int]
            lib.lljt_error_string.restype = ctypes.c_char_p
            bind_all(lib)
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, looked up once."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, int_args) -> None:
    """Declare ``fn(ptr * n_ptr, *int_args, stream) -> int``. Pointers and the
    stream are ``c_void_p``: ctypes would otherwise pass them as 32-bit ints."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + list(int_args) + [ctypes.c_void_p]
    f.restype = ctypes.c_int


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        msg = lib.lljt_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
