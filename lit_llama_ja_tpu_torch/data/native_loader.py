"""ctypes binding for the native C++ packed-dataset reader (counterpart of
`lit_llama_ja_tpu/data/native_loader.py`).

A background C++ thread mmaps LITPKDS chunk files, walks a shuffled block order and
assembles int32 batches into a prefetch ring; Python only copies ready buffers out.
The source is the port's own byte-identical copy of `native/packed_reader.cpp`
(``lit_llama_ja_tpu_torch/native/packed_reader.cpp``). `build_native` compiles it with
``g++`` at first use into ``build/native/`` at the root of the checkout, under a file
name that carries a hash of the source and the flags (as `ops/cuda/_build.py` names
the kernels), so an edited source is rebuilt; it never writes into ``native/``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "packed_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"packedreader-{digest.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the shared library if it is missing; returns its path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ {SRC.name} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    lib.pr_create.restype = ctypes.c_void_p
    lib.pr_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
    ]
    lib.pr_next.restype = ctypes.c_int
    lib.pr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.pr_destroy.restype = None
    lib.pr_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


class NativePackedBatches:
    """Iterator of ``(batch_size, block_size)`` int32 batches from the C++ prefetching
    reader, with `PackedDataset`'s file-sharding arithmetic. ``skip_batches`` resumes a
    run: the reader replays the seeded shuffle and skips that many batches without
    reading their payload."""

    def __init__(
        self,
        filenames: Sequence[str],
        batch_size: int,
        block_size: int,
        n_chunks: Optional[int] = None,
        seed: int = 12345,
        shuffle: bool = True,
        wrap: bool = False,
        num_processes: int = 1,
        process_rank: int = 0,
        prefetch_depth: int = 4,
        skip_batches: int = 0,
    ):
        lib = _load()
        # shard files across processes (reference packed_dataset.py:48-56)
        max_num_files = len(filenames) // num_processes * num_processes
        shard = list(filenames)[process_rank:max_num_files:num_processes]
        if not shard:
            raise ValueError("no files assigned to this shard")
        self._files = [str(f).encode() for f in shard]  # kept alive for the reader
        arr = (ctypes.c_char_p * len(self._files))(*self._files)
        self._lib = lib
        self._handle = lib.pr_create(
            arr, len(self._files), block_size,
            n_chunks if n_chunks is not None else len(self._files),
            seed, int(shuffle), int(wrap), batch_size, prefetch_depth,
            skip_batches * batch_size,
        )
        self._buf = np.empty((batch_size, block_size), np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        ok = self._lib.pr_next(
            self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not ok:
            raise StopIteration
        return self._buf.copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.pr_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
