"""Packed streaming dataset (a copy of `lit_llama_ja_tpu/data/packed_dataset.py`).

The JAX package's modules cannot be imported without importing jax, so the port keeps
its own copy of this numpy-only module. It keeps the reference's on-disk binary
format bit for bit (`LITPKDS` magic, version, dtype code, chunk_size header —
`lit_llama/packed_dataset.py:33-34,98-107`), so data prepared by either package is
read by the other, and the same seeds give the same blocks in the same order. The
reader is pure NumPy (memmap); sharding across (num_processes × num_workers) uses the
reference's file-assignment math (`packed_dataset.py:48-56`).

Batches are delivered as NumPy arrays; the training loop stacks them and ships one
device batch per step.
"""
from __future__ import annotations

import os
import random
import struct
from typing import Iterator, List, Optional, Sequence

import numpy as np

dtypes = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}


def code(dtype) -> int:
    for k, v in dtypes.items():
        if v == dtype:
            return k
    raise ValueError(dtype)


HDR_MAGIC = b"LITPKDS"
HDR_SIZE = 24  # bytes


class PackedDatasetBuilder:
    """Streams token arrays into fixed-size ``LITPKDS`` chunk files.

    Byte-compatible with files written by the reference builder
    (`lit_llama/packed_dataset.py:68-134`, same header + sep-padded chunks and
    the same write cadence: a chunk is flushed only once MORE than
    ``chunk_size`` tokens are buffered, so an exactly-full buffer waits for
    `write_reminder`), but built around a pending-queue of whole input arrays
    rather than a persistent write cursor: each flush assembles one chunk from
    the queue head in a single pass. ``write_reminder`` (reference API name
    kept) pads the final partial chunk with ``sep_token`` — it always emits a
    file, even for an empty queue."""

    def __init__(
        self,
        outdir,
        prefix,
        chunk_size,
        sep_token,
        dtype="auto",
        vocab_size=None,
    ):
        if dtype == "auto":
            if vocab_size is None:
                raise ValueError("vocab_size cannot be None when dtype='auto'")
            # uint16 when the vocab fits (reference `packed_dataset.py:79-84`)
            dtype = np.uint16 if vocab_size < 65500 else np.int32
        self._dtype = dtype
        self._outdir = outdir
        self._prefix = prefix
        self._chunk_size = chunk_size
        self._sep_token = sep_token
        self._version = 1
        self._pending: List[np.ndarray] = []
        self._pending_len = 0
        self._filenames: List[str] = []

    @property
    def dtype(self):
        return self._dtype

    @property
    def filenames(self) -> List[str]:
        return self._filenames.copy()

    def _emit(self, tokens: np.ndarray) -> None:
        """Write one chunk file: 24-byte header (magic, version u64, dtype code
        u8, chunk_size u64 — all little-endian) + the chunk payload."""
        path = os.path.join(
            self._outdir, f"{self._prefix}_{len(self._filenames):010d}.bin"
        )
        header = HDR_MAGIC + struct.pack(
            "<QBQ", self._version, code(self._dtype), self._chunk_size
        )
        with open(path, "wb") as f:
            f.write(header)
            f.write(np.ascontiguousarray(tokens, dtype=self._dtype).tobytes())
        self._filenames.append(path)

    def _take(self, n: int) -> np.ndarray:
        """Pop exactly ``n`` tokens off the queue head (splitting a straddling
        array back onto the queue)."""
        out = np.empty(n, dtype=self._dtype)
        filled = 0
        while filled < n:
            head = self._pending[0]
            want = n - filled
            if head.shape[0] <= want:
                out[filled : filled + head.shape[0]] = head
                filled += head.shape[0]
                self._pending.pop(0)
            else:
                out[filled:] = head[:want]
                self._pending[0] = head[want:]
                filled = n
        self._pending_len -= n
        return out

    def add_array(self, arr: np.ndarray) -> None:
        self._pending.append(np.asarray(arr))
        self._pending_len += arr.shape[0]
        while self._pending_len > self._chunk_size:
            self._emit(self._take(self._chunk_size))

    def write_reminder(self) -> None:
        tail = self._take(min(self._pending_len, self._chunk_size))
        pad = np.full(self._chunk_size - tail.shape[0], self._sep_token, self._dtype)
        self._emit(np.concatenate([tail, pad]))


def read_header(path):
    with open(path, "rb") as f:
        magic = f.read(len(HDR_MAGIC))
        assert magic == HDR_MAGIC, "File doesn't match expected format."
        (version,) = struct.unpack("<Q", f.read(8))
        assert version == 1
        (dtype_code,) = struct.unpack("<B", f.read(1))
        (chunk_size,) = struct.unpack("<Q", f.read(8))
    return dtypes[dtype_code], chunk_size


class PackedDataset:
    """Iterable over shuffled blocks of a sharded set of chunk files
    (reference `lit_llama/packed_dataset.py:37-65`).

    ``num_processes`` / ``process_rank`` shard at file granularity; ``num_workers`` /
    ``worker_id`` allow further splitting inside a data-loading process, with the same
    shard-assignment math as the reference so both frameworks read identical shards.
    """

    def __init__(
        self,
        filenames: Sequence[str],
        n_chunks: int,
        block_size: int,
        seed: int = 12345,
        shuffle: bool = True,
        wrap: bool = False,
        num_processes: int = 1,
        process_rank: int = 0,
        num_workers: int = 1,
        worker_id: int = 0,
    ):
        self._filenames = list(filenames)
        self._n_chunks = n_chunks
        self._block_size = block_size
        self._seed = seed
        self._shuffle = shuffle
        self._wrap = wrap
        self._num_processes = num_processes
        self._process_rank = process_rank
        self._num_workers = num_workers
        self._worker_id = worker_id

    def shard_filenames(self) -> List[str]:
        num_shards = self._num_workers * self._num_processes
        shard_id = self._process_rank * self._num_workers + self._worker_id
        max_num_files = len(self._filenames) // num_shards * num_shards
        return self._filenames[shard_id:max_num_files:num_shards]

    def __iter__(self) -> "PackedDatasetIterator":
        return PackedDatasetIterator(
            filenames=self.shard_filenames(),
            n_chunks=self._n_chunks,
            block_size=self._block_size,
            seed=self._seed,
            shuffle=self._shuffle,
            wrap=self._wrap,
        )


class PackedDatasetIterator:
    """Memmaps ``n_chunks`` files at a time and yields shuffled ``block_size`` slices
    (reference `lit_llama/packed_dataset.py:137-237`)."""

    def __init__(self, filenames, n_chunks, block_size, seed, shuffle, wrap):
        self._seed = seed
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed) if shuffle else None
        self._wrap = wrap
        self._filenames = filenames
        self._file_idx = 0
        self._n_chunks = n_chunks
        self._dtype = None
        self._block_size = block_size
        self._n_blocks = None
        self._mmaps: List[np.memmap] = []
        self._buffers: List[memoryview] = []
        self._block_idxs = []
        self._curr_idx = 0
        self._n_yielded = 0
        self._load_n_chunks()

    def _close_mmaps(self) -> None:
        for mmap in self._mmaps:
            mmap._mmap.close()

    def _load_n_chunks(self) -> None:
        self._close_mmaps()
        self._mmaps = []
        self._buffers = []

        if self._n_chunks > len(self._filenames[self._file_idx :]):
            if not self._wrap:
                raise StopIteration
            self._file_idx = 0

        for i in range(self._n_chunks):
            filename = self._filenames[self._file_idx + i]
            if self._dtype is None:
                self._dtype, self._chunk_size = read_header(filename)
                self._n_blocks = self._chunk_size // self._block_size
            mmap = np.memmap(filename, mode="r", order="C", offset=HDR_SIZE)
            self._mmaps.append(mmap)
            self._buffers.append(memoryview(mmap))

        self._file_idx += self._n_chunks
        n_all_blocks = self._n_chunks * self._n_blocks
        self._block_idxs = (
            self._rng.permutation(n_all_blocks) if self._shuffle else range(n_all_blocks)
        )
        self._curr_idx = 0

    def __del__(self):
        self._close_mmaps()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._curr_idx >= len(self._block_idxs):
            self._load_n_chunks()
        block_idx = self._block_idxs[self._curr_idx]
        chunk_id = block_idx // self._n_blocks
        buffer = self._buffers[chunk_id]
        elem_id = (block_idx % self._n_blocks) * self._block_size
        offset = np.dtype(self._dtype).itemsize * elem_id
        arr = np.frombuffer(
            buffer, dtype=self._dtype, count=self._block_size, offset=offset
        )
        self._curr_idx += 1
        self._n_yielded += 1
        return arr.astype(np.int64)

    def fast_forward(self, n: int) -> None:
        """Data-loader resume: advance ``n`` samples without reading payload
        bytes — the seeded shuffle replays, only the block cursor moves.
        (The reference cannot do this: its restart reshuffles from the seed and
        re-reads the stream from iteration 0, SURVEY.md §5 "data-loader position
        is not restored".)"""
        for _ in range(n):
            if self._curr_idx >= len(self._block_idxs):
                self._load_n_chunks()
            self._curr_idx += 1
            self._n_yielded += 1

    def state_dict(self) -> dict:
        return {"n_yielded": self._n_yielded}


class CombinedDataset:
    """Weighted random mixture over datasets (reference `packed_dataset.py:240-261`)."""

    def __init__(self, datasets, seed, weights: Optional[Sequence[float]] = None):
        self._seed = seed
        self._datasets = datasets
        n = len(datasets)
        self._weights = list(weights) if weights is not None else [1 / n] * n

    def __iter__(self):
        return CombinedDatasetIterator(self._datasets, self._seed, self._weights)


class CombinedDatasetIterator:
    def __init__(self, datasets, seed, weights):
        self._datasets = [iter(d) for d in datasets]
        self._weights = weights
        self._rng = random.Random(seed)
        self._n_yielded = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        (dataset,) = self._rng.choices(self._datasets, weights=self._weights, k=1)
        self._n_yielded += 1
        return next(dataset)

    def fast_forward(self, n: int) -> None:
        """Replay ``n`` mixture draws, fast-forwarding each chosen sub-iterator
        (no payload reads for PackedDatasetIterator members)."""
        for _ in range(n):
            (dataset,) = self._rng.choices(
                self._datasets, weights=self._weights, k=1
            )
            self._n_yielded += 1
            if hasattr(dataset, "fast_forward"):
                dataset.fast_forward(1)
            else:
                next(dataset)

    def state_dict(self) -> dict:
        return {"n_yielded": self._n_yielded}


def batch_iterator(
    dataset, batch_size: int, block_size: Optional[int] = None
) -> Iterator[np.ndarray]:
    """Stack single-block samples into ``(batch_size, block_size)`` device batches."""
    try:
        it = iter(dataset)
        while True:
            rows = [next(it) for _ in range(batch_size)]
            yield np.stack(rows)
    except (StopIteration, RuntimeError):
        return
