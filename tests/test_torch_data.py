"""Parity of the port's copy of the packed dataset (`data/packed_dataset.py`) with the
JAX package's: the builder writes the same bytes, the readers yield the same blocks
in the same order from the same seeds, and ``fast_forward`` lands where sequential
reading does (the cases of `tests/test_data_resume.py`)."""
import filecmp
import os

import numpy as np
import pytest

from lit_llama_ja_tpu.data import packed_dataset as jpd

from lit_llama_ja_tpu_torch.data import packed_dataset as tpd


def _build(module, outdir, prefix, arrays, chunk_size, vocab):
    os.makedirs(outdir, exist_ok=True)
    b = module.PackedDatasetBuilder(outdir=str(outdir), prefix=prefix, chunk_size=chunk_size,
                                    sep_token=0, dtype="auto", vocab_size=vocab)
    for a in arrays:
        b.add_array(a)
    b.write_reminder()
    return b.filenames


@pytest.mark.parametrize("vocab", [500, 70000])  # uint16 and int32 payloads
def test_builder_writes_identical_files(tmp_path, rng, vocab):
    dtype = np.uint16 if vocab < 65500 else np.int32
    arrays = [rng.integers(1, vocab, size=n).astype(dtype) for n in (5, 64, 130, 1, 63)]
    jfiles = _build(jpd, tmp_path / "jax", "p", arrays, 64, vocab)
    tfiles = _build(tpd, tmp_path / "port", "p", arrays, 64, vocab)
    assert [os.path.basename(f) for f in tfiles] == [os.path.basename(f) for f in jfiles]
    for a, b in zip(tfiles, jfiles):
        assert filecmp.cmp(a, b, shallow=False), a


def make_files(tmp_path, prefix="res", n_files=4, chunk_size=64, vocab=500):
    rng = np.random.default_rng(sum(map(ord, prefix)))
    arrays = [rng.integers(1, vocab, size=(chunk_size,)).astype(np.uint16)
              for _ in range(n_files)]
    return _build(tpd, tmp_path, prefix, arrays, chunk_size, vocab)


def _take(it, n):
    return np.stack([np.asarray(next(it)) for _ in range(n)])


@pytest.mark.parametrize("kw", [
    dict(n_chunks=2, block_size=16, seed=99, shuffle=True, wrap=True),
    dict(n_chunks=1, block_size=8, seed=3, shuffle=False, wrap=True),
    dict(n_chunks=1, block_size=16, seed=5, shuffle=True, wrap=True,
         num_processes=2, process_rank=1),
])
def test_readers_yield_identical_blocks(tmp_path, kw):
    files = make_files(tmp_path)
    got = _take(iter(tpd.PackedDataset(files, **kw)), 20)
    want = _take(iter(jpd.PackedDataset(files, **kw)), 20)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


@pytest.mark.parametrize("skip", [0, 3, 7, 19])
def test_packed_fast_forward_matches_sequential(tmp_path, skip):
    files = make_files(tmp_path)
    kw = dict(n_chunks=2, block_size=16, seed=99, shuffle=True, wrap=True)
    ref = iter(jpd.PackedDataset(files, **kw))
    for _ in range(skip):
        next(ref)
    resumed = iter(tpd.PackedDataset(files, **kw))
    resumed.fast_forward(skip)
    assert resumed.state_dict()["n_yielded"] == skip
    np.testing.assert_array_equal(_take(resumed, 5), _take(ref, 5))


def test_packed_fast_forward_across_chunk_windows(tmp_path):
    """Skip past a window reload boundary (re-mmap + reshuffle)."""
    files = make_files(tmp_path, n_files=4, chunk_size=32)
    kw = dict(n_chunks=2, block_size=16, seed=5, shuffle=True, wrap=True)
    ref = iter(jpd.PackedDataset(files, **kw))
    skip = 9  # a window holds 2 * 32 / 16 = 4 blocks: crosses 2 reloads
    for _ in range(skip):
        next(ref)
    resumed = iter(tpd.PackedDataset(files, **kw))
    resumed.fast_forward(skip)
    np.testing.assert_array_equal(np.asarray(next(resumed)), np.asarray(next(ref)))


def test_combined_fast_forward_and_batches_match(tmp_path):
    files_a = make_files(tmp_path, prefix="a", n_files=3)
    files_b = make_files(tmp_path, prefix="b", n_files=3)

    def mk(module):
        dss = [module.PackedDataset(f, n_chunks=1, block_size=16, seed=7, wrap=True)
               for f in (files_a, files_b)]
        return module.CombinedDataset(dss, seed=11, weights=[0.7, 0.3])

    ref = iter(mk(jpd))
    skip = 13
    for _ in range(skip):
        next(ref)
    resumed = iter(mk(tpd))
    resumed.fast_forward(skip)
    assert resumed.state_dict()["n_yielded"] == skip
    np.testing.assert_array_equal(_take(resumed, 4), _take(ref, 4))

    got = list(zip(range(3), tpd.batch_iterator(mk(tpd), 4)))
    want = list(zip(range(3), jpd.batch_iterator(mk(jpd), 4)))
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == (4, 16)
        np.testing.assert_array_equal(a, b)
