"""The port's C++ packed reader (`lit_llama_ja_tpu_torch/data/native_loader.py`) on the
CPU: its source is the JAX package's byte for byte, it builds into ``build/native/``,
and its batches equal the port's Python reader (unshuffled) and the JAX package's
native reader (shuffled, resumed with ``skip_batches``, sharded by rank). Every
comparison is exact: the readers copy tokens, they compute nothing."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from lit_llama_ja_tpu.data import native_loader as jnative

from lit_llama_ja_tpu_torch.data import native_loader as native
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDataset, PackedDatasetBuilder

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    assert native.native_available()
    if not jnative.native_available():
        pytest.skip("the JAX package's reader did not build")
    return True


def make_files(tmp_path, n_files=4, chunk_size=64, vocab=100):
    b = PackedDatasetBuilder(str(tmp_path), "nat", chunk_size, 0, vocab_size=vocab)
    rng = np.random.default_rng(7)
    toks = [rng.integers(1, vocab, chunk_size).astype(np.uint16) for _ in range(n_files)]
    for t in toks:
        b.add_array(t)
    b.write_reminder()
    return b.filenames, np.concatenate(toks)


def drain(it, n=None):
    rows = []
    try:
        while n is None or len(rows) < n:
            rows.append(next(it))
    except StopIteration:
        pass
    it.close()
    return np.stack(rows)


def test_source_is_the_jax_package_copy():
    ours = REPO / "lit_llama_ja_tpu_torch" / "native" / "packed_reader.cpp"
    assert native.SRC == ours
    assert ours.read_bytes() == (REPO / "native" / "packed_reader.cpp").read_bytes()


def test_build_lands_in_build_native(built):
    lib = native.build_native()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent == REPO / "build" / "native"
    assert lib.name.startswith("packedreader-") and lib.suffix == ".so"


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    bad = tmp_path / "packed_reader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ packed_reader.cpp failed"):
        native.build_native()
    assert not list((tmp_path / "out").glob("*.so"))


def test_unshuffled_batches_equal_the_python_reader(built, tmp_path):
    files, tokens = make_files(tmp_path)
    got = drain(native.NativePackedBatches(files, batch_size=2, block_size=8, shuffle=False))
    want = np.stack(list(PackedDataset(files, n_chunks=4, block_size=8, shuffle=False)))
    np.testing.assert_array_equal(got.reshape(-1, 8), want.astype(np.int32))
    np.testing.assert_array_equal(got.reshape(-1), tokens.astype(np.int32))


@pytest.mark.parametrize("seed,n_chunks,wrap", [(3, None, False), (12345, 2, True)])
def test_shuffled_batches_equal_jax(built, tmp_path, seed, n_chunks, wrap):
    files, _ = make_files(tmp_path)
    kw = dict(batch_size=2, block_size=16, seed=seed, n_chunks=n_chunks, wrap=wrap)
    n = 24 if wrap else None
    got = drain(native.NativePackedBatches(files, **kw), n)
    want = drain(jnative.NativePackedBatches(files, **kw), n)
    assert got.shape == want.shape and got.shape[1:] == (2, 16)
    np.testing.assert_array_equal(got, want)


def test_skip_batches_equals_a_drained_reader(built, tmp_path):
    files, _ = make_files(tmp_path)
    kw = dict(batch_size=2, block_size=16, seed=3, shuffle=True, wrap=True)
    skip = 5
    want = drain(native.NativePackedBatches(files, **kw), skip + 3)[skip:]
    got = drain(native.NativePackedBatches(files, skip_batches=skip, **kw), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, drain(jnative.NativePackedBatches(files, skip_batches=skip, **kw), 3))


def test_rank_sharding_matches_jax(built, tmp_path):
    files, _ = make_files(tmp_path, n_files=5)  # 5 files over 2 ranks: one is left out
    for rank in range(2):
        kw = dict(batch_size=1, block_size=8, shuffle=False, num_processes=2, process_rank=rank)
        got = drain(native.NativePackedBatches(files, **kw))
        np.testing.assert_array_equal(got, drain(jnative.NativePackedBatches(files, **kw)))
        py = PackedDataset(files, 2, 8, shuffle=False, num_processes=2, process_rank=rank)
        np.testing.assert_array_equal(got[:, 0], np.stack(list(py)).astype(np.int32))
    with pytest.raises(ValueError, match="no files"):
        native.NativePackedBatches(files[:1], 1, 8, num_processes=2, process_rank=1)
