"""The port's data-preparation CLIs (`lit_llama_ja_tpu_torch/cli/prepare_cli.py`) against
the JAX package's on the CPU: the same local text through both, with one byte-level BPE
tokenizer trained in the test's directory, must give the same chunk files byte for
byte. Nothing is fetched: `prepare_ja` reads a stand-in for `datasets.load_dataset`,
and `prepare_shakespeare` a pre-placed ``input.txt`` (only where sentencepiece is
installed)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lit_llama_ja_tpu.cli import prepare_cli as jprep

from lit_llama_ja_tpu_torch.cli import prepare_cli as prep
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDataset
from lit_llama_ja_tpu_torch.io.tokenizer import HFTokenizer

REPO = Path(__file__).resolve().parents[1]
LINES = ["吾輩は猫である。名前はまだ無い。", "The quick brown fox jumps over the lazy dog.",
         "どこで生れたかとんと見当がつかぬ。", "", "   ", "Lorem ipsum dolor sit amet, 12345."]


def _text(i):
    return " ".join(LINES[(i + j) % len(LINES)] for j in range(1 + i % 3)).strip() or "x"


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    corpus = root / "corpus.txt"
    corpus.write_text("\n".join(LINES * 20), encoding="utf-8")
    return HFTokenizer.train(str(corpus), str(root), vocab_size=300)


def _files(d: Path):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.bin"))}


def _same_chunks(a: Path, b: Path):
    fa, fb = _files(a), _files(b)
    assert fa and sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    return fa


def test_prepare_any_text_matches_jax(tok, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        (src / f"part{i}.txt").write_text("\n".join(_text(i + j) for j in range(9)),
                                          encoding="utf-8")
    (src / "skip.md").write_text("not matched by the glob")
    kw = dict(source_path=str(src), tokenizer_path=tok, chunk_size=64, prefix="anytext")
    prep.prepare_any_text(destination_path=str(tmp_path / "port"), **kw)
    jprep.prepare_any_text(destination_path=str(tmp_path / "jax"), **kw)
    files = _same_chunks(tmp_path / "port", tmp_path / "jax")
    assert all(name.startswith("anytext_") for name in files)
    # the chunks read back: every line as BOS + tokens + EOS, then sep padding
    rows = np.concatenate(list(PackedDataset(sorted(map(str, (tmp_path / "port").glob("*.bin"))),
                                             n_chunks=len(files), block_size=64, shuffle=False)))
    t = HFTokenizer(tok)
    first = t.encode(_text(0), bos=True, eos=True)
    np.testing.assert_array_equal(rows[: len(first)], first)
    with pytest.raises(RuntimeError, match="no files matching"):
        prep.prepare_any_text(destination_path=str(tmp_path / "none"),
                              **{**kw, "source_path": str(tmp_path / "empty")})


def _write_jsonl(path: Path, n: int, seed: int):
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = "".join(json.dumps({"text": _text(seed + i), "meta": {"i": i}}) + "\n"
                   for i in range(n))
    if path.suffix == ".zst":
        import zstandard

        path.write_bytes(zstandard.ZstdCompressor().compress(rows.encode("utf-8")))
    else:
        path.write_text(rows, encoding="utf-8")


@pytest.mark.parametrize("sample,match", [(True, ""), (True, "book"), (False, ""),
                                          (False, "c4")])
def test_prepare_redpajama_matches_jax(tok, tmp_path, sample, match):
    src = tmp_path / "src"
    for i, name in enumerate(prep.filenames_sample):
        _write_jsonl(src / name, 3 + i % 4, i)
    for i, pattern in enumerate(prep.filename_sets.values()):
        stem = pattern.replace("*", "")
        _write_jsonl(src / f"{stem}_0.jsonl", 4, 10 + i)
        _write_jsonl(src / f"{stem}_1.jsonl.zst", 3, 20 + i)  # zstd-compressed jsonl
    kw = dict(source_path=str(src), tokenizer_path=tok, chunk_size=48, sample=sample,
              match=match)
    prep.prepare_redpajama(destination_path=str(tmp_path / "port"), **kw)
    jprep.prepare_redpajama(destination_path=str(tmp_path / "jax"), **kw)
    files = _same_chunks(tmp_path / "port", tmp_path / "jax")
    prefixes = {name.rsplit("_", 1)[0] for name in files}
    if match:
        assert prefixes == {"book_sample" if sample else "c4"}
    else:
        assert len(prefixes) == len(prep.filenames_sample if sample else prep.filename_sets)
    (src / prep.filenames_sample[0]).unlink()
    with pytest.raises(RuntimeError, match="Input file not found"):
        prep.prepare_redpajama(destination_path=str(tmp_path / "again"),
                               **{**kw, "sample": True, "match": "arxiv"})


def test_prepare_ja_matches_jax(tok, tmp_path, monkeypatch):
    datasets = pytest.importorskip("datasets")
    loaded = []

    def load_dataset(name, split):
        loaded.append((name, split))
        i = len(loaded)
        return [{"text": _text(i + j)} if j % 2 else {"content": _text(i - j)}
                for j in range(5)]

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    prep.prepare_ja(tokenizer_path=tok, destination_path=str(tmp_path / "port"), chunk_size=40,
                    match="wiki")
    n = len(loaded)
    loaded.clear()
    jprep.prepare_ja(tokenizer_path=tok, destination_path=str(tmp_path / "jax"), chunk_size=40,
                     match="wiki")
    assert n == len(loaded) == 4  # wikipedia and wikinews, ja and en
    _same_chunks(tmp_path / "port", tmp_path / "jax")


def test_prepare_shakespeare_offline(tmp_path):
    pytest.importorskip("sentencepiece")
    text = "\n".join(LINES[:3] * 200)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "input.txt").write_text(text, encoding="utf-8")
    prep.prepare_shakespeare(str(tmp_path / "port"))
    jprep.prepare_shakespeare(str(tmp_path / "jax"))
    for name in ("train.bin", "val.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_module_entry_point_takes_prepare_any_text():
    out = subprocess.run(
        [sys.executable, "-m", "lit_llama_ja_tpu_torch.cli.prepare_cli", "-h"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=120).stdout
    assert "--source-path" in out and "--glob-pattern" in out and "--prefix" in out
