"""The PyTorch port's config registry equals the JAX package's, field for field."""
import dataclasses

import pytest

from lit_llama_ja_tpu.core import config as jconfig

from lit_llama_ja_tpu_torch.core import config as tconfig


def test_registry_names_match():
    assert tconfig.llama_configs == jconfig.llama_configs
    assert tconfig.llama_model_sizes == jconfig.llama_model_sizes


@pytest.mark.parametrize("name", sorted(jconfig.llama_configs))
def test_config_fields_match(name):
    j = jconfig.LLaMAConfig.from_name(name)
    t = tconfig.LLaMAConfig.from_name(name)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.head_dim, t.n_hidden, t.padded_vocab_size) == (
        j.head_dim, j.n_hidden, j.padded_vocab_size
    )
    assert tconfig.llama_model_lookup(t.n_embd) == jconfig.llama_model_lookup(j.n_embd)


@pytest.mark.parametrize("n,k", [(35000, 64), (32000, 64), (11008, 256), (7, 7), (1, 8)])
def test_find_multiple(n, k):
    assert tconfig.find_multiple(n, k) == jconfig.find_multiple(n, k)


def test_config_is_frozen_and_replace_works():
    c = tconfig.LLaMAConfig(n_layer=2, n_head=2, n_embd=16, vocab_size=100)
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.n_layer = 3
    assert c.replace(n_layer=3).n_layer == 3 and c.padded_vocab_size == 128
