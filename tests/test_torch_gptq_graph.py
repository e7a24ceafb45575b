"""The GPTQ solver's block bodies (`quant/gptq.GPTQGraphs`, kind "gptq"), on the CPU:
the staged solver against the JAX package's jitted `gptq_solve`, every block's body run
once under `no_host_reads` (the guard a capture needs), and one body a key, reused over
the blocks, linears and layers that share it.

Tolerances are `tests/test_torch_gptq.py`'s: the two solvers sum in float32 in
different orders, so levels agree on at least 99.9% of the entries, scales and zeros
within 1e-4 relative, the total error within 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import guarded_bodies, to_port  # noqa: F401 (a fixture)

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.models import llama as jl
from lit_llama_ja_tpu.quant import gptq as jg

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.quant import gptq as tg
from lit_llama_ja_tpu_torch.quant import pipeline as tpipe

LEVEL_AGREE = 0.999
PARAM_REL = 1e-4
BLOCK = 128
CFG = dict(block_size=32, vocab_size=96, n_layer=2, n_head=4, n_embd=64)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: a block body is hundreds of tiny ops, which several threads
    a worker only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(rng, K, N=40):
    w = rng.standard_normal((N, K)).astype(np.float32)
    a = rng.standard_normal((4 * K, K)).astype(np.float32)
    a[:, : K // 4] *= 3.0  # anisotropic, correlated inputs
    a[:, 7] = 0.0  # a dead input column
    return w, (2.0 / a.shape[0] * (a.T @ a)).astype(np.float32)


def _keys(N, K, bits, groupsize, sym):
    """The block keys of one solve: (N, width, bits, groupsize, sym, offset in group)."""
    return {(N, min(BLOCK, K - i1), bits, groupsize, sym, 0 if groupsize == -1 else i1 % groupsize)
            for i1 in range(0, K, BLOCK)}


@pytest.mark.parametrize("bits,groupsize,actorder,sym,K", [
    (4, -1, True, False, 300),  # whole rows, actorder, a ragged last block of 44
    (3, 32, False, False, 300),  # groups dividing the block; the last window clamps
    (4, 256, False, False, 380),  # groups of two blocks: both offsets, a ragged third block
    (2, 64, False, True, 300),  # sym
    (8, -1, True, True, 256),  # 8 bits, sym, whole blocks only
])
def test_staged_solver_matches_jax(rng, guarded_bodies, bits, groupsize, actorder, sym, K):
    w, H = _problem(rng, K)
    kw = dict(bits=bits, groupsize=groupsize, actorder=actorder, sym=sym)
    graphs = tg.GPTQGraphs("cpu", capture=False)
    q, s, z, err = tg.gptq_solve(torch.from_numpy(w), torch.from_numpy(H), graphs=graphs,
                                 cuda_graph=False, **kw)
    jq, js, jz, jerr = jg.gptq_solve(jnp.asarray(w), jnp.asarray(H), **kw)
    agree = (q.numpy() == np.asarray(jq)).mean()
    assert agree >= LEVEL_AGREE, agree
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=PARAM_REL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=PARAM_REL, atol=PARAM_REL)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-2)
    # one guarded body a block, one graph a key; the call's own set is the caller's
    assert guarded_bodies["gptq"] == -(-K // BLOCK)
    assert set(graphs.graphs) == set(graphs.buffers) == _keys(w.shape[0], K, bits, groupsize, sym)
    assert all(gr.kind == "gptq" and not gr.capture_enabled for gr in graphs.graphs.values())


def test_solve_alone_builds_and_frees_its_own_set(rng, guarded_bodies, monkeypatch):
    """Called without a set, the solve builds one for itself, runs every block in it,
    and closes it before returning; a second solve of the same shape gives the same
    bits."""
    w, H = (torch.from_numpy(a) for a in _problem(rng, 300))
    sets = []

    class Recorded(tg.GPTQGraphs):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            sets.append(self)

    monkeypatch.setattr(tg, "GPTQGraphs", Recorded)
    first = tg.gptq_solve(w, H, bits=3, groupsize=64)
    second = tg.gptq_solve(w, H, bits=3, groupsize=64)
    assert len(sets) == 2 and all(not s.graphs and not s.buffers for s in sets)
    assert guarded_bodies["gptq"] == 2 * 3
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_graphs_reused_over_layers_and_linears(rng, guarded_bodies, monkeypatch):
    """A 2-layer model: one graph a distinct key over the run, not one a block, a linear
    or a layer; the set is closed before `gptq_quantize_model` returns."""
    jp = jl.init_params(jax.random.PRNGKey(3), JConfig(**CFG))
    tp = to_port(jax.tree.map(lambda a: a * 8.0 if a.ndim >= 2 else a, jp))
    config = LLaMAConfig(**CFG)
    seen = {}
    close = tg.GPTQGraphs.close

    def recorded_close(self):
        seen["keys"] = set(self.graphs)
        close(self)
        seen["left"] = len(self.graphs) + len(self.buffers)

    monkeypatch.setattr(tg.GPTQGraphs, "close", recorded_close)
    calib = rng.integers(0, CFG["vocab_size"], size=(2, 16))
    tpipe.gptq_quantize_model(tp, config, calib, bits=4, micro_batch=2, progress=False)
    shapes = {name: tuple(tpipe._get(tp["blocks"], name)["weight"].shape[1:])
              for name in tpipe.SUBMODULES}
    shapes["lm_head"] = tuple(tp["lm_head"]["weight"].shape)
    want = set().union(*(_keys(N, K, 4, -1, False) for K, N in shapes.values()))
    blocks = CFG["n_layer"] * sum(-(-K // BLOCK) for name, (K, _) in shapes.items()
                                  if name != "lm_head") + -(-shapes["lm_head"][0] // BLOCK)
    assert seen["keys"] == want and seen["left"] == 0
    assert guarded_bodies["gptq"] == blocks > len(want)
