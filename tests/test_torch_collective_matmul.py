"""The port's `ring_quant_matmul` (`parallel/collective_matmul.py`) on 2 and 4 gloo
ranks against the single-rank dequant-matmul and the JAX package's ring on the tests'
virtual devices (mirroring tests/test_collective_matmul.py).

Each rank cuts its K-shard of the same full pack (`k_shard`); the int4 and int8 hops go
through `quant/linear.quant_matmul` (the plain versions on the CPU). Tolerance: f32 on
every side, the hop products summed in another order: 1e-5 relative and absolute, the
JAX test's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_ranks import ring_matmuls, spawn

from lit_llama_ja_tpu.parallel.collective_matmul import ring_quant_matmul as j_ring
from lit_llama_ja_tpu.parallel.mesh import make_mesh as j_make_mesh

from lit_llama_ja_tpu_torch.parallel.collective_matmul import RING_COPY, k_shard
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh
from lit_llama_ja_tpu_torch.quant.linear import (
    quant_matmul,
    quantize_colblock,
    quantize_int8_absmax,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pack(rng, K, N, bits, tile):
    w = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32) * 0.1)
    return quantize_int8_absmax(w) if bits == 8 else quantize_colblock(w, bits=4, tile_cols=tile)


# the JAX ring runs one case a world (its Pallas matmul in interpret mode takes 10-15 s
# a case on the CPU); the port's one-rank matmul is the oracle of every case
JAX_CASE = {2: "ragged_780", 4: "int4_grouped"}


def _cases(world):
    """name -> (x, pack, K): whole-column and grouped int4, int8, a batched x, and
    ragged groups: K = 1560 in groups of 60 (shards of K = 780, 13 tiles each, the 125M
    width) and groups of 64 that the JAX ring refuses (its tiles do not divide over
    the ranks): K = 780 on 2 ranks (13 tiles of 60 by the tile rule, cut at 390 rows)
    and K = 1560 on 4 (25 tiles of 63, cut at 390): the shards repeat tile rows."""
    rng = np.random.default_rng(world)
    K = 780 if world == 2 else 1560
    return {"int4": (rng.normal(size=(8, 64)), _pack(rng, 64, 32, 4, -1), 64),
            "int4_grouped": (rng.normal(size=(8, 64)), _pack(rng, 64, 32, 4, 64 // world), 64),
            "int8": (rng.normal(size=(4, 32)), _pack(rng, 32, 48, 8, -1), 32),
            "batched": (rng.normal(size=(2, 3, 32)), _pack(rng, 32, 32, 4, -1), 32),
            "ragged_780": (rng.normal(size=(3, 1560)), _pack(rng, 1560, 16, 4, 60), 1560),
            "ragged_g64": (rng.normal(size=(5, K)), _pack(rng, K, 16, 4, 64), K)}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_single_rank_and_jax(tmp_path, world):
    cases = {name: (torch.as_tensor(x, dtype=torch.float32), qp, K)
             for name, (x, qp, K) in _cases(world).items()}
    outs = spawn(ring_matmuls, world, tmp_path, cases)
    for name, (x, qp, K) in cases.items():
        want = quant_matmul(x, qp).numpy()
        for out in outs:
            got = out[name].numpy()
            assert got.shape == tuple(x.shape[:-1]) + (qp["qweight"].shape[-1],)
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    x, qp, _ = cases[JAX_CASE[world]]
    jmesh = j_make_mesh(dp=1, fsdp=world, tp=1, devices=jax.devices()[:world])
    jgot = np.asarray(j_ring(jnp.asarray(x.numpy()),
                             {k: jnp.asarray(v.numpy()) for k, v in qp.items()}, jmesh,
                             axis="fsdp"))
    np.testing.assert_allclose(outs[0][JAX_CASE[world]].numpy(), jgot, **TOL)


def unblock(t):
    """`k_shard`'s ``(n, rows, N/n)`` column blocks back to ``(rows, N)``."""
    return t.transpose(0, 1).flatten(1)


@pytest.mark.parametrize("K,tile,world", [(780, 64, 2), (1560, 64, 4), (4096, 128, 2),
                                          (1560, 60, 2)])
def test_k_shard_keeps_the_whole_matrix_tile_rule(K, tile, world):
    """Every shard's rows dequantize as the whole matrix's: the shard's scale rows and
    its own tile rule give each of its K rows the whole matrix's scale row. The shard
    comes in column blocks, laid out whole again here."""
    from lit_llama_ja_tpu_torch.quant.linear import _expand_tiles

    rng = np.random.default_rng(K)
    qp = _pack(rng, K, 8, 4, tile)
    whole = _expand_tiles(qp["scales"], K)
    for r in range(world):
        shard = k_shard(qp, K, Mesh({"dp": 1, "fsdp": world, "tp": 1}, rank=r))
        K_loc = K // world
        assert shard["qweight"].shape == (world, K_loc // 2, 8 // world)
        assert torch.equal(unblock(shard["qweight"]),
                           qp["qweight"][r * K_loc // 2:(r + 1) * K_loc // 2])
        assert torch.equal(_expand_tiles(unblock(shard["scales"]), K_loc),
                           whole[r * K_loc:(r + 1) * K_loc])
    assert RING_COPY["bytes"] >= 0
