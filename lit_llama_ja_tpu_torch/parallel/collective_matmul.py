"""Collective dequant-matmul: weight shards travel around a ring of ranks while each
hop's dequant-matmul computes (counterpart of `lit_llama_ja_tpu/parallel/
collective_matmul.py`).

A model whose quantized weights exceed one card must shard them for storage, and every
forward then has to bring the missing shards in. Here they travel at int4/int8 width,
one shard a hop, and each rank dequantizes only the ``(K/n, N/n)`` tile it is about to
multiply: the full bf16 weight never exists anywhere.

Work split, as in the JAX package: storage is K-sharded (rank ``d`` owns K rows
``[d·K/n, (d+1)·K/n)`` of the pack and, when grouped, the matching scale and zero
rows); compute is N-split (rank ``d`` accumulates output columns
``[d·N/n, (d+1)·N/n)`` over all n hops, in f32), and the only activation collective
is the final all-gather of the ``(M, N/n)`` outputs. Each hop's product is K1 (int4)
or K3 (int8) through `quant/linear.quant_matmul`; the shard moves to the next rank
with one ``batch_isend_irecv`` (`mesh.ring_shift`).

The kernels take contiguous weights, and the hop's ``N/n`` columns of a ``(K/n, N)``
shard are not. So `k_shard` copies the rank's shard ONCE, when it cuts it, into column
blocks ``(n, K/n, N/n)`` (scales and zeros alike): that blocked layout is what
`ring_quant_matmul` takes and what travels, and block ``d`` is contiguous at every hop.
``RING_COPY`` counts the bytes of that copy; a call copies nothing.

Each hop's transfer overlaps the previous hop's product, as XLA's asynchronous
``ppermute`` does for the JAX package: hop i posts the move of the shard it holds
(`mesh.ring_shift_async`), runs its product on that shard, then waits for the next one.
The products are summed in hop order, as before the overlap. On one card shared by
several ranks over gloo the overlap has nothing to hide behind (every transfer is
staged through the host); it needs several cards to show.
"""
from __future__ import annotations

from typing import Dict

import torch

from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, all_gather, ring_shift_async
from lit_llama_ja_tpu_torch.parallel.sharded import k_shard_groups
from lit_llama_ja_tpu_torch.quant.linear import quant_matmul

RING_COPY = {"bytes": 0}  # bytes of the column-blocking copies of `k_shard`


def _column_blocks(t: torch.Tensor, n: int) -> torch.Tensor:
    """``(rows, N)`` -> ``(n, rows, N/n)``, contiguous: block ``j`` is columns
    ``[j·N/n, (j+1)·N/n)``."""
    out = t.unflatten(-1, (n, t.shape[-1] // n)).transpose(0, 1).contiguous()
    RING_COPY["bytes"] += out.numel() * out.element_size()
    return out


def k_shard(qparams: Dict[str, torch.Tensor], K: int, mesh: Mesh,
            axis: str = "fsdp") -> Dict[str, torch.Tensor]:
    """This rank's K-shard of a full ``{"qweight", "scales", "zeros"}`` pack over K
    input rows, in `ring_quant_matmul`'s column blocks ``(n, ·, N/n)``: its packed rows,
    and its scale and zero rows by the whole matrix's tile rule
    (`sharded.k_shard_groups`; every shard gets as many)."""
    n, d = mesh.size(axis), mesh.index(axis)
    qw = qparams["qweight"]
    N = qw.shape[-1]
    if qw.shape[0] % n or K % n or N % n:
        raise ValueError(f"K={K} ({qw.shape[0]} packed rows) and N={N} do not split over "
                         f"{n} ranks")
    rows, K_loc = qw.shape[0] // n, K // n
    return {"qweight": _column_blocks(qw[d * rows:(d + 1) * rows], n),
            "scales": _column_blocks(k_shard_groups(qparams["scales"], K, d * K_loc, K_loc), n),
            "zeros": _column_blocks(k_shard_groups(qparams["zeros"], K, d * K_loc, K_loc), n)}


def ring_quant_matmul(
    x: torch.Tensor,  # (..., K), the same on every rank of the axis
    qshard: Dict[str, torch.Tensor],  # this rank's K-shard in column blocks (`k_shard`)
    mesh: Mesh,
    axis: str = "fsdp",
    grouped: bool = True,
) -> torch.Tensor:
    """``x @ dequant(W)`` with W K-sharded over ``axis``: the result ``(..., N)`` on
    every rank. Scale and zero rows travel with the weight only when ``grouped`` (the
    whole pack has more than one scale row); otherwise the one row serves every
    K-shard. Needs K and N divisible by the axis size."""
    n, d = mesh.size(axis), mesh.index(axis)
    qw, s, z = qshard["qweight"], qshard["scales"], qshard["zeros"]
    if qw.dim() != 3 or qw.shape[0] != n:
        raise ValueError(f"qshard must hold {n} column blocks (k_shard), got "
                         f"{tuple(qw.shape)}")
    n_loc = qw.shape[-1]
    K = x.shape[-1]
    if K % n:
        raise ValueError(f"K={K} must divide over {n} ranks")
    K_loc = K // n
    travel = [qw, s, z] if grouped else [qw]
    x2 = x.reshape(-1, K)
    y = torch.zeros((x2.shape[0], n_loc), dtype=torch.float32, device=x.device)
    for i in range(n):
        # post the move of the held shard to the left neighbour (and the right one's to
        # here) before this hop's product, which reads the held shard meanwhile
        pending = ring_shift_async(travel, mesh, axis, step=-1) if i < n - 1 else None
        k_idx = (d + i) % n  # the K-shard this rank holds at hop i
        xs = x2[:, k_idx * K_loc:(k_idx + 1) * K_loc]
        leaves = {"qweight": travel[0][d],
                  "scales": travel[1][d] if grouped else s[d],
                  "zeros": travel[2][d] if grouped else z[d]}
        y += quant_matmul(xs, leaves).float()
        if pending is not None:
            travel = pending()
    y = all_gather(y, mesh, axis, dim=1)  # (M, N)
    return y.to(x.dtype).reshape(*x.shape[:-1], n * n_loc)
