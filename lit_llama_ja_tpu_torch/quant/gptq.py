"""GPTQ solver (counterpart of `lit_llama_ja_tpu/quant/gptq.py`; reference
`lit_llama/quantization.py:424-614`, after E. Frantar et al., "GPTQ: Accurate
Post-training Compression for GPT", arXiv:2210.17323).

The JAX package's blocked structure is kept: inside each block of columns a loop
quantizes one column at a time and feeds its error back into the block's remaining
columns (a ``lax.scan`` there), then one matmul pushes the block's error into every
later column. The damped Cholesky chain runs in float32, as in the JAX package; the
Hessian accumulates in float64 (`hessian_update` says why). W is (out=N, in=K) inside
the solver, H is (K, K); `gptq_quantize_linear` takes and packs the (K, N) layout of
`quant/linear.py`.

The JAX package compiles the whole solve once an (N, K) shape. Here the column loop of
one block is a **body** (`_block_body`, kind "gptq") over static buffers: the block's
columns, its slice of the inverse Cholesky factor, the scales and zeros of the groups
it touches, and outputs for its levels and errors. `GPTQGraphs` holds one body a key
(N, block width, bits, groupsize, sym, the block's offset in its group) and, on a CUDA
device, captures it in a CUDA graph at its first run and replays it after that: a
block's 128 columns, some 1,300 kernels, launch with one ``replay()``, and a graph is
reused over every block, linear and layer of its key. Around it the rest stays eager:
the prologue (dead columns, the actorder permutation, the whole-row params and the
Cholesky chain, whose ``info`` check reads back to the host to raise), the copies in and
out of a block, and the level-3 push of its error into the later columns. On the CPU
the same body runs uncaptured.
"""
from __future__ import annotations

import functools
from typing import Dict, Hashable, Optional, Tuple

import torch

from lit_llama_ja_tpu_torch.infer.decode_graph import DecodeGraph
from lit_llama_ja_tpu_torch.quant.linear import Params, pack_prequantized


# ---------------------------------------------------------------------------
# Hessian accumulation (reference `collect_input_stats`, quantization.py:513-527)
# ---------------------------------------------------------------------------

def hessian_update(H: torch.Tensor, nsamples: torch.Tensor, x: torch.Tensor):
    """Online update ``H <- H * n/(n+b) + 2/(n+b) * X^T X``.

    x: ``(..., K)`` activations feeding one linear; the sample count grows by the
    leading-dim size (the reference's per-forward ``inp.shape[0]``).

    H accumulates in float64, where the JAX package uses float32. A float32 ``X^T X``
    over 16,384 rows of the 125M model's MLP input carried rounding of 5e-6 of its
    largest eigenvalue on an H100 (one eigenvalue at -3.0e-4 against 54.7). When the
    activations are dominated by one direction (a barely trained model, or repeated
    calibration text) that exceeds the solver's damping, 1% of the mean diagonal
    (2.4e-4 there), so ``H + damp·I`` is not positive definite and its Cholesky
    fails. The solver itself still runs in float32.
    """
    b = x.shape[0]
    x2d = x.reshape(-1, x.shape[-1]).double()
    new_n = nsamples + b
    H = H * (nsamples / new_n)
    return H + (2.0 / new_n) * (x2d.T @ x2d), new_n


def init_hessian(K: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((K, K), dtype=torch.float64, device=device),
            torch.zeros((), dtype=torch.float64, device=device))


# ---------------------------------------------------------------------------
# Scale/zero search (reference `find_params_weight`, quantization.py:475-511)
# ---------------------------------------------------------------------------

def _find_params_rows(w: torch.Tensor, maxq: int, sym: bool):
    """Per-row (out-channel) scale/zero of ``w`` (N, k_window). Returns (N,), (N,).

    The range is multiplied by the f32 reciprocal of ``maxq``, as XLA compiles the JAX
    package's division by that constant: a row's extreme sits on a rounding tie (with
    ``sym`` always, ``w / scale`` = ±maxq/2), which the last bit of the scale decides."""
    xmin = torch.clamp(w.amin(dim=1), max=0.0)
    xmax = torch.clamp(w.amax(dim=1), min=0.0)
    if sym:
        xmax = torch.maximum(torch.abs(xmin), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = (xmax - xmin) * (1.0 / maxq)
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return scale, zero


def _inverse_cholesky(H: torch.Tensor, percdamp: float) -> torch.Tensor:
    """Upper Cholesky factor of ``inv(H + damp·I)``, damp = percdamp·mean(diag H)
    (`quantization.py:549-555`), in float32 as the JAX package computes it."""
    K = H.shape[0]
    H = H + percdamp * torch.mean(torch.diag(H)) * torch.eye(K, dtype=H.dtype, device=H.device)
    L = torch.linalg.cholesky(H)
    return torch.linalg.cholesky(torch.cholesky_inverse(L), upper=True)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def _block_body(maxq: int, groupsize: int, sym: bool, phase: int, *, W1, Hinv1, S, Z, Q1,
                Err1, loss) -> None:
    """The column loop of one block over static buffers: quantize each column of ``W1``
    (N, count) against the scale and zero of its group, feed its error back into the
    block's remaining columns through ``Hinv1`` (count, count), and write its levels
    into ``Q1`` and its error into ``Err1``; half the block's summed squared error goes
    into ``loss``.

    ``S``, ``Z`` (N, groups): the scales and zeros of the groups the block touches, its
    first the group that holds column 0; a group that starts inside the block
    (``phase``, the block's offset in its group, decides which, with ``groupsize``) gets
    params from the error-updated block, its window clamped into the block as
    ``lax.dynamic_slice`` clamps it. With ``groupsize`` -1, ``S`` and ``Z`` hold the
    whole-row params. Reads nothing back to the host."""
    count = W1.shape[1]
    for i in range(count):
        g = 0
        if groupsize != -1:
            g = (phase + i) // groupsize
            if (phase + i) % groupsize == 0:
                size = min(groupsize, count)
                start = min(i, count - size)
                S[:, g], Z[:, g] = _find_params_rows(W1[:, start : start + size], maxq, sym)
        w, scale, zero = W1[:, i], S[:, g], Z[:, g]
        q = torch.clamp(torch.round(w / scale) + zero, 0, maxq, out=Q1[:, i])
        err = torch.div(w - scale * (q - zero), Hinv1[i, i], out=Err1[:, i])
        # rank-1 error feedback into this and the remaining columns of the block
        W1[:, i:] -= err[:, None] * Hinv1[i, i:][None, :]
    # the reference's per-column (w - w_rec)**2 / d**2, summed over the block at once
    loss += torch.sum(Err1**2) / 2


class GPTQGraphs:
    """The solver's block bodies, one `DecodeGraph` (kind "gptq") a key over buffers of
    its own, and the error accumulator they share: what one quantization run (a whole
    model, or one solve called alone) holds.

    ``capture``: capture each key's body at its first run and replay it after (a CUDA
    device only), else call it. The graphs share one pool, since no two run at once;
    `close` drops them and their buffers, which frees the pool. A failed capture or
    replay raises.
    """

    def __init__(self, device, *, capture: bool):
        self.device = torch.device(device)
        self.capture = capture
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.graphs: Dict[Hashable, DecodeGraph] = {}
        self.buffers: Dict[Hashable, Dict[str, torch.Tensor]] = {}
        # allocated here, outside the pool: every body adds into it
        self.loss = torch.zeros((), dtype=torch.float32, device=self.device)

    def block(self, N: int, count: int, bits: int, groupsize: int, sym: bool, phase: int):
        """The buffers and the graph of a block of ``count`` columns of an N-row weight
        at ``phase`` in its group (0 without groups), built at the key's first use."""
        key = (N, count, bits, groupsize, sym, phase)
        graph = self.graphs.get(key)
        if graph is None:
            groups = 1 if groupsize == -1 else (phase + count - 1) // groupsize + 1
            f32 = dict(dtype=torch.float32, device=self.device)
            bufs = self.buffers[key] = {
                "W1": torch.zeros((N, count), **f32), "Hinv1": torch.zeros((count, count), **f32),
                "S": torch.zeros((N, groups), **f32), "Z": torch.zeros((N, groups), **f32),
                "Q1": torch.zeros((N, count), **f32), "Err1": torch.zeros((N, count), **f32)}
            body = functools.partial(_block_body, 2**bits - 1, groupsize, sym, phase,
                                     loss=self.loss, **bufs)
            graph = self.graphs[key] = DecodeGraph(body, self.device, capture=self.capture,
                                                   pool=self.pool, kind="gptq")
        return self.buffers[key], graph

    def close(self) -> None:
        self.graphs.clear()
        self.buffers.clear()


@torch.no_grad()
def gptq_solve(
    W: torch.Tensor,  # (N, K) float — torch/reference orientation (out, in)
    H: torch.Tensor,  # (K, K), solved in float32
    *,
    bits: int = 4,
    blocksize: int = 128,
    percdamp: float = 0.01,
    groupsize: int = -1,
    actorder: bool = False,
    sym: bool = False,
    graphs: Optional[GPTQGraphs] = None,
    cuda_graph: bool = True,
):
    """Run GPTQ. Returns (q_levels (N, K) float levels in [0, maxq], scales
    (N, n_tiles), zeros (N, n_tiles), total_error scalar): dead columns, optional
    actorder permutation, damped Cholesky inverse, column blocks with error
    feedback, and per-group scales recomputed from the error-updated block.

    Each block's column loop runs in ``graphs`` (a caller's set, whose capture setting
    must be this call's), or in a set of the call's own: captured and replayed on a
    CUDA device with ``cuda_graph``, eager otherwise."""
    if actorder and groupsize != -1:
        raise ValueError("the permutation trick does not work for grouped quantization")
    capture = cuda_graph and W.device.type == "cuda"
    own = graphs is None
    if own:
        graphs = GPTQGraphs(W.device, capture=capture)
    elif graphs.capture != capture:
        raise ValueError(f"the graph set captures={graphs.capture}, the call {capture}")
    N, K = W.shape
    maxq = 2**bits - 1
    W = W.float().clone()
    H = H.float().clone()

    dead = torch.diag(H) == 0
    H[dead, dead] = 1.0
    W[:, dead] = 0.0

    if actorder:
        perm = torch.argsort(-torch.diag(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]

    # initial whole-row params (used when groupsize == -1)
    scale0, zero0 = _find_params_rows(W, maxq, sym)
    n_tiles = 1 if groupsize == -1 else (K + groupsize - 1) // groupsize
    scales = scale0[:, None].repeat(1, n_tiles)
    zeros = zero0[:, None].repeat(1, n_tiles)

    Hinv = _inverse_cholesky(H, percdamp)
    Q = torch.zeros_like(W)
    graphs.loss.zero_()

    for i1 in range(0, K, blocksize):
        i2 = min(i1 + blocksize, K)
        phase, g0 = (0, 0) if groupsize == -1 else (i1 % groupsize, i1 // groupsize)
        bufs, graph = graphs.block(N, i2 - i1, bits, groupsize, sym, phase)
        g1 = g0 + bufs["S"].shape[1]
        bufs["W1"].copy_(W[:, i1:i2])
        bufs["Hinv1"].copy_(Hinv[i1:i2, i1:i2])
        bufs["S"].copy_(scales[:, g0:g1])
        bufs["Z"].copy_(zeros[:, g0:g1])
        graph.run()
        Q[:, i1:i2] = bufs["Q1"]
        scales[:, g0:g1] = bufs["S"]
        zeros[:, g0:g1] = bufs["Z"]
        # push the block's error into all remaining columns
        if i2 < K:
            W[:, i2:] -= bufs["Err1"] @ Hinv[i1:i2, i2:]
    total_err = graphs.loss.clone()
    if own:
        graphs.close()

    if actorder:
        Q = Q[:, torch.argsort(perm)]
    return Q, scales, zeros, total_err


def gptq_quantize_linear(
    w_kn: torch.Tensor,  # (K, N) — this package's layout
    H: torch.Tensor,
    *,
    bits: int = 4,
    blocksize: int = 128,
    percdamp: float = 0.01,
    groupsize: int = -1,
    actorder: bool = False,
    sym: bool = False,
    graphs: Optional[GPTQGraphs] = None,
    cuda_graph: bool = True,
) -> Tuple[Params, torch.Tensor]:
    """GPTQ-quantize a (K, N) weight given its input Hessian; returns the packed
    quantized leaf dict (layout of `quant/linear.py`) and the solver error. ``graphs``
    and ``cuda_graph``: as `gptq_solve` takes them."""
    if groupsize != -1 and not (blocksize % groupsize == 0 or groupsize % blocksize == 0):
        raise ValueError("group windows must not straddle solver blocks")
    Q, scales, zeros, err = gptq_solve(
        w_kn.T, H, bits=bits, blocksize=blocksize, percdamp=percdamp,
        groupsize=groupsize, actorder=actorder, sym=sym, graphs=graphs, cuda_graph=cuda_graph,
    )
    params = pack_prequantized(Q.T.contiguous(), scales.T.contiguous(), zeros.T.contiguous(),
                               bits, groupsize=groupsize)
    return params, err
