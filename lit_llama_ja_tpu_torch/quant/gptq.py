"""GPTQ solver (counterpart of `lit_llama_ja_tpu/quant/gptq.py`; reference
`lit_llama/quantization.py:424-614`, after E. Frantar et al., "GPTQ: Accurate
Post-training Compression for GPT", arXiv:2210.17323).

The JAX package's blocked structure is kept: inside each block of columns a loop
quantizes one column at a time and feeds its error back into the block's remaining
columns (a ``lax.scan`` there, a Python loop here, as in the reference's PyTorch
GPTQ), then one matmul pushes the block's error into every later column. The damped
Cholesky chain runs in float32, as in the JAX package; the Hessian accumulates in
float64 (`hessian_update` says why). W is (out=N, in=K) inside the
solver, H is (K, K); `gptq_quantize_linear` takes and packs the (K, N) layout of
`quant/linear.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
    """Per-row (out-channel) scale/zero of ``w`` (N, k_window). Returns (N,), (N,)."""
    xmin = torch.clamp(w.amin(dim=1), max=0.0)
    xmax = torch.clamp(w.amax(dim=1), min=0.0)
    if sym:
        xmax = torch.maximum(torch.abs(xmin), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = (xmax - xmin) / maxq
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
):
    """Run GPTQ. Returns (q_levels (N, K) float levels in [0, maxq], scales
    (N, n_tiles), zeros (N, n_tiles), total_error scalar): dead columns, optional
    actorder permutation, damped Cholesky inverse, column blocks with error
    feedback, and per-group scales recomputed from the error-updated block."""
    if actorder and groupsize != -1:
        raise ValueError("the permutation trick does not work for grouped quantization")
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
    total_err = torch.zeros((), dtype=torch.float32, device=W.device)

    for i1 in range(0, K, blocksize):
        i2 = min(i1 + blocksize, K)
        count = i2 - i1
        W1 = W[:, i1:i2].clone()
        Hinv1 = Hinv[i1:i2, i1:i2]
        Err1 = torch.zeros_like(W1)
        for i in range(count):
            w = W1[:, i].clone()
            d = Hinv1[i, i]
            if groupsize != -1:
                g_idx = (i1 + i) // groupsize
                if (i1 + i) % groupsize == 0:
                    # params of the group starting here, from the error-updated block;
                    # the window clamps into the block as lax.dynamic_slice does
                    size = min(groupsize, count)
                    start = min(i, count - size)
                    s, z = _find_params_rows(W1[:, start : start + size], maxq, sym)
                    scales[:, g_idx] = s
                    zeros[:, g_idx] = z
                scale, zero = scales[:, g_idx], zeros[:, g_idx]
            else:
                scale, zero = scale0, zero0
            q = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
            w_rec = scale * (q - zero)
            err = (w - w_rec) / d
            total_err += torch.sum((w - w_rec) ** 2 / d**2) / 2
            # rank-1 error feedback into this and the remaining columns of the block
            W1[:, i:] -= err[:, None] * Hinv1[i, i:][None, :]
            Err1[:, i] = err
            Q[:, i1 + i] = q
        # push the block's error into all remaining columns
        if i2 < K:
            W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]

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
) -> Tuple[Params, torch.Tensor]:
    """GPTQ-quantize a (K, N) weight given its input Hessian; returns the packed
    quantized leaf dict (layout of `quant/linear.py`) and the solver error."""
    if groupsize != -1 and not (blocksize % groupsize == 0 or groupsize % blocksize == 0):
        raise ValueError("group windows must not straddle solver blocks")
    Q, scales, zeros, err = gptq_solve(
        w_kn.T, H, bits=bits, blocksize=blocksize, percdamp=percdamp,
        groupsize=groupsize, actorder=actorder, sym=sym,
    )
    params = pack_prequantized(Q.T.contiguous(), scales.T.contiguous(), zeros.T.contiguous(),
                               bits, groupsize=groupsize)
    return params, err
