"""Shared fixtures for the parity tests of the PyTorch port (`tests/test_torch_*.py`):
one numpy parameter tree feeds the JAX package and the port; `guarded_bodies`, the
guard that runs every decode-step, prefill-span, training-step, validation and GPTQ
block body (`infer/decode_graph.DecodeGraph`) with host reads and host-built tensors
refused."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_ja_tpu.quant.linear import quantize_colblock, resolve_bits, resolve_groupsize

from lit_llama_ja_tpu_torch.infer import decode_graph
from lit_llama_ja_tpu_torch.io.from_jax import params_from_numpy

LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc1"), ("mlp", "c_fc2"),
           ("mlp", "c_proj"))


HOST_READS = ("item", "cpu", "tolist", "numpy", "__int__", "__bool__", "__float__",
              "__index__")
HOST_BUILDS = ("tensor", "as_tensor", "from_numpy")


@contextlib.contextmanager
def no_host_reads():
    """Inside, every tensor method that reads a value back to the host raises, and so
    do `torch.tensor`, `torch.as_tensor` and `torch.from_numpy` of anything but a tensor
    (a numpy array, a list, a Python number: data built on the host)."""
    own = {name: torch.Tensor.__dict__.get(name) for name in HOST_READS}
    builds = {name: getattr(torch, name) for name in HOST_BUILDS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"the step body read a tensor back: Tensor.{name}")
        return read

    def tensors_only(name):
        def build(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"the step body built a tensor from host data: "
                                     f"torch.{name}({type(data).__name__})")
            return builds[name](data, *args, **kwargs)
        return build

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    for name in HOST_BUILDS:
        setattr(torch, name, tensors_only(name))
    try:
        yield
    finally:
        for name, fn in own.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        for name, fn in builds.items():
            setattr(torch, name, fn)


BODY_COUNTS = {"span": "spans", "train": "train", "val": "val", "gptq": "gptq"}  # by kind


@pytest.fixture
def guarded_bodies(monkeypatch):
    """Every `DecodeGraph` body runs under `no_host_reads`; counts the bodies run by kind:
    ``n`` the decode steps (rounds, tokens, windows), ``spans`` the prefill spans,
    ``train`` the training steps, ``val`` the validation losses and ``gptq`` the GPTQ
    solver's blocks."""
    runs = {"n": 0, "spans": 0, "train": 0, "val": 0, "gptq": 0}
    run = decode_graph.DecodeGraph.run

    def guarded(self):
        runs[BODY_COUNTS.get(self.kind, "n")] += 1
        with no_host_reads():
            run(self)

    monkeypatch.setattr(decode_graph.DecodeGraph, "run", guarded)
    return runs


def quantize_rtn_tree(params, bits=4, tile_cols=-1):
    """RTN quantization of every linear of a JAX param tree (stacked blocks quantized
    per layer, then restacked) with the JAX package's `quantize_colblock`; ``bits`` is
    an int or a mixed-mode dict, whose groupsize reaches the sub-4-bit projections."""
    blocks = dict(params["blocks"])
    for mod, name in LINEARS:
        w = params["blocks"][mod][name]["weight"]
        nb = resolve_bits(bits, f"{mod}.{name}")
        gs = resolve_groupsize(bits, f"{mod}.{name}", tile_cols)
        per_layer = [quantize_colblock(w[i], bits=nb, tile_cols=gs) for i in range(w.shape[0])]
        stacked = {k: jnp.stack([p[k] for p in per_layer]) for k in per_layer[0]}
        blocks[mod] = {**blocks[mod], name: stacked}
    out = dict(params)
    out["blocks"] = blocks
    out["lm_head"] = quantize_colblock(params["lm_head"]["weight"],
                                       bits=resolve_bits(bits, "lm_head"),
                                       tile_cols=resolve_groupsize(bits, "lm_head", tile_cols))
    return out


def quantize_int4_tree(params, tile_cols=-1):
    """RTN int4 of every linear of a JAX param tree."""
    return quantize_rtn_tree(params, 4, tile_cols)


def to_port(params):
    """JAX param tree -> the port's tree of CPU tensors, via numpy."""
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def random_tree(rng, n_layer, n_embd, n_hidden, vocab, std=0.1):
    """A numpy f32 param tree in the layout both packages share, from ``rng``: weights
    N(0, std) (larger than the init's, so a few optimizer steps move the loss) and
    RMSNorm scales around 1."""
    L, D, H, V = n_layer, n_embd, n_hidden, vocab

    def w(*shape):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def scale(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "wte": {"weight": w(V, D)},
        "lm_head": {"weight": w(D, V)},
        "ln_f": {"scale": scale(D)},
        "blocks": {
            "rms_1": {"scale": scale(L, D)},
            "attn": {"c_attn": {"weight": w(L, D, 3 * D)}, "c_proj": {"weight": w(L, D, D)}},
            "rms_2": {"scale": scale(L, D)},
            "mlp": {"c_fc1": {"weight": w(L, D, H)}, "c_fc2": {"weight": w(L, D, H)},
                    "c_proj": {"weight": w(L, H, D)}},
        },
    }


def flat_numpy(tree, prefix=""):
    """``{"a/b": numpy array}`` of a tree of jax arrays or torch tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_numpy(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "detach"):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


# The A8 modes (int8 activations: W4A8, W8A8, W2A8, W3A8) against the JAX kernels in
# interpret mode, row by row against max|want| of the case's output. The int8 activations
# are recomputed in numpy from the JAX kernels' formula (f32 ``127 / max(amax, 1e-30)``,
# ``round_half_even(x * rsx)``). A row whose port levels all equal them is within
# EXACT_TOL (the same integer sums; the epilogue's f32 order alone differs between the
# names). A row may differ from them only by levels whose ``x * rsx`` lies within 4 ulp of
# a .5 tie, at most one a group, and is then within FLIP_TOL (one level flipped moves a
# row by about 1e-3). Anything else fails.
EXACT_TOL, FLIP_TOL = 1e-5, 3e-3


def check_a8_rows(got, want, x, plan, case):
    """The row rule above for x ``(M, K)`` f32 and the port's `A8Plan` ``plan`` (x
    zero-padded to ``plan.k_read``); returns the rows with flipped levels."""
    import ml_dtypes
    import torch

    from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import a8_quantize_ref

    M, K = x.shape
    mx = np.abs(want).max()
    xb = np.zeros((M, plan.k_read), np.float32)
    xb[:, :K] = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    xb = xb.reshape(M, plan.n_act, plan.group)
    amax = np.maximum(np.abs(xb).max(-1, keepdims=True), np.float32(1e-30))
    v = xb * (np.float32(127) / amax)
    levels = a8_quantize_ref(torch.from_numpy(x), plan)[0].numpy()
    flipped = levels != np.round(v)
    near = np.abs(np.abs(v - np.floor(v)) - 0.5) <= 4 * np.spacing(np.abs(v))
    flipped_rows = []
    for r in range(M):
        err = np.abs(got[r] - want[r]).max()
        if not flipped[r].any():
            assert err <= EXACT_TOL * mx, (case, r, err / mx)
            continue
        assert not (flipped[r] & ~near[r]).any(), (case, r, "a level flipped off a tie")
        assert flipped[r].sum(-1).max() <= 1, (case, r, "two flipped levels in a group")
        assert err <= FLIP_TOL * mx, (case, r, err / mx)
        flipped_rows.append(r)
    return flipped_rows


# ---------------------------------------------------------------------------
# The A8 kernel's data movement (csrc/qmm_a8.cuh), emulated lane by lane in numpy
# ---------------------------------------------------------------------------

def _int8s(word):
    return np.frombuffer(int(word).to_bytes(4, "little"), dtype=np.int8).astype(np.int64)


def keep_bytes(kb, k0, k1):
    """``keep_bytes`` of csrc/qmm_a8.cuh."""
    lo, hi = min(max(k0 - kb, 0), 4), min(max(k1 - kb, 0), 4)
    return 0 if hi <= lo else ((1 << (8 * hi)) - 1) ^ ((1 << (8 * lo)) - 1)


def fused_quad(p0, p1):
    """``Int4A8::fused_quad`` of csrc/quant_matmul_w4a8.cu."""
    t = p0 | (p1 << 16)
    return ((((t & 0x000F000F) << 4) ^ 0x00800080) | ((t & 0x00F000F0) << 8)) & 0xFFFFFFFF


def spread2(b):
    """``spread2`` of csrc/quant_matmul_sub4_a8.cu."""
    return ((b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303) ^ 0x02000000


def _frag_int4(T, u, h, t, c):
    r = 16 * u + 8 * h + 2 * t
    return fused_quad(int(T[0][r, c]), int(T[0][r + 1, c]))


def _frag_int8(T, u, h, t, c):
    r = 32 * u + 16 * h + 4 * t
    return int.from_bytes(bytes(int(T[0][r + i, c]) for i in range(4)), "little")


def _frag_int3(T, u, h, t, c):
    n = (int(T[1][4 * u + 2 * h + (t >> 1), c]) >> (4 * (t & 1))) & 0xF
    h4 = ((n | (n << 7) | (n << 14) | (n << 21)) & 0x01010101) << 2
    return spread2(int(T[0][8 * u + 4 * h + t, c])) | h4


# the decoders of csrc/quant_matmul_w4a8.cu, csrc/quant_matmul_a8.cu and
# csrc/quant_matmul_sub4_a8.cu: name -> (rows a k32 step of each plane, U, SHIFT,
# frag(tiles, u, h, t, c): the B register of column c, K-rows 32 u + 16 h + 4 t .. + 3
# of the batch)
A8_DECODERS = {
    "int4": ((16,), 4, 4, _frag_int4),
    "int8": ((32,), 2, 0, _frag_int8),
    "uint8": ((32,), 2, 0, lambda T, u, h, t, c: _frag_int8(T, u, h, t, c) ^ 0x80808080),
    "int2": ((8,), 8, 0, lambda T, u, h, t, c: spread2(int(T[0][8 * u + 4 * h + t, c]))),
    "int3": ((8, 4), 8, 0, _frag_int3),
}


def emulate_a8(x, planes, scales, zeros, plan, decoder, zshift):
    """``a8_mma`` and ``a8_merge`` of csrc/qmm_a8.cuh with one of `A8_DECODERS`, as the
    CUDA sources write them, on the levels of the plain versions' ``a8_quantize_ref``
    (the quantize kernel's job): each block's shared tiles of the stored ``planes``
    (uint8 ``(rows, N)`` arrays; rows past a plane's end and columns past N read as 0),
    each lane's m16n8k32 fragments (A from the padded x̂ buffer with its group masks, B
    through the decoder), the products, the fold at every group's end with the scale
    row ``j / rep``, and the merge of the splits in order."""
    import torch

    from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qm

    rows_step, U, shift, frag = A8_DECODERS[decoder]
    M, K = x.shape
    n = planes[0].shape[1]
    cols = qm.A8_COLS
    lp = qm.a8_launch_plan(M, plan.k_read, n, plan.n_act, 132, [0])
    levels, rsx = qm.a8_quantize_ref(torch.from_numpy(x), plan)
    xq = np.zeros((lp.Mpad, lp.Kpad), np.uint8)
    xq[:M, :plan.k_read] = levels.reshape(M, -1).numpy().astype(np.int8).view(np.uint8)
    rs = np.ones((lp.Mpad, plan.n_act), np.float32)
    rs[:M] = rsx.reshape(M, -1).numpy()
    sx = np.zeros((lp.Mpad, plan.n_act), np.int64)
    sx[:M] = levels.sum(-1).numpy()
    ws = np.zeros((lp.ksplit, lp.Mpad, n), np.float32)
    rows_blk = 16 * lp.mt
    for c0, split, r0 in np.ndindex(-(-n // cols), lp.ksplit, lp.Mpad // rows_blk):
        c0, r0 = c0 * cols, r0 * rows_blk
        acc = np.zeros((rows_blk, cols), np.float32)
        for j in range(split * plan.n_act // lp.ksplit, (split + 1) * plan.n_act // lp.ksplit):
            k0, k1 = j * plan.group, (j + 1) * plan.group
            s0, s1 = k0 // 32, -(-k1 // 32)
            d = np.zeros((rows_blk, cols), np.int64)
            for sb in range(s0, s1, U):
                tiles = []
                for p, R in zip(planes, rows_step):
                    tile = np.zeros((U * R, cols), np.int64)
                    for r in range(U * R):
                        row = sb * R + r
                        if sb + r // R < s1 and row < p.shape[0]:
                            got = p[row, c0:c0 + cols]
                            tile[r, :got.shape[0]] = got
                    tiles.append(tile)
                for u in range(U):
                    if sb + u >= s1:
                        break
                    kb = 32 * (sb + u)
                    A = np.zeros((rows_blk, 32), np.int64)
                    B = np.zeros((32, cols), np.int64)
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        for h in range(2):
                            kk = kb + 16 * h + 4 * t
                            mask = keep_bytes(kk, k0, k1)
                            for rr in (g, g + 8):
                                for mt in range(lp.mt):
                                    word = int.from_bytes(
                                        xq[r0 + 16 * mt + rr, kk:kk + 4].tobytes(), "little")
                                    A[16 * mt + rr, kk - kb:kk - kb + 4] = _int8s(word & mask)
                            for jn in range(4):
                                c = 8 * jn + g
                                B[kk - kb:kk - kb + 4, c] = _int8s(frag(tiles, u, h, t, c))
                    d += A @ B
            sr = j // plan.rep
            cc = np.arange(c0, c0 + cols)
            ok = cc < n
            sc = np.where(ok, scales[sr, np.minimum(cc, n - 1)], 0).astype(np.float32)
            zc = np.where(ok, zeros[sr, np.minimum(cc, n - 1)] - np.float32(zshift),
                          0).astype(np.float32)
            rr_ = rs[r0:r0 + rows_blk, j:j + 1]
            S = sx[r0:r0 + rows_blk, j:j + 1].astype(np.float32)
            assert (d % (1 << shift) == 0).all()
            acc += ((d >> shift).astype(np.float32) - S * zc) * (sc / rr_)
        hi_r, hi_c = min(M, r0 + rows_blk) - r0, min(n, c0 + cols) - c0
        if hi_r > 0:
            ws[split, r0:r0 + hi_r, c0:c0 + hi_c] = acc[:hi_r, :hi_c]
    out = np.zeros((M, n), np.float32)
    for p in range(lp.ksplit):
        out += ws[p, :M]
    return out
