"""How the flash-attention kernels K2 and K6 (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) spend their time, on the card.

    python -m lit_llama_ja_tpu_torch.ops.cuda.flash_probe [SECTION ...]

SECTION is any of ``ptxas``, ``k2``, ``k6``, ``route`` and ``variant`` (all when none is
named).

Prints one JSON line per item:

* ``ptxas``: registers, spill bytes and shared memory that ``-Xptxas -v`` reports for
  every instantiation of the two sources (kernel, padded head dim, block rows).
* ``k2`` / ``k6``: each kernel at the shapes of ``chip_smoke.py`` (K2: 1 x (32, 128),
  (10, 78), (8, 64) heads at T 512, 777 and 2048, contiguous; K6: (B, heads, hd) of
  its four rows at T 2048, in the layouts the model hands over) with the block size
  forced to 64 and to 128 rows, beside the size `flash_plan` picks.
* ``route``: K2 and K6 on the 125M model's views (10 x 78; one sequence of T 128,
  512 and 2048, and the training micro-batch, B 4 at T 2048) on both copy routes:
  4-byte ``cp.async`` straight from the views, and the wrapper's copy into buffers
  whose rows lie 80 elements apart with 16-byte copies, the wrapper's copies included
  in ``ms``.
* ``variant``: variants of the sources built from text edits of a copy under
  ``build/flash_probe/``, at the 7B prefill (32 x 128, T 512), 32 x 128 at T 2048 and
  the 125M training shape: K2 without the copies of the next tiles, without the
  softmax, with 16 rows a warp (one m16 tile, so no B fragment is shared), with a
  three-stage ring and with 256-row blocks; both kernels with every tile of a head
  scheduled before the next head (as shipped, each tile index goes out for every head
  first); K6 with a three-stage ring, with only its dq kernel and with only its dkv
  kernel. The variants compute garbage (only
  their times are theirs) and are never used by the port.

Times are CUDA-event medians of 20 launches after 3 warm-up launches, each after a
256 MB write that evicts the L2 cache (``ms``, which includes any host time of the
wrapper that the 256 MB write does not hide), and the device time of the flash
kernels alone from ``torch.profiler`` over 10 launches (``device_ms``). Every run of
the kernels as they are is first held to the plain version (2e-2 of the largest
magnitude). The probe changes nothing in the port.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import flash_attention as fa

K2_SHAPES = [(32, 128), (10, 78), (8, 64)]
K2_LENGTHS = [512, 777, 2048]
K6_SHAPES = [(1, 10, 78), (1, 8, 64), (1, 32, 128), (4, 10, 78)]  # (B, n_head, hd), T 2048
TRAIN_SHAPE = (4, 10, 2048, 78)  # the 125M micro-batch: (B, n_head, T, hd)
# the 125M model's views at one sequence of 128, 512 and 2048 tokens and the micro-batch
ROUTE_SHAPES = [(1, 10, 128, 78), (1, 10, 512, 78), (1, 10, 2048, 78), TRAIN_SHAPE]
REL_TOL = 2e-2
WORK = Path(__file__).resolve().parents[3] / "build" / "flash_probe"
LIBS = {"flash_attention_fwd": fa._bind_fwd, "flash_attention_bwd": fa._bind_bwd}
NEXT_K = "fetch_k(kt + S - 1);"
NEXT_V = "fetch_v(kt + S - 1);"
FWD_STAGES = "constexpr int fwd_stages() { return 2; }"
BWD_STAGES = "constexpr int bwd_stages() { return 2; }"
HEADS = "constexpr bool HEADS_FASTEST = true;"
# name -> (source built, [(file edited, old, new)])
VARIANTS = {
    "k2_no_next_copies": ("flash_attention_fwd", [("flash_attention_fwd.cu", NEXT_K, ";"),
                                                  ("flash_attention_fwd.cu", NEXT_V, ";")]),
    "k2_no_softmax": ("flash_attention_fwd", [
        ("flash_attention_fwd.cu",
         "softmax_step<NS, NO>(s[mi], oacc[mi], m_a[mi], m_b[mi], l_a[mi], l_b[mi], scale_log2);",
         ";")]),
    "k2_rows16": ("flash_attention_fwd", [("flash_attention_fwd.cu",
                                           "constexpr int ROWS_PER_WARP = 32;",
                                           "constexpr int ROWS_PER_WARP = 16;")]),
    "k2_3_stages": ("flash_attention_fwd", [("flash_common.cuh", FWD_STAGES,
                                             FWD_STAGES.replace("2", "3"))]),
    "k6_3_stages": ("flash_attention_bwd", [("flash_common.cuh", BWD_STAGES,
                                             BWD_STAGES.replace("2", "3"))]),
    "k2_tiles_fastest": ("flash_attention_fwd", [("flash_common.cuh", HEADS,
                                                  HEADS.replace("true", "false"))]),
    "k6_tiles_fastest": ("flash_attention_bwd", [("flash_common.cuh", HEADS,
                                                  HEADS.replace("true", "false"))]),
    # run with the plan forced to 64 rows, which this variant launches as 256
    "k2_rows256": ("flash_attention_fwd", [("flash_attention_fwd.cu", "return launch<HDP, 64>(",
                                            "return launch<HDP, 256>(")]),
    "k6_dq_only": ("flash_attention_bwd", [("flash_attention_bwd.cu",
                                            "  flash_bwd_dkv_kernel<HDP, BR><<<",
                                            "  if (false) flash_bwd_dkv_kernel<HDP, BR><<<")]),
    "k6_dkv_only": ("flash_attention_bwd", [("flash_attention_bwd.cu",
                                             "  flash_bwd_dq_kernel<HDP, BR><<<",
                                             "  if (false) flash_bwd_dq_kernel<HDP, BR><<<")]),
}


def ptxas_report(log: str):
    """(kernel, padded head dim, rows, registers, spill store bytes, spill load bytes,
    shared bytes) of each flash kernel in a -Xptxas -v log."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(flash_\w+?_kernel)ILi(\d+)ELi(\d+)E", line)
        if m:
            name = (m.group(1), int(m.group(2)), int(m.group(3)))
        elif name and "spill stores" in line:
            spills = tuple(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out.append({"kernel": name[0], "hdp": name[1], "rows": name[2], "registers": regs,
                        "spill_store_bytes": spills[0], "spill_load_bytes": spills[1],
                        "static_smem_bytes": int(smem.group(1)) if smem else 0})
            name, spills = None, (0, 0)
    return out


def ptxas() -> None:
    WORK.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for src in ("flash_attention_fwd", "flash_attention_bwd"):
        proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", "-o",
                               str(WORK / f"{src}.o"), str(_build.CSRC / f"{src}.cu")],
                              capture_output=True, text=True, check=True)
        for row in ptxas_report(proc.stdout + proc.stderr):
            print(json.dumps({"probe": "ptxas", "source": src, **row}), flush=True)


def build_variants() -> None:
    nvcc = _build.find_nvcc()
    procs = []
    for name, (src, edits) in VARIANTS.items():
        d = WORK / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        procs.append((name, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")


def use_library(src: str, path: Path) -> None:
    """Make the wrappers launch the kernels of the library at ``path``."""
    handle = ctypes.CDLL(str(path))
    handle.lljt_error_string.argtypes = [ctypes.c_int]
    handle.lljt_error_string.restype = ctypes.c_char_p
    LIBS[src](handle)
    _build._libs[src] = handle


def device_ms(fn, n: int = 10) -> float:
    """Device time of the flash kernels per call of ``fn``, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "flash_" in e.key) / 1e3 / n


class Timer:
    def __init__(self, device):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def model_views(g, device, B, nh, T, hd):
    """q, k as the transposes of contiguous (B, T, nh, hd) tensors (RoPE's outputs), v as
    a view of a (B, T, 3 * nh * hd) projection, dO as the transpose of a (B, T, nh, hd)
    gradient: the layouts the model and autograd hand over."""
    def rand(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    C = nh * hd
    q, k = (rand(B, T, nh, hd).transpose(1, 2) for _ in range(2))
    v = rand(B, T, 3 * C)[..., 2 * C:].reshape(B, T, nh, hd).transpose(1, 2)
    return q, k, v, rand(B, T, nh, hd).transpose(1, 2)


def forced(rows=None, realign=None) -> ExitStack:
    """Patch the plan to a block size and the copy route, where given."""
    stack = ExitStack()
    plan = fa.flash_plan
    if realign is not None:  # at any size, or never
        stack.enter_context(mock.patch.object(fa, "REALIGN_MIN_ROWS", 0 if realign else 2**62))
    if rows is not None:
        stack.enter_context(mock.patch.object(
            fa, "flash_plan", lambda *a, **kw: plan(*a, **kw)._replace(rows=rows)))
    return stack


def check(got, want, what) -> float:
    torch.cuda.synchronize()
    tol = REL_TOL * max(w.float().abs().max().item() for w in want)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    assert err <= tol, (what, err, tol)
    return err


def time_k2(timer, q, k, v, **force) -> dict:
    with forced(**force):
        err = check(fa.flash_attention_fwd(q, k, v)[:1], fa.flash_attention_fwd_ref(q, k, v)[:1],
                    ("k2", q.shape, force))
        run = lambda: fa.flash_attention_fwd(q, k, v)  # noqa: E731
        return {"ms": timer.ms(run), "device_ms": device_ms(run), "max_abs_err": err}


def time_k6(timer, q, k, v, do, **force) -> dict:
    o, lse = fa.flash_attention_fwd(q, k, v)
    with forced(**force):
        err = check(fa.flash_attention_bwd(q, k, v, o, lse, do),
                    fa.flash_attention_bwd_ref(q, k, v, o, lse, do), ("k6", q.shape, force))
        run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
        return {"ms": timer.ms(run), "device_ms": device_ms(run), "max_abs_err": err}


def main() -> None:
    sections = set(sys.argv[1:])
    want = lambda name: not sections or name in sections  # noqa: E731
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"probe": "device", "nvidia_smi": smi}), flush=True)
    if want("ptxas"):
        ptxas()
    _build.build_all()
    timer = Timer(device)
    g = torch.Generator(device=device).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for nh, hd in K2_SHAPES if want("k2") else ():
        for T in K2_LENGTHS:
            q, k, v = (torch.randn((1, nh, T, hd), generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
            plan = fa.flash_plan(1, nh, T, hd, [t.stride()[:3] for t in (q, k, v)], n_sm)
            runs = {f"rows_{r}": time_k2(timer, q, k, v, rows=r) for r in (64, 128)}
            print(json.dumps({"probe": "k2", "n_head": nh, "head_dim": hd, "T": T,
                              "plan_rows": plan.rows, **runs}), flush=True)
    for B, nh, hd in K6_SHAPES if want("k6") else ():
        T = 2048
        q, k, v, do = model_views(g, device, B, nh, T, hd)
        plan = fa.flash_plan(B, nh, T, hd, [t.stride()[:3] for t in (q, k, v, do)], n_sm,
                             [t.data_ptr() for t in (q, k, v, do)])
        runs = {f"rows_{r}": time_k6(timer, q, k, v, do, rows=r) for r in (64, 128)}
        print(json.dumps({"probe": "k6", "B": B, "n_head": nh, "head_dim": hd, "T": T,
                          "plan": plan._asdict(), **runs}), flush=True)
    for B, nh, T, hd in ROUTE_SHAPES if want("route") else ():
        q, k, v, do = model_views(g, device, B, nh, T, hd)
        for realign in (False, True):
            print(json.dumps({"probe": "route", "B": B, "n_head": nh, "T": T, "head_dim": hd,
                              "route": "realigned_16B" if realign else "views_4B",
                              "k2": time_k2(timer, q, k, v, realign=realign),
                              "k6": time_k6(timer, q, k, v, do, realign=realign)}), flush=True)
    if want("variant"):
        variants(timer, g, device)


def variants(timer, g, device) -> None:
    build_variants()
    q7, k7, v7 = (torch.randn((1, 32, 512, 128), generator=g, device=device)
                  .to(torch.bfloat16) for _ in range(3))
    q2, k2, v2, do2 = (torch.randn((1, 32, 2048, 128), generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(4))
    B, nh, T, hd = TRAIN_SHAPE
    qt, kt, vt, dot = model_views(g, device, B, nh, T, hd)
    o2, lse2 = fa.flash_attention_fwd(q2, k2, v2)
    ot, lset = fa.flash_attention_fwd(qt, kt, vt)
    cases = {"k2": [("7B_T512", lambda: fa.flash_attention_fwd(q7, k7, v7)),
                    ("32x128_T2048", lambda: fa.flash_attention_fwd(q2, k2, v2)),
                    ("125M_train", lambda: fa.flash_attention_fwd(qt, kt, vt))],
             "k6": [("32x128_T2048", lambda: fa.flash_attention_bwd(q2, k2, v2, o2, lse2, do2)),
                    ("125M_train", lambda: fa.flash_attention_bwd(qt, kt, vt, ot, lset, dot))]}
    built = {src: _build._libs[src] for src in LIBS}
    try:
        for name, (src, _) in [("kernel", ("flash_attention_fwd", ())),
                               ("kernel", ("flash_attention_bwd", ()))] + list(VARIANTS.items()):
            if name != "kernel":
                use_library(src, WORK / name / f"{src}.so")
            for case, fn in cases["k2" if src.endswith("fwd") else "k6"]:
                with forced(rows=64 if name == "k2_rows256" else None):
                    print(json.dumps({"probe": "variant", "variant": name, "source": src,
                                      "case": case, "ms": timer.ms(fn),
                                      "device_ms": device_ms(fn)}), flush=True)
            _build._libs[src] = built[src]
    finally:
        _build._libs.update(built)


if __name__ == "__main__":
    main()
