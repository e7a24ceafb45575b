"""How the paged decode-attention kernels K7 and K8 (``csrc/paged_attention.cu``) spend
their time, on the card.

    python -m lit_llama_ja_tpu_torch.ops.cuda.paged_probe [SECTION ...] [flush=read]

SECTION is any of ``ptxas``, ``splits`` and ``variant`` (all when none is named).
``flush=read`` evicts the L2 cache between launches by reading the 256 MB buffer
instead of writing it, so that no dirty line is written back during a launch. Prints
one JSON line per item:

* ``ptxas``: registers, spill bytes and shared memory that ``-Xptxas -v`` reports for
  every instantiation of the source as it is and of each variant below.
* ``splits``: K7 and K8 at the cases below with the plan's split count forced to 1, 2,
  3, 4, 6 and 8 (the span follows), beside the count `paged_plan` picks.
* ``variant``: variants of the source built from text edits of a copy under
  ``build/paged_probe/``, at the same cases: ``loads_only`` (the copies and the ring,
  no fold), ``no_convert`` (the levels' bits used as they are: no PRMT and FADD on v,
  no PRMT on k), ``i2f`` (v's levels converted by I2F, the parent's route; k's
  f16 route unchanged), ``no_cluster_merge`` (no cluster launch attribute, no cluster
  barrier, no distributed shared memory: every block writes its own partial), rings of
  2 and 4 stages for K7 and of 2 and 4 for K8, and ``warps8`` (8 folding warps a
  block, the plan's tile doubled). The variants compute garbage (only their times are theirs)
  and are never used by the port.

Cases: 32 heads of 128 at page 16 with B 1, 8 and 32 and every slot at position 2047,
the serve run's positions at B 8 (``chip_smoke.serve_positions``), and the 125M heads
(10 x 78) at B 8, mixed positions. Times are CUDA-event medians of 20 launches after 3
warm-up launches, each after a 256 MB write that evicts the L2 cache (``ms``), and the
median of graph replays of one launch (``graph_ms``), beside the byte bound. Every run
of the kernels as they are is first held to the plain version (2e-2 of the largest
magnitude). The probe changes nothing in the port.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import paged_attention as pa

WORK = Path(__file__).resolve().parents[3] / "build" / "paged_probe"
SOURCE = "paged_attention"
SPLITS = (1, 2, 3, 4, 6, 8)
LEVELS = "    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) - 8388736.f;"
XOR = "  w ^= 0x80808080u;\n"
HALF2 = "  return __byte_perm(w, 0x64646464u, sel);"
FOLD = "  constexpr int VL = 4 * J, VG = 32 / VL, TPV = WT / VG;\n"
REMOTE = ("  float* dst = cg::this_cluster().map_shared_rank(slots, 0) + rank * SLOT;\n"
          "  cluster_wait();  // rank 0 has started: its shared memory may be written\n")
MERGE = "  cluster_arrive_release();\n  cluster_wait();\n  if (rank != 0) return;\n"
K7_STAGES = "constexpr int K7_STAGES = 3;"
WARPS = "constexpr int WARPS = 4; "
K8_STAGES = "constexpr int K8_STAGES = 3;"
# name -> [(old, new)] edits of csrc/paged_attention.cu
VARIANTS = {
    "loads_only": [(FOLD, FOLD + "  if (n > 0) return;\n")],
    "no_convert": [(XOR, "\n"), (LEVELS, "    f[i] = __uint_as_float(w);"),
                   (HALF2, "  return w;")],
    "i2f": [(XOR, "\n"),
            (LEVELS, "    f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));")],
    "no_cluster_merge": [(REMOTE, "  float* dst = slots + rank * SLOT;\n"),
                         (MERGE, "  __syncthreads();\n"),
                         ("  cluster_arrive_relaxed();\n", "\n"),
                         ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "k7_2_stages": [(K7_STAGES, K7_STAGES.replace("3", "2"))],
    "k7_4_stages": [(K7_STAGES, K7_STAGES.replace("3", "4"))],
    "k8_2_stages": [(K8_STAGES, K8_STAGES.replace("3", "2"))],
    "k8_4_stages": [(K8_STAGES, K8_STAGES.replace("3", "4"))],
    "warps8": [(WARPS, WARPS.replace("4", "8"))],
}
# the plan's constants a variant changes with its source
VARIANT_PLANS = {"warps8": {"PAGED_WARPS": 8}}
# (B, n_head, head_dim, page, fill)
CASES = [(1, 32, 128, 16, "full"), (8, 32, 128, 16, "full"), (32, 32, 128, 16, "full"),
         (8, 32, 128, 16, "serve"), (8, 10, 78, 16, "mixed")]


def ptxas_report(log: str):
    """(kernel, 64-byte column blocks, vec, registers, spill store bytes, spill load
    bytes, static shared bytes) of each paged kernel in a -Xptxas -v log."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(paged_decode_k[78])ILi(\d+)ELb(\d)E", line)
        if m:
            name = (m.group(1), int(m.group(2)), bool(int(m.group(3))))
        elif name and "spill stores" in line:
            spills = tuple(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append({"kernel": name[0], "column_blocks": name[1], "vec": name[2],
                        "registers": int(re.search(r"Used (\d+) registers", line).group(1)),
                        "spill_store_bytes": spills[0], "spill_load_bytes": spills[1],
                        "static_smem_bytes": int(smem.group(1)) if smem else 0})
            name, spills = None, (0, 0)
    return out


def build(names) -> None:
    """Each named variant (``kernel``: the source as it is) into WORK/<name>/, all nvcc
    processes at once, with -Xptxas -v; prints each instantiation's report."""
    nvcc = _build.find_nvcc()
    procs = []
    for name in names:
        d = WORK / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = d / f"{SOURCE}.cu"
        text = path.read_text()
        for old, new in VARIANTS.get(name, []):
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {path.name}")
            text = text.replace(old, new)
        path.write_text(text)
        procs.append((name, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / f"{SOURCE}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        for row in ptxas_report(log):
            print(json.dumps({"probe": "ptxas", "variant": name, **row}), flush=True)


def use_library(path: Path) -> None:
    """Make the wrappers launch the kernels of the library at ``path``."""
    handle = ctypes.CDLL(str(path))
    handle.lljt_error_string.argtypes = [ctypes.c_int]
    handle.lljt_error_string.restype = ctypes.c_char_p
    pa._bind(handle)
    _build._libs[SOURCE] = handle


def forced(splits: int):
    """Patch the plan to ``splits`` splits (the span follows, in whole tiles)."""
    plan = pa.paged_plan

    def patched(B, nh, hd, page, AP, n_sm):
        p = plan(B, nh, hd, page, AP, n_sm)
        n_tiles = -(-AP * page // p.tile)
        span = -(-n_tiles // min(splits, n_tiles)) * p.tile
        return p._replace(splits=-(-AP * page // span), span=span)

    return mock.patch.object(pa, "paged_plan", patched)


def smoke():
    """``chip_smoke`` at the root of the checkout: its inputs, bound and timers."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
    import chip_smoke

    return chip_smoke


def case_inputs(g, device, B, nh, hd, page, fill):
    cs = smoke()
    extra = 0
    if fill == "serve":
        pos, extra = cs.serve_positions()
    else:
        pos = [cs.MAX_POS] * B if fill == "full" else cs.mixed_positions(B, page)
    args = cs.paged_inputs(g, device, B, nh, hd, page, pos, extra)
    return args, cs.paged_bound(args)[0]


def time_case(timer, args, fn) -> dict:
    cs = smoke()
    return {"ms": timer.ms(lambda: fn(*args)), "graph_ms": cs.graph_ms(timer, lambda: fn(*args))}


class ReadFlush:
    """Stands in for the timer's flush buffer: its ``zero_`` reads the buffer instead."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.max()


def main() -> None:
    cs = smoke()
    flush_read = "flush=read" in sys.argv[1:]
    sections = set(sys.argv[1:]) - {"flush=read"}
    want = lambda name: not sections or name in sections  # noqa: E731
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"probe": "device", "nvidia_smi": smi}), flush=True)
    variants = list(VARIANTS) if want("variant") else []
    if want("ptxas") or variants:
        build(["kernel"] + variants)
    _build.build_all()
    timer = cs.Timer(device)
    if flush_read:
        timer.flush_buf = ReadFlush(timer.flush_buf)
    g = torch.Generator(device=device).manual_seed(0)
    n_sm = _build.sm_count(0)
    kernels = {"k7": pa.paged_decode_attention, "k8": pa.paged_decode_attention_db}
    for B, nh, hd, page, fill in CASES if want("splits") else ():
        args, bound = case_inputs(g, device, B, nh, hd, page, fill)
        wanted = pa.paged_decode_attention_ref(*args)
        plan = pa.paged_plan(B, nh, hd, page, args[5].shape[1], n_sm)
        for splits in SPLITS:
            with forced(splits):
                for name, fn in kernels.items():
                    cs.check_paged(fn, args, wanted, (B, nh, hd, page, fill, splits))
                    print(json.dumps({"probe": "splits", "kernel": name, "B": B, "n_head": nh,
                                      "head_dim": hd, "page": page, "fill": fill,
                                      "splits": splits, "plan_splits": plan.splits,
                                      "bound_ms": bound, **time_case(timer, args, fn)}),
                          flush=True)
    if not variants:
        return
    inputs = [(case, *case_inputs(g, device, *case)) for case in CASES]
    built = _build._libs.get(SOURCE)
    try:
        for name in ["kernel"] + variants:
            use_library(WORK / name / f"{SOURCE}.so")
            pa.paged_plan.cache_clear()
            plan = VARIANT_PLANS.get(name)
            with mock.patch.multiple(pa, **plan) if plan else contextlib.nullcontext():
                for (B, nh, hd, page, fill), args, bound in inputs:
                    for kname, fn in kernels.items():
                        print(json.dumps({"probe": "variant", "variant": name, "kernel": kname,
                                          "flush": "read" if flush_read else "write",
                                          "B": B, "n_head": nh, "head_dim": hd, "page": page,
                                          "fill": fill, "bound_ms": bound,
                                          **time_case(timer, args, fn)}), flush=True)
            pa.paged_plan.cache_clear()
    finally:
        if built is not None:
            _build._libs[SOURCE] = built


if __name__ == "__main__":
    main()
