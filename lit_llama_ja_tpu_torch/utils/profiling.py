"""Profiling and roofline accounting (counterpart of `lit_llama_ja_tpu/utils/profiling.py`).

  * `trace` records a `torch.profiler` trace (host and, on the card, device activity)
    and writes it as a Chrome trace into the directory it is given.
  * `sync` waits for the card; `timeit` times a call as the JAX package does (median
    wall-clock seconds) and, beside it, its CUDA-event time and the process CPU time,
    so that a host-bound call shows as wall time the device does not account for.
  * `Roofline` reports achieved rates against the H100 SXM data-sheet peaks (989
    TFLOP/s dense bf16, 3.35 TB/s HBM) unless given others.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

from lit_llama_ja_tpu_torch.core.device import resolve_device


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _first_tensor(t)
            if found is not None:
                return found
    return None


@contextlib.contextmanager
def trace(log_dir, device="cuda"):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA activity when
    ``device`` is the card); on exit write ``<log_dir>/trace.json`` for Perfetto or
    ``chrome://tracing``. Yields the profiler, whose ``key_averages()`` sums the time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def sync(tree) -> None:
    """Device barrier: wait for the card when the first tensor of ``tree`` lives on
    it; nothing to wait for on the CPU."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class Timing(NamedTuple):
    """Medians over the timed calls: ``wall_s`` is the JAX package's `timeit`
    number; ``cuda_s`` the CUDA-event time (None when the call's result is not on the
    card); ``cpu_s`` the process CPU time (every thread of the process)."""

    wall_s: float
    cuda_s: Optional[float]
    cpu_s: float


def timeit(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> Timing:
    """Median seconds per call of ``fn(*args, **kw)``, each call ended by `sync`.
    CUDA events are recorded when the last warm-up call's result is on the card
    (so with ``warmup=0`` there is no event time)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        sync(out)
    leaf = _first_tensor(out)
    events = leaf is not None and leaf.is_cuda
    wall, cpu, pairs = [], [], []
    for _ in range(iters):
        if events:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0, c0 = time.perf_counter(), time.process_time()
        out = fn(*args, **kw)
        if events:
            end.record()
            pairs.append((start, end))
        sync(out)
        wall.append(time.perf_counter() - t0)
        cpu.append(time.process_time() - c0)
    cuda_s = statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3 if pairs else None
    return Timing(statistics.median(wall), cuda_s, statistics.median(cpu))


@dataclass
class Roofline:
    """Roofline accounting for a kernel or step: report achieved vs peak."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_flops: float = 989e12  # H100 SXM, dense bf16
    peak_bw: float = 3.35e12  # H100 SXM HBM3, B/s

    def report(self, seconds: float) -> Dict[str, float]:
        achieved_flops = self.flops / seconds if self.flops else 0.0
        achieved_bw = self.bytes_accessed / seconds if self.bytes_accessed else 0.0
        t_compute = self.flops / self.peak_flops
        t_memory = self.bytes_accessed / self.peak_bw
        bound = "memory" if t_memory >= t_compute else "compute"
        sol = max(t_compute, t_memory) / seconds if seconds else 0.0
        return {
            "seconds": seconds,
            "tflops": achieved_flops / 1e12,
            "gbps": achieved_bw / 1e9,
            "bound": bound,
            "fraction_of_roofline": sol,
        }


def decode_step_roofline(config, quant_bits: int = 4, kv_bits: int = 16,
                         seq: int = 2048, batch: int = 1) -> Roofline:
    """Per-token decode roofline for a quantized LLaMA, as the JAX package counts it:
    the KV cache's bytes are ``kv_bits // 8`` an element, so an int4 cache
    (``kv_bits=4``) streams 0 bytes (a quirk of the reference, ROADMAP.md queue 3,
    kept for parity; count int4 KV as half a byte an element elsewhere)."""
    L, D, H, V = config.n_layer, config.n_embd, config.n_hidden, config.padded_vocab_size
    w_elems = L * (3 * D * D + D * D + 2 * D * H + H * D) + D * V
    kv_bytes = batch * 2 * L * config.n_head * seq * config.head_dim * (kv_bits // 8)
    return Roofline(
        flops=2.0 * batch * w_elems,
        bytes_accessed=w_elems * quant_bits / 8 + kv_bytes,
    )
