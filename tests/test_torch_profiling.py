"""Parity of the port's `utils/profiling.py` with the JAX package's, and its timers and
trace on the CPU.

`Roofline.report` and `decode_step_roofline` are pure arithmetic: with the same peaks
they must give JAX's numbers exactly (int4's KV-cache quirk of 0 bytes included). The
timers and the trace are checked for what a CPU run can show: call counts, positive
times, no CUDA-event time, a trace file.
"""
import json

import pytest
import torch

from lit_llama_ja_tpu.core.config import LLaMAConfig as JConfig
from lit_llama_ja_tpu.utils import profiling as jprof

from lit_llama_ja_tpu_torch.core.config import LLaMAConfig
from lit_llama_ja_tpu_torch.utils import profiling as tprof

V5E = dict(peak_flops=197e12, peak_bw=819e9)


@pytest.mark.parametrize("flops,nbytes,seconds", [
    (2e12, 4e9, 1e-2),     # memory-bound at both peaks
    (4e14, 1e6, 0.5),      # compute-bound
    (0.0, 7e9, 3e-3),      # bytes only
    (5e11, 0.0, 2e-3),     # operations only
])
def test_roofline_report_matches_jax(flops, nbytes, seconds):
    for peaks in (V5E, dict(peak_flops=989e12, peak_bw=3.35e12)):
        got = tprof.Roofline(flops, nbytes, **peaks).report(seconds)
        want = jprof.Roofline(flops, nbytes, **peaks).report(seconds)
        assert got == want


def test_roofline_defaults_are_the_h100_peaks():
    r = tprof.Roofline()
    assert (r.peak_flops, r.peak_bw) == (989e12, 3.35e12)
    rep = tprof.Roofline(flops=989e12 * 1e-3, bytes_accessed=3.35e12 * 5e-4).report(2e-3)
    assert rep["bound"] == "compute" and rep["fraction_of_roofline"] == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["7B", "125M"])
@pytest.mark.parametrize("quant_bits,kv_bits", [(4, 16), (8, 8), (4, 4), (2, 16)])
def test_decode_step_roofline_matches_jax(name, quant_bits, kv_bits):
    """Same flops and bytes as JAX, the int4 cache's ``kv_bits // 8 == 0`` included."""
    kw = dict(quant_bits=quant_bits, kv_bits=kv_bits, seq=1024, batch=2)
    got = tprof.decode_step_roofline(LLaMAConfig.from_name(name), **kw)
    want = jprof.decode_step_roofline(JConfig.from_name(name), **kw)
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)
    if kv_bits == 4:  # the reference's quirk: the int4 cache streams nothing
        no_kv = tprof.decode_step_roofline(LLaMAConfig.from_name(name), quant_bits,
                                           kv_bits=0, seq=1024, batch=2)
        assert got.bytes_accessed == no_kv.bytes_accessed


def test_timeit_on_the_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return {"y": x * scale}

    t = tprof.timeit(fn, torch.ones(64), iters=5, warmup=2, scale=3.0)
    assert len(calls) == 7
    assert isinstance(t, tprof.Timing) and t.wall_s > 0 and t.cpu_s >= 0
    assert t.cuda_s is None  # the result is on the CPU: no CUDA events


def test_sync_is_a_noop_off_the_card():
    tprof.sync({"a": [torch.zeros(2)]})
    tprof.sync({})
    tprof.sync(3.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "tr", device="cpu") as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]


def test_trace_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with tprof.trace(tmp_path):
            pass
