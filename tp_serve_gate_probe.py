"""Reading of the tensor-parallel serve step's K7 gate at the 7B's widths cut to 8 layers.

    python3 tp_serve_gate_probe.py [SEED_OFFSET ...]

`chip_smoke.py`'s parallel phase serves the 7B int4 checkpoint at tp 2 and holds one
decode step's logits through K7 against the same step with K7's plain version
(`decode_step_gate`: argmaxes agree on at least ARGMAX_AGREE of the rows). This probe
runs that gate on checkpoints of the 7B's widths at PAR_LAYERS layers with unit-gain
int4 packs, one a generator seed (default: SEED + 46, the tp-2 generation's, then
SEED + 47 and SEED + 48), and prints what separates a near tie from a fault:

* per row of the step: the argmax through K7 and through the plain K7, the plain
  logits' top-2 margin, the largest |K7 - plain| logit difference of the row, and
  whether K7's pick is the plain logits' second;
* per layer, on the step's pool (a rank's own 16 heads, or all 32 on one rank): K7
  against its plain version on the same random queries, max abs error over max |plain|.

Each checkpoint is read first on one rank, then by two ranks that share the one card
over gloo, as in `chip_smoke.py`. One JSON line a seed and rank, after the card's name
and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as cs

ROOT = cs.WORK_DIR.parent / "tp_serve_gate_probe"
WORLD = 2


def step_reading(engine, device, out):
    """At the first step where every slot decodes: the gate's two logit sets read
    row by row, and K7 against its plain version on every layer of the step's pool."""
    if out or len(engine._decoding()) < engine.B or engine.prefilling:
        return
    engine._ensure_capacity()
    pos = engine.pos.copy()
    ap = min(cs.bucket_length(int(pos.max()) // engine.page + 1, minimum=1), engine.maxP)
    tables = cs.np.ascontiguousarray(engine.tables[:, :ap])

    def step_logits():
        pool = {k: v.clone() for k, v in engine.pool.items()}
        logits = cs.paged_forward(engine.params, engine.cur[:, None], pos[:, None], tables,
                                  pool, engine.config, engine.quantized, device=device,
                                  mesh=engine.mesh)[0].float()
        return logits.reshape(engine.B, -1), pool

    got, pool = step_logits()
    with mock.patch("lit_llama_ja_tpu_torch.infer.paged.paged_decode_attention",
                    cs.paged_decode_attention_ref):
        want, _ = step_logits()
    top2 = want.topk(2, dim=-1)
    rows = []
    for b in range(engine.B):
        a_got, a_want = int(got[b].argmax()), int(want[b].argmax())
        rows.append({"argmax_k7": a_got, "argmax_plain": a_want,
                     "plain_top2_margin": (top2.values[b, 0] - top2.values[b, 1]).item(),
                     "max_abs_diff": (got[b] - want[b]).abs().max().item(),
                     "k7_pick_is_plain_second": a_got == int(top2.indices[b, 1])})
    g = torch.Generator(device=device).manual_seed(cs.SEED)
    nh = pool["k"].shape[2]
    layers = []
    for layer in range(engine.config.n_layer):
        q = torch.randn((engine.B, nh, engine.config.head_dim), generator=g,
                        device=device).to(torch.bfloat16)
        args = (q, pool["k"][layer], pool["k_scale"][layer], pool["v"][layer],
                pool["v_scale"][layer], torch.as_tensor(tables, device=device),
                torch.as_tensor(pos, device=device))
        k7 = cs.paged_decode_attention(*args).float()
        plain = cs.paged_decode_attention_ref(*args).float()
        layers.append((k7 - plain).abs().max().item() / plain.abs().max().item())
    out.update(positions=pos.tolist(), pool_heads=nh,
               logits_rel_err=((got - want).norm() / want.norm()).item(),
               argmax_agree=sum(r["argmax_k7"] == r["argmax_plain"] for r in rows) / len(rows),
               rows=rows, k7_rel_err_by_layer=layers)


def serve_reading(params, config, device, mesh=None):
    """`PagedEngine` (int8 pool, serve_cli's paged settings) on the parallel phase's
    requests, read by `step_reading`."""
    prompts = cs.serve_mix(config)[1][:cs.PAR_SERVE_REQUESTS]
    engine = cs.PagedEngine(params, config, quantize_kv="int8", device=device, mesh=mesh,
                            **cs.SERVE)
    reading = {}
    cs.drive(engine, prompts, new=cs.PAR_SERVE_NEW,
             on_step=lambda e: step_reading(e, device, reading))
    del engine
    torch.cuda.empty_cache()
    return reading


def _rank(rank, offsets):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{ROOT}/rendezvous", rank=rank,
                           world_size=WORLD)
    try:
        device = torch.device("cuda")
        mesh = cs.make_mesh(dp=1, fsdp=1, tp=WORLD)
        config = cs.par_7b_config()
        for off in offsets:
            params, _ = cs.load_model_any(ROOT / f"seed{off}", None, device=device, mesh=mesh)
            params = cs.cast_params(params, torch.bfloat16)
            print(json.dumps({"seed": cs.SEED + off, "layers": config.n_layer, "tp": WORLD,
                              "rank": rank, **serve_reading(params, config, device, mesh)}),
                  flush=True)
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("tp_serve_gate_probe: CUDA is not available", file=sys.stderr)
        return 1
    offsets = [int(a) for a in sys.argv[1:]] or [46, 47, 48]
    device = torch.device("cuda")
    cs.phase_device()
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    config = cs.par_7b_config()
    for off in offsets:
        g = torch.Generator(device=device).manual_seed(cs.SEED + off)
        params = cs.synth_7b_params(config, g, device, "int4", unit_gain=True)
        cs.save_checkpoint(ROOT / f"seed{off}", params, config)
        print(json.dumps({"seed": cs.SEED + off, "layers": config.n_layer, "tp": 1,
                          **serve_reading(params, config, device)}), flush=True)
        del params
        torch.cuda.empty_cache()
    mp.spawn(_rank, args=(offsets,), nprocs=WORLD, join=True)
    shutil.rmtree(ROOT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
