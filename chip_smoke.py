"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --gemms-of TREE
    python3 chip_smoke.py --attention-of TREE
    python3 chip_smoke.py --host-of TREE
    python3 chip_smoke.py --paged-of TREE
    python3 chip_smoke.py --a8-of TREE

The second form runs only the device phase, the K1 and K3-K5 rows of phases 2 and 5
(graph-replay times included), the host time of the four GEMV wrappers (`phase_host`)
and the 7B int4, llm.int8, gptq.int2 and gptq.int3 generations with their profiled
decode steps, with the package and kernels of the
checkout TREE in place of this one's, so that two checkouts (a parent and its change)
can be timed in turns by one measuring script. The third does the same for the attention kernels: the
device phase, the K2 rows of phase 3, the K6 rows of phase 4 with its repeat check, and
the 125M micro-batch and optimizer step of phase 7's `micro_step` line. The fourth
runs the device phase and `phase_host` alone, so that many processes of two checkouts
can take turns within one call. The fifth runs the device phase, the K7 and K8 rows of
phase 9 (with graph-replay times and the serve run's positions) and the host time of
one K7 and one K8 call (`phase_paged_host`), with TREE's package and kernels. The sixth
runs the device phase and `phase_a8_of`: each A8 mode (K1's W4A8, K3's W8A8, K4/K5's
W2A8/W3A8) timed at the 7B shapes, whole-column, M in {1, 8, 16}, beside the exact kernel
on the same inputs, with its sums over one 7B decode step, with TREE's package and
kernels, so that a parent and its change can be timed in turns in one call.

Phases, each printing one JSON line and each asserting (any failure ends the run
with a non-zero exit and no result line):

  1. device    the card's name and power limit; builds the CUDA kernels from
               ``lit_llama_ja_tpu_torch/csrc`` and prints the build seconds.
  2. kernels   K1, the int4 dequant-matmul, against its plain version at the LLaMA-7B
               shapes, M in {1, 8, 512}, whole-column and 128-row-group scales, and at
               the 125M shapes, M 2048; with the sums over one prefill's linears.
  3. kernels   K2, the causal flash-attention forward, against its plain version for
               (n_head, head_dim) in {(32, 128), (10, 78), (8, 64)}, T in {512, 777, 2048}.
     kernels   both kernels against their plain versions at ragged and strided shapes
               off the 7B path (one line each, correctness only); then the prefill
               GEMM's structured single-tile check through the int4 decoder; then the
               decode GEMV of K1, K3, K4 and K5 (`gemv_checks`): every M from 1 to 16 at
               narrow, odd, padded-K and ragged-group shapes and layer views against the
               plain versions, two launches that must give equal bits, and
               `structured_gemv` (one-hot x, weights that encode their K-row and
               column, or their scale group).
  4. kernels   K6, the causal flash-attention backward, against its plain version for
               (n_head, head_dim) in {(10, 78), (8, 64), (32, 128)} at T 2048, and at
               the 125M training shape (batch 4, 10 x 78, T 2048), with q, k, v and dO
               in the layouts the model hands over, and two launches there that must
               give the same bits; then ragged and strided edges; then the structured
               check of K2 and K6 (`structured_attention`) at both block sizes.
     w4a8      K1's W4A8 modes (`quant_matmul_int4(..., unpack="int8dot*")`, the kernel
               of `csrc/quant_matmul_w4a8.cu`) against their plain version, f32 out: at
               the 7B shapes, M in {1, 8, 16, 64}, whole-column and 128-row groups, the
               int8 levels of its quantize pass against the plain version's (flips at
               a .5 tie counted and printed) and every row within 1e-5 of max|want|
               (3e-3 for a row with a flipped level), two launches with equal bits,
               timed beside the exact K1 on the same inputs; the 125M shapes with
               their 780-, 60- and 64-element activation groups; M = 65 and 512 at the
               7B shapes, whose activation groups follow the JAX plan above 64 rows
               (packed tiles of 1024 rows, not 512), untimed; the sum over one 7B
               decode step (161 launches at M = 1), CUDA-event and graph replay, beside
               the exact K1's. Every row names the route it took: "decode" (M <= 16,
               the one launch of `a8_gemv`) or "mma" (above); at M = 1 one call of
               each shape is traced (`one_call`): the kernels `torch.profiler` records,
               the wrapper's launches and the allocations it made (one kernel, one
               launch, the output alone on the decode route).
     a8        K3's W8A8 (`quant_matmul_int8(..., unpack="int8dot")`) and K4/K5's
               W2A8/W3A8 (`quant_matmul_int2/int3(..., unpack="int8dot*")`), the A8
               kernel of `csrc/qmm_a8.cuh` with the decoders of
               `csrc/quant_matmul_a8.cu` and `csrc/quant_matmul_sub4_a8.cu`, against
               their plain versions, f32 out, as the
               w4a8 phase holds K1's (levels with tie flips counted, every row within
               1e-5 of max|want|, two launches with equal bits): at the 7B and 125M
               shapes, M in {1, 8, 16, 64, 65, 512}, K3 int8 whole-column and uint8 in
               128-row groups, K4/K5 whole-column and in 64-row groups (the refused plan
               of K3 at K = 780 whole-column and M <= 64 raises on the card too);
               `structured_a8`; the sums over one 7B decode step (161 launches at M =
               1, whole-column) of each mode beside the exact K3/K4/K5 on the same
               inputs, CUDA-event and graph replay; routes and `one_call` as in the
               w4a8 phase. `structured_a8` runs every A8 mode,
               K1's W4A8 too, on one-hot x, levels that encode their K-row and column
               and scale rows that encode their index.
  5. kernels   K3 (int8: symmetric whole-column, and uint8 in 128-row groups), K4 (int2:
               whole-column, and 64-row groups) and K5 (int3: whole-column) against their
               plain versions at the 7B shapes (M 1, 8 and 512) and the 125M shapes (M 1 and
               2048), timed, with the prefill sums; then off those shapes (ragged M, N
               and scale groups, stored rows past K) and the structured single-tile
               check through each of their decoders, correctness only.
  6. generate  LLaMA-7B at full width and depth, one run per weight format: int4 (random
               packs from a seed), llm.int8 (random bf16 weights quantized on the card by
               `int8_quantize_model`), gptq.int2, gptq.int3 and gptq.mix-a4m2h4-g64 (random
               packs by the recipe of `bench.py:73-180`). The port's `generate` on a
               500-token prompt with an int4 KV cache, greedy, 16 new tokens, on the
               program `generate` holds for its key (the default: its prefill span and
               its decode step each captured in a CUDA graph after an eager warm-up,
               then 14 step replays), then the same with every body eager
               (``cuda_graph=False``, a fresh program): greedy tokens and the KV cache's
               bytes equal; two more calls of the held key (the same prompt, a
               480-token one in the bucket), each building, capturing and launching
               nothing, with a fresh call's tokens and cache bytes;
               launch counts of both (the capture's wrapper launches and its graph's
               own kernel nodes, read through the driver API: one step's, 161
               quantized GEMVs), the capture's ms, decode ms a token over the replays
               (CUDA events around them) beside the eager steps', and the prefill
               logits against the plain versions of every kernel used; for int4,
               llm.int8, gptq.int2 and gptq.int3 also one replay of the captured step
               under `torch.profiler` (`decode_profile`: device time by kernel, the
               quantized GEMVs' sum, the replay's busy share, the port's kernels in the
               trace gated to the graph's kernel nodes).
               Then each A8 mode's generation under the JAX package's chip dispatch,
               patched in here while the step is captured (`generate_a8`, 16 greedy
               tokens, captured and eager, tokens equal): the int4 run's weights
               with K1's W4A8 and gptq.int2/int3's with W2A8/W3A8 at M <= 64 (every
               decode step), exact in the 512-row prefill; the llm.int8 run's bf16
               weights quantized again as llm.int8-dyn, the bulk through W8A8 at every
               M (the live outlier columns of its prefill printed), beside the same
               tree through the exact K3. Each: launch counts and the prefill logits
               against the plain versions of every kernel it used, gated; decode ms a
               token and tokens beside the exact route's, printed.
  7. train     the 125M ja model at full width and depth through
               `cli/pretrain_cli.main` (T 2048, micro-batch 4, batch 32: 8 micro-
               batches per step) on a synthetic packed dataset written from the seed
               (a repeated random sequence), 6 steps with a save and a validation
               after the fourth, then `--resume` from the saved state; finite and falling loss,
               the resumed losses against the uninterrupted run's; the CLI's step and
               validation each one captured CUDA graph (`train/step.TrainStep`): the
               graphs' K2/K6 nodes one step's and one batch's, the run's launches two
               of each (the warm-up and the capture); then 3 steps without and with
               remat (K2 doubled) captured and eager from the same fresh params and
               batches (`train_pair`: losses, leaves and AdamW moments within
               RESUME_REL_TOL and STATE_REL_TOL, step ms of each route by CUDA events,
               capture and warm-up ms, the graph pool's bytes, the busy share of one
               replay, tokens/s, model flop share, peak memory); the gradients of one
               micro-batch against the plain versions of K2 and K6; then `micro_step`:
               one micro-batch's forward and backward and one captured optimizer step
               on random tokens, timed.
  8. quant_eval the 125M model from the train phase's last checkpoint, cut to its first 4
               layers (EVAL_LAYERS, saved as a checkpoint of its own): perplexity on 4
               windows of 2048 tokens of the synthetic data, in fp; after GPTQ at
               gptq.int4, gptq.int3, gptq.int2-g64 and gptq.mix on 8 calibration windows
               (saved, then read back by `load_model_any`); and after llm.int8 and
               llm.int8-dyn quantization at load. Each perplexity through the kernels
               against the same with the plain versions swapped in (1e-2 relative), with
               its launch counts; then one decode-path perplexity (int4 KV cache, a
               256-token window) of the mix, kernels against plain versions.
     finetune  (a) the 125M model from that checkpoint through the four finetune CLIs
               (`cli/finetune_cli`: LoRA, Adapter v1, Adapter v2, full; 20 steps of 2
               micro-batches of 4 x 256 on an instruction dataset written here with a
               character-level stand-in tokenizer), each run captured (the step and the
               validation one graph each: K2/K6 nodes and launches gated) and again
               eager (`cuda_graph=False`): falling losses, the two runs' losses, trained
               leaves and moments within `train_pair`'s tolerances, step ms of each, the
               PEFT saves' keys, frozen leaves bit-identical; then `generate_finetuned`
               (LoRA on the fp base, Adapter v1 on gptq.int4 and llm.int8 bases through
               K1 and K3, v2 on the fp base) with launch counts and repeatable tokens,
               `evaluate_cli`'s PEFT mains against the plain kernels (1e-2), the LoRA
               merge of `convert_lora_weights` against base + LoRA, and the two
               quantized-base errors of the JAX package (LoRA merge, Adapter v2).
               (b) `lora_7B`: 3 LLaMA-7B LoRA steps (frozen bf16 base from the seed, r 8
               on q and v, dropout 0.05, 2 micro-batches of 4 x 256), captured and eager
               (`train_pair`: step ms, tokens/s, peak memory, one replay under
               `torch.profiler`), frozen leaves untouched, the lora_B gradient against
               the plain K2 and K6 (5e-2). (c) `adapter_7B`: Adapter v1 on the 7B int4 base,
               a 500-token prompt and 32 greedy tokens: K1 launches a forward (161
               linears and 32 prefix projections), repeatable tokens, prefill logits
               against the plain versions, prefill and decode ms through
               `utils/profiling.timeit`.
     moe       the 125M ja config with 8 experts, top 2, from text to serving: (a)
               `prepare_cli.prepare_any_text` on a line-based corpus written from the
               seed (the finetune phase's character tokenizer), its chunk files read
               back through `PackedDataset`; (b) the C++ reader (`data/native_loader`,
               built by g++ here, its seconds printed) equal to the Python reader
               unshuffled, and resumed with ``skip_batches`` equal to a drained one;
               (c) `pretrain_cli.main --moe-experts 8` through the C++ reader (T 2048,
               micro-batch 4, batch 32), 3 steps and a ``--resume`` from the state
               after the second: falling finite loss, resumed losses within 2e-3, one
               captured step graph (12 K2 and 12 K6 nodes a micro-batch; the run's
               launches the warm-up's and the capture's), one micro-batch's loss and
               gradients (an expert leaf, the router, c_attn) against the plain K2/K6,
               3 optimizer steps of 4 micro-batches captured and eager (`train_pair`,
               `moe_train_steps`);
               step ms, tokens/s, the model flop share over the expert rows computed
               (E * C a layer), peak memory, the routing statistics; (d) `generate`
               from its checkpoint (500-token prompt, int4 KV cache, 32 greedy tokens):
               12 K2 launches, repeatable tokens, prefill logits against the plain
               versions, prefill and decode ms; (e) `PagedEngine` at serve_cli's
               defaults (int8 pool, page 16, 8 slots) on 8 requests of 64-1000 tokens,
               eager decode steps: every request completes, tokens repeat, 12 K7
               launches a decode step, one step's logits through K7 against its plain
               version; then captured, decode steps and prefill spans
               (`captured_serve_gate`): the eager tokens and page pool, one span's
               launches (12 K2 from position 0) a span capture; time to first token,
               decode step ms, tokens/s.
  9. kernels   K7 and K8, the paged int8 decode attention and its form fed by TMA
               bulk copies, against their plain version at the 7B heads (32 x 128) with
               B in {1, 8, 32}, page in {16, 128}, every slot at position 2047 or mixed
               positions, at the serve run's first 8 prompt lengths, and at the 125M
               (10 x 78) and 19M (8 x 64) heads, timed (CUDA events and graph replay)
               beside their bound and SDPA on pre-gathered bf16 k/v; then edges
               (position 0, wide tables of trash entries, a table longer than one
               cluster's splits of one tile, a table of one split, unaligned page runs
               and scale runs, pages at an odd byte offset, layer views), two launches
               that must give equal bits, and `structured_paged`: a one-hot q, and k
               and v that encode their token and column, so a wrong lane-to-token
               mapping prints as a wrong (token, column).
 10. serve     LLaMA-7B int4 weights through `PagedEngine` over an int8 page pool
               (page 16, 8 slots, 1025 pages, prefill chunk 512): 16 greedy requests of
               64-1000 tokens, 4 over a registered 256-token prefix, 32 new tokens
               each, with eager decode steps and prefill spans (``cuda_graph=False``):
               launch counts (K1 161 per forward, K2 32 per span from position 0, K7 32
               per decode step), the prefix's pages alone held afterwards, the same
               tokens in a second run, and one decode step's logits through K7 against
               its plain version; then the same requests with the decode steps and the
               prefill spans captured, the default (one CUDA graph an attend width, one
               a (span length, attend width, from position 0), `captured_serve_gate`):
               the eager tokens and the eager page pool's bytes, one step's launches a
               step capture and one span's a span capture (161 K1, 32 K2 from position
               0), the same kernel nodes in each graph, the replays, one replay of the
               widest step graph under `torch.profiler` with K7 and the GEMVs counted in
               the trace beside the graph's nodes; time to first token (median and
               p90), decode step ms, span ms by key (`span_ms`), tokens/s, K7 per step
               beside its bound, capture and warm-up ms, peak memory and the graphs'
               pool, captured and eager; then the mix again on the same captured engine
               (its graphs warm, what a long-running server sees: tokens equal to the
               first pass's, only new keys launch). Then 8 requests over the int4 pool
               (no K7), eager and captured, and 4 through the stripe `Engine` (int8
               cache; its slot prefill one graph a prompt bucket).
     parallel  the port's dp/fsdp/tp/ep/sequence parallelism (`parallel/`): 2 ranks
               share the one card, spawned after the kernels are built, over gloo
               (every collective copied through the host and counted); each rank runs,
               in turn: 7B int4 `generate_cli.main --tp 2` (the 7B's widths cut to 8
               layers, PAR_LAYERS, with unit-gain packs; a 500-token prompt, int4 KV
               cache, 16 greedy tokens; 41 K1 launches a forward a rank at the shard
               shapes, 8 K2), `generate` again (the tokens repeat) and the
               prefill logits against the single-rank run of the same weights (5e-2,
               argmax 0.9); 7B int4 `serve_cli.main --tp 2` and `PagedEngine` on 8 of
               the serve phase's requests (int8 pool of 16 heads a rank, 16 tokens
               each): every request answered, tokens repeat, 32 K7 launches a decode
               step, one step's logits through K7 against its plain version;
               `serve_cli.main --tp 2` with a checkpoint of the 7B's widths cut to 8
               layers (PAR_LAYERS) as its own draft, whole on every rank (a chain of 4, and `--draft-tree 4,2,2`), and with `--paged
               false` (the stripe engine on the rank's 16 heads): every request
               answered, the K1 and K2 launches worked out from the code, the share of
               tokens equal to the one-rank engines' (run in the setup, printed on the
               `parallel_spec_one_rank` line);
               `ring_quant_matmul` with n = 2 at 4096 x 4096 and 4096 x 11008, M 1
               and 512, int4 (K1 a hop) and int8 (K3 a hop), against x @ the
               dequantized pack (2e-2 of max|want|), each rank's columns equal in bits
               to the same hops run one after the other (the hops' transfers overlap
               the products) and no column-blocking copy in a call; the 125M ja
               `pretrain_cli.main`
               on the train phase's data and seed with `--fsdp 2` and `--tp 2` (a
               step of 2 micro-batches of 4 each) and a `--resume` under `--fsdp 2` for
               the second step, each loss within 2e-3 of the single-rank CLI's; the 125M MoE (8 experts,
               top 2, room for every token) through `forward_moe_ep` and one
               `make_moe_train_step_ep` step at ep 2 against `forward_moe` and the
               one-device step; `forward_sp` with the ring at T 4096 against one rank,
               then its backward in f32 (the next-token loss): the ranks' gradients
               summed over the axis against one rank's (1e-3 of each leaf's norm), the
               step's ms and the gradient all-reduce's;
               `generate_cli.main --tp 2` on gptq.int3 and gptq.mix (the 7B's widths at
               8 layers, random packs) and on the train phase's 125M checkpoint with
               `--quantize llm.int8-dyn` (int8 KV cache: 5 heads a rank), each with the
               int4 run's gates and the K1, K3, K4, K5 launches a forward at the shard
               shapes, and K4 or K5 at the rank's row shard of ``mlp.c_proj`` (5632 of
               the 11264 stored rows) against its plain version; the finetune CLIs on
               the train phase's checkpoint and the finetune phase's instruction data
               (`main_lora --tp 2`, `--fsdp 2`, `main_adapter_v2 --tp 2`; 2 steps of 2
               micro-batches of 4 x 256 under deterministic CUDA algorithms): losses
               within 2e-3 of the one-rank CLI's (run in the setup), the replicated
               leaves equal in bits on both ranks, K2 and K6 12 a micro-batch a rank
               (`parallel_finetune`).
               Then one rank over NCCL runs the generation (the CLI without a mesh,
               then `generate` and the prefill on a mesh of one rank whose NCCL
               collectives run as device copies, `mesh.ONE_RANK_COLLECTIVES`: the
               single-rank tokens exactly), and `generate` again with the default
               one-rank identity (the same tokens, its decode ms a token). Each line
               carries the backend, the world, the bytes staged through the host and
               each rank's peak memory.
     pipeline  pipeline parallelism (`parallel/pipeline.py`, `parallel/pp_decode.py`): 2
               ranks share the card over gloo, one stage each (every hop copied
               through the host and counted). First, in this process, the one-rank
               references: `PagedEngine` (int8 pool) on the parallel phase's 7B int4
               checkpoint and 8 of its requests (after a BOS, 16 greedy tokens), two
               125M `make_train_step` steps (4 micro-batches of 4 x 2048, bf16
               compute), one device's MoE routing statistics and a one-rank
               `pretrain_cli --moe-experts 8` step. Each rank then runs 7B int4
               `serve_cli.main --pp-stages 2 --pp-microbatches 2` (the parallel phase's
               8-layer checkpoint: 4 layers a stage) and `PagedEngine(pp_mesh=)`: tokens
               equal to the one-rank engine's, K1 (GEMV and GEMM) and K7 launches a
               stage (K7: 4 layers x 2 micro-groups a decode step), step times and staged bytes; speculative serving with
               the checkpoint drafting for itself (whole on each stage, a bf16 draft
               pool): `serve_cli.main --pp-stages 2 --pp-microbatches 2
               --draft-checkpoint-path`, `SpeculativePagedEngine(pp_mesh=)` (K 4) and
               `TreeSpeculativePagedEngine(pp_mesh=)` (4,2,2): tokens equal to the
               one-rank engines', K1 and K2 launches a stage worked out from the code,
               acceptance, tokens a round, round ms, tokens/s beside the plain pp
               engine's and the one-rank engines', staged bytes; two 125M GPipe steps
               (`make_pp_train_step`, K2 and K6 in each stage): losses within 1e-6 of
               the one-rank steps; the MoE at the CLI's capacity factor 1.25 on an
               fsdp-2 mesh: the dropped share of its forward and the loss of one
               `pretrain_cli --fsdp 2` step within 1e-6 of one rank's. The losses and
               the MoE statistics are taken under deterministic CUDA algorithms on
               both sides. Then 4 ranks, pp 2 x tp 2, serve the same requests through
               `serve_cli --tp 2 --pp-stages 2` and `PagedEngine(pp_mesh=)` at the 7B's
               widths cut to 8 layers, then the same CLI with the cut checkpoint as its
               own draft (a chain of 4 and `--draft-tree 4,2,2`): every request
               answered, launches; the share of tokens equal to one rank's printed (tp
               sums in another order).
     dryrun    `lit_llama_ja_tpu_torch.dryrun.main(4)`: 4 gloo ranks on the card run one
               step of every parallel family on the JAX dry run's tiny config (a
               dp x fsdp x tp train step and LoRA SFT step, a pp x tp GPipe step, a pp x tp
               `PagedEngine` on one prompt, an ep MoE step, the ring `forward_sp`): the
               six lines, finite losses, rank 0's K2 and K6 launches, and no K7 (the
               engine's pool is bf16, the JAX function's default).
     spec      speculative serving: a 125M ja target (bf16 weights from the seed, int8
               pool, K7 at 10 x 78 in its decode) with a 19M ja draft; the target alone
               through `PagedEngine`, then `SpeculativePagedEngine` (K 4) and
               `TreeSpeculativePagedEngine` (tree 4,2,2) on 8 greedy requests, eager
               and then with their rounds and spans captured (`gated_engine_runs`:
               tokens and both pools equal, one round's or one span's kernels a graph,
               the target's and the draft's span in one graph): launch counts,
               acceptance, tokens/s, span ms, and the share of requests whose tokens
               equal the target-only engine's (printed, not gated).
 11. kernels   one line with every ported kernel, its launches on its path and by path,
               its time beside its bound, the plain version's time and the library
               call's time. Each time there is the sum over the kernel's launches in one
               forward or step of its path: K1, K3, K4 and K5 over the 161 linears of
               one 7B decode step of their format (M = 1; the m8_* keys at M = 8, the
               prefill_* keys at M = 512), K2 over the 32 layers of the 7B prefill, K6 over the 384
               launches of one 125M training step, K7 and K8 over the 32 layers of one
               7B decode step at B = 8 with every slot at position 2047; K1's W4A8
               kernel over the 161 linears of one 7B decode step (M = 1, whole-column)
               beside the exact K1 on the same inputs, and K3's W8A8 and K4/K5's
               W2A8/W3A8 alike beside the exact K3/K4/K5, their launches from
               `generate_a8`.
 12. the last line: {"ok": true, "device": {...}}.

Every phase line ends with the card's SM clock and temperature, read at its end. After
each phase a `phase_end` line releases the programs `generate` and
`speculative_generate` hold across calls and prints the bytes the CUDA-graph pools still
hold (by pool, with their live blocks) and what is left after a garbage collection.
Times are CUDA-event medians of 20 launches after 3 warm-up launches, with a 256 MB
buffer written between launches so that each one finds the L2 cache cold, as the
decode loop does. K1-K6 rows also carry ``graph_ms`` (and the dequant-matmuls'
``library_graph_ms``): the same median over replays of the call captured in a CUDA
graph, which leaves out the host time of the wrapper where the 256 MB write does not
hide it. Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM and
989 TFLOP/s of dense bf16. TF32 is off for matmuls and cuDNN, so the float32 parts
of the plain versions run in full float32.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

OTHER_TREE_MODES = ("--gemms-of", "--attention-of", "--host-of", "--paged-of", "--a8-of")
if sys.argv[1:2] and sys.argv[1] in OTHER_TREE_MODES:  # another checkout's package and kernels
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))

import numpy as np
import torch

from lit_llama_ja_tpu_torch import dryrun
from lit_llama_ja_tpu_torch.cli import (
    convert_cli,
    evaluate_cli,
    finetune_cli,
    generate_cli,
    generate_finetuned,
    prepare_cli,
    pretrain_cli,
    serve_cli,
)
from lit_llama_ja_tpu_torch.cli.generate_cli import load_model_any
from lit_llama_ja_tpu_torch.core.config import LLaMAConfig, llama_configs
from lit_llama_ja_tpu_torch.data import native_loader
from lit_llama_ja_tpu_torch.data.native_loader import NativePackedBatches
from lit_llama_ja_tpu_torch.data.packed_dataset import PackedDataset, PackedDatasetBuilder
from lit_llama_ja_tpu_torch.data.sft import generate_prompt, prepare_sample, save_sft_dataset
from lit_llama_ja_tpu_torch.infer import decode_graph
from lit_llama_ja_tpu_torch.infer import generate as generate_mod
from lit_llama_ja_tpu_torch.infer import speculative as speculative_mod
from lit_llama_ja_tpu_torch.infer.decode_graph import release_programs
from lit_llama_ja_tpu_torch.infer.evaluate import decode_path_perplexity, perplexity
from lit_llama_ja_tpu_torch.infer.generate import bucket_length, decode_step, generate
from lit_llama_ja_tpu_torch.infer.paged import PagedEngine, paged_forward
from lit_llama_ja_tpu_torch.infer.serving import Engine
from lit_llama_ja_tpu_torch.infer.spec_serving import SpeculativePagedEngine
from lit_llama_ja_tpu_torch.infer.speculative import speculative_generate
from lit_llama_ja_tpu_torch.infer.tree_spec import TreeSpeculativePagedEngine, tree_topology
from lit_llama_ja_tpu_torch.io.checkpoint import (
    flatten_tree,
    load_checkpoint,
    load_state_npz,
    save_checkpoint,
    unflatten_tree,
)
from lit_llama_ja_tpu_torch.models.adapter import (
    AdapterConfig,
    adapter_forward_with_cache,
    adapter_v2_trainable,
    add_adapter,
    init_adapter_params,
)
from lit_llama_ja_tpu_torch.models.llama import (
    block_config,
    cast_params,
    forward,
    forward_with_cache,
    init_kv_cache,
    init_params,
    unstack_layers,
)
from lit_llama_ja_tpu_torch.models.lora import (
    LORA_KEYS,
    add_lora,
    init_lora_params,
    lora_trainable,
)
from lit_llama_ja_tpu_torch.models.moe import (
    MoEConfig,
    forward_moe,
    forward_moe_with_cache,
    init_moe_params,
    make_moe_train_step,
    moe_penalty,
)
from lit_llama_ja_tpu_torch.ops.cuda import _build
from lit_llama_ja_tpu_torch.ops.cuda import flash_attention as flash_wrappers
from lit_llama_ja_tpu_torch.ops.cuda import paged_attention as paged_wrappers
from lit_llama_ja_tpu_torch.ops.cuda import quant_matmul as qmm_wrappers
from lit_llama_ja_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.paged_attention import (
    gather_pages,
    paged_decode_attention,
    paged_decode_attention_db,
    paged_decode_attention_ref,
)
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul import (
    A8_DECODE_M,
    a8_quantize_ref,
    quant_matmul_int4,
    quant_matmul_int4_ref,
    quant_matmul_int4_w4a8,
    quant_matmul_int4_w4a8_ref,
    quant_matmul_int8,
    quant_matmul_int8_ref,
    quant_matmul_int8_w8a8,
    quant_matmul_int8_w8a8_ref,
    w4a8_launch,
    w4a8_plan,
    w8a8_launch,
    w8a8_plan,
)
from lit_llama_ja_tpu_torch.ops.cuda.quant_matmul_sub4 import (
    quant_matmul_int2,
    quant_matmul_int2_a8,
    quant_matmul_int2_a8_ref,
    quant_matmul_int2_ref,
    quant_matmul_int3,
    quant_matmul_int3_a8,
    quant_matmul_int3_a8_ref,
    quant_matmul_int3_ref,
    sub4_a8_launch,
    sub4_a8_plan,
)
from lit_llama_ja_tpu_torch.ops.rope import build_rope_cache
from lit_llama_ja_tpu_torch.parallel import mesh as mesh_mod
from lit_llama_ja_tpu_torch.parallel.collective_matmul import RING_COPY, k_shard, ring_quant_matmul
from lit_llama_ja_tpu_torch.parallel.ep import (
    forward_moe_ep,
    make_moe_train_step_ep,
    shard_params_ep,
)
from lit_llama_ja_tpu_torch.parallel.mesh import Mesh, all_reduce, make_mesh, single_device_mesh
from lit_llama_ja_tpu_torch.parallel.pipeline import make_pp_train_step, shard_params_pp
from lit_llama_ja_tpu_torch.parallel.sharded import k_shard_groups
from lit_llama_ja_tpu_torch.parallel.specs import shard_params, spec_of
from lit_llama_ja_tpu_torch.train.step import local_rows
from lit_llama_ja_tpu_torch.parallel.sp_forward import forward_sp
from lit_llama_ja_tpu_torch.quant import linear as linear_mod
from lit_llama_ja_tpu_torch.quant.linear import (
    dequantize_with_k,
    pack_int2,
    pack_int3,
    parse_quant_mode,
    quant_matmul,
    sub4_pad_rows,
    unpack_levels,
)
from lit_llama_ja_tpu_torch.quant import gptq as gptq_mod
from lit_llama_ja_tpu_torch.quant import pipeline as pipeline_mod
from lit_llama_ja_tpu_torch.quant.gptq import GPTQGraphs, hessian_update, init_hessian
from lit_llama_ja_tpu_torch.quant.pipeline import (
    SUBMODULES,
    block_forward,
    capture_linear_input,
    gptq_quantize_model,
    int8_quantize_model,
)
from lit_llama_ja_tpu_torch.train import step as step_mod
from lit_llama_ja_tpu_torch.train import trainer as trainer_mod
from lit_llama_ja_tpu_torch.train.loss import cross_entropy_loss
from lit_llama_ja_tpu_torch.train.step import (
    cast_floating,
    init_opt_state,
    make_adamw,
    make_sft_train_step,
    make_train_step,
)
from lit_llama_ja_tpu_torch.utils.profiling import timeit

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
SEED = 0
HOST_CALLS = 200  # calls a loop of `phase_host`
K1_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
K2_SHAPES = [(32, 128), (10, 78), (8, 64)]
K2_LENGTHS = [512, 777, 2048]
# (K, N, groups, Ms) off the 7B shapes; (768, 35008) is the 125M ja lm_head
K1_EDGES = [(90, 36, 2, (3, 40)), (768, 35008, 6, (1, 17)), (4096, 1000, 32, (2, 16)),
            (1000, 264, 3, (5, 8, 130))]
# the shared GEMM's copy paths and group cases for int4 (K is always even): K < 64, an
# odd N (byte loads of the packed rows), groups of 32 (two in a 64-deep tile), the 125M
# shape with groups of 60 that split tiles, and N = 4096 at M = 512 (128-wide tiles,
# 128 blocks)
K1_GEMM_EDGES = [(40, 264, 1, (17, 130)), (200, 37, 1, (17, 33)), (1024, 264, 32, (17, 130)),
                 (780, 2340, 13, (17, 130)), (4096, 4096, 32, (512,))]
K2_EDGES = [(2, 3, 1, 64, False), (2, 3, 65, 96, False), (1, 4, 200, 40, False),
            (3, 2, 130, 128, True), (1, 10, 300, 78, True)]  # (B, nh, T, hd, strided)
K6_SHAPES = [(1, 10, 78), (1, 8, 64), (1, 32, 128), (4, 10, 78)]  # (B, n_head, hd), T 2048
K6_EDGES = [(3, 2, 1, 64, True), (1, 4, 65, 78, True), (3, 2, 777, 64, False),
            (1, 3, 777, 128, True), (2, 3, 130, 96, False)]  # (B, nh, T, hd, strided)
# the structured check of K2 and K6: (n_head, T, head_dim, strided, realigned); T 200
# keeps every expected value exact in bf16 and ends inside a 64-key tile; hd 78 views
# both as they are (4-byte copies) and realigned (16-byte copies, the short last chunk)
STRUCTURED_ATTENTION = [(2, 200, 64, False, False), (2, 200, 78, True, False),
                        (2, 200, 78, True, True), (2, 200, 128, False, False)]
MICRO_REPS = 5  # timed micro-batch forward + backward passes of the micro_step line
TRAIN_MODEL = "125M"
TRAIN = dict(micro_batch_size=4, batch_size=32, max_iters=6, warmup_iters=2, save_interval=4,
             eval_interval=4, eval_iters=2, log_interval=1, train_prefixes="synth",
             val_prefixes="synth", device="cuda")
RESUME_REL_TOL = 2e-3  # resumed vs uninterrupted losses: the CUDA embedding backward
                       # adds with atomics, so the sums' order changes from run to run
TRAIN_STEPS = 3  # the timed steps of each captured-against-eager pair (`train_pair`)
GRAD_LOSS_TOL = 1e-2  # one micro-batch, kernel vs plain attention: |Δloss|
GRAD_REL_TOL = 5e-2  # and every gradient leaf: ||Δg|| <= 5e-2 ||g_plain|| (bf16 compute)
# a captured training run against the eager one after the same steps (`train_pair`): each
# trained leaf's difference within this share of the eager run's change of it, each AdamW
# moment's within this share of the eager moment. The gradient check's bound: the two
# routes differ where atomic adds (the embedding backward, the MoE dispatch) sum in
# another order, and the moments average the gradients that carry it.
STATE_REL_TOL = GRAD_REL_TOL
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
REL_TOL = 2e-2  # kernel vs plain: |got - want| <= 2e-2 * max|want| (bf16 inputs)
LSE_ATOL = 1e-3  # f32 statistics on both sides
LOGIT_REL_TOL = 5e-2  # 32 bf16 layers: ||Δ|| <= 5e-2 ||plain|| over the prefill logits
ARGMAX_AGREE = 0.9  # share of prefill rows whose argmax agrees
# the quantized dequant-matmuls: name -> (wrapper, plain version, leaves it takes)
QUANT_KERNELS = {
    "quant_matmul_int4": (quant_matmul_int4, quant_matmul_int4_ref,
                          ("qweight", "scales", "zeros")),
    "quant_matmul_int8": (quant_matmul_int8, quant_matmul_int8_ref,
                          ("qweight", "scales", "zeros")),
    "quant_matmul_int2": (quant_matmul_int2, quant_matmul_int2_ref,
                          ("qweight", "scales", "zeros")),
    "quant_matmul_int3": (quant_matmul_int3, quant_matmul_int3_ref,
                          ("qweight", "qweight_hi", "scales", "zeros")),
}
PAGED_KERNELS = {"paged_decode_attention": paged_decode_attention,
                 "paged_decode_attention_db": paged_decode_attention_db}
# the A8 modes of K1, K3, K4 and K5: name -> (wrapper, plain version, the exact kernel
# whose leaves it takes)
A8_KERNELS = {
    "quant_matmul_int4_w4a8": (quant_matmul_int4_w4a8, quant_matmul_int4_w4a8_ref,
                               "quant_matmul_int4"),
    "quant_matmul_int8_w8a8": (quant_matmul_int8_w8a8, quant_matmul_int8_w8a8_ref,
                               "quant_matmul_int8"),
    "quant_matmul_int2_a8": (quant_matmul_int2_a8, quant_matmul_int2_a8_ref, "quant_matmul_int2"),
    "quant_matmul_int3_a8": (quant_matmul_int3_a8, quant_matmul_int3_a8_ref, "quant_matmul_int3"),
}
KERNELS = {**{n: k[0] for n, k in QUANT_KERNELS.items()},
           "flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
           **PAGED_KERNELS, **{n: k[0] for n, k in A8_KERNELS.items()}}
# the device kernels of each wrapper in a profiler trace or a captured graph, by parts
# of their names: the GEMVs (`qmm_gemv.cuh`, M <= 16) and the GEMMs (`qmm_generic.cuh`)
# of K1, K3-K5 and `a8_gemv` (`qmm_a8.cuh`) by their decoders, K7, K8 and K2 by their own
TRACE_NAMES = {"quant_matmul_int4": ("Int4Gemv", "Int4Fmt"),
               "quant_matmul_int8": ("Int8Gemv", "Int8Fmt"),
               "quant_matmul_int2": ("Int2Gemv", "Int2Fmt"),
               "quant_matmul_int3": ("Int3Gemv", "Int3Fmt"),
               "quant_matmul_int4_w4a8": ("Int4A8",), "quant_matmul_int8_w8a8": ("Int8A8",),
               "quant_matmul_int2_a8": ("Int2A8",), "quant_matmul_int3_a8": ("Int3A8",),
               "paged_decode_attention": ("paged_decode_k7",),
               "paged_decode_attention_db": ("paged_decode_k8",),
               "flash_attention_fwd": ("flash_fwd_kernel",),
               "flash_attention_bwd": ("flash_bwd_",)}
# device kernels a wrapper launch runs (1 where not named): K6 runs its dq kernel, then
# its dk/dv kernel, as the JAX function runs two pallas_calls
KERNELS_PER_LAUNCH = {"flash_attention_bwd": 2}
# K3-K5 cases (kernel, bits, groupsize, signed); signed: int8 levels, zeros 0
QUANT_CASES = [("quant_matmul_int8", 8, -1, True), ("quant_matmul_int8", 8, 128, False),
               ("quant_matmul_int2", 2, -1, False), ("quant_matmul_int2", 2, 64, False),
               ("quant_matmul_int3", 3, -1, False)]
Q125_SHAPES = [(780, 2340), (780, 780), (780, 2304), (2304, 780), (780, 35008)]
# launches of each (K, N) in one forward: 7B (161 linears) and 125M (61)
LINEARS_PER_FORWARD = {
    "7B": {(4096, 12288): 32, (4096, 4096): 32, (4096, 11008): 64, (11008, 4096): 32,
           (4096, 32000): 1},
    "125M": {(780, 2340): 12, (780, 780): 12, (780, 2304): 24, (2304, 780): 12, (780, 35008): 1},
}
PREFILL_M = {"7B": 512, "125M": 2048}
SERVE_M = 8  # rows of x in a 7B serve decode step at 8 slots
TIMED_KEYS = ("ms", "graph_ms", "plain_ms", "bound_ms", "library_ms", "library_graph_ms")
# the structured single-tile check: (kernel, bits, signed) of every GEMM decoder
STRUCTURED = [("quant_matmul_int4", 4, False), ("quant_matmul_int8", 8, True),
              ("quant_matmul_int8", 8, False), ("quant_matmul_int2", 2, False),
              ("quant_matmul_int3", 3, False)]
# (K, N, groupsize, Ms) off the model shapes; K3 at (780, 13 groups) reads its scale
# rows by the _expand_tiles rule, K4 and K5 store padded rows past K. The GEMM's copy
# paths: an odd K (2-byte x rows: plain loads), K < 64 (one partial k-tile), an odd N
# (byte loads of the packed rows), groupsize 32 (two groups a 64-deep tile), M = 17, and
# N = 4096 at M = 512 (128-wide tiles: 128 blocks)
QUANT_GEMM_EDGES = [(91, 264, -1, (17, 40)), (40, 264, -1, (17, 130)), (200, 37, -1, (17, 33))]
QUANT_EDGES = {
    "quant_matmul_int8": [(90, 36, -1, (3, 40)), (780, 2340, 64, (1, 17, 130)),
                          (1000, 264, 334, (5, 8)), (4096, 1000, 128, (2, 16)),
                          *QUANT_GEMM_EDGES, (4096, 4096, 128, (512,))],
    "quant_matmul_int2": [(780, 36, 64, (1, 3, 17, 130)), (100, 264, -1, (1, 5, 40)),
                          (2304, 780, 64, (1, 130)), (11008, 1000, -1, (1, 16, 17)),
                          *QUANT_GEMM_EDGES, (1024, 264, 32, (17, 130)),
                          (4096, 4096, 64, (512,))],
    "quant_matmul_int3": [(780, 36, 64, (1, 3, 17, 130)), (100, 264, -1, (1, 5, 40)),
                          (2304, 780, 64, (1, 130)), (11008, 1000, -1, (1, 16, 17)),
                          *QUANT_GEMM_EDGES, (1024, 264, 32, (17, 130)),
                          (4096, 4096, 64, (512,))],
}
# the decode GEMV (M <= 16) of K1, K3, K4 and K5: its decoders; by bits, (K, N, groups)
# edges at every M 1..16 (int2/int3: (K, N, groups, stored rows Kp), groups over Kp),
# layer views, repeat shapes (K, N, M; int2/int3 also groups and Kp); the structured
# check's layout (one group a K-row, Kp = K) and ragged shapes (groups of 60 rows; of
# 61 over int2/int3's Kp = 784)
GEMV_DECODERS = [("quant_matmul_int4", 4, False), ("quant_matmul_int8", 8, True),
                 ("quant_matmul_int8", 8, False), ("quant_matmul_int2", 2, False),
                 ("quant_matmul_int3", 3, False)]
# whole columns and 64-row groups over Kp (fast: 4096 and the padded 11008; general: the
# 125M 780 and 2304 with N = 780), 32-row groups, groups of 61 rows (ragged), stored rows
# past K, N % 16 != 0, odd N and odd K
SUB4_GEMV_EDGES = [(90, 36, 2, 96), (91, 264, 1, 96), (256, 37, 1, 256), (780, 2340, 13, 832),
                   (780, 2340, 13, 784), (1024, 264, 32, 1024), (2304, 780, 48, 3072),
                   (11008, 1000, 1, 11264), (11008, 4096, 176, 11264), (4096, 4096, 1, 4096)]
GEMV_EDGES = {4: [(90, 36, 2), (780, 2340, 13), (1000, 264, 3), (256, 37, 1), (4096, 1000, 32),
                  (4096, 4096, 1)],
              8: [(91, 264, 1), (777, 2340, 5), (90, 36, 2), (1000, 264, 3), (4096, 1000, 32),
                  (4096, 4096, 1)],
              2: SUB4_GEMV_EDGES, 3: SUB4_GEMV_EDGES}
SUB4_GEMV_VIEWS = [(780, 2340, 13, 832), (4096, 4096, 64, 4096)]
GEMV_VIEWS = {4: [(780, 2340, 13), (4096, 4096, 32)], 8: [(780, 2340, 13), (4096, 4096, 32)],
              2: SUB4_GEMV_VIEWS, 3: SUB4_GEMV_VIEWS}
SUB4_GEMV_REPEATS = [(4096, 4096, 1, 1, 4096), (11008, 4096, 8, 1, 11264),
                     (11008, 4096, 8, 176, 11264), (780, 2340, 16, 13, 832)]
GEMV_REPEATS = {4: [(4096, 4096, 1), (11008, 4096, 8), (780, 2340, 16)],
                8: [(4096, 4096, 1), (11008, 4096, 8), (780, 2340, 16)],
                2: SUB4_GEMV_REPEATS, 3: SUB4_GEMV_REPEATS}
STRUCTURED_GEMV_SHAPES = [(256, 256, 256), (780, 2340, 13)]
# 7B formats whose decode step is profiled
# K1's W4A8 modes (phase `w4a8`): the 7B shapes at these M, whole-column and 128-row
# groups; the 125M shapes (K, N, G) with their 780-, 60- and 64-element activation
# groups; kernel (f32 out) against its plain version: rows whose int8 levels agree
# within A8_REL_TOL of max|want|, a row with a level flipped at a tie (at most one a
# group, counted and printed) within A8_FLIP_TOL
W4A8_MS = (1, SERVE_M, 16, 64)
W4A8_ABOVE_MS = (65, 512)  # the plan above 64 rows, checked after the timed rows
W4A8_125M = [(780, 2340, 13), (780, 2340, 1), (780, 780, 13), (2304, 780, 36), (780, 35008, 1)]
A8_REL_TOL, A8_FLIP_TOL = 1e-5, 3e-3
# the a8 phase: (kernel, bits, groupsize, signed) at the 7B shapes and the 125M shapes
# (A8_125M), each at every M of A8_MS; the first case of each kernel is its generation's
# format, timed at A8_TIMED_MS beside the exact kernel and summed over a decode step
A8_CASES = [("quant_matmul_int8_w8a8", 8, -1, True), ("quant_matmul_int8_w8a8", 8, 128, False),
            ("quant_matmul_int2_a8", 2, -1, False), ("quant_matmul_int2_a8", 2, 64, False),
            ("quant_matmul_int3_a8", 3, -1, False), ("quant_matmul_int3_a8", 3, 64, False)]
A8_MS = (1, SERVE_M, 16, 64, 65, 512)
A8_TIMED_MS = (1, SERVE_M)
A8_125M = [(780, 2340), (780, 780), (2304, 780), (780, 35008)]
# the structured check of every A8 mode: (kernel, bits, signed, K, N, groupsize, one-hot
# K-rows at group edges); int2/int3 store sub4_pad_rows(K, groupsize) rows
STRUCTURED_A8 = [("quant_matmul_int4_w4a8", 4, False, 780, 2340, 64,
                  [0, 31, 32, 59, 60, 61, 119, 120, 389, 390, 779]),
                 ("quant_matmul_int4_w4a8", 4, False, 4096, 4096, 128,
                  [0, 127, 128, 1023, 1024, 2047, 4095]),
                 ("quant_matmul_int4_w4a8", 4, False, 11008, 4096, 128,
                  [0, 255, 256, 5503, 5504, 11007]),
                 ("quant_matmul_int8_w8a8", 8, True, 4096, 4096, 128, [0, 127, 128, 255, 256, 4095]),
                 ("quant_matmul_int8_w8a8", 8, False, 780, 2340, 64, [0, 59, 60, 61, 779]),
                 ("quant_matmul_int8_w8a8", 8, True, 11008, 4096, -1, [0, 255, 256, 11007]),
                 ("quant_matmul_int2_a8", 2, False, 11008, 4096, -1, [0, 1023, 1024, 11007]),
                 ("quant_matmul_int2_a8", 2, False, 780, 2340, 64, [0, 63, 64, 779]),
                 ("quant_matmul_int3_a8", 3, False, 11008, 4096, -1, [0, 1023, 1024, 11007]),
                 ("quant_matmul_int3_a8", 3, False, 780, 2340, 64, [0, 63, 64, 779])]
# the A8 generations under the JAX package's chip dispatch, patched in here only: format
# -> (the wrapper of `quant/linear.py` it replaces, the A8 mode, the rows up to which the
# JAX function takes the mode: None for every M), A8_NEW greedy tokens
A8_RULES = {"int4": ("quant_matmul_int4", "quant_matmul_int4_w4a8", A8_DECODE_M),
            "llm.int8-dyn": ("quant_matmul_int8", "quant_matmul_int8_w8a8", None),
            "gptq.int2": ("quant_matmul_int2", "quant_matmul_int2_a8", A8_DECODE_M),
            "gptq.int3": ("quant_matmul_int3", "quant_matmul_int3_a8", A8_DECODE_M)}
A8_NEW = 16
PROFILED_FORMATS = ("int4", "llm.int8", "gptq.int2", "gptq.int3")
GEN_FORMATS = ("llm.int8", "gptq.int2", "gptq.int3", "gptq.mix-a4m2h4-g64")
EVAL_WINDOWS = 4  # 2048-token windows of the 125M perplexity
EVAL_LAYERS = 4  # the quant_eval phase's cut of the trained 125M (its first layers)
CALIB_WINDOWS = 8  # 2048-token GPTQ calibration windows
GPTQ_MODES = ("gptq.int4", "gptq.int3", "gptq.int2-g64", "gptq.mix")
GPTQ_EAGER_MODES = ("gptq.int4", "gptq.int2-g64")  # solved eagerly too, from the same Hessians
GPTQ_7B_WINDOWS = 8  # 2048-token windows of the 7B-width GPTQ phase: one micro-batch
PPL_REL_TOL = 1e-2  # kernel vs plain perplexity (bf16 activations, f32 sums)
CAPTURED_PPL_REL_TOL = 1e-5  # a perplexity's captured windows or tokens vs eager
DECODE_WINDOW = 256  # tokens of the one decode-path perplexity window
# K7 / K8 at the 7B shape: (n_head, head_dim, B, page, fill); fill "full" puts every
# slot at position 2047, "mixed" draws positions from the seed with 0 and page edges
PAGED_SHAPES = [(32, 128, B, page, fill) for B in (1, 8, 32) for page in (16, 128)
                for fill in ("full", "mixed")]
PAGED_MODELS = [(10, 78, 8, 16, "mixed"), (8, 64, 8, 16, "mixed")]  # the 125M and 19M heads
# fill "serve": the serve run's first 8 prompt lengths as positions, with the table width
# the engine buckets them to
PAGED_SERVE = (32, 128, 8, 16, "serve")
# (B, n_head, head_dim, page, positions or None for mixed, extra table width, layer view,
# pages at an odd byte offset); 4095 at B = 1: 8 splits of 8 tiles; 3 x 8 x 64 at page
# 8: one split; page 3 and 5: scale runs of 12 and 20 bytes, which no bulk copy takes
PAGED_EDGES = [(4, 32, 128, 16, [0, 0, 0, 0], 0, False, False),
               (4, 32, 128, 16, None, 48, False, False),
               (3, 10, 78, 4, None, 5, False, False), (3, 10, 78, 3, None, 2, True, False),
               (5, 8, 64, 8, [0, 7, 8, 63, 300], 0, True, False),
               (2, 32, 128, 128, [127, 128], 3, True, False),
               (1, 32, 128, 16, [4095], 0, False, False),
               (3, 8, 64, 8, [5, 20, 31], 0, False, False),
               (3, 8, 64, 3, None, 2, True, False), (2, 4, 128, 5, [300, 77], 1, False, False),
               (2, 10, 78, 16, None, 1, False, True),
               (3, 32, 128, 16, [0, 700, 2047], 0, True, True)]
# two launches that must give equal bits: (B, n_head, head_dim, page, fill)
PAGED_REPEATS = [(8, 32, 128, 16, "full"), (8, 10, 78, 16, "mixed")]
# the structured check: (B, n_head, head_dim, page, positions)
STRUCTURED_PAGED = [(8, 32, 128, 16, [2047, 0, 15, 16, 700, 1023, 1024, 333]),
                    (3, 10, 78, 3, [0, 200, 517]), (4, 8, 64, 8, [63, 64, 1000, 129]),
                    (1, 32, 128, 16, [4095])]
MAX_POS = 2047
# the serve phase: serve_cli's paged defaults at max_batch 8 and 2048 tokens a slot
SERVE = dict(max_batch=8, n_pages=8 * 2048 // 16 + 1, page_size=16, max_pages_per_slot=2048 // 16,
             prefill_chunk=512)
SERVE_REQUESTS, SERVE_NEW, SERVE_PREFIX, SERVE_PREFIXED = 16, 32, 256, 4
SERVE_INT4_REQUESTS, STRIPE_REQUESTS = 8, 4
SPEC_TARGET, SPEC_DRAFT, SPEC_REQUESTS, SPEC_PROMPTS = "125M", "19M", 8, (64, 512)
SPEC_GEN_PROMPT, SPEC_GEN_NEW, SPEC_GEN_K = 500, 32, 4  # the 7B int4 self-draft generation
HELD_PROMPT = 480  # a held generate call's other prompt, in the 500-token prompt's bucket
# the finetune phase: (a) the four finetune CLIs on the train phase's 125M checkpoint, each
# FT_ITERS optimizer steps of 2 micro-batches of 4 x 256 (the CLIs' max_seq_length) on
# FT_SAMPLES instruction samples, warm-up and intervals cut to the short run, at the
# learning rates below (the CLIs' defaults, LoRA's and full's raised so that a few steps
# move the loss); then generation, evaluation and conversion from their outputs.
# (b) one LLaMA-7B LoRA step, (c) LLaMA-7B Adapter v1 generation on an int4 base.
FT_MODEL, FT_BIG = "125M", "7B"
FT_ITERS, FT_SAMPLES, FT_NEW, FT_EVAL_WINDOWS = 20, 16, 16, 2
FT_RUN = dict(micro_batch_size=4, batch_size=8, max_iters=FT_ITERS)
FT_SHORT = dict(warmup_iters=1, log_interval=1, eval_interval=FT_ITERS, save_interval=FT_ITERS,
                eval_iters=2)
FT_LR = {"lora": 1e-2, "adapter": 5e-2, "adapter_v2": 5e-2, "full": 1e-4}
FT_PROMPT = "Continue the sequence."
FT_OUTPUT = "".join(chr(97 + (7 * j) % 26) for j in range(120))  # the sample's response
BIG_LORA = dict(r=8, alpha=16, dropout=0.05, accum=2, micro=4, T=256, lr=3e-4)
ADAPTER_PROMPT, ADAPTER_NEW = 500, 32
# the moe phase: the 125M ja config with 8 experts, top 2, through the pretrain CLI at the
# train phase's shapes (T 2048, micro-batch 4, batch 32) for MOE_ITERS steps, a save
# after the second; the corpus (MOE_TEXT_FILES files of MOE_LINES lines) packed into
# MOE_CHUNK-token chunks; MOE_SKIP batches skipped by the resumed reader; a MOE_PROMPT-token
# prompt and MOE_NEW greedy tokens; MOE_REQUESTS served requests
MOE = dict(n_expert=8, n_expert_active=2)
MOE_ITERS = 3
MOE_TRAIN = dict(micro_batch_size=4, batch_size=32, max_iters=MOE_ITERS, warmup_iters=1,
                 save_interval=2, log_interval=1)
MOE_SENTENCES, MOE_TEXT_FILES, MOE_LINES, MOE_CHUNK = 64, 3, 1500, 2049 * 64
MOE_SKIP, MOE_PROMPT, MOE_NEW, MOE_REQUESTS = 5, 500, 32, 8
MOE_PROFILE_ACCUM = 4  # micro-batches of the profiled step
# the parallel phase: PAR_WORLD ranks share the card over gloo. 7B int4 generation
# (PAR_GEN_PROMPT tokens, PAR_GEN_NEW greedy) and serving (PAR_SERVE_REQUESTS of the
# serve phase's requests, PAR_SERVE_NEW greedy tokens each) at tp = PAR_WORLD; the ring at PAR_RING_SHAPES (K, N) and
# PAR_RING_M rows; the 125M pretraining CLI at the train phase's data, seed and
# micro-batch, PAR_TRAIN_BATCH rows a step on one rank (2 micro-batches; the mesh runs
# take PAR_WORLD times as many, so that every run takes the same 2 a step); the 125M
# MoE at ep = PAR_WORLD with room for every token (PAR_MOE_BT: batch, tokens); the 125M
# sequence-parallel forward at PAR_SP_T tokens
PAR_WORLD, PAR_GEN_PROMPT, PAR_GEN_NEW, PAR_SERVE_REQUESTS, PAR_SERVE_NEW = 2, 500, 16, 8, 16
# checkpoints of the 7B's widths cut to PAR_LAYERS layers, each from a generator of its
# own (every path below read the 32-layer int4 checkpoint before this cut, which the
# tp-2 serving alone keeps): PAR_CUT (scales 0.01 and zeros 7) for the parallel phase's
# tp-2 speculative and stripe CLIs and their one-rank references and the pipeline
# phase's pp-2 serving and speculative serving; PAR_GEN_CUT (the unit-gain scales and
# zeros of the other cut checkpoints) for the tp-2 and NCCL generations, whose
# prefill-logit gate the first recipe fails at 8 layers (0.088 from one rank's)
PAR_LAYERS, PAR_CUT, PAR_GEN_CUT = 8, "int4_7b_l8", "int4_7b_l8_gain"
PAR_RING_SHAPES, PAR_RING_M = [(4096, 4096), (4096, 11008)], (1, 512)
PAR_TRAIN = dict(eval_interval=10**6, log_interval=1, val_prefixes=None)
PAR_TRAIN_BATCH = 8
PAR_MOE, PAR_MOE_BT = dict(n_expert=8, n_expert_active=2, capacity_factor=8.0), (4, 512)
PAR_SP_T = 4096
# the ring backward in f32 against one rank: ||Δg|| <= PAR_SP_GRAD_TOL ||g|| a leaf, and
# the losses alike (another fold order over the ring's blocks, another sum of the ranks)
PAR_SP_GRAD_TOL = 1e-3
# the finetune CLIs on a 2-rank mesh: name -> (main, variant, mesh arguments); 2 steps
# of 2 micro-batches of 4 x 256 each, losses within 2e-3 of one rank's
MESH_FT_RUNS = {"lora_tp2": ("main_lora", "lora", dict(tp=2)),
                "lora_fsdp2": ("main_lora", "lora", dict(fsdp=2)),
                "adapter_v2_tp2": ("main_adapter_v2", "adapter_v2", dict(tp=2))}
MESH_FT = dict(micro_batch_size=4, batch_size=8, max_iters=2)
MESH_FT_SHORT = dict(warmup_iters=1, log_interval=1, eval_interval=10**6, save_interval=10**6)
MESH_FT_TOL = 2e-3
# the tp-2 generations of the formats that tp refused before: fmt -> (sub-phase, the
# directory of a checkpoint of the 7B's widths at PAR_QUANT_LAYERS layers, or None for
# llm.int8-dyn at load from the train phase's 125M checkpoint)
PAR_QUANT_LAYERS = 8
PAR_QUANT = {"gptq.int3": ("generate_int3", "int3_7b"),
             "gptq.mix-a4m2h4-g64": ("generate_mix", "mix_7b"),
             "llm.int8-dyn": ("generate_int8dyn", None)}
# the pipeline phase: PP_WORLD ranks share the card over gloo, one stage each. 7B int4
# serving through serve_cli --pp-stages and PagedEngine(pp_mesh=) on the parallel phase's
# requests (PP_MICRO micro-groups a decode step), against the one-rank engine; the 125M
# GPipe step (PP_M micro-batches of PP_MB rows at T = block_size, PP_STEPS steps) against
# the one-rank make_train_step; the 125M MoE (8 experts, top 2, the CLI's capacity factor
# 1.25) through pretrain_cli --fsdp PP_WORLD (one step of PAR_TRAIN_BATCH rows a rank)
# against the one-rank CLI, and its routing statistics against one device's
PP_WORLD, PP_MICRO, PP_M, PP_MB, PP_STEPS = 2, 2, 4, 4, 2
# pp 2 x tp 2 (4 ranks on the card): 7B widths at PP_TP_LAYERS layers, int4 weights from
# the seed, the same requests (tp sums in another order: tokens against one rank printed)
PP_TP_LAYERS = 8
PP_REL_TOL = 1e-6  # losses and the MoE drop share against one rank (deterministic sums)
PP_MOE = dict(n_expert=8, n_expert_active=2)
# speculative serving on meshes: a 7B int4 checkpoint drafts for itself (the same weights
# whole on every rank, a bf16 draft pool beside the target's int8 pool) with a chain of
# MESH_SPEC_K tokens and the tree MESH_SPEC_TREE, on the parallel phase's requests; on
# random weights any other draft accepts nothing, so this measures the mechanism (accepted
# rounds, page-crossing commits), not a speed-up
MESH_SPEC_K, MESH_SPEC_TREE = 4, (4, 2, 2)


def gpu_state():
    """The card's SM clock (MHz) and temperature (C) now, as `nvidia-smi` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    try:
        sm, temp = (float(x) for x in out[0].split(","))
    except (IndexError, ValueError):
        return {"sm_clock_mhz": None, "temp_c": None}
    return {"sm_clock_mhz": sm, "temp_c": temp}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line carries the SM clock and temperature at its end, and
    ``t_s``, the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, **gpu_state(), "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


class Timer:
    """CUDA-event median over launches, each after an L2-evicting write."""

    def __init__(self, device):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def graph_ms(timer, fn) -> float:
    """``timer.ms`` of the replay of one call of ``fn`` captured in a CUDA graph: the
    device time of the call's kernels (the wrapper's copies included) without the host
    time of launching them, which the L2-evicting write does not always hide."""
    fn()  # builds, loads and allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timer.ms(graph.replay)


def timed(timer, fn, w, x):
    """A dequant-matmul row's times: the kernel's and the library's (``torch.matmul`` on
    the dequantized bf16 weight ``w``), each as CUDA-event and as graph-replay time."""
    return {"ms": timer.ms(fn), "graph_ms": graph_ms(timer, fn),
            "library_ms": timer.ms(lambda: torch.matmul(x, w)),
            "library_graph_ms": graph_ms(timer, lambda: torch.matmul(x, w))}


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "built": built, "build_s": build_s})
    return name


def synth_int4(g, K, N, groups, device, lead=()):
    """Random packed int4 linear: qweight bytes, scales around 0.01, zeros 0..15."""
    qweight = torch.randint(0, 256, (*lead, K // 2, N), generator=g, device=device,
                            dtype=torch.uint8)
    scales = torch.rand((*lead, groups, N), generator=g, device=device) * 0.01 + 0.005
    zeros = torch.randint(0, 16, (*lead, groups, N), generator=g, device=device).float()
    return qweight, scales, zeros


def check_k1(x, qweight, scales, zeros, case):
    """K1 against its plain version on the same inputs: (max_abs_err, tol)."""
    got = quant_matmul_int4(x, qweight, scales, zeros).float()
    want = quant_matmul_int4_ref(x, qweight, scales, zeros).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = REL_TOL * want.abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (case, err, tol)
    return err, tol


def check_k2(q, k, v, case):
    """K2 against its plain version on the same inputs: (max_abs_err, tol, lse error)."""
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    tol = REL_TOL * ro.float().abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    assert torch.isfinite(o).all() and err <= tol, (case, err, tol)
    assert lse_err <= LSE_ATOL, (case, lse_err)
    return err, tol, lse_err


def forward_sums(rows):
    """Sums over one forward's linears at the prefill M (7B: 161 at M = 512; 125M: 61 at
    M = 2048) of the rows of `phase_k1` or `phase_quant_kernels`, one entry per kernel,
    scale case and model."""
    cases = {}
    for r in rows:
        model = r["model"]
        if r["M"] == PREFILL_M[model]:
            case = (r["kernel"], r["groupsize"], r["signed"], model)
            cases.setdefault(case, {})[(r["K"], r["N"])] = r
    out = []
    for (kernel, gs, signed, model), at in cases.items():
        counts = LINEARS_PER_FORWARD[model]
        if set(at) == set(counts):
            out.append({"kernel": kernel, "groupsize": gs, "signed": signed, "model": model,
                        "M": PREFILL_M[model], "linears": sum(counts.values()),
                        **{key: sum(c * at[sh][key] for sh, c in counts.items())
                           for key in TIMED_KEYS}})
    return out


def structured_check(name, bits, signed, device):
    """One 64-deep k-tile of the GEMM (M 128, K 64, N = BN) at both tile widths, with
    data that makes a wrong operand layout readable: row m of x is one-hot at K-row
    k(m) (m for the first 64 rows, 127 - m for the second warpgroup's), and the weight,
    one scale group a K-row with scale 1 and zero = level - e, is exactly e = n + 1 in
    one run and k + 1 in the other. So y[m, n] names the weight column and K-row that
    the kernel read; any difference from the plain version fails, with up to eight
    (m, n) -> (K-row, column) read. Correctness only."""
    K, M = 64, 128
    fn, ref, _ = QUANT_KERNELS[name]
    g = torch.Generator(device=device).manual_seed(SEED)
    k_of = torch.cat([torch.arange(64), 127 - torch.arange(64, 128)]).to(device)
    x = torch.zeros((M, K), dtype=torch.bfloat16, device=device)
    x[torch.arange(M, device=device), k_of] = 1
    plan = qmm_wrappers.gemm_plan
    out = []
    for bn in (64, 128):
        N = bn
        if bits == 4:
            leaves = dict(zip(("qweight", "scales", "zeros"), synth_int4(g, K, N, 1, device)))
        else:
            leaves = synth_quant(g, bits, K, N, -1, device, signed)
        levels = unpack_levels(leaves, K)
        Kp = levels.shape[-2]
        rows = torch.arange(Kp, device=device, dtype=torch.float32)[:, None].expand(Kp, N)
        cols = torch.arange(N, device=device, dtype=torch.float32)[None, :].expand(Kp, N)
        got, want = [], []
        for enc in (cols + 1, rows + 1):
            args = quant_args(name, {**leaves, "scales": torch.ones((Kp, N), device=device),
                                     "zeros": levels - enc})
            with mock.patch.object(qmm_wrappers, "gemm_plan",
                                   lambda *a, bn=bn: (bn, *plan(*a)[1:])):
                got.append(fn(x, *args).float())
            want.append(ref(x, *args).float())
        torch.cuda.synchronize()
        bad = ((got[0] != want[0]) | (got[1] != want[1])).nonzero().tolist()
        examples = [{"m": m, "n": n, "want": [int(k_of[m]), n],
                     "read": [got[1][m, n].item() - 1, got[0][m, n].item() - 1]}
                    for m, n in bad[:8]]
        out.append({"bn": bn, "mismatches": len(bad), "examples": examples})
    emit({"phase": "kernels", "kernel": name, "bits": bits, "signed": signed, "structured": out})
    assert all(r["mismatches"] == 0 for r in out), (name, bits, signed, out)


def synth_gemv(g, bits, signed, K, N, G, device, lead=(), Kp=None):
    """Random leaves of one K1 (bits 4), K3 (8), K4 (2) or K5 (3) linear with G scale
    groups (over Kp stored rows for int2/int3, default sub4_pad_rows(K)): random bytes
    over every stored row, scales around 0.01, random zero levels (0 for signed int8)."""
    if bits == 4:
        return dict(zip(("qweight", "scales", "zeros"), synth_int4(g, K, N, G, device, lead)))
    if bits in (2, 3):
        Kp = sub4_pad_rows(K) if Kp is None else Kp
        leaves = {"qweight": torch.randint(0, 256, (*lead, Kp // 4, N), generator=g,
                                           device=device, dtype=torch.uint8)}
        if bits == 3:
            leaves["qweight_hi"] = torch.randint(0, 256, (*lead, Kp // 8, N), generator=g,
                                                 device=device, dtype=torch.uint8)
        return {**leaves,
                "scales": torch.rand((*lead, G, N), generator=g, device=device) * 0.01 + 0.005,
                "zeros": torch.randint(0, 2**bits, (*lead, G, N), generator=g,
                                       device=device).float()}
    lo, hi, dtype = (-128, 128, torch.int8) if signed else (0, 256, torch.uint8)
    zeros = torch.randint(0, 256, (*lead, G, N), generator=g, device=device).float()
    return {"qweight": torch.randint(lo, hi, (*lead, K, N), generator=g,
                                     device=device).to(dtype),
            "scales": torch.rand((*lead, G, N), generator=g, device=device) * 0.01 + 0.005,
            "zeros": zeros.zero_() if signed else zeros}


def structured_gemv(device):
    """The GEMV (M <= 16) of K1, K3, K4 and K5 with data that makes a wrong fragment
    layout readable, at M = 1, 8 and 16, every K-row probed: row m of x is one-hot at a
    K-row k, and in the layout case (K = 256, Kp = K: one scale group a K-row, scale 1,
    zero = level - e) the weight is exactly e = n + 1 in one run and k + 1 in the
    other, so y[m, n] names the column and K-row that the kernel read. In the ragged
    case (K 780 in 13 groups of 60 rows, or of 61 over int2/int3's Kp = 784, so k16
    steps straddle groups, and N % 16 != 0) the weight is its random level times its
    group's scale g + 1, zero 0, so a row scaled by its neighbour's group (or by groups
    counted over K, not Kp), a wrong field, bit plane or sign reads as a wrong value.
    Every value is exact, so any difference from the plain version fails, with up to
    eight (m, n) shown. Correctness only."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    results = []
    for name, bits, signed in GEMV_DECODERS:
        fn, ref, _ = QUANT_KERNELS[name]
        for K, N, G in STRUCTURED_GEMV_SHAPES:
            leaves = synth_gemv(gen, bits, signed, K, N, 1, device)
            rows = torch.arange(K, device=device, dtype=torch.float32)[:, None].expand(K, N)
            cols = torch.arange(N, device=device, dtype=torch.float32)[None, :].expand(K, N)
            if G == K:
                levels = unpack_levels(leaves, K)
                encs = [{"scales": torch.ones((K, N), device=device), "zeros": levels - enc}
                        for enc in (cols + 1, rows + 1)]
            else:
                grp = torch.arange(G, device=device, dtype=torch.float32)[:, None] + 1
                encs = [{"scales": grp.expand(G, N).contiguous(),
                         "zeros": torch.zeros((G, N), device=device)}]
            for M in (1, 8, 16):
                bad = []
                for b in range(-(-K // M)):
                    k_of = (b * M + torch.arange(M, device=device)) % K
                    x = torch.zeros((M, K), dtype=torch.bfloat16, device=device)
                    x[torch.arange(M, device=device), k_of] = 1
                    got = [fn(x, *quant_args(name, {**leaves, **e})).float() for e in encs]
                    want = [ref(x, *quant_args(name, {**leaves, **e})).float() for e in encs]
                    diff = torch.zeros_like(got[0], dtype=torch.bool)
                    for a, w in zip(got, want):
                        diff |= a != w
                    for m, n in diff.nonzero().tolist()[:8 - len(bad)]:
                        bad.append({"m": m, "n": n, "k": int(k_of[m]),
                                    "got": [a[m, n].item() for a in got],
                                    "want": [w[m, n].item() for w in want]})
                    if len(bad) >= 8:
                        break
                results.append({"kernel": name, "signed": signed, "K": K, "N": N, "groups": G,
                                "M": M, "mismatches": len(bad), "examples": bad})
    emit({"phase": "kernels", "gemv_structured": results})
    assert all(r["mismatches"] == 0 for r in results), [r for r in results if r["mismatches"]]


def gemv_checks(device):
    """The GEMV of K1, K3, K4 and K5 off the model shapes and twice on the same inputs:
    every M from 1 to 16 at N % 16 != 0 (narrow loads), odd K and K % 16 != 0, ragged
    scale groups, stored rows past K (int2/int3, groups over them), stacked-layer views
    (layers 1 and 2 of a (3, ...) tree) and 7B shapes, each against the plain version;
    then two launches that must give equal bits; then `structured_gemv`. Correctness
    only."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    edges = []
    for name, bits, signed in GEMV_DECODERS:
        for K, N, G, Kp in ((*e, e[0])[:4] for e in GEMV_EDGES[bits]):
            leaves = synth_gemv(gen, bits, signed, K, N, G, device, Kp=Kp)
            for M in range(1, qmm_wrappers.GEMV_MAX_M + 1):
                x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
                err, tol = check_quant(name, x, leaves, (K, N, G, M, signed))
                edges.append({"kernel": name, "signed": signed, "K": K, "N": N, "groups": G,
                              "stored_rows": Kp, "M": M, "max_abs_err": err, "tol": tol})
        for K, N, G, Kp in ((*e, e[0])[:4] for e in GEMV_VIEWS[bits]):
            stacked = synth_gemv(gen, bits, signed, K, N, G, device, lead=(3,), Kp=Kp)
            for layer in (1, 2):
                leaves = {k: v[layer] for k, v in stacked.items()}
                for M in (1, 5, 16):
                    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
                    err, tol = check_quant(name, x, leaves, (K, N, G, M, signed, layer))
                    edges.append({"kernel": name, "signed": signed, "K": K, "N": N,
                                  "groups": G, "stored_rows": Kp, "M": M, "layer": layer,
                                  "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "gemv_edges": edges,
          "worst_err_over_tol": max(e["max_abs_err"] / e["tol"] for e in edges)})
    repeats = []
    for name, bits, signed in GEMV_DECODERS:
        fn = QUANT_KERNELS[name][0]
        for K, N, M, G, Kp in ((*r, 1, r[0])[:5] for r in GEMV_REPEATS[bits]):
            leaves = synth_gemv(gen, bits, signed, K, N, G, device, Kp=Kp)
            x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
            a, b = (fn(x, *quant_args(name, leaves)) for _ in range(2))
            torch.cuda.synchronize()
            repeats.append({"kernel": name, "signed": signed, "K": K, "N": N, "M": M,
                            "groups": G, "stored_rows": Kp, "equal_bits": torch.equal(a, b)})
    emit({"phase": "kernels", "gemv_repeats": repeats})
    assert all(r["equal_bits"] for r in repeats), repeats
    structured_gemv(device)


def phase_w4a8(timer, device):
    """K1's W4A8 modes (`quant_matmul_int4_w4a8`, ``csrc/quant_matmul_w4a8.cu``) against
    their plain version (`check_a8`): at the 7B shapes (M in W4A8_MS, whole-column and
    128-row groups), timed beside the exact K1 (the GEMV at M <= 16) on the same inputs;
    at the 125M shapes; at the 7B shapes above 64 rows. A generator of its own keeps the
    later phases' draws as they were."""
    release_programs()  # the plain version's f64 temporaries reach 1 GB a call
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    rows, flips = [], 0

    def check(qweight, scales, zeros, x, case):
        leaves = {"qweight": qweight, "scales": scales, "zeros": zeros}
        return check_a8("quant_matmul_int4_w4a8", x, leaves, case)

    for K, N in K1_SHAPES:
        for groups in (1, K // 128):
            qweight, scales, zeros = synth_int4(gen, K, N, groups, device)
            for M in W4A8_MS:
                x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
                err, flipped = check(qweight, scales, zeros, x, (K, N, groups, M))
                flips += flipped
                n_bytes = qweight.numel() + 8 * groups * N + 2 * M * K + 2 * M * N
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = 2.0 * M * K * N / INT8_OPS_PER_S * 1e3
                kern = lambda: quant_matmul_int4_w4a8(x, qweight, scales, zeros)  # noqa: E731
                exact = lambda: quant_matmul_int4(x, qweight, scales, zeros)  # noqa: E731
                route = a8_route("quant_matmul_int4_w4a8", K, {"qweight": qweight,
                                                                "scales": scales}, M)
                row = {"kernel": "quant_matmul_int4_w4a8", "model": "7B", "K": K, "N": N,
                       "groups": groups, "group": w4a8_plan(K // 2, groups, M).group, "M": M,
                       "route": route, "max_abs_err": err, "flipped_levels": flipped,
                       "ms": timer.ms(kern), "graph_ms": graph_ms(timer, kern),
                       "exact_ms": timer.ms(exact), "exact_graph_ms": graph_ms(timer, exact),
                       "plain_ms": timer.ms(lambda: quant_matmul_int4_w4a8_ref(
                           x, qweight, scales, zeros)),
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                if M == 1:
                    row["one_call"] = check_one_call("quant_matmul_int4_w4a8", x,
                                                     (qweight, scales, zeros), route)
                emit({"phase": "w4a8", **row})
                rows.append(row)
    for K, N, groups in W4A8_125M:
        qweight, scales, zeros = synth_int4(gen, K, N, groups, device)
        for M in (1, 17, 64):
            x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
            err, flipped = check(qweight, scales, zeros, x, (K, N, groups, M))
            flips += flipped
            rows.append({"kernel": "quant_matmul_int4_w4a8", "model": "125M", "K": K, "N": N,
                         "groups": groups, "group": w4a8_plan(K // 2, groups, M).group, "M": M,
                         "route": a8_route("quant_matmul_int4_w4a8", K,
                                           {"qweight": qweight, "scales": scales}, M),
                         "max_abs_err": err, "flipped_levels": flipped})
    emit({"phase": "w4a8", "model": "125M", "rows": [r for r in rows if r["model"] == "125M"]})
    above = []
    for K, N in K1_SHAPES:
        qweight, scales, zeros = synth_int4(gen, K, N, 1, device)
        for M in W4A8_ABOVE_MS:
            x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
            err, flipped = check(qweight, scales, zeros, x, (K, N, 1, M))
            flips += flipped
            above.append({"K": K, "N": N, "M": M, "group": w4a8_plan(K // 2, 1, M).group,
                          "max_abs_err": err, "flipped_levels": flipped})
    emit({"phase": "w4a8", "model": "7B", "above_64_rows": above})
    emit({"phase": "w4a8", "decode_step": "7B, 161 launches at M=1, whole-column",
          **a8_step_sums(rows, "quant_matmul_int4_w4a8"), "flipped_levels_total": flips,
          "phase_s": time.perf_counter() - t_phase})
    return rows


def a8_plan_of(name, K, leaves, M):
    """The `A8Plan` of an A8 mode's leaves at M rows."""
    G = leaves["scales"].shape[-2]
    if name == "quant_matmul_int4_w4a8":
        return w4a8_plan(K // 2, G, M)
    if name == "quant_matmul_int8_w8a8":
        return w8a8_plan(K, G, M)
    bits = 3 if "qweight_hi" in leaves else 2
    return sub4_a8_plan(K, 4 * leaves["qweight"].shape[-2], G, M, bits)


def a8_route(name, K, leaves, M):
    """The route of the A8 kernel that a call of M rows takes: "decode" (the one launch
    of ``a8_gemv``, planned by `a8_gemv_plan`) or "mma" (``a8_quantize``, ``a8_mma``,
    ``a8_merge``); "mma" at every M for a checkout without the decode route."""
    gemv_plan = getattr(qmm_wrappers, "a8_gemv_plan", None)
    if gemv_plan is None or M > qmm_wrappers.GEMV_MAX_M:
        return "mma"
    plan = a8_plan_of(name, K, leaves, M)
    return "mma" if gemv_plan(M, plan.k_read, leaves["qweight"].shape[-1], plan.n_act,
                              plan.group, _build.sm_count(0), [0]) is None else "decode"


def one_call(name, x, args):
    """One call of an A8 wrapper after a warm-up: the kernels that a `torch.profiler`
    trace of it records, the wrapper's launches and the allocations it made (the caching
    allocator's count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = A8_KERNELS[name][0]
    fn(x, *args)
    torch.cuda.synchronize()
    n0 = fn.launches
    a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x, *args)
        torch.cuda.synchronize()
    allocations = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"kernels": [(k[:90], c) for k, c in kernels], "launches": fn.launches - n0,
            "allocations": allocations}


def check_one_call(name, x, args, route):
    """`one_call`, held on the decode route to one launch of one ``a8_gemv`` kernel (where
    the profiler records device kernels at all) and one allocation, the output."""
    got = one_call(name, x, args)
    if route == "decode":
        assert got["launches"] == 1 and got["allocations"] == 1, (name, got)
        assert not got["kernels"] or (len(got["kernels"]) == 1 and got["kernels"][0][1] == 1
                                      and "a8_gemv" in got["kernels"][0][0]), (name, got)
    return got


def check_a8(name, x, leaves, case):
    """An A8 mode of K1, K3, K4 or K5 (f32 out) against its plain version on the same
    inputs: the int8 levels of its quantize pass against `a8_quantize_ref`'s (a level may
    differ only where ``x * rsx`` lies within 4 ulp of a .5 tie, at most one a group),
    then every row within A8_REL_TOL of max|want|, or A8_FLIP_TOL for a row with a
    flipped level; the wrapper's own launch must give the same bits. Returns
    ``(max_abs_err, flipped levels)``."""
    fn, ref, exact = A8_KERNELS[name]
    args = quant_args(exact, leaves)
    K, N = x.shape[-1], leaves["qweight"].shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    plan = a8_plan_of(name, K, leaves, M)
    got = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if name in ("quant_matmul_int4_w4a8", "quant_matmul_int8_w8a8"):
        launch = w4a8_launch if name == "quant_matmul_int4_w4a8" else w8a8_launch
        scratch = launch(x2, leaves["qweight"], leaves["scales"], leaves["zeros"], got, plan,
                         levels=True)
    else:
        scratch = sub4_a8_launch(x2, leaves["qweight"], leaves.get("qweight_hi"),
                                 leaves["scales"], leaves["zeros"], got, plan, levels=True)
    again = fn(x, *args, out_dtype=torch.float32)
    want = ref(x, *args, out_dtype=torch.float32)
    levels, rsx = a8_quantize_ref(x2, plan)
    torch.cuda.synchronize()
    assert torch.equal(again.reshape(M, N), got), (case, "two launches differ")
    xb = torch.nn.functional.pad(x2.to(torch.bfloat16).float(), (0, plan.k_read - K))
    v = (xb.reshape(levels.shape) * rsx).abs()
    near = ((v - v.floor() - 0.5).abs() <= 4 * (torch.nextafter(v, v + 1) - v))
    flipped = scratch["xq"][:M, :plan.k_read].float().reshape(levels.shape) != levels
    assert not (flipped & ~near).any(), (case, "a level flipped off a tie")
    assert int(flipped.sum(-1).max()) <= 1, (case, "two flipped levels in a group")
    row_flip = flipped.flatten(1).any(1)
    mx = want.abs().max().item()
    row_err = (got - want.reshape(M, N)).abs().amax(-1)
    tol = torch.where(row_flip, A8_FLIP_TOL * mx, A8_REL_TOL * mx)
    assert torch.isfinite(got).all() and bool((row_err <= tol).all()), (
        case, (row_err / max(mx, 1e-30)).max().item())
    return row_err.max().item(), int(flipped.sum())


def structured_a8(device):
    """Every A8 mode on data that makes a wrong fragment readable: one-hot rows of x (+1
    or -1 at K-rows on and around the activation-group edges, and a zero row) through
    levels that encode their K-row and column, ``(k + 3n) % 2**bits`` (signed int8:
    ``% 255 - 127``),
    with zeros 0 and scale rows ``1 + r``: row m's output is ``±(1 + r(k_m)) q(k_m, n)``,
    so a wrong K-row, column, plane bit or scale row prints as a wrong value at (row,
    column)."""
    out = []
    for name, bits, signed, K, N, gs, hot in STRUCTURED_A8:
        k = torch.arange(K, device=device)[:, None]
        n = torch.arange(N, device=device)[None, :]
        q = (k + 3 * n) % 255 - 127 if signed else (k + 3 * n) % 2**bits
        if bits == 8:
            G = 1 if gs < 0 else -(-K // gs)
            leaves = {"qweight": q.to(torch.int8 if signed else torch.uint8)}
        elif bits == 4:
            G = 1 if gs < 0 else -(-K // gs)
            leaves = {"qweight": (q[0::2] | (((q[1::2] - 8) & 0xF) << 4)).to(torch.uint8)}
        else:
            Kp = sub4_pad_rows(K, gs)
            G = 1 if gs < 0 else Kp // gs
            qp = torch.nn.functional.pad(q, (0, 0, 0, Kp - K)).to(torch.uint8)
            leaves = pack_int3(qp) if bits == 3 else {"qweight": pack_int2(qp)}
        leaves["scales"] = (1.0 + torch.arange(G, device=device, dtype=torch.float32))[
            :, None].expand(G, N).contiguous()
        leaves["zeros"] = torch.zeros((G, N), device=device)
        M = len(hot) + 1
        plan = a8_plan_of(name, K, leaves, M)
        x = torch.zeros((M, K), device=device)
        sign = torch.tensor([(-1.0) ** m for m in range(len(hot))], device=device)
        x[torch.arange(len(hot), device=device), torch.tensor(hot, device=device)] = sign
        srow = torch.tensor(hot, device=device) // plan.group // plan.rep
        want = torch.zeros((M, N), device=device)
        want[:-1] = sign[:, None] * (1.0 + srow.float())[:, None] * q[hot].float()
        fn, _, exact = A8_KERNELS[name]
        got = fn(x.to(torch.bfloat16), *quant_args(exact, leaves), out_dtype=torch.float32)
        torch.cuda.synchronize()
        bad = ((got - want).abs() > 1e-4 * want.abs().clamp(min=1.0)).nonzero().tolist()
        out.append({"kernel": name, "signed": signed, "K": K, "N": N, "groups": G,
                    "group": plan.group, "hot_rows": hot, "mismatches": len(bad),
                    "first": [(m, c, hot[m] if m < len(hot) else None, got[m, c].item(),
                               want[m, c].item()) for m, c in bad[:8]]})
    emit({"phase": "kernels", "structured_a8": out})
    assert all(r["mismatches"] == 0 for r in out), out


def phase_a8(timer, device):
    """The A8 modes of K3 (W8A8), K4 (W2A8) and K5 (W3A8) against their plain versions
    (`check_a8`): the `A8_CASES` at the 7B and 125M shapes and every M of A8_MS, the
    generation formats timed at A8_TIMED_MS beside the exact kernel on the same inputs
    (the GEMV at M <= 16); then `structured_a8`; then each mode's sums over one 7B decode
    step (161 launches at M = 1). A generator of its own keeps the later phases' draws as
    they were. K3's W8A8 at K = 780 whole-column and M <= 64 must raise (the JAX plan
    leaves K-rows unread there)."""
    release_programs()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    rows, flips, timed_names = [], 0, set()
    for name, bits, gs, signed in A8_CASES:
        fn, ref, exact = A8_KERNELS[name]
        timed_case = name not in timed_names
        timed_names.add(name)
        shapes = [(K, N, "7B") for K, N in K1_SHAPES] + [(K, N, "125M") for K, N in A8_125M]
        for K, N, model in shapes:
            # the JAX int8 plan cannot run K = 780 in 128-row groups (7 tiles of 111
            # rows): the 125M's groups are 64 rows
            leaves = synth_quant(gen, bits, K, N, 64 if gs > 0 and model == "125M" else gs,
                                 device, signed)
            args = quant_args(exact, leaves)
            weight_bytes = K * N * bits / 8 + sum(
                leaves[k].numel() * leaves[k].element_size() for k in ("scales", "zeros"))
            for M in A8_MS:
                x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
                case = (name, gs, K, N, M)
                if bits == 8 and gs < 0 and K == 780 and M <= A8_DECODE_M:
                    try:
                        fn(x, *args)
                    except ValueError:
                        continue
                    raise AssertionError((case, "the W8A8 plan at K = 780 did not raise"))
                err, flipped = check_a8(name, x, leaves, case)
                flips += flipped
                route = a8_route(name, K, leaves, M)
                row = {"kernel": name, "bits": bits, "groups": leaves["scales"].shape[0],
                       "signed": signed, "model": model, "K": K, "N": N, "M": M,
                       "group": a8_plan_of(name, K, leaves, M).group, "route": route,
                       "max_abs_err": err, "flipped_levels": flipped}
                if timed_case and model == "7B" and M in A8_TIMED_MS:
                    kern = lambda: fn(x, *args)  # noqa: E731
                    ex = lambda: QUANT_KERNELS[exact][0](x, *args)  # noqa: E731
                    t_bytes = (weight_bytes + 2 * M * K + 2 * M * N) / HBM_BYTES_PER_S * 1e3
                    t_ops = 2.0 * M * K * N / INT8_OPS_PER_S * 1e3
                    row.update(ms=timer.ms(kern), graph_ms=graph_ms(timer, kern),
                               exact_ms=timer.ms(ex), exact_graph_ms=graph_ms(timer, ex),
                               plain_ms=timer.ms(lambda: ref(x, *args)),
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations")
                    if M == 1:
                        row["one_call"] = check_one_call(name, x, args, route)
                    emit({"phase": "a8", **row})
                rows.append(row)
            del leaves, args
    emit({"phase": "a8", "untimed": [r for r in rows if "ms" not in r]})
    structured_a8(device)
    for name in A8_KERNELS.keys() - {"quant_matmul_int4_w4a8"}:
        emit({"phase": "a8", "decode_step": f"{name}: 7B, 161 launches at M=1, whole-column",
              **a8_step_sums(rows, name)})
    emit({"phase": "a8", "flipped_levels_total": flips, "checked": len(rows),
          "phase_s": time.perf_counter() - t_phase})
    return rows


def a8_step_sums(rows, name):
    """An A8 mode's timed keys summed over one 7B decode step (161 launches at M = 1)."""
    at = {(r["K"], r["N"]): r for r in rows if r["kernel"] == name and "ms" in r
          and r["M"] == 1 and r["groups"] == 1}
    return {key: sum(c * at[sh][key] for sh, c in LINEARS_PER_FORWARD["7B"].items())
            for key in ("ms", "graph_ms", "exact_ms", "exact_graph_ms", "plain_ms", "bound_ms")}


def phase_a8_of(timer, device, Ms=(1, SERVE_M, 16)):
    """Each A8 mode (the first case of its kernel in the w4a8 and a8 phases: int4, int8
    symmetric, int2 and int3, whole-column) at the 7B shapes and every M of ``Ms``, timed
    beside the exact kernel on the same inputs, CUDA-event and graph replay, with the
    route it took; then the sums over one 7B decode step (161 launches) at each M. Uses
    the wrappers alone, so that another checkout's package can be timed (``--a8-of``)."""
    release_programs()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    modes = [("quant_matmul_int4_w4a8", 4, False), ("quant_matmul_int8_w8a8", 8, True),
             ("quant_matmul_int2_a8", 2, False), ("quant_matmul_int3_a8", 3, False)]
    for name, bits, signed in modes:
        fn, _, exact = A8_KERNELS[name]
        rows = []
        for K, N in K1_SHAPES:
            if bits == 4:
                qweight, scales, zeros = synth_int4(gen, K, N, 1, device)
                leaves = {"qweight": qweight, "scales": scales, "zeros": zeros}
            else:
                leaves = synth_quant(gen, bits, K, N, -1, device, signed)
            args = quant_args(exact, leaves)
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
                kern = lambda: fn(x, *args)  # noqa: E731
                ex = lambda: QUANT_KERNELS[exact][0](x, *args)  # noqa: E731
                rows.append({"K": K, "N": N, "M": M, "route": a8_route(name, K, leaves, M),
                             "ms": timer.ms(kern), "graph_ms": graph_ms(timer, kern),
                             "exact_ms": timer.ms(ex), "exact_graph_ms": graph_ms(timer, ex)})
            del leaves, args
        for M in Ms:
            at = {(r["K"], r["N"]): r for r in rows if r["M"] == M}
            emit({"phase": "a8_of", "kernel": name, "M": M,
                  "routes": sorted({r["route"] for r in at.values()}),
                  "decode_step": "7B, 161 launches, whole-column",
                  **{key: sum(c * at[sh][key] for sh, c in LINEARS_PER_FORWARD["7B"].items())
                     for key in ("ms", "graph_ms", "exact_ms", "exact_graph_ms")},
                  "rows": [{k: r[k] for k in ("K", "N", "graph_ms", "exact_graph_ms")}
                           for r in at.values()]})
    emit({"phase": "a8_of", "phase_s": time.perf_counter() - t_phase})


def phase_k1(timer, g, device):
    """K1 at the 7B shapes (M 1, 8 and 512, whole-column and 128-row groups), then at
    the 125M shapes (M 2048, whole-column). The 125M rows and the M = 8 rows draw from
    generators of their own, so that the phases after this one draw what they drew
    before these rows were added."""
    rows = []
    g125 = torch.Generator(device=device).manual_seed(SEED + 1)
    g8 = torch.Generator(device=device).manual_seed(SEED + 3)
    cases = [("7B", K, N, groups, (1, SERVE_M, 512), g) for K, N in K1_SHAPES
             for groups in (1, K // 128)]
    cases += [("125M", K, N, 1, (2048,), g125) for K, N in Q125_SHAPES]
    for model, K, N, groups, Ms, gen in cases:
        qweight, scales, zeros = synth_int4(gen, K, N, groups, device)
        w = dequantize_with_k({"qweight": qweight, "scales": scales, "zeros": zeros},
                              K, dtype=torch.bfloat16)
        for M in Ms:
            x = torch.randn((M, K), generator=g8 if M == SERVE_M else gen,
                            device=device).to(torch.bfloat16)
            err, tol = check_k1(x, qweight, scales, zeros, (K, N, groups, M))
            n_bytes = qweight.numel() + 8 * groups * N + 2 * M * K + 2 * M * N
            b, by = bound_ms(n_bytes, 2.0 * M * K * N)
            row = {"kernel": "quant_matmul_int4", "groupsize": -1 if groups == 1 else 128,
                   "signed": False, "model": model, "K": K, "N": N, "groups": groups, "M": M,
                   "max_abs_err": err, "tol": tol,
                   **timed(timer, lambda: quant_matmul_int4(x, qweight, scales, zeros), w, x),
                   "plain_ms": timer.ms(lambda: quant_matmul_int4_ref(x, qweight, scales, zeros)),
                   "bound_ms": b, "bound_by": by}
            emit({"phase": "kernels", **row})
            rows.append(row)
        del w
    emit({"phase": "kernels", "kernel": "quant_matmul_int4", "prefill_sums": forward_sums(rows)})
    return rows


def phase_k2(timer, g, device):
    rows = []
    for nh, hd in K2_SHAPES:
        for T in K2_LENGTHS:
            q, k, v = (torch.randn((1, nh, T, hd), generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
            err, tol, lse_err = check_k2(q, k, v, (nh, hd, T))
            flops = 4.0 * hd * nh * T * (T + 1) / 2  # q k^T and p v over the causal pairs
            b, by = bound_ms(2 * 4 * nh * T * hd + 4 * nh * T, flops)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row = {"n_head": nh, "head_dim": hd, "T": T, "max_abs_err": err, "tol": tol,
                   "lse_max_abs_err": lse_err,
                   "ms": timer.ms(lambda: flash_attention_fwd(q, k, v)),
                   "graph_ms": graph_ms(timer, lambda: flash_attention_fwd(q, k, v)),
                   "plain_ms": timer.ms(lambda: flash_attention_fwd_ref(q, k, v)),
                   "library_ms": timer.ms(lambda: sdpa(q, k, v, is_causal=True)),
                   "bound_ms": b, "bound_by": by}
            emit({"phase": "kernels", "kernel": "flash_attention_fwd", **row})
            rows.append(row)
    return rows


def phase_edges(g, device):
    """Both kernels against their plain versions off the 7B shapes: ragged M, N and K
    edges, the unvectorized loads (K or N not a multiple of 8), scale groups that end
    inside a k-tile or split a packed byte, every GEMV row count, batch > 1, T = 1,
    head dims padded inside the tile and a strided q, k, v. Correctness only."""
    k1 = []
    for K, N, G, Ms in K1_EDGES:
        qweight, scales, zeros = synth_int4(g, K, N, G, device)
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
            err, tol = check_k1(x, qweight, scales, zeros, (K, N, G, M))
            k1.append({"K": K, "N": N, "groups": G, "M": M, "max_abs_err": err, "tol": tol})
    g_gemm = torch.Generator(device=device).manual_seed(SEED + 2)  # leaves g's draws as they were
    for K, N, G, Ms in K1_GEMM_EDGES:
        qweight, scales, zeros = synth_int4(g_gemm, K, N, G, device)
        for M in Ms:
            x = torch.randn((M, K), generator=g_gemm, device=device).to(torch.bfloat16)
            err, tol = check_k1(x, qweight, scales, zeros, (K, N, G, M))
            k1.append({"K": K, "N": N, "groups": G, "M": M, "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "kernel": "quant_matmul_int4", "edges": k1})
    structured_check(*STRUCTURED[0], device)
    k2 = []
    for B, nh, T, hd, strided in K2_EDGES:
        if strided:  # q, k, v as views of one (B, T, 3, nh, hd) projection
            qkv = torch.randn((B, T, 3, nh, hd), generator=g, device=device).to(torch.bfloat16)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.randn((B, nh, T, hd), generator=g, device=device)
                       .to(torch.bfloat16) for _ in range(3))
        err, tol, lse_err = check_k2(q, k, v, (B, nh, T, hd, strided))
        k2.append({"B": B, "n_head": nh, "T": T, "head_dim": hd, "strided": strided,
                   "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err})
    emit({"phase": "kernels", "kernel": "flash_attention_fwd", "edges": k2})


def attention_inputs(g, device, B, nh, T, hd, strided):
    """bf16 q, k, v, dO. strided: q, k, v as views of one (B, T, 3, nh, hd) projection
    and dO as the transpose of a (B, T, nh, hd) gradient, the layouts the model's
    forward and autograd hand over; otherwise contiguous (B, nh, T, hd)."""
    if strided:
        qkv = torch.randn((B, T, 3, nh, hd), generator=g, device=device).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn((B, T, nh, hd), generator=g, device=device).to(torch.bfloat16)
        return q, k, v, do.transpose(1, 2)
    return [torch.randn((B, nh, T, hd), generator=g, device=device).to(torch.bfloat16)
            for _ in range(4)]


def check_k6(q, k, v, do, case):
    """K6 against its plain version on the same inputs (K2's o and lse):
    (max_abs_err, tol). dq, dk and dv are each held to 2e-2 of the largest |want| of
    the three: a gradient that is zero in exact arithmetic (dq and dk at T = 1) is
    rounding noise on both sides, with no scale of its own."""
    o, lse = flash_attention_fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    tol = REL_TOL * max(b.float().abs().max().item() for b in want)
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e = (a.float() - b.float()).abs().max().item()
        assert torch.isfinite(a).all() and e <= tol, (case, name, e, tol)
        err = max(err, e)
    return err, tol, (o, lse)


def phase_k6(timer, g, device):
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    T = 2048
    for B, nh, hd in K6_SHAPES:
        q, k, v, do = attention_inputs(g, device, B, nh, T, hd, strided=True)
        err, tol, (o, lse) = check_k6(q, k, v, do, (B, nh, hd, T))
        # five products (s, dp, dv, dk, dq) of 2 * hd flops per causal pair
        flops = 5 * 2.0 * hd * B * nh * T * (T + 1) / 2
        b, by = bound_ms(8 * B * nh * T * hd * 2 + 4 * B * nh * T, flops)  # + lse
        # K2 at the same shape, as the training step runs it: q k^T and p v
        fb, fby = bound_ms(2 * 4 * B * nh * T * hd + 4 * B * nh * T, flops * 2 / 5)
        qkv = q.detach().clone(), k.detach().clone(), v.detach().clone()
        leaves = [t.requires_grad_(True) for t in qkv]
        out = sdpa(*leaves, is_causal=True)
        row = {"B": B, "n_head": nh, "head_dim": hd, "T": T, "max_abs_err": err, "tol": tol,
               "ms": timer.ms(lambda: flash_attention_bwd(q, k, v, o, lse, do)),
               "graph_ms": graph_ms(timer, lambda: flash_attention_bwd(q, k, v, o, lse, do)),
               "plain_ms": timer.ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do)),
               "library_ms": timer.ms(
                   lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)),
               "fwd_ms": timer.ms(lambda: flash_attention_fwd(q, k, v)),
               "fwd_graph_ms": graph_ms(timer, lambda: flash_attention_fwd(q, k, v)),
               "fwd_plain_ms": timer.ms(lambda: flash_attention_fwd_ref(q, k, v)),
               "fwd_library_ms": timer.ms(lambda: sdpa(q, k, v, is_causal=True)),
               "fwd_bound_ms": fb, "fwd_bound_by": fby,
               "bound_ms": b, "bound_by": by}
        del out, leaves
        if (B, nh, hd) == (4, 10, 78):  # the training shape: two launches, the same bits
            again = flash_attention_bwd(q, k, v, o, lse, do)
            first = flash_attention_bwd(q, k, v, o, lse, do)
            row["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(first, again))
            assert row["repeat_bitwise"], "K6 gave different bits on the same inputs"
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", **row})
        rows.append(row)
    edges = []
    for B, nh, T, hd, strided in K6_EDGES:
        q, k, v, do = attention_inputs(g, device, B, nh, T, hd, strided)
        err, tol, _ = check_k6(q, k, v, do, (B, nh, T, hd, strided))
        edges.append({"B": B, "n_head": nh, "T": T, "head_dim": hd, "strided": strided,
                      "max_abs_err": err, "tol": tol})
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "edges": edges})
    return rows


def _mismatches(got, want, names):
    """Count and up to eight examples of the elements where got != want exactly;
    ``names`` turns a (head, row, column) index into what the element encodes."""
    bad = (got.float() != want.float()).nonzero().tolist()
    return {"mismatches": len(bad),
            "examples": [{**names(*ix), "want": want[tuple(ix)].item(),
                          "got": got[tuple(ix)].item()} for ix in bad[:8]]}


def structured_attention(device):
    """K2 and K6 on data that makes a wrong operand layout readable, at both block sizes
    (64 and 128 rows), head dims 64, 78 (the model's strided views, copied as they are
    and realigned) and 128, T 200.
    q = 0 makes every visible score 0, so each row's probabilities are exactly 1 over
    its visible keys:

    * K2: with v[key, c] = c + 1, o[row, c] = c + 1 (a wrong column of v's .trans load
      reads as another number); with v[key, c] = key + 1, o[row, c] = (row + 2) / 2,
      the mean of 1 .. row + 1 (a wrong key reads as another mean).
    * K6, given lse = 0 (so p = 1 on the visible keys): with dO[r, c] = [r % hd == c],
      dv[key, c] counts the rows r >= key with r % hd == c (dO's .trans load in dv); with
      dO[r, 0] = v[key, 0] = 1, o = 0 (so ds = scale) and k[key, c] = [key % hd == c],
      dq[row, c] = bf16(scale) times the keys <= row with key % hd == c (k's .trans load
      in dq); dk = ds^T q = 0 in both.

    Every expected value is exact in bf16, so any difference fails. Correctness only."""
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    plan = flash_wrappers.flash_plan
    results = []
    for nh, T, hd, strided, realigned in STRUCTURED_ATTENTION:
        B = 1
        rows = torch.arange(T, device=device)
        cols = torch.arange(hd, device=device)
        ind = (rows[:, None] % hd == cols[None, :]).float()  # (T, hd): [r % hd == c]
        for block in (64, 128):
            q, k, v, do = attention_inputs(g, device, B, nh, T, hd, strided)
            q.zero_()
            o = torch.zeros((B, nh, T, hd), dtype=torch.bfloat16, device=device)
            zero_lse = torch.zeros((B, nh, T), device=device)
            res = {"n_head": nh, "T": T, "head_dim": hd, "strided": strided,
                   "realigned": realigned, "rows": block}
            with mock.patch.object(flash_wrappers, "flash_plan",
                                   lambda *a, r=block, **kw: plan(*a, **kw)._replace(rows=r)), \
                 mock.patch.object(flash_wrappers, "REALIGN_MIN_ROWS",
                                   0 if realigned else flash_wrappers.REALIGN_MIN_ROWS):
                v.copy_((cols + 1).float().expand(B, nh, T, hd))
                got_c = flash_attention_fwd(q, k, v)[0][0]
                v.copy_((rows + 1).float()[:, None].expand(B, nh, T, hd))
                got_k = flash_attention_fwd(q, k, v)[0][0]
                v.zero_()
                do.copy_(ind.expand(B, nh, T, hd))
                _, dk1, dv1 = flash_attention_bwd(q, k, v, o, zero_lse, do)
                do.zero_()
                do[..., 0] = 1
                v.zero_()
                v[..., 0] = 1
                k.copy_(ind.expand(B, nh, T, hd))
                dq2, dk2, _ = flash_attention_bwd(q, k, v, o, zero_lse, do)
            torch.cuda.synchronize()
            want_c = (cols + 1).float().expand(nh, T, hd)
            want_k = ((rows + 2) / 2).float()[:, None].expand(nh, T, hd)
            want_dv = ind.flip(0).cumsum(0).flip(0).expand(nh, T, hd)
            scale = torch.tensor(1 / math.sqrt(hd)).to(torch.bfloat16).float()
            want_dq = (ind.cumsum(0) * scale).to(torch.bfloat16).expand(nh, T, hd)

            def at_row(h, r, c):
                return {"head": h, "row": r, "col": c}

            res["fwd_columns"] = _mismatches(got_c, want_c, at_row)
            res["fwd_keys"] = _mismatches(got_k, want_k, at_row)
            res["dv"] = _mismatches(dv1[0], want_dv,
                                    lambda h, r, c: {"head": h, "key": r, "col": c})
            res["dq"] = _mismatches(dq2[0], want_dq, at_row)
            res["dk_zero"] = bool((dk1 == 0).all() and (dk2 == 0).all())
            results.append(res)
    emit({"phase": "kernels", "kernel": "flash_attention", "structured": results})
    for res in results:
        assert res["dk_zero"] and all(res[key]["mismatches"] == 0 for key in
                                      ("fwd_columns", "fwd_keys", "dv", "dq")), res


def synth_quant(g, bits, K, N, groupsize, device, signed=False, lead=()):
    """Random pack of one linear: random bytes over every stored row (pad rows of a
    sub-4-bit pack too: the kernels must never multiply them), scales around 0.01 and
    random zero levels (0 for signed int8)."""
    def rand_bytes(rows, dtype=torch.uint8, lo=0, hi=256):
        return torch.randint(lo, hi, (*lead, rows, N), generator=g, device=device).to(dtype)

    Kp = sub4_pad_rows(K, groupsize) if bits in (2, 3) else K
    G = 1 if groupsize < 0 else (Kp // groupsize if bits in (2, 3) else -(-K // groupsize))
    leaves = {"scales": torch.rand((*lead, G, N), generator=g, device=device) * 0.01 + 0.005,
              "zeros": torch.randint(0, 2**bits, (*lead, G, N), generator=g,
                                     device=device).float()}
    if bits == 8 and signed:
        leaves["qweight"] = rand_bytes(K, torch.int8, -127, 128)
        leaves["zeros"].zero_()
    elif bits == 8:
        leaves["qweight"] = rand_bytes(K)
    else:
        leaves["qweight"] = rand_bytes(Kp // 4)
        if bits == 3:
            leaves["qweight_hi"] = rand_bytes(Kp // 8)
    return leaves


def quant_args(name, leaves):
    return [leaves[k] for k in QUANT_KERNELS[name][2]]


def check_quant(name, x, leaves, case):
    """A quantized kernel against its plain version on the same inputs:
    (max_abs_err, tol)."""
    fn, ref, _ = QUANT_KERNELS[name]
    args = quant_args(name, leaves)
    got = fn(x, *args).float()
    want = ref(x, *args).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = REL_TOL * want.abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (name, case, err, tol)
    return err, tol


def phase_quant_kernels(timer, g, device):
    """K3 (int8 symmetric whole-column; uint8 in 128-row groups), K4 (whole-column;
    64-row groups) and K5 (whole-column) against their plain versions at the 7B
    shapes (M 1, 8 and 512; M = 8 from a generator of its own) and the 125M shapes (M 1
    and 2048), timed beside their bounds, plain versions and the library's bf16 matmul
    on the dequantized weight."""
    rows = []
    g8 = torch.Generator(device=device).manual_seed(SEED + 4)
    for name, bits, gs, signed in QUANT_CASES:
        fn = QUANT_KERNELS[name][0]
        shapes = [(K, N, "7B", (1, SERVE_M, 512)) for K, N in K1_SHAPES]
        shapes += [(K, N, "125M", (1, 2048)) for K, N in Q125_SHAPES]
        for K, N, model, Ms in shapes:
            leaves = synth_quant(g, bits, K, N, gs, device, signed)
            args = quant_args(name, leaves)
            w = dequantize_with_k(leaves, K, dtype=torch.bfloat16)
            # the bytes the function must read: K rows of the pack (not the pad rows
            # K..Kp-1 of K4/K5, which hold level 0 and are never multiplied), plus
            # the scales and zeros
            weight_bytes = K * N * bits / 8 + sum(
                leaves[k].numel() * leaves[k].element_size() for k in ("scales", "zeros"))
            for M in Ms:
                x = torch.randn((M, K), generator=g8 if M == SERVE_M else g,
                                device=device).to(torch.bfloat16)
                err, tol = check_quant(name, x, leaves, (K, N, gs, M))
                b, by = bound_ms(weight_bytes + 2 * M * K + 2 * M * N, 2.0 * M * K * N)
                ref = QUANT_KERNELS[name][1]
                row = {"kernel": name, "bits": bits, "groupsize": gs, "signed": signed,
                       "model": model, "K": K, "N": N, "groups": leaves["scales"].shape[0],
                       "M": M, "max_abs_err": err, "tol": tol,
                       **timed(timer, lambda: fn(x, *args), w, x),
                       "plain_ms": timer.ms(lambda: ref(x, *args)),
                       "bound_ms": b, "bound_by": by}
                emit({"phase": "kernels", **row})
                rows.append(row)
            del w, leaves, args
    emit({"phase": "kernels", "prefill_sums": forward_sums(rows)})
    return rows


def phase_host(device):
    """Host time of one call of K1, K3, K4 and K5 at M = 1, the decode GEMV's path, at
    the 7B shapes with whole-column scales (K3 symmetric): the CPU time of a loop of
    HOST_CALLS calls with no synchronization inside it, after HOST_CALLS warm-up
    calls, the median of 5 loops, in us a call; and its sum over one decode step's 161
    linears. A loop queues at most 2 * HOST_CALLS kernels, fewer than the card's launch
    queue holds, so it never waits on the card: this is the wrapper's and the driver's
    cost of a launch."""
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    weight = LINEARS_PER_FORWARD["7B"]
    for name, bits, signed in (("quant_matmul_int4", 4, False), ("quant_matmul_int8", 8, True),
                               ("quant_matmul_int2", 2, False), ("quant_matmul_int3", 3, False)):
        fn = QUANT_KERNELS[name][0]
        rows = []
        for K, N in K1_SHAPES:
            if bits == 4:
                leaves = dict(zip(("qweight", "scales", "zeros"), synth_int4(g, K, N, 1, device)))
            else:
                leaves = synth_quant(g, bits, K, N, -1, device, signed)
            args = quant_args(name, leaves)
            x = torch.randn((1, K), generator=g, device=device).to(torch.bfloat16)
            loops = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fn(x, *args)
                loops.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
            rows.append({"K": K, "N": N, "host_us": statistics.median(loops[1:])})
            del leaves, args
        emit({"phase": "host", "kernel": name, "M": 1, "calls": HOST_CALLS, "shapes": rows,
              "host_ms_per_decode_step": sum(weight[r["K"], r["N"]] * r["host_us"]
                                             for r in rows) / 1e3})


def phase_quant_edges(g, device):
    """K3-K5 off the model shapes: ragged M and N, unvectorized loads, every GEMV row
    count, ragged scale groups (K3), stored rows past K (K4, K5). Correctness only."""
    for name, cases in QUANT_EDGES.items():
        bits = {"quant_matmul_int8": 8, "quant_matmul_int2": 2, "quant_matmul_int3": 3}[name]
        out = []
        for K, N, gs, Ms in cases:
            leaves = synth_quant(g, bits, K, N, gs, device, signed=gs < 0)
            for M in Ms:
                x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
                err, tol = check_quant(name, x, leaves, (K, N, gs, M))
                out.append({"K": K, "N": N, "stored_rows": leaves["qweight"].shape[0]
                            * {8: 1, 2: 4, 3: 4}[bits], "groups": leaves["scales"].shape[0],
                            "M": M, "max_abs_err": err, "tol": tol})
        emit({"phase": "kernels", "kernel": name, "edges": out})
    for name, bits, signed in STRUCTURED[1:]:
        structured_check(name, bits, signed, device)


def synth_7b_params(config: LLaMAConfig, g, device, fmt="int4", unit_gain=False, fp_out=None):
    """LLaMA params of a format, bf16 embedding and norms, one pack per layer:
    * int4: random packed-int4 bytes, whole-column scales 0.01 and zeros 7 (the int4
      tree layout of the quantized JAX checkpoints); with ``unit_gain``, the scales
      and zeros of the sub-4-bit recipe below;
    * gptq.int2 / gptq.int3 / the mix (int4 attention and head, int2 MLP in 64-row
      groups): random bytes over the padded rows, as `bench.py:73-180` makes them,
      but with the zero point at the mean level, (2**bits - 1) / 2, and the scale
      that gives each linear unit gain, 1 / (sqrt(K) * std of the levels). With
      bench.py's integer zeros the weights have a mean of +-scale / 2, the residual
      stream grows along one direction, the attention scores reach thousands and the
      softmax becomes a hard argmax in which bf16 rounding flips whole rows: one
      draw of the mix (and one of int4) gave a prefill-logit error of 0.088;
    * llm.int8: N(0, 0.02/8) bf16 weights drawn from ``g`` and quantized on the card
      by `int8_quantize_model(outliers=True)`, the load-time path of `load_model_any`;
      with ``fp_out`` (a dict), the bf16 tree is kept there as ``"tree"``.
    """
    L, D, H, V = config.n_layer, config.n_embd, config.n_hidden, config.padded_vocab_size
    bf16 = torch.bfloat16
    if fmt == "llm.int8":
        fp = init_params(g, config, dtype=bf16, device=device)
        if fp_out is not None:
            fp_out["tree"] = fp
        return int8_quantize_model(fp, outliers=True)
    _, bits, groupsize = parse_quant_mode("gptq.int4" if fmt == "int4" else fmt)

    def qlin(K, N, name, lead=()):
        nb = bits if isinstance(bits, int) else bits["head" if name == "lm_head" else name]
        gs = groupsize if nb < 4 else -1
        Kp = sub4_pad_rows(K, gs) if nb < 4 else K
        G = 1 if gs < 0 else Kp // gs
        rows = {4: K // 2, 2: Kp // 4, 3: Kp // 4}[nb]
        if fmt == "int4" and not unit_gain:
            scale, zero = 0.01, 7.0
        else:
            n_levels = 2**nb
            scale = 1.0 / math.sqrt(K * (n_levels**2 - 1) / 12)
            zero = (n_levels - 1) / 2
        out = {"qweight": torch.randint(0, 256, (*lead, rows, N), generator=g, device=device,
                                        dtype=torch.uint8),
               "scales": torch.full((*lead, G, N), scale, device=device),
               "zeros": torch.full((*lead, G, N), zero, device=device)}
        if nb == 3:
            out["qweight_hi"] = torch.randint(0, 256, (*lead, Kp // 8, N), generator=g,
                                              device=device, dtype=torch.uint8)
        return out

    return {
        "wte": {"weight": (torch.randn((V, D), generator=g, device=device) * 0.02).to(bf16)},
        "lm_head": qlin(D, V, "lm_head"),
        "ln_f": {"scale": torch.ones((D,), dtype=bf16, device=device)},
        "blocks": {
            "rms_1": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "attn": {"c_attn": qlin(D, 3 * D, "attn", (L,)), "c_proj": qlin(D, D, "attn", (L,))},
            "rms_2": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "mlp": {"c_fc1": qlin(D, H, "mlp", (L,)), "c_fc2": qlin(D, H, "mlp", (L,)),
                    "c_proj": qlin(H, D, "mlp", (L,))},
        },
    }


def launches_per_forward(fmt: str, L: int):
    """Quantized-kernel launches of one forward of a format: 5 linears per layer and
    the lm_head (on a tp rank: its shard of each, the quantized head whole)."""
    one = {"int4": "quant_matmul_int4", "llm.int8": "quant_matmul_int8",
           "llm.int8-dyn": "quant_matmul_int8", "gptq.int2": "quant_matmul_int2",
           "gptq.int3": "quant_matmul_int3"}
    if fmt in one:
        return {one[fmt]: 5 * L + 1}
    return {"quant_matmul_int4": 2 * L + 1, "quant_matmul_int2": 3 * L}  # the mix


def expect_launches(launches, want):
    """Every count as ``want`` says, and every kernel it does not name at 0."""
    assert all(launches[k] == want.get(k, 0) for k in launches), (launches, want)


def timed_generate(params, config, prompt, n, device, cuda_graph=True, caches=None, **kw):
    """`generate` of n greedy tokens (int4 KV cache) and its wall ms: the held program of
    its key (the default: captured at the key's first call, replayed after) or, with
    ``cuda_graph=False``, a fresh program run eagerly. ``caches``: a list the
    generation's KV cache is appended to (a copy of the held program's, or the fresh
    program's own). ``kw``: more arguments of `generate` (``max_seq_length``)."""
    keep = contextlib.nullcontext()
    if caches is not None and not cuda_graph:
        def kept(*args, **kwargs):
            caches.append(init_kv_cache(*args, **kwargs))
            return caches[-1]

        keep = mock.patch("lit_llama_ja_tpu_torch.infer.generate.init_kv_cache", kept)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with keep:
        out = generate(params, config, prompt, n, temperature=0.0, cache_dtype=torch.bfloat16,
                       quantize_kv="int4", device=device, cuda_graph=cuda_graph, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if caches is not None and cuda_graph:
        caches.append({k: v.clone() for k, v in generate_mod.PROGRAMS.last.cache.items()})
    return out, ms


def held_calls(calls, eager_ref):
    """Calls of held programs whose keys were built before (``calls``: ``(name, fn)``,
    each ``fn()`` returning ``(tokens, ms, caches)``), each gated: no program built, no
    capture (so no warm-up), no wrapper launch (a replay launches none), tokens and
    every cache's bytes equal to ``eager_ref(name)``'s. Returns a row a call: its wall
    ms, and the device ms of its prefill span's replay and of its steps' replays."""
    rows = []
    for name, fn in calls:
        built = generate_mod.PROGRAMS.built + speculative_mod.PROGRAMS.built
        _counts_zero()
        with probed_graphs() as caps, timed_runs() as runs:
            tokens, ms, caches = fn()
        launches = _counts()
        assert generate_mod.PROGRAMS.built + speculative_mod.PROGRAMS.built == built, name
        assert not caps, (name, [c["kind"] for c in caps])
        assert not any(launches.values()), (name, launches)
        want_tokens, want_caches = eager_ref(name)
        assert np.array_equal(tokens, want_tokens), f"{name}: held and fresh tokens differ"
        for got, want in zip(caches, want_caches, strict=True):
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            assert not bad, f"{name}: held and fresh caches differ in {bad}"
        torch.cuda.synchronize()
        span = [a.elapsed_time(b) for kind, a, b, _ in runs if kind == "span_replay"]
        step = [a.elapsed_time(b) for kind, a, b, _ in runs if kind == "replay"]
        assert len(span) == 1, (name, len(span))
        rows.append({"call": name, "wall_ms": ms, "prefill_replay_ms": span[0],
                     "step_replays": len(step), "step_replay_ms_sum": sum(step),
                     "captures": 0, "warmups": 0, "launches": 0, "tokens_equal_fresh": True,
                     "caches_equal_fresh": True})
    return rows


def graph_pool_bytes(pool=None):
    """Bytes of the segments the caching allocator holds for CUDA-graph pools, or for
    ``pool`` alone (None where the snapshot does not name a segment's pool)."""
    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in s for s in segs):
        return None
    if pool is not None:
        return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(pool))
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) != (0, 0))


def graph_pools():
    """The segments of every CUDA-graph pool, by pool id: their bytes, the bytes of
    their live blocks and the five largest live blocks (None where the snapshot does not
    name a segment's pool)."""
    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in s for s in segs):
        return None
    pools = {}
    for seg in segs:
        if tuple(seg["segment_pool_id"]) == (0, 0):
            continue
        row = pools.setdefault(str(tuple(seg["segment_pool_id"])),
                               {"bytes": 0, "live_bytes": 0, "live": []})
        row["bytes"] += seg["total_size"]
        live = [b["size"] for b in seg["blocks"] if b["state"] == "active_allocated"]
        row["live_bytes"] += sum(live)
        row["live"] = sorted(row["live"] + live, reverse=True)[:5]
    return pools


def phase_end(name: str) -> None:
    """The line after a phase: its held programs released (`release_programs`, which
    empties the allocator's cache), then the bytes the graph pools still hold and those
    pools (`graph_pools`), then the bytes left after a full garbage collection (a pool
    that only the collection frees was held by a dead reference cycle)."""
    torch.cuda.synchronize()
    held = sum(len(h.programs) for h in decode_graph.HeldPrograms.held)
    release_programs()
    line = {"phase": "phase_end", "of": name, "held_programs": held,
            "graph_pool_bytes": graph_pool_bytes(), "pools": graph_pools()}
    gc.collect()
    torch.cuda.empty_cache()
    emit({**line, "graph_pool_bytes_after_gc": graph_pool_bytes()})


def phase(fn, *args):
    """``fn(*args)``, then its `phase_end` line."""
    out = fn(*args)
    phase_end(fn.__name__)
    return out


def graph_kernels(graph):
    """The nodes of a graph captured with ``keep_graph=True``, read from the graph
    itself through the driver API: ``(number of nodes, {kernel name: kernel nodes})``.
    No node holds a child graph, so the kernel nodes are every kernel a replay
    launches."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(status, what):
        assert status == 0, f"{what}: CUresult {status}"

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    params = (ctypes.c_byte * 256)()  # a CUDA_KERNEL_NODE_PARAMS, its function first
    names = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        assert kind.value not in (4, 13), kind.value  # a child graph, a conditional node
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        ok(cu.cuGraphKernelNodeGetParams(ctypes.c_void_p(node), params),
           "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        func = ctypes.c_void_p.from_buffer(params).value
        ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
        key = name.value.decode()
        names[key] = names.get(key, 0) + 1
    return n.value, names


@contextlib.contextmanager
def probed_graphs():
    """Record every capture of a decode step or a prefill span (`infer/decode_graph.
    DecodeGraph`) inside, in order: ``kind`` ("step" or "span") and ``graph_id`` (the
    `DecodeGraph`'s id, which `graph_keys` maps to its key); ``launches``, the wrapper
    launches made while the body was captured (read
    by difference, so an outer count goes on); ``graph_kernels``, the port's kernel nodes
    of the captured graph itself by wrapper (`graph_kernels`, `port_counts`; the graph
    is captured with ``keep_graph=True`` to be read, then instantiated), beside
    ``graph_nodes`` and ``graph_other_kernels``; ``capture_ms`` and ``warmup_ms``, the
    wall ms of the capture (with its instantiation) and of the eager warm-up step before
    it (the device synchronized around each); and ``pool_bytes``, `graph_pool_bytes`
    after it, with ``own_pool_bytes`` the graph's own pool's."""
    seen = []
    capture, record = decode_graph.DecodeGraph.capture, decode_graph.DecodeGraph._record
    new_graph = torch.cuda.CUDAGraph

    def timed_capture(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen.append({"kind": self.kind, "graph_id": id(self)})
        capture(self)
        torch.cuda.synchronize()
        rec = seen[-1]
        rec.update(warmup_ms=(time.perf_counter() - t0) * 1e3 - rec["capture_ms"],
                   pool_bytes=graph_pool_bytes(),
                   own_pool_bytes=None if self.pool is None else graph_pool_bytes(self.pool))

    def counted_record(self, stream):
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        with mock.patch.object(torch.cuda, "CUDAGraph", lambda: new_graph(keep_graph=True)):
            graph = record(self, stream)
        torch.cuda.synchronize()
        after, t1 = _counts(), time.perf_counter()
        nodes, kernels = graph_kernels(graph)
        ours, other = port_counts(kernels.items())
        t2 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        seen[-1].update(capture_ms=(t1 - t0 + time.perf_counter() - t2) * 1e3,
                        launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
                        graph_nodes=nodes, graph_kernels=ours,
                        graph_other_kernels=sum(other.values()))
        return graph

    with mock.patch.object(decode_graph.DecodeGraph, "capture", timed_capture), \
            mock.patch.object(decode_graph.DecodeGraph, "_record", counted_record):
        yield seen


def of_kind(caps, kind="step"):
    """The records of `probed_graphs` of one kind: decode steps ("step"), prefill spans
    ("span"), training steps ("train") or validation losses ("val")."""
    return [c for c in caps if c["kind"] == kind]


def expect_captures(caps, per_step, n=None, kind="step"):
    """Each capture of a decode step (or of ``kind``: "train", "val") made the wrapper
    launches of one step, ``per_step``, and its graph holds the kernel nodes of the same
    (and there were ``n`` such captures, where given). Span captures are
    `expect_span_captures`'."""
    caps = of_kind(caps, kind)
    assert caps and (n is None or len(caps) == n), (len(caps), n)
    nodes = {k: v * KERNELS_PER_LAUNCH.get(k, 1) for k, v in per_step.items()}
    for rec in caps:
        expect_launches({k: rec["launches"].get(k, 0) for k in KERNELS}, per_step)
        expect_launches({**dict.fromkeys(KERNELS, 0), **rec["graph_kernels"]}, nodes)


def graph_keys(span_step):
    """``{id(graph): key}`` of a `SpanStep`'s (or a `PagedStep`'s) graphs."""
    return {id(gr): key for key, gr in span_step.graphs.items()}


def span_from0(key) -> bool:
    """Whether a span graph's key is a span from position 0: a paged span's key (P, AP,
    prefill_attn), or a stripe prefill's (P,), which always starts at 0."""
    return len(key) == 1 or bool(key[2])


def expect_span_captures(caps, span_step, per_span):
    """Each capture of a prefill span made the wrapper launches of one span of its key,
    ``per_span(from0)`` (from0: the span starts at position 0, so K2 runs on every
    layer), and its graph holds the kernel nodes of the same; one capture a key of
    ``span_step``. Returns the keys of the captures, in order."""
    keys = graph_keys(span_step)
    spans = of_kind(caps, "span")
    assert len(spans) == len(span_step.graphs) and {c["graph_id"] for c in spans} == set(keys), \
        (len(spans), list(span_step.graphs))
    for rec in spans:
        want = per_span(span_from0(keys[rec["graph_id"]]))
        expect_launches({k: rec["launches"].get(k, 0) for k in KERNELS}, want)
        expect_launches({**dict.fromkeys(KERNELS, 0), **rec["graph_kernels"]}, want)
    return [keys[c["graph_id"]] for c in spans]


def launched_spans(caps, span_step):
    """The spans that launched kernels in a captured run, as ``(start, P)`` (start 0 or
    not): each span capture's warm-up and capture, two a key."""
    keys = graph_keys(span_step)
    return [(0 if span_from0(keys[c["graph_id"]]) else 1, keys[c["graph_id"]][0])
            for c in of_kind(caps, "span") for _ in range(2)]


def capture_totals(caps):
    """The decode steps' captures (count, capture and warm-up ms), the prefill spans'
    (``span_*``), and the bytes of the graph pools after the last."""
    steps, spans = of_kind(caps), of_kind(caps, "span")
    return {"captures": len(steps), "capture_ms": sum(c["capture_ms"] for c in steps),
            "warmup_ms": sum(c["warmup_ms"] for c in steps),
            "span_captures": len(spans), "span_capture_ms": sum(c["capture_ms"] for c in spans),
            "span_warmup_ms": sum(c["warmup_ms"] for c in spans),
            "graph_pool_bytes": caps[-1]["pool_bytes"] if caps else None}


@contextlib.contextmanager
def timed_runs():
    """CUDA events around every run of a decode step, a prefill span, a training step or
    a validation loss (`DecodeGraph.run`) inside: a list of ``(kind, start, end, graph
    id)``, ``kind`` "replay", "capture" (the warm-up step and the capture) or "eager" for
    a step, the same with "span_", "train_" or "val_" before it for the others."""
    runs, run = [], decode_graph.DecodeGraph.run

    def timed(self):
        kind = ("eager" if not self.capture_enabled
                else "capture" if self.graph is None else "replay")
        if self.kind != "step":
            kind = f"{self.kind}_{kind}"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(self)
        end.record()
        runs.append((kind, start, end, id(self)))

    with mock.patch.object(decode_graph.DecodeGraph, "run", timed):
        yield runs


def clone_tree(tree):
    """A tree of copies of ``tree``'s leaves."""
    return unflatten_tree({k: v.detach().clone() for k, v in flatten_tree(tree).items()})


def trained_state(params, opt_state):
    """The trained leaves of ``params`` (those with AdamW moments) and both moments,
    flat."""
    mu = flatten_tree(opt_state["mu"])
    flat = flatten_tree(params)
    return {k: flat[k] for k in mu}, mu, flatten_tree(opt_state["nu"])


def _rel(got, want, scale) -> float:
    """``||got - want|| / ||scale||``, 0 where both differences are empty."""
    diff = (got.float() - want.float()).norm().item()
    norm = scale.float().norm().item()
    return diff / norm if norm else (0.0 if diff == 0 else float("inf"))


def train_pair(make_step, fresh, batches, per_step, *, tokens_per_step, flops_per_step=None,
               step_args=lambda: ()):
    """A phase's timed training steps, captured (``make_step(True)``: the main path, one
    CUDA graph) and eager (``make_step(False)``), each from fresh params and optimizer
    state (``fresh()``, the same values each call, separate tensors) over the same
    ``batches`` (``step_args()``: the step's further arguments, made anew for each run,
    such as a dropout generator seeded alike). Gates: the captured run's wrapper
    launches two steps' (the warm-up and the capture), the eager run's every step's
    (``per_step`` a step); the one graph's kernel nodes one step's; after the same
    steps, the losses within RESUME_REL_TOL, every trained leaf within STATE_REL_TOL of
    the eager run's change of it, each AdamW moment within STATE_REL_TOL of the eager
    one, the counts equal. Then one more replay under the profiler (the busy share).
    Step ms: CUDA events around each replay, and around each eager step."""
    line, kept = {}, {}
    for captured in (True, False):
        params, state = fresh()
        start = {k: v.detach().clone() for k, v in trained_state(params, state)[0].items()}
        step = make_step(captured)
        args = step_args()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _counts_zero()
        losses, events = [], []
        t0 = time.perf_counter()
        with probed_graphs() as caps, timed_runs() as runs:
            for b in batches:
                a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                loss = step(params, state, b, *args)[2]
                e.record()
                losses.append(float(loss))
                events.append((a, e))
        secs = time.perf_counter() - t0
        launches = _counts()
        n = 2 if captured else len(batches)
        expect_launches(launches, {k: v * n for k, v in per_step.items()})
        call_ms = [a.elapsed_time(e) for a, e in events]
        row = {"losses": losses, "seconds": secs, "call_ms": call_ms,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "launches": {k: v for k, v in launches.items() if v}}
        if captured:
            expect_captures(caps, per_step, n=1, kind="train")
            rec = of_kind(caps, "train")[0]
            row.update(step_ms=each_run_ms(runs, "train_replay"),
                       capture_ms=rec["capture_ms"], warmup_ms=rec["warmup_ms"],
                       graph_pool_bytes=rec["pool_bytes"], graph_nodes=rec["graph_nodes"],
                       graph_kernels=rec["graph_kernels"],
                       graph_other_kernels=rec["graph_other_kernels"])
        else:
            assert not caps
            row["step_ms"] = float(np.median(call_ms))
        row["tokens_per_s"] = tokens_per_step / (row["step_ms"] / 1e3)
        if flops_per_step is not None:
            row["model_flop_share_of_989"] = (flops_per_step / (row["step_ms"] / 1e3)
                                              / BF16_FLOPS_PER_S)
        line["captured" if captured else "eager"] = row
        kept[captured] = (params, state, start, step, args)
    (pc, sc, start, step, args), (pe, se, _, _, _) = kept[True], kept[False]
    cap, eag = line["captured"]["losses"], line["eager"]["losses"]
    loss_rel = max(abs(c - e) / abs(e) for c, e in zip(cap, eag))
    assert all(np.isfinite([*cap, *eag])) and loss_rel <= RESUME_REL_TOL, (cap, eag)
    (lc, muc, nuc), (le, mue, nue) = trained_state(pc, sc), trained_state(pe, se)
    leaf_rel = {k: _rel(lc[k], le[k], le[k] - start[k]) for k in le}
    moment_rel = {**{f"mu/{k}": _rel(muc[k], mue[k], mue[k]) for k in mue},
                  **{f"nu/{k}": _rel(nuc[k], nue[k], nue[k]) for k in nue}}
    worst = max([*leaf_rel.values(), *moment_rel.values()])
    assert worst <= STATE_REL_TOL, (
        {k: v for k, v in {**leaf_rel, **moment_rel}.items() if v > STATE_REL_TOL})
    assert int(sc["count"]) == int(se["count"]) == len(batches)
    del kept, pe, se, le, mue, nue
    release_programs()
    prof = profile_replay(lambda: float(step(pc, sc, batches[0], *args)[2]))
    return {**line, "steps": len(batches), "loss_max_rel_diff": loss_rel,
            "leaf_max_rel_diff": max(leaf_rel.values()),
            "moment_max_rel_diff": max(moment_rel.values()),
            "replay_profile": {k: prof[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                                    "n_kernel_launches", "port_kernels",
                                                    "top")}}


def run_ms(runs, kind):
    """Device ms a decode step over the runs of ``kind`` (`timed_runs`), which follow one
    another: from the first one's start to the last one's end, over their number."""
    mine = [r for r in runs if r[0] == kind]
    torch.cuda.synchronize()
    return mine[0][1].elapsed_time(mine[-1][2]) / len(mine)


def span_label(key) -> str:
    """A span graph's key as text: "P", or "P/AP/0" (from position 0) or "P/AP/+" (past
    it)."""
    return str(key[0]) if len(key) == 1 else f"{key[0]}/{key[1]}/{'0' if key[2] else '+'}"


def span_ms(runs, span_step, captured):
    """The median ms of one prefill span (CUDA events around each run, `timed_runs`) by
    key (`span_label`): the replays of a captured run (``captured``), with the warm-up
    and capture of each key apart, or the spans of an eager run. Event time: an eager
    span's includes the device's waits on the host."""
    keys = graph_keys(span_step)
    torch.cuda.synchronize()
    out = {}
    for kind in (("span_replay", "span_capture") if captured else ("span_eager",)):
        by_key = {}
        for k, a, b, gid in runs:
            if k == kind:
                by_key.setdefault(keys[gid], []).append(a.elapsed_time(b))
        out[kind[5:]] = {span_label(key): {"ms_median": float(np.median(v)), "n": len(v)}
                         for key, v in sorted(by_key.items())}
    return out


def port_counts(kernels):
    """Device kernels given as ``(name, count)`` pairs: the port's counted by the wrapper
    that launches them (`TRACE_NAMES`), and every other kernel's count by name."""
    ours, other = {}, {}
    for name, count in kernels:
        hit = [w for w, parts in TRACE_NAMES.items() if any(p in name for p in parts)]
        if hit:
            ours[hit[0]] = ours.get(hit[0], 0) + count
        else:
            other[name[:80]] = other.get(name[:80], 0) + count
    return ours, other


def trace_launches(prof):
    """The kernels of a `torch.profiler` trace, by `port_counts`."""
    from torch.autograd import DeviceType

    return port_counts((e.key, e.count) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)


def profile_replay(run, top=12):
    """One replay (``run``) under `torch.profiler`, after the device is idle: the device
    time of every kernel by name (the top ``top``), the sum over the quantized GEMVs, the
    wall time of the replay and the share of it in which a kernel ran (the profiler's
    own host time lengthens the wall time, so the share is a lower bound), and the
    kernels of the port counted by wrapper (`trace_launches`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)  # margins: no kernel of the replay near an end of the window
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.01)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    gemv = [(ms, c) for n, ms, c in kernels if "gemv" in n and ("qmm" in n or "a8_gemv" in n)]
    ours, other = trace_launches(prof)
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "gemv_ms": sum(ms for ms, _ in gemv), "gemv_kernel_launches": sum(c for _, c in gemv),
            "n_kernel_launches": sum(c for _, _, c in kernels), "port_kernels": ours,
            "other_kernels": len(other),
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in kernels[:top]]}


def prefill_logits(params, config, prompt, new, device):
    """The f32 logits of a generation's prefill forward (the prompt in its bucket, an
    int4 KV cache for ``new`` more tokens)."""
    T = len(prompt)
    P = bucket_length(T)
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :T] = torch.as_tensor(prompt, device=device)
    cache = init_kv_cache(config, 1, T + new, torch.bfloat16, "int4", device=device)
    return forward_with_cache(params, idx, torch.arange(P), cache, config,
                              prefill_attn=True, device=device)[0].float()


def phase_generate(g, device, fmt="int4", paths=None):
    """One 7B generation of ``fmt`` on the held program of its key, built and captured
    by this call (the main path: the prefill span and the decode step, each a graph),
    then the same with every body eager (``cuda_graph=False``): greedy tokens and the
    int4 KV cache's bytes equal, the launch counts of both (each capture's too; the span
    graph's kernel nodes one prefill's), the decode ms a token over the replays beside
    the eager one. Then two more calls of the held key (`held_calls`: the same prompt,
    and a HELD_PROMPT-token one in the same bucket with the key's cache slots), each
    gated to build, capture and launch nothing and to give a fresh eager call's tokens
    and cache bytes; the prefill alone held (a second call) and eager; the program's
    pool bytes. The held programs are released before the plain-version checks. With
    ``paths``, the int4, llm.int8,
    gptq.int2 and gptq.int3 runs also run `generate_a8` (llm.int8: on its bf16 weights
    quantized again as llm.int8-dyn), recording its counts there."""
    config = LLaMAConfig.from_name("7B")
    assert llama_configs["7B"] == dict(n_layer=32, n_head=32, n_embd=4096)
    L = config.n_layer
    t_build = time.perf_counter()
    fp = {} if fmt == "llm.int8" and paths is not None else None
    params = synth_7b_params(config, g, device, fmt, fp_out=fp)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    T, new = 500, 16
    prompt = torch.randint(0, config.vocab_size, (T,), generator=g, device=device).cpu().numpy()

    # warm-up: allocator, rope table, libraries; a fresh program, so nothing is held
    timed_generate(params, config, prompt, 1, device, cuda_graph=False)
    per_forward = launches_per_forward(fmt, L)
    prefill = {**per_forward, "flash_attention_fwd": L}  # one prefill forward's launches
    caches = []
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    built = generate_mod.PROGRAMS.built
    with probed_graphs() as caps, timed_runs() as runs:
        out_a, total_ms = timed_generate(params, config, prompt, new, device, caches=caches)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    program = generate_mod.PROGRAMS.last
    assert generate_mod.PROGRAMS.built == built + 1
    expect_captures(caps, per_forward, n=1)  # the cache holds every position: no roll
    # the held prefill: one span graph whose kernel nodes are one prefill's launches
    expect_span_captures(caps, program.span, lambda _: prefill)
    # the first call of a key: the span's warm-up and capture, then the step's
    steps = 2 * len(of_kind(caps))
    expect_launches(launches, {k: 2 * prefill.get(k, 0) + steps * per_forward.get(k, 0)
                               for k in prefill})
    span_cap = of_kind(caps, "span")[0]
    pool_bytes = graph_pool_bytes(program.span.pool)
    assert out_a.shape == (T + new,) and (out_a[:T] == prompt).all()
    assert ((out_a >= 0) & (out_a < config.padded_vocab_size)).all()

    _counts_zero()
    with timed_runs() as eager_runs:
        out_b, eager_ms = timed_generate(params, config, prompt, new, device,
                                         cuda_graph=False, caches=caches)
    eager_launches = _counts()
    expect_launches(eager_launches, {**{k: v * new for k, v in per_forward.items()},
                                     "flash_attention_fwd": L})
    assert (out_a == out_b).all(), "captured and eager greedy tokens differ"
    kv_equal = [key for key in caches[0] if not torch.equal(caches[0][key], caches[1][key])]
    assert not kv_equal, f"captured and eager KV caches differ in {kv_equal}"
    # two more calls of the held key: the same prompt, then another in the 512 bucket
    # (HELD_PROMPT tokens, its cache pinned to the first's T + new slots, the key's S)
    prompt_b = np.random.default_rng(SEED + 47).integers(0, config.vocab_size, HELD_PROMPT)
    fresh_caches = []
    out_c, _ = timed_generate(params, config, prompt_b, new, device, cuda_graph=False,
                              caches=fresh_caches, max_seq_length=T + new)
    fresh = {"same_prompt": (out_b, caches[1:2]), "bucket_prompt": (out_c, fresh_caches)}

    def held(p, **kw):
        kept = []
        out, ms = timed_generate(params, config, p, new, device, caches=kept, **kw)
        return out, ms, kept

    held_rows = held_calls(
        (("same_prompt", lambda: held(prompt)),
         ("bucket_prompt", lambda: held(prompt_b, max_seq_length=T + new))),
        fresh.get)
    del caches, fresh, fresh_caches
    # the prefill alone (one new token): eager, then a held key's second call
    _, prefill_ms_eager = timed_generate(params, config, prompt, 1, device, cuda_graph=False)
    timed_generate(params, config, prompt, 1, device)
    _, prefill_ms = timed_generate(params, config, prompt, 1, device)
    release_programs()

    # prefill logits, kernel path vs the plain versions of every kernel on the card
    got = prefill_logits(params, config, prompt, new, device)
    with plain_versions():
        want = prefill_logits(params, config, prompt, new, device)
    P = bucket_length(T)
    assert got.shape == (1, P, config.padded_vocab_size) and torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (fmt, rel, agree)
    decode_ms, eager_decode_ms = run_ms(runs, "replay"), run_ms(eager_runs, "eager")
    if fmt in PROFILED_FORMATS:
        emit({"phase": "decode_profile", "config": "7B", "format": fmt,
              **profile_decode_step(params, config, prompt, device, per_forward)})
    weights = {"int4": "int4, G=1", "llm.int8": "llm.int8 (static bf16 outlier rows)",
               "gptq.int2": "int2, G=1", "gptq.int3": "int3, G=1",
               "gptq.mix-a4m2h4-g64": "int4 attention and head G=1, int2 MLP in 64-row groups"}
    emit({"phase": "generate", "config": "7B", "format": fmt, "n_layer": L,
          "weights": weights[fmt], "kv_cache": "int4", "prompt": T, "bucket": P,
          "new_tokens": new, "weight_bytes": weight_bytes, "build_s": build_s,
          "launches": {k: v for k, v in launches.items() if v},
          "eager_launches": {k: v for k, v in eager_launches.items() if v},
          "launches_per_forward": {**per_forward, "flash_attention_fwd": L},
          "launches_per_capture": of_kind(caps)[0]["launches"],
          "graph_nodes": of_kind(caps)[0]["graph_nodes"],
          "graph_other_kernels": of_kind(caps)[0]["graph_other_kernels"],
          **capture_totals(caps), "span_graph_nodes": span_cap["graph_nodes"],
          "span_graph_kernels": span_cap["graph_kernels"], "program_pool_bytes": pool_bytes,
          "prefill_ms": prefill_ms, "prefill_ms_eager": prefill_ms_eager,
          "first_call_ms": total_ms, "total_ms": total_ms, "eager_total_ms": eager_ms,
          "held_calls": held_rows,
          "decode_ms_per_token": decode_ms, "decode_tok_s": 1e3 / decode_ms,
          "replays": new - 1 - steps // 2, "eager_decode_ms_per_token": eager_decode_ms,
          "peak_mem_bytes": peak, "logits_rel_err": rel, "argmax_agree": agree,
          "tokens_equal_eager": True, "kv_cache_equal_eager": True,
          "tokens": out_a[T:].tolist()})
    if fmt in A8_RULES and paths is not None:
        paths[f"generate_{fmt}_a8"] = generate_a8(params, config, prompt, fmt,
                                                  (out_a, decode_ms), device)
    if fp is not None:  # llm.int8: its bf16 weights quantized again as llm.int8-dyn
        del params
        params = int8_quantize_model(fp.pop("tree"), outliers="dynamic")
        paths["generate_llm.int8-dyn_a8"] = generate_a8(params, config, prompt,
                                                        "llm.int8-dyn", None, device)
    del params
    release_programs()
    return launches


def a8_rule(fmt, plain=False):
    """A patch of `quant/linear`'s wrapper of ``fmt``'s width under the JAX package's chip
    dispatch (`A8_RULES`): the A8 mode at M up to its rows (every M for llm.int8-dyn;
    for int2 only whole-column packs, as the JAX function picks), the exact kernel
    otherwise; with ``plain``, the plain versions of both."""
    wrapper, a8_name, max_m = A8_RULES[fmt]
    exact_fn, exact_ref, _ = QUANT_KERNELS[wrapper]
    a8_fn, a8_ref, _ = A8_KERNELS[a8_name]
    a8, exact = (a8_ref, exact_ref) if plain else (a8_fn, exact_fn)

    def rule(x, *args):
        rows = x.numel() // x.shape[-1]
        whole = args[-2].shape[-2] == 1 or wrapper != "quant_matmul_int2"
        return (a8 if max_m is None or (rows <= max_m and whole) else exact)(x, *args)

    return mock.patch(f"lit_llama_ja_tpu_torch.quant.linear.{wrapper}", rule)


def generate_a8(params, config, prompt, fmt, exact, device):
    """A 7B generation of ``fmt`` under `a8_rule`, its decode steps captured with the
    rule in force: A8_NEW greedy tokens, launch counts (gated, each capture's too), the
    tokens of the same run eager (gated equal), the prefill logits against the plain
    versions of every kernel it used (gated), decode ms a token (over the replays, and
    eager) and the tokens beside the exact route's (``exact``: tokens and decode ms of
    the format's own run; None: the same tree through the exact route here).
    llm.int8-dyn also prints its prefill's live outlier columns a linear."""
    L, T, new = config.n_layer, len(prompt), A8_NEW
    wrapper, a8_name, max_rows = A8_RULES[fmt]
    per_forward = 5 * L + 1
    t_wall = time.perf_counter()
    # a held program replays the route it was captured with: none of the exact route is
    # kept into the rule, and none of the rule's out of it
    release_programs()
    if exact is None:
        timed_generate(params, config, prompt, 1, device, cuda_graph=False)
        with timed_runs() as runs:
            exact_tokens, _ = timed_generate(params, config, prompt, new, device)
        exact = (exact_tokens, run_ms(runs, "replay"))
        release_programs()
    with a8_rule(fmt):
        # warm-up: the A8 library's load
        timed_generate(params, config, prompt, 2, device, cuda_graph=False)
        _counts_zero()
        with probed_graphs() as caps, timed_runs() as runs:
            out, total_ms = timed_generate(params, config, prompt, new, device)
        launches = _counts()
        span_step = generate_mod.PROGRAMS.last.span
        with timed_runs() as eager_runs:
            out_eager, eager_ms = timed_generate(params, config, prompt, new, device,
                                                 cuda_graph=False)
        _, prefill_ms = timed_generate(params, config, prompt, 1, device, cuda_graph=False)
        release_programs()
        live = []
        top_k = linear_mod._top_k_indices

        def counted_top_k(v, k):
            idx = top_k(v, k)
            live.append(int((v[idx] > 6.0).sum()))  # quantize_int8_dynamic's threshold
            return idx

        with mock.patch.object(linear_mod, "_top_k_indices", counted_top_k):
            got = prefill_logits(params, config, prompt, new, device)
    with plain_versions(), a8_rule(fmt, plain=True):
        want = prefill_logits(params, config, prompt, new, device)
    wall_s = time.perf_counter() - t_wall
    expect_captures(caps, {a8_name: per_forward}, n=1)
    steps = 2 * len(of_kind(caps))  # the warm-up step and the capture: replays count nothing
    # the prefill span: its warm-up and capture, its graph's nodes one prefill's
    if max_rows is not None:  # the prefill exact, every decode step A8
        assert bucket_length(T) > max_rows
        span = {wrapper: per_forward}
        want_launches = {wrapper: 2 * per_forward, a8_name: per_forward * steps}
    else:
        span = {a8_name: per_forward}
        want_launches = {a8_name: per_forward * (2 + steps)}
    expect_span_captures(caps, span_step, lambda _: {**span, "flash_attention_fwd": L})
    expect_launches(launches, {**want_launches, "flash_attention_fwd": 2 * L})
    assert out.shape == (T + new,) and (out[:T] == prompt).all()
    assert (out == out_eager).all(), f"{fmt}: captured and eager A8 tokens differ"
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert torch.isfinite(got).all() and rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (
        fmt, rel, agree)
    same = np.asarray(out[T:]) == np.asarray(exact[0][T:T + new])
    decode_ms = run_ms(runs, "replay")
    line = {"phase": "generate_a8", "config": "7B", "format": fmt, "n_layer": L,
            "wall_s": wall_s, "rule": (f"{a8_name} at every M" if max_rows is None
                                       else f"{a8_name} at M <= {max_rows}, exact above"),
            "prompt": T, "new_tokens": new, "launches": {k: v for k, v in launches.items() if v},
            "launches_per_capture": of_kind(caps)[0]["launches"],
            "graph_nodes": of_kind(caps)[0]["graph_nodes"],
            **capture_totals(caps), "logits_rel_err": rel, "argmax_agree": agree, "prefill_ms": prefill_ms,
            "total_ms": total_ms, "eager_total_ms": eager_ms,
            "decode_ms_per_token": decode_ms, "replays": new - 1 - steps // 2,
            "eager_decode_ms_per_token": run_ms(eager_runs, "eager"),
            "exact_decode_ms_per_token": exact[1], "tokens_equal_eager": True,
            "tokens": out[T:].tolist(), "exact_tokens": exact[0][T:T + new].tolist(),
            "tokens_equal_exact": int(same.sum()),
            "first_difference": int(np.argmin(same)) if not same.all() else None}
    if fmt == "llm.int8-dyn":
        line["live_outlier_columns"] = {"linears": len(live), "total": sum(live),
                                        "max": max(live, default=0)}
    emit(line)
    return launches


def gated_replay_profile(run, want, tries=2, top=12):
    """`profile_replay` of one replay of a graph (``run``), its kernels of the port gated
    to ``want``: up to ``tries`` traces of the same graph, the counts of each one that
    counted otherwise kept in ``trace_misses``."""
    misses = []
    for _ in range(tries):
        prof = profile_replay(run, top)
        if prof["port_kernels"] == want:
            return {**prof, "trace_misses": misses}
        misses.append(prof["port_kernels"])
    raise AssertionError(f"the traces of {len(misses)} replays count {misses}, "
                         f"the graph {want}")


def profile_decode_step(params, config: LLaMAConfig, prompt, device, per_step, top=12,
                        reps=8):
    """One 7B decode step (M = 1, int4 KV cache, the prompt in the cache) captured as
    `generate` captures it (`infer/generate.decode_step`), ``reps`` replays timed (wall
    ms a replay, the device synchronized at the ends), and one replay under
    `torch.profiler` (`profile_replay`): the capture's wrapper launches are gated to
    ``per_step``, and the trace's kernels of the port to the same names and counts; the
    busy share is given of the profiled replay's wall and of the unprofiled one's."""
    T = len(prompt)
    P = bucket_length(T)
    runs = reps + 4  # the warm-up and capture, one replay, the timed ones, the profiled ones
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :T] = torch.as_tensor(prompt, device=device)
    cache = init_kv_cache(config, 1, max(P, T + runs + 1), torch.bfloat16, "int4", device=device)
    logits = forward_with_cache(params, idx, torch.arange(P), cache, config, prefill_attn=True,
                                device=device)[0]
    step = decode_step(params, config, cache, torch.argmax(logits[0, T - 1]), T, runs + 1,
                       temperature=0.0, device=device)
    with probed_graphs() as caps:
        step.run()  # the warm-up step and the capture
    expect_captures(caps, per_step, n=1)
    step.run()  # one replay, so the timed ones find everything warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step.run()
    torch.cuda.synchronize()
    replay_wall = (time.perf_counter() - t0) * 1e3 / reps
    prof = gated_replay_profile(step.run, caps[0]["graph_kernels"], top=top)
    traced = 1 + len(prof["trace_misses"])
    assert step.graphs[False].replays == reps + 1 + traced and not step.graphs[True].replays
    assert step.host_pos < step.S
    del step, cache
    return {**prof, "replay_ms": replay_wall,
            "busy_share_unprofiled": prof["kernel_ms"] / replay_wall,
            "launches_per_capture": caps[0]["launches"], **capture_totals(caps)}


def synth_sequence(config: LLaMAConfig) -> np.ndarray:
    """The synthetic corpus: one random 1024-token sequence from the seed, repeated."""
    return np.random.default_rng(SEED).integers(1, config.vocab_size, 1024).astype(np.uint16)


def write_synth_data(root: Path, config: LLaMAConfig):
    """Packed train and val chunk files of `synth_sequence`, a structure the model can
    learn within a few steps."""
    seq = synth_sequence(config)
    T1 = config.block_size + 1
    for split, n_files, blocks in (("train", 2, 64), ("val", 1, 8)):
        (root / split).mkdir(parents=True)
        builder = PackedDatasetBuilder(str(root / split), "synth", T1 * blocks, 0,
                                       vocab_size=config.vocab_size)
        builder.add_array(np.resize(seq, n_files * T1 * blocks))
        builder.write_reminder()


def model_flops_per_token(config: LLaMAConfig, T: int, frozen: bool = False) -> float:
    """Training flops per token without recompute: 6 per weight of every linear (the
    blocks' and the lm_head; the embedding is a gather), 4 where the linears are
    ``frozen`` (the forward and the input's gradient, no weight gradient: a LoRA step),
    plus 6 * L * T * D for the attention products q k^T and p v over the causal half,
    forward and backward."""
    D, H, L = config.n_embd, config.n_hidden, config.n_layer
    linear = L * (D * 3 * D + D * D + 3 * D * H) + D * config.padded_vocab_size
    return (4.0 if frozen else 6.0) * linear + 6.0 * L * T * D


def _counts_zero():
    for fn in KERNELS.values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def plain_versions():
    """Every kernel wrapper that the model reaches replaced by its plain version."""
    stack = contextlib.ExitStack()
    for name, (_, ref, _) in QUANT_KERNELS.items():
        stack.enter_context(mock.patch(f"lit_llama_ja_tpu_torch.quant.linear.{name}", ref))
    stack.enter_context(mock.patch(
        "lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_fwd",
        flash_attention_fwd_ref))
    return stack


def _losses(out_dir: Path, key="train_loss"):
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    return {r["iter"]: r[key] for r in records if key in r}


def run_cli(log, **kw):
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        pretrain_cli.main(**{**TRAIN, "model_size": TRAIN_MODEL, **kw})


def loss_and_grads(params, micro, config, device):
    """Loss and gradients of one micro-batch with bf16 compute, as the train step
    computes them."""
    leaves = flatten_tree(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        logits = forward(cast_floating(params, torch.bfloat16), micro[:, :-1], config,
                         device=device)
        loss = cross_entropy_loss(logits, micro[:, 1:])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, grads))


def phase_train(device):
    config = LLaMAConfig.from_name(TRAIN_MODEL)
    assert llama_configs[TRAIN_MODEL] == dict(n_layer=12, n_head=10, n_embd=780,
                                              vocab_size=35000)
    L, T = config.n_layer, config.block_size
    accum = TRAIN["batch_size"] // TRAIN["micro_batch_size"]
    per_step = L * accum  # K2 and K6 launches in one optimizer step
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    write_synth_data(WORK_DIR / "data", config)
    data = dict(train_data_dir=str(WORK_DIR / "data" / "train"),
                val_data_dir=str(WORK_DIR / "data" / "val"))
    log = WORK_DIR / "cli.log"
    run_dir, resumed_dir = WORK_DIR / "run", WORK_DIR / "resumed"
    mid = TRAIN["save_interval"] - 1  # the iteration of the first save
    save_state = pretrain_cli.save_train_state

    def save_and_keep_mid(path, params, opt_state, config, meta):
        save_state(path, params, opt_state, config, meta)
        if meta["iter"] == mid:  # the resumed run starts from this one
            shutil.copytree(path, resumed_dir / "state-latest")

    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    with mock.patch.object(pretrain_cli, "save_train_state", save_and_keep_mid), \
            probed_graphs() as caps:
        run_cli(log, out_dir=str(run_dir), **data)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    n_steps, n_val = TRAIN["max_iters"], TRAIN["max_iters"] // TRAIN["eval_interval"]
    # the CLI's step and its validation are one captured graph each: their warm-up and
    # capture launch the kernels, the replays of the later steps and batches do not
    one_step = {"flash_attention_fwd": per_step, "flash_attention_bwd": per_step}
    expect_captures(caps, one_step, n=1, kind="train")
    expect_captures(caps, {"flash_attention_fwd": L}, n=1, kind="val")
    expect_launches(launches, {"flash_attention_fwd": 2 * per_step + 2 * L,
                               "flash_attention_bwd": 2 * per_step})
    assert "using native C++ packed reader" in log.read_text()
    losses = _losses(run_dir)
    val = _losses(run_dir, "val_loss")
    assert sorted(losses) == list(range(n_steps)) and len(val) == n_val, (losses, val)
    assert all(np.isfinite(x) for x in [*losses.values(), *val.values()])
    assert losses[n_steps - 1] < losses[0], losses
    cli_ms = [float(m) for m in re.findall(r"iter \d+: loss \S+, time: (\S+)ms",
                                           log.read_text())]

    run_cli(log, out_dir=str(resumed_dir), resume=str(resumed_dir / "state-latest"), **data)
    resumed = _losses(resumed_dir)
    assert sorted(resumed) == list(range(mid + 1, n_steps)), resumed
    resume_rel = max(abs(resumed[i] - losses[i]) / abs(losses[i]) for i in resumed)
    assert resume_rel <= RESUME_REL_TOL, (resumed, losses)

    # TRAIN_STEPS optimizer steps without and with remat, captured and eager, each from
    # the same fresh params over the same batches
    init = init_params(torch.Generator().manual_seed(SEED), config, device=device)
    opt = make_adamw(1e-4)
    ds = pretrain_cli.create_dataset(data["train_data_dir"], [("synth", 1.0)], T + 1)
    it = iter(ds)
    batches = [np.stack([np.stack([next(it) for _ in range(TRAIN["micro_batch_size"])])
                         for _ in range(accum)]) for _ in range(TRAIN_STEPS)]
    tokens = accum * TRAIN["micro_batch_size"] * T
    flops = model_flops_per_token(config, T) * tokens

    def fresh():
        params = clone_tree(init)
        return params, opt.init(params)

    steps = {}
    for remat in (False, True):
        steps[remat] = train_pair(
            lambda cg: make_train_step(config, opt, remat=remat, compute_dtype=torch.bfloat16,
                                       device=device, cuda_graph=cg),
            fresh, batches, {"flash_attention_fwd": (2 if remat else 1) * per_step,
                             "flash_attention_bwd": per_step},
            tokens_per_step=tokens, flops_per_step=flops)
        release_programs()

    # one micro-batch: the kernel path's loss and gradients against the plain versions
    micro = torch.as_tensor(batches[0][0], device=device)
    got_loss, got = loss_and_grads(init, micro, config, device)
    with mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_fwd",
                    flash_attention_fwd_ref), \
         mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_bwd",
                    flash_attention_bwd_ref):
        want_loss, want = loss_and_grads(init, micro, config, device)
    grad_rel = {k: ((got[k].float() - want[k].float()).norm() / want[k].float().norm()).item()
                for k in want}
    assert abs(got_loss - want_loss) <= GRAD_LOSS_TOL, (got_loss, want_loss)
    assert all(np.isfinite(r) and r <= GRAD_REL_TOL for r in grad_rel.values()), grad_rel

    cap, eager = steps[False]["captured"], steps[False]["eager"]
    emit({"phase": "train", "config": TRAIN_MODEL, "n_layer": L, "n_embd": config.n_embd,
          "n_head": config.n_head, "T": T, "micro_batch": TRAIN["micro_batch_size"],
          "grad_accum": accum, "tokens_per_step": tokens, "compute_dtype": "bfloat16",
          "losses": [losses[i] for i in range(n_steps)], "val_losses": val,
          "resumed_losses": resumed, "resume_max_rel_diff": resume_rel,
          "cli_run_s": run_s, "cli_step_ms": cli_ms, "launches": launches,
          "cli_graphs": capture_kinds(caps),
          "step_ms": cap["step_ms"], "eager_step_ms": eager["step_ms"],
          "tokens_per_s": cap["tokens_per_s"], "eager_tokens_per_s": eager["tokens_per_s"],
          "model_flop_share_of_989": cap["model_flop_share_of_989"],
          "eager_model_flop_share_of_989": eager["model_flop_share_of_989"],
          "model_tflops_per_s": flops / (cap["step_ms"] / 1e3) / 1e12,
          "flop_formula": "6 * linear weights (blocks + lm_head) + 6 * L * T * D per token",
          "peak_mem_bytes": cap["peak_mem_bytes"], "eager_peak_mem_bytes": eager["peak_mem_bytes"],
          "remat_step_ms": steps[True]["captured"]["step_ms"],
          "remat_eager_step_ms": steps[True]["eager"]["step_ms"],
          "remat_peak_mem_bytes": steps[True]["captured"]["peak_mem_bytes"],
          "remat_eager_peak_mem_bytes": steps[True]["eager"]["peak_mem_bytes"],
          "steps": {"no_remat": steps[False], "remat": steps[True]},
          "grad_check": {"loss": got_loss, "plain_loss": want_loss,
                         "max_leaf_rel_err": max(grad_rel.values()), "leaf_rel_err": grad_rel}})
    return launches, run_dir / f"iter-{n_steps:06d}-ckpt"


def capture_kinds(caps):
    """Each capture of `probed_graphs` by kind: its count, capture and warm-up ms, and
    the graph pool's bytes after the last."""
    out = {}
    for kind in sorted({c["kind"] for c in caps}):
        mine = of_kind(caps, kind)
        out[kind] = {"captures": len(mine), "capture_ms": sum(c["capture_ms"] for c in mine),
                     "warmup_ms": sum(c["warmup_ms"] for c in mine),
                     "graph_nodes": [c["graph_nodes"] for c in mine]}
    if caps:
        out["graph_pool_bytes"] = caps[-1]["pool_bytes"]
    return out


def captured_and_eager(run, per_step, n_steps):
    """``run(cuda_graph)`` (a perplexity) with its windows or tokens captured, then eager:
    the captured value within CAPTURED_PPL_REL_TOL of the eager one (the difference
    printed), one graph holding one step's kernels (``per_step``), the captured run's
    launches two steps' (the warm-up and the capture) and the eager run's ``n_steps``
    steps'. Returns the captured value and the line of both: seconds, ms a step (CUDA
    events around the replays and the eager steps), capture ms, launches."""
    line, vals = {}, {}
    for captured in (True, False):
        torch.cuda.synchronize()
        _counts_zero()
        t0 = time.perf_counter()
        with probed_graphs() as caps, timed_runs() as runs:
            vals[captured] = run(captured)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, _counts()
        steps = 2 if captured else n_steps
        expect_launches(launches, {k: v * steps for k, v in per_step.items()})
        row = {"seconds": secs, "ms_per_step": each_run_ms(runs, "replay" if captured else "eager"),
               "launches": {k: v for k, v in launches.items() if v}}
        if captured:
            expect_captures(caps, per_step, n=1)
            row.update(capture_totals(caps), graph_nodes=caps[0]["graph_nodes"])
        else:
            assert not caps
        line["captured" if captured else "eager"] = row
    ppl, eager = vals[True], vals[False]
    rel = abs(ppl - eager) / eager
    assert np.isfinite(ppl) and rel <= CAPTURED_PPL_REL_TOL, (ppl, eager)
    return ppl, {**line, "eager_ppl": eager, "captured_rel_diff_eager": rel}


def eval_tree(params, config, tokens, want, device):
    """Perplexity of a (quantized) 125M tree in bf16 activations through the kernels, a
    window captured and replayed (the main path) and eager (`captured_and_eager`; the
    launches of a window: ``want`` and K2 on every layer), then with the plain versions
    of every kernel swapped in, eager."""
    tree = cast_params(params, torch.bfloat16)
    ppl, line = captured_and_eager(
        lambda cg: perplexity(tree, config, tokens, device=device, cuda_graph=cg),
        {**want, "flash_attention_fwd": config.n_layer}, EVAL_WINDOWS)
    with plain_versions():
        plain = perplexity(tree, config, tokens, device=device, cuda_graph=False)
    assert abs(ppl - plain) <= PPL_REL_TOL * plain, (ppl, plain)
    return {"ppl": ppl, "plain_ppl": plain, "rel_diff": abs(ppl - plain) / plain,
            "eval_s": line["captured"]["seconds"], **line,
            "launches": line["captured"]["launches"]}


@contextlib.contextmanager
def recorded_linear_solves():
    """Every `gptq_quantize_linear` call that `gptq_quantize_model` makes inside, in
    order: ``(w (K, N), H, keywords, (packed leaves, error))``."""
    seen, solve = [], pipeline_mod.gptq_quantize_linear

    def recorded(w, H, **kw):
        out = solve(w, H, **kw)
        seen.append((w, H, kw, out))
        return out

    with mock.patch.object(pipeline_mod, "gptq_quantize_linear", recorded):
        yield seen


def gptq_keys(solves):
    """The block keys of the recorded solves, as `quant/gptq.GPTQGraphs` keys them: (N,
    block width, bits, groupsize, sym, the block's offset in its group)."""
    keys = set()
    for w, _, kw, _ in solves:
        (K, N), bs, gs = w.shape, kw["blocksize"], kw["groupsize"]
        keys |= {(N, min(bs, K - i1), kw["bits"], gs, kw.get("sym", False),
                  0 if gs == -1 else i1 % gs) for i1 in range(0, K, bs)}
    return keys


def eager_resolves(solves, times):
    """Each recorded solve again from its weight and Hessian with its column loops eager
    (``cuda_graph=False``), timed as `gptq_quantize_model` times a solve: every packed
    leaf (the levels, scales and zeros) and the error must equal the captured solve's in
    bits. Returns ``[(name, seconds)]``."""
    out = []
    for (w, H, kw, (params, err)), (name, _) in zip(solves, times, strict=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, got_err = gptq_mod.gptq_quantize_linear(
            w, H, **{**kw, "graphs": None, "cuda_graph": False})
        torch.cuda.synchronize()
        out.append((name, time.perf_counter() - t0))
        bad = [k for k in params if not torch.equal(got[k], params[k])]
        assert set(got) == set(params) and not bad and torch.equal(got_err, err), (
            f"captured and eager {name} differ in {bad}, errors {float(err)} {float(got_err)}")
    return out


def solve_numbers(times, solves, prefix=""):
    """Seconds, columns a second and µs a column of a run's solves, in all and by
    linear."""
    by_name = {}
    for (name, sec), (w, *_) in zip(times, solves, strict=True):
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += sec
        acc[1] += w.shape[0]
    total, cols = sum(t for t, _ in by_name.values()), sum(c for _, c in by_name.values())
    return {f"{prefix}solve_s": total,
            f"{prefix}solve_s_by_name": {n: t for n, (t, _) in by_name.items()},
            f"{prefix}columns_per_s": cols / total, f"{prefix}us_per_column": total / cols * 1e6,
            f"{prefix}us_per_column_by_name": {n: t / c * 1e6 for n, (t, c) in by_name.items()}}


def gptq_solve_line(times, solves, caps, eager: bool):
    """A captured GPTQ run's solve numbers (`solve_numbers` of `gptq_quantize_model`'s
    ``solve_times``) and its block graphs (`probed_graphs`: how many, gated to one a
    distinct key, their capture and warm-up ms, nodes, and their pool's bytes after the
    last); with ``eager``, every solve again eager and equal in bits (`eager_resolves`),
    its numbers under ``eager_``."""
    graphs = of_kind(caps, "gptq")
    keys = gptq_keys(solves)
    assert len(graphs) == len(keys), (len(graphs), sorted(keys))
    line = {**solve_numbers(times, solves), "columns": sum(w.shape[0] for w, *_ in solves),
            "blocks": sum(-(-w.shape[0] // kw["blocksize"]) for w, _, kw, _ in solves),
            "graphs": len(graphs), "capture_ms": sum(c["capture_ms"] for c in graphs),
            "warmup_ms": sum(c["warmup_ms"] for c in graphs),
            "graph_nodes": [c["graph_nodes"] for c in graphs],
            "graph_pool_bytes": graphs[-1]["own_pool_bytes"]}
    errs = torch.stack([err.reshape(()) for *_, (_, err) in solves])
    assert bool(torch.isfinite(errs).all()), errs
    if eager:
        line.update(solve_numbers(eager_resolves(solves, times), solves, "eager_"),
                    captured_equal_eager=True)
    return line


def phase_quant_eval(device, ckpt):
    """The 125M ja model from the train phase's last checkpoint, its depth cut to its
    first EVAL_LAYERS layers (saved as a checkpoint of its own, which every mode reads):
    fp perplexity, GPTQ at four modes on calibration windows of the same data (save,
    then `load_model_any`), llm.int8 and llm.int8-dyn quantized at load, each perplexity
    through the kernels against the plain versions; then one decode-path perplexity with
    an int4 KV cache. Every GPTQ solve runs its column loops as replays of block graphs
    (the default), one graph a distinct key; GPTQ_EAGER_MODES solve again eager from the
    same Hessians, equal in bits (`gptq_solve_line`). Returns the kernel launches of the
    perplexity runs, summed."""
    config = LLaMAConfig.from_name(TRAIN_MODEL)
    T = config.block_size
    seq = synth_sequence(config)
    tokens = np.resize(seq, EVAL_WINDOWS * T + 1).astype(np.int64)
    calib = np.resize(seq, CALIB_WINDOWS * T).reshape(CALIB_WINDOWS, T).astype(np.int64)
    full, cfg = load_model_any(ckpt, device=device)
    assert cfg == config
    config = config.replace(n_layer=EVAL_LAYERS)
    L = config.n_layer
    flat = flatten_tree(full)
    fp = unflatten_tree({k: v[:L].clone() if k.startswith("blocks/") else v
                         for k, v in flat.items()})
    del full, flat
    ckpt = WORK_DIR / f"eval_l{L}"
    save_checkpoint(ckpt, fp, config)
    fp, cfg = load_model_any(ckpt, device=device)
    assert cfg == config
    per_window = {"gptq.int4": {"quant_matmul_int4": 5 * L + 1},
                  "gptq.int3": {"quant_matmul_int3": 5 * L + 1},
                  "gptq.int2-g64": {"quant_matmul_int2": 5 * L + 1},
                  "gptq.mix": {"quant_matmul_int4": 2 * L + 1, "quant_matmul_int2": 3 * L},
                  "llm.int8": {"quant_matmul_int8": 5 * L + 1},
                  "llm.int8-dyn": {"quant_matmul_int8": 5 * L + 1}}
    results = {"fp": eval_tree(fp, config, tokens, {}, device)}
    total = {k: 0 for k in KERNELS}
    for mode in (*GPTQ_MODES, "llm.int8", "llm.int8-dyn"):
        t0 = time.perf_counter()
        if mode.startswith("gptq"):
            _, bits, gs = parse_quant_mode(mode)
            times = []
            with probed_graphs() as caps, recorded_linear_solves() as solves:
                q = gptq_quantize_model(fp, config, calib, bits=bits, groupsize=gs,
                                        progress=False, solve_times=times)
            save_checkpoint(WORK_DIR / mode, q, config)
            del q
            q, _ = load_model_any(WORK_DIR / mode, device=device)
        else:
            solves = None
            q, _ = load_model_any(ckpt, mode, device=device)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        res = eval_tree(q, config, tokens, per_window[mode], device)
        for k, v in res["launches"].items():
            total[k] += v
        res.update(quantize_s=quantize_s,
                   weight_bytes=sum(t.numel() * t.element_size() for t in _leaves(q)))
        if solves is not None:
            res.update(gptq_solve_line(times, solves, caps, eager=mode in GPTQ_EAGER_MODES))
            del solves
        results[mode] = res
        if mode != "gptq.mix":
            del q
        else:
            mix = q
        release_programs()

    # teacher-forced through the cached decode path (M = 1: the GEMV kernels)
    tree = cast_params(mix, torch.bfloat16)
    kw = dict(quantize_kv="int4", windows=1, window=DECODE_WINDOW, device=device)
    dppl, dline = captured_and_eager(
        lambda cg: decode_path_perplexity(tree, config, tokens, cuda_graph=cg, **kw),
        per_window["gptq.mix"], DECODE_WINDOW)
    dlaunches = dline["captured"]["launches"]
    for k, v in dlaunches.items():
        total[k] += v
    with plain_versions():
        dplain = decode_path_perplexity(tree, config, tokens, cuda_graph=False, **kw)
    assert abs(dppl - dplain) <= PPL_REL_TOL * dplain, (dppl, dplain)
    emit({"phase": "quant_eval", "config": TRAIN_MODEL, "n_layer": L, "checkpoint": ckpt.name,
          "eval_tokens": EVAL_WINDOWS * T, "calib": [CALIB_WINDOWS, T], "results": results,
          "decode_path": {"format": "gptq.mix", "kv_cache": "int4", "window": DECODE_WINDOW,
                          "ppl": dppl, "plain_ppl": dplain, **dline, "launches": dlaunches}})
    return total


def calibration_profile(params, config: LLaMAConfig, calib, device):
    """The calibration forwards of `gptq_quantize_model`'s first layer as it runs them,
    each under `profile_replay` after a warm run: for each linear the activations that
    feed it (`capture_linear_input`) over one micro-batch (every window) and its Hessian
    update, then the block's forward (`block_forward`). Wall ms, kernel ms and busy
    share of each, profiled and not (`unprofiled_busy`)."""
    T = calib.shape[1]
    block = unstack_layers(params["blocks"], config.n_layer)[0]
    rope = build_rope_cache(config.block_size, config.head_dim, config.rope_base,
                            device=device)[:T]
    x = params["wte"]["weight"][torch.as_tensor(calib, device=device)].to(torch.bfloat16)

    def hessian(name):
        acts = capture_linear_input(block, x, rope, config, name)
        return hessian_update(*init_hessian(acts.shape[-1], device=device),
                              acts.reshape(-1, acts.shape[-1]))

    runs = {name: functools.partial(hessian, name) for name in SUBMODULES}
    runs["block_forward"] = lambda: block_forward(block, x, rope, config)
    out = {}
    for name, run in runs.items():
        run()
        prof = profile_replay(run, top=4)
        out[name] = {**{k: prof[k] for k in ("wall_ms", "kernel_ms", "busy_share", "top")},
                     **unprofiled_busy(run, prof["kernel_ms"])}
    return out


def unprofiled_busy(run, kernel_ms, reps=5):
    """The wall ms of ``run`` without the profiler (the mean of ``reps`` runs, the device
    synchronized at the ends) and the share of it that ``kernel_ms`` (one profiled
    run's kernel time) fills: the profiler's host time lengthens a profiled wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return {"wall_ms_unprofiled": wall, "busy_share_unprofiled": kernel_ms / wall}


def phase_gptq_7b(device):
    """GPTQ at the 7B's full width through `gptq_quantize_model` (gptq.int4 with
    actorder, `lm_head` included), its depth cut to one layer, bf16 weights from the
    seed as `init_params` draws them, calibrated on GPTQ_7B_WINDOWS 2048-token windows of
    the synthetic corpus. The solves run captured (the main path), one block graph a
    distinct key, then again eager from the same Hessians, equal in bits
    (`gptq_solve_line`). Then `attn.c_attn`'s solve again in a set of its own: one
    replay of its 128-column graph (profiled and not) and the whole solve profiled; and
    the calibration forwards' busy share (`calibration_profile`)."""
    config = LLaMAConfig.from_name("7B").replace(n_layer=1)
    g = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(g, config, dtype=torch.bfloat16, device=device)
    T = config.block_size
    calib = np.resize(synth_sequence(config), GPTQ_7B_WINDOWS * T).reshape(
        GPTQ_7B_WINDOWS, T).astype(np.int64)
    _, bits, gs = parse_quant_mode("gptq.int4")
    times = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with probed_graphs() as caps, recorded_linear_solves() as solves:
        q = gptq_quantize_model(params, config, calib, bits=bits, groupsize=gs, progress=False,
                                solve_times=times)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    assert all(bool(torch.isfinite(leaf).all()) for leaf in _leaves(q) if leaf.is_floating_point())
    del q
    line = gptq_solve_line(times, solves, caps, eager=True)

    w, H, kw, _ = solves[0]
    assert times[0][0] == "attn.c_attn"
    K, N = w.shape
    graphs = GPTQGraphs(device, capture=True)
    solve = functools.partial(gptq_mod.gptq_quantize_linear, w, H, **{**kw, "graphs": graphs})
    solve()
    graph = graphs.graphs[(N, kw["blocksize"], bits, gs, False, 0)]
    replay = profile_replay(graph.run, top=6)
    replay_wall = unprofiled_busy(graph.run, replay["kernel_ms"])
    whole = profile_replay(solve, top=6)
    graphs.close()
    del solves, graphs, solve, graph, w, H
    emit({"phase": "gptq_7b", "config": "7B", "n_layer": config.n_layer, "mode": "gptq.int4",
          "calib": [GPTQ_7B_WINDOWS, T], "quantize_s": quantize_s, **line,
          "calibration_s": quantize_s - line["solve_s"],
          "replay": {"key": [N, kw["blocksize"]], "columns": kw["blocksize"],
                     **{k: replay[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                               "n_kernel_launches", "top")},
                     **replay_wall},
          "solve_profiled": {"name": "attn.c_attn", "columns": K,
                             **{k: whole[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                                      "n_kernel_launches", "top")}},
          "calibration_forwards": calibration_profile(params, config, calib, device)})
    del params
    release_programs()


class CharTokenizer:
    """The finetune phase's stand-in tokenizer (nothing is downloaded): character ``c``
    is token ``synth_sequence[ord(c) % 1024]`` of the model's synthetic corpus; BOS 1,
    EOS 2. `decode` writes each token as a letter."""

    bos_id, eos_id, pad_id = 1, 2, 0

    def __init__(self, config: LLaMAConfig):
        self.table = synth_sequence(config).astype(np.int32)
        self.vocab_size = config.vocab_size

    def encode(self, s, bos=True, eos=False, max_length=-1, pad=False):
        ids = [self.table[ord(c) % len(self.table)] for c in s]
        ids = ([self.bos_id] if bos else []) + ids + ([self.eos_id] if eos else [])
        return np.asarray(ids[:max_length] if max_length > 0 else ids, np.int32)

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in np.asarray(ids).reshape(-1))


def write_sft_data(root: Path, tok, config: LLaMAConfig):
    """FT_SAMPLES copies of one instruction sample (`prepare_sample`, prompt masked): every
    batch is the same, so the logged losses move by the updates alone. And a text of the
    same sample, FT_EVAL_WINDOWS windows long."""
    examples = [{"instruction": FT_PROMPT, "input": "", "output": FT_OUTPUT}] * FT_SAMPLES
    samples = [prepare_sample(e, tok, 256) for e in examples]
    root.mkdir(parents=True, exist_ok=True)
    save_sft_dataset(samples, root / "train.pt")
    save_sft_dataset(samples[:4], root / "test.pt")
    one = generate_prompt(examples[0]) + FT_OUTPUT
    n_chars = FT_EVAL_WINDOWS * config.block_size  # with BOS: FT_EVAL_WINDOWS windows + 1
    text = root / "eval.txt"
    text.write_text((one * (n_chars // len(one) + 1))[:n_chars])
    return text


def quiet(fn, **kw):
    """``fn(**kw)`` with its standard output kept, and its device time: (result, output,
    seconds)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(**kw)
    torch.cuda.synchronize()
    return out, buf.getvalue(), time.perf_counter() - t0


def finetune_cli_run(main, variant, data: Path, ckpt: Path, out: Path, device, captured):
    """One run of a finetune CLI (its main, the shared loop's warm-up and intervals cut
    to the short run), its step and validation captured (the main path) or eager
    (``cuda_graph=False``): the returned params, the log, the seconds, the launches, the
    captures (`probed_graphs`), each step call's ms (CUDA events around it), and the
    trained leaves before the first step with the optimizer state after the last."""
    real = finetune_cli._finetune_driver
    make_step, make_val = step_mod.make_sft_train_step, trainer_mod.make_val_loss
    events, seen = [], {}

    def recording(*a, **k):
        fn = make_step(*a, **k, cuda_graph=captured)

        def run(params, opt_state, *rest):
            if not seen:
                seen["start"] = {p: t.detach().clone()
                                 for p, t in trained_state(params, opt_state)[0].items()}
            a0, a1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a0.record()
            res = fn(params, opt_state, *rest)
            a1.record()
            events.append((a0, a1))
            seen["state"] = res[1]
            return res

        run.pool = fn.pool
        return run

    _counts_zero()
    with mock.patch.object(finetune_cli, "_finetune_driver",
                           lambda **kw: real(**{**kw, **FT_SHORT})), \
            mock.patch.object(step_mod, "make_sft_train_step", recording), \
            mock.patch.object(trainer_mod, "make_val_loss",
                              functools.partial(make_val, cuda_graph=captured)), \
            probed_graphs() as caps, timed_runs() as runs:
        params, log, secs = quiet(main, data_dir=str(data), pretrained_path=str(ckpt),
                                  out_dir=str(out), learning_rate=FT_LR[variant],
                                  device=device, **FT_RUN)
    call_ms = [a.elapsed_time(b) for a, b in events]
    return {"params": params, "log": log, "seconds": secs, "launches": _counts(), "caps": caps,
            "runs": runs, "call_ms": call_ms, **seen}


def finetune_run(main, variant, data: Path, ckpt: Path, out: Path, base, device):
    """One finetune CLI, captured (the main path: logged losses finite and falling, K2/K6
    launches and graph nodes, and a PEFT save that holds its variant's keys and left the
    frozen leaves as loaded), then eager from the same checkpoint and batches: the
    losses, the validation loss, the trained leaves and the AdamW moments against the
    captured run's within `train_pair`'s tolerances."""
    L = llama_configs[FT_MODEL]["n_layer"]
    accum = FT_RUN["batch_size"] // FT_RUN["micro_batch_size"]
    # Adapter v1 trains nothing that reaches layer 0's self-attention, so autograd runs
    # no backward through it; v2 trains layer 0's rms_1, LoRA its c_attn
    bwd_layers = L - 1 if variant == "adapter" else L
    one_step = {"flash_attention_fwd": accum * L, "flash_attention_bwd": accum * bwd_layers}
    got = finetune_cli_run(main, variant, data, ckpt, out, device, captured=True)
    # the step graph and the validation graph launch at their warm-up and capture
    expect_captures(got["caps"], one_step, n=1, kind="train")
    expect_captures(got["caps"], {"flash_attention_fwd": L}, n=1, kind="val")
    launches, log, params = got["launches"], got["log"], got["params"]
    expect_launches(launches, {"flash_attention_bwd": 2 * accum * bwd_layers,
                               "flash_attention_fwd": 2 * (accum + 1) * L})
    losses = [float(x) for x in re.findall(r"iter \d+: loss (\S+),", log)]
    val = float(re.search(r"val loss (\S+)", log).group(1))
    assert len(losses) == FT_ITERS and all(np.isfinite([*losses, val])), log
    assert statistics.mean(losses[-2:]) < losses[0], (variant, losses)
    saved = out / f"iter-{FT_ITERS:06d}"

    eager = finetune_cli_run(main, variant, data, ckpt, out.with_name(out.name + "_eager"),
                             device, captured=False)
    expect_launches(eager["launches"], {
        "flash_attention_bwd": FT_ITERS * accum * bwd_layers,
        "flash_attention_fwd": (FT_ITERS * accum + FT_SHORT["eval_iters"]) * L})
    assert not eager["caps"]
    e_losses = [float(x) for x in re.findall(r"iter \d+: loss (\S+),", eager["log"])]
    e_val = float(re.search(r"val loss (\S+)", eager["log"]).group(1))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip([*losses, val], [*e_losses, e_val]))
    assert loss_rel <= RESUME_REL_TOL, (losses, val, e_losses, e_val)
    (lc, muc, nuc), (le, mue, nue) = (trained_state(r["params"], r["state"])
                                      for r in (got, eager))
    leaf_rel = {k: _rel(lc[k], le[k], le[k] - eager["start"][k]) for k in le}
    moment_rel = {**{f"mu/{k}": _rel(muc[k], mue[k], mue[k]) for k in mue},
                  **{f"nu/{k}": _rel(nuc[k], nue[k], nue[k]) for k in nue}}
    assert max([*leaf_rel.values(), *moment_rel.values()]) <= STATE_REL_TOL, (
        {k: v for k, v in {**leaf_rel, **moment_rel}.items() if v > STATE_REL_TOL})
    rec = of_kind(got["caps"], "train")[0]
    result = {"losses": losses, "val_loss": val, "eager_losses": e_losses, "eager_val_loss": e_val,
              "loss_max_rel_diff": loss_rel, "leaf_max_rel_diff": max(leaf_rel.values()),
              "moment_max_rel_diff": max(moment_rel.values()),
              "seconds": got["seconds"], "eager_seconds": eager["seconds"],
              "step_ms": each_run_ms(got["runs"], "train_replay"),
              "eager_step_ms": float(np.median(eager["call_ms"])),
              "capture_ms": rec["capture_ms"], "warmup_ms": rec["warmup_ms"],
              "graphs": capture_kinds(got["caps"]),
              "launches": {k: v for k, v in launches.items() if v}}
    del eager, le, mue, nue
    if variant == "full":
        assert (saved / "params.pt").exists(), list(out.iterdir())
        return result, saved
    flat = flatten_tree(params)
    pred = adapter_v2_trainable if variant == "adapter_v2" else lambda _: False
    keys = {"lora": set(LORA_KEYS), "adapter": {"adapter/adapter_wte", "adapter/gating_factor"},
            "adapter_v2": {p for p in flat if pred(p)}}[variant]
    npz = saved.with_suffix(".npz")
    with np.load(npz) as f:
        assert set(f.files) == keys, (variant, sorted(f.files))
    frozen = [p for p in base if not pred(p)]  # the base's leaves that did not train
    assert all(torch.equal(flat[p], base[p]) for p in frozen), variant
    return {**result, "npz_keys": len(keys), "frozen_leaves_identical": len(frozen)}, npz


def adapter_forwards(ids, n_prompt: int, eos_id: int) -> int:
    """Forwards of `generate_finetuned.main_adapter`: the prefill, then one a sampled
    token but an EOS that ends the loop."""
    return 1 + len(ids) - n_prompt - int(ids[-1] == eos_id)


def expect_key_error(fn, **kw):
    try:
        quiet(fn, **kw)
    except KeyError as e:
        assert "weight" in str(e), e
        return str(e)
    raise AssertionError(f"{fn.__name__} ran on a quantized base")


def phase_finetune(device, ckpt: Path):
    """(a) The 125M ja model from the train phase's checkpoint through the four finetune
    CLIs on an instruction dataset written here, then generation (LoRA on the fp base,
    Adapter v1 on gptq.int4 and llm.int8 bases, v2 on the fp base), evaluation against
    the plain kernels, the LoRA merge, and the two quantized-base errors the JAX package
    has too. Returns the launches of each main-path run."""
    config = LLaMAConfig.from_name(FT_MODEL)
    L = config.n_layer
    root = WORK_DIR / "finetune"
    tok = CharTokenizer(config)
    text = write_sft_data(root / "data", tok, config)
    base = flatten_tree(load_checkpoint(ckpt, device=device)[0])
    runs, outs = {}, {}
    paths = {"finetune": {k: 0 for k in KERNELS}}
    for variant, main in (("lora", finetune_cli.main_lora), ("adapter", finetune_cli.main_adapter),
                          ("adapter_v2", finetune_cli.main_adapter_v2),
                          ("full", finetune_cli.main_full)):
        runs[variant], outs[variant] = finetune_run(main, variant, root / "data", ckpt,
                                                    root / variant, base, device)
        for k, v in runs[variant]["launches"].items():
            paths["finetune"][k] += v
        release_programs()
    del base

    n_prompt = len(tok.encode(generate_prompt({"instruction": FT_PROMPT, "input": ""})))
    gen_kw = dict(prompt=FT_PROMPT, checkpoint_path=str(ckpt), tokenizer_path="char",
                  max_new_tokens=FT_NEW, temperature=0.0, device=device)
    per_forward = 5 * L + 1 + L  # the linears and the prefix through c_attn
    gens = {}
    with mock.patch("lit_llama_ja_tpu_torch.cli.generate_cli.load_tokenizer", lambda _: tok):
        for name, fn, kw, kernel in (
                ("lora", generate_finetuned.main_lora, dict(lora_path=str(outs["lora"])), None),
                ("adapter_gptq.int4", generate_finetuned.main_adapter,
                 dict(adapter_path=str(outs["adapter"]), quantize="gptq.int4"), "quant_matmul_int4"),
                ("adapter_llm.int8", generate_finetuned.main_adapter,
                 dict(adapter_path=str(outs["adapter"]), quantize="llm.int8"), "quant_matmul_int8"),
                ("adapter_v2", generate_finetuned.main_adapter,
                 dict(adapter_path=str(outs["adapter_v2"]), v2=True), None)):
            _counts_zero()
            ids, _, secs = quiet(fn, **gen_kw, **kw)
            launches = _counts()
            # `generate` (LoRA): its held prefill span's warm-up and capture; an
            # adapter's own loop: one eager prefill
            want = {"flash_attention_fwd": L if fn is generate_finetuned.main_adapter else 2 * L}
            if kernel is not None:
                want[kernel] = per_forward * adapter_forwards(ids, n_prompt, tok.eos_id)
            expect_launches(launches, want)
            again, _, _ = quiet(fn, **gen_kw, **kw)
            assert len(ids) > n_prompt and np.array_equal(ids, again), name
            assert ((ids >= 0) & (ids < config.padded_vocab_size)).all()
            paths[f"generate_{name}"] = launches
            gens[name] = {"new_tokens": len(ids) - n_prompt, "seconds": secs,
                          "launches": {k: v for k, v in launches.items() if v}}

        evals = {}
        for name, fn, kw, kernel in (
                ("lora", evaluate_cli.main_lora, dict(lora_path=str(outs["lora"])), None),
                ("adapter_gptq.int4", evaluate_cli.main_adapter,
                 dict(adapter_path=str(outs["adapter"]), quantize="gptq.int4"), "quant_matmul_int4"),
                ("adapter_v2", evaluate_cli.main_adapter,
                 dict(adapter_path=str(outs["adapter_v2"]), v2=True), None)):
            ev_kw = dict(datasets=str(text), checkpoint_path=str(ckpt), tokenizer_path="char",
                         device=device, **kw)
            _counts_zero()
            got, _, secs = quiet(fn, **ev_kw)
            launches = _counts()
            # the default forward (LoRA, merged) runs a captured window: its warm-up and
            # capture launch, the replays do not; an adapter's forward runs eagerly
            windows = 2 if name == "lora" else FT_EVAL_WINDOWS
            want = {"flash_attention_fwd": L * windows}
            if kernel is not None:
                want[kernel] = per_forward * windows
            expect_launches(launches, want)
            with plain_versions():
                plain, _, _ = quiet(fn, **ev_kw)
            ppl, plain = got[str(text)], plain[str(text)]
            assert np.isfinite(ppl) and abs(ppl - plain) <= PPL_REL_TOL * plain, (name, ppl, plain)
            paths[f"evaluate_{name}"] = launches
            evals[name] = {"ppl": ppl, "plain_ppl": plain, "rel_diff": abs(ppl - plain) / plain,
                           "seconds": secs, "launches": {k: v for k, v in launches.items() if v}}

        errors = {
            "lora_merge": expect_key_error(generate_finetuned.main_lora, **{
                **gen_kw, "lora_path": str(outs["lora"]), "quantize": "gptq.int4"}),
            "adapter_v2": expect_key_error(generate_finetuned.main_adapter, **{
                **gen_kw, "adapter_path": str(outs["adapter_v2"]), "v2": True,
                "quantize": "gptq.int4"}),
        }

    # the merged checkpoint against the base with the LoRA branch, bf16 compute
    merged_dir = root / "merged"
    quiet(convert_cli.convert_lora_weights, lora_path=str(outs["lora"]),
          checkpoint_path=str(ckpt), output_path=str(merged_dir), device=device)
    idx = torch.as_tensor(np.resize(synth_sequence(config), (2, 256)).astype(np.int64),
                          device=device)
    with torch.no_grad():
        merged = forward(cast_params(load_checkpoint(merged_dir, device=device)[0],
                                     torch.bfloat16), idx, config, device=device).float()
        branch = add_lora(load_checkpoint(ckpt, device=device)[0],
                          load_state_npz(outs["lora"], device=device))
        branch = forward(cast_params(branch, torch.bfloat16), idx, config, device=device).float()
    merge_rel = ((merged - branch).norm() / branch.norm()).item()
    merge_agree = (merged.argmax(-1) == branch.argmax(-1)).float().mean().item()
    assert merge_rel <= LOGIT_REL_TOL and merge_agree >= ARGMAX_AGREE, (merge_rel, merge_agree)
    emit({"phase": "finetune", "config": FT_MODEL, "checkpoint": ckpt.name,
          "samples": FT_SAMPLES, "T": 256, **FT_RUN, "learning_rates": FT_LR,
          "runs": runs, "generate": gens, "evaluate": evals,
          "merge": {"logits_rel_err": merge_rel, "argmax_agree": merge_agree},
          "quantized_base_errors": errors})
    del merged, branch
    release_programs()
    paths["lora_7B"] = phase_lora_7b(device)
    paths["adapter_7B"] = phase_adapter_7b(device)
    return paths


def mesh_ft_run(main, variant, data: Path, ckpt: Path, out: Path, device, **mesh):
    """One finetune CLI run of `MESH_FT` (`_finetune_driver`'s intervals cut: no validation, one
    save at the end) under deterministic CUDA algorithms: its step losses and step ms
    (recorded around `make_sft_train_step`), launches and host-staged bytes, and the
    params it returns."""
    real, make = finetune_cli._finetune_driver, step_mod.make_sft_train_step
    losses, times = [], []

    def recording(*a, **k):
        fn = make(*a, **k)

        def run(*b, **kb):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*b, **kb)
            losses.append(float(res[2]))
            times.append((time.perf_counter() - t0) * 1e3)
            return res
        return run

    _counts_zero()
    staged0 = mesh_mod.STAGED["bytes"]
    with deterministic(), \
            mock.patch.object(finetune_cli, "_finetune_driver",
                              lambda **kw: real(**{**kw, **MESH_FT_SHORT})), \
            mock.patch.object(step_mod, "make_sft_train_step", recording):
        params, _, secs = quiet(getattr(finetune_cli, main), data_dir=str(data),
                                pretrained_path=str(ckpt), out_dir=str(out),
                                learning_rate=FT_LR[variant], device=device, **MESH_FT, **mesh)
    return {"losses": losses, "step_ms": times, "seconds": secs, "launches": _counts(),
            "staged_bytes": mesh_mod.STAGED["bytes"] - staged0}, params


def par_finetune_refs(root: Path, ckpt: Path, device):
    """The finetune CLIs' one-rank references of the mesh runs, on the finetune phase's
    instruction data (written again under ``root``)."""
    config = LLaMAConfig.from_name(FT_MODEL)
    write_sft_data(root / "sft", CharTokenizer(config), config)
    ref = {}
    for main, variant, _ in MESH_FT_RUNS.values():
        if variant not in ref:
            ref[variant] = mesh_ft_run(main, variant, root / "sft", ckpt, root / f"{variant}_one",
                                       device)[0]
            release_programs()
    return ref


def par_finetune(root: Path, ckpt):
    """This rank's mesh finetune runs (`MESH_FT_RUNS`): each run's result and a digest
    of the bits of its replicated leaves (spec ``P()``)."""
    import hashlib

    out = {}
    for name, (main, variant, mesh) in MESH_FT_RUNS.items():
        res, params = mesh_ft_run(main, variant, root / "sft", Path(ckpt), root / name,
                                  torch.device("cuda"), **mesh)
        digest, flat = hashlib.sha256(), flatten_tree(params)
        replicated = sorted(p for p in flat if spec_of(p) == ())
        for p in replicated:
            digest.update(flat[p].detach().cpu().contiguous().numpy().tobytes())
        out[name] = {**res, "launches": {k: v for k, v in res["launches"].items() if v},
                     "replicated_leaves": len(replicated),
                     "replicated_digest": digest.hexdigest()}
        del params, flat
        release_programs()
    return out


def par_finetune_gate(ranks, ref, setup_s):
    """The mesh finetune runs against the one-rank references: losses within
    MESH_FT_TOL, the replicated leaves equal in bits on both ranks, K2 and K6 once a
    layer a micro-batch on each rank. Returns their launch counts."""
    L = llama_configs[FT_MODEL]["n_layer"]
    micro = MESH_FT["max_iters"] * MESH_FT["batch_size"] // MESH_FT["micro_batch_size"]
    paths, runs = {}, {}
    for name, (_, variant, mesh) in MESH_FT_RUNS.items():
        want = ref[variant]["losses"]
        got = [r["finetune"][name] for r in ranks]
        for r in got:
            assert len(r["losses"]) == MESH_FT["max_iters"] and all(np.isfinite(r["losses"]))
            assert max(abs(a - b) for a, b in zip(r["losses"], want)) <= MESH_FT_TOL, (
                name, r["losses"], want)
            # each rank holds its rows, or its heads, of every micro-batch
            expect_launches({k: r["launches"].get(k, 0) for k in KERNELS},
                            {"flash_attention_fwd": micro * L, "flash_attention_bwd": micro * L})
        assert len({r["replicated_digest"] for r in got}) == 1, name
        paths[f"parallel_finetune_{name}"] = {k: got[0]["launches"].get(k, 0) for k in KERNELS}
        runs[name] = {"mesh": mesh, "losses": got[0]["losses"], "one_rank_losses": want,
                      "max_loss_diff": max(abs(a - b) for r in got
                                           for a, b in zip(r["losses"], want)),
                      "step_ms": got[0]["step_ms"], "one_rank_step_ms": ref[variant]["step_ms"],
                      "staged_bytes_per_step": got[0]["staged_bytes"] / MESH_FT["max_iters"],
                      "replicated_leaves": got[0]["replicated_leaves"],
                      "replicated_equal_bits": True, "launches": got[0]["launches"]}
    emit({"phase": "parallel_finetune", "backend": "gloo", "world": len(ranks),
          "config": FT_MODEL, **MESH_FT, "T": 256, "runs": runs,
          "left_out": "main_adapter --tp 2 on a gptq.int4 base: the quantized kernels have "
                      "no backward on the card, so no step trains through a quantized base",
          "setup_s": setup_s, "ranks_s": ranks[0]["finetune_s"]})
    return paths


def phase_dryrun():
    """`dryrun.main(4)`: 4 gloo ranks on the card run one step of every parallel
    family (see the module docstring)."""
    t0 = time.perf_counter()
    out = dryrun.main(4)
    secs = time.perf_counter() - t0
    oks = [line for line in out["lines"] if line.startswith("dryrun_multichip(4): ")]
    assert len(oks) == 6 and all(" OK" in line for line in oks), out["lines"]
    assert set(out["loss"]) == {"train", "lora_sft", "gpipe", "moe_ep"}, out["loss"]
    assert all(np.isfinite(v) for v in out["loss"].values()), out["loss"]
    assert out["tokens"] == 9 and out["sp_logits_finite"], out
    launches = out["launches"]
    # rank 0: the 2 layers once each (one micro-batch) in the train and SFT steps; the
    # engine's pool is bf16 (the JAX function's default), so its decode attends in
    # PyTorch and K7 never runs; its one prefill runs K2 on the stage's one layer
    for step in ("train", "lora_sft"):
        expect_launches(launches[step], {"flash_attention_fwd": 2, "flash_attention_bwd": 2})
    expect_launches(launches["paged_engine"], {"flash_attention_fwd": 1})
    emit({"phase": "dryrun", "world": 4, "lines": out["lines"], "loss": out["loss"],
          "tokens": out["tokens"],
          "launches": {k: {n: c for n, c in v.items() if c} for k, v in launches.items()},
          "seconds": secs})
    return {f"dryrun_{k}": v for k, v in launches.items()}


def lora_grads(params, ids, labels, config, device, seed):
    """Loss and LoRA gradients of one micro-batch (bf16 compute, dropout from ``seed``)."""
    c_attn = params["blocks"]["attn"]["c_attn"]
    leaves = [c_attn["lora_A"], c_attn["lora_B"]]
    for t in leaves:
        t.requires_grad_(True)
    try:
        logits = forward(cast_floating(params, torch.bfloat16), ids, config, device=device,
                         dropout_generator=torch.Generator(device=device).manual_seed(seed),
                         dropout_rate=BIG_LORA["dropout"])
        loss = cross_entropy_loss(logits[:, :-1], labels[:, 1:])
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return float(loss.detach()), grads


def phase_lora_7b(device):
    """(b) LoRA optimizer steps of LLaMA-7B at full width and depth: a frozen bf16 base
    from the seed, LoRA on q and v (r 8, alpha 16, dropout 0.05 from a generator),
    2 micro-batches of 4 x 256 random tokens a step, the first quarter of each row
    masked as a prompt; TRAIN_STEPS steps captured and eager from the same LoRA init
    (`train_pair`). Gates: `train_pair`'s, frozen leaves untouched, one micro-batch's
    lora_B gradient against the same with the plain K2 and K6."""
    config = LLaMAConfig.from_name(FT_BIG)
    L, T, A, B = config.n_layer, BIG_LORA["T"], BIG_LORA["accum"], BIG_LORA["micro"]
    g = torch.Generator(device=device).manual_seed(SEED)
    base = init_params(g, config, dtype=torch.bfloat16, device=device)
    lora0 = init_lora_params(g, config, r=BIG_LORA["r"], alpha=BIG_LORA["alpha"], device=device)
    opt = make_adamw(BIG_LORA["lr"], weight_decay=0.0)

    def fresh():
        params = add_lora(base, clone_tree(lora0))
        return params, init_opt_state(opt, params, trainable_pred=lora_trainable)

    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(TRAIN_STEPS):
        ids = rng.integers(0, config.vocab_size, (A, B, T))
        labels = ids.copy()
        labels[..., : T // 4] = -1
        batches.append({"input_ids": ids, "labels": labels})
    frozen = flatten_tree(base)
    marks = {p: (t._version, int(t.view(torch.int16).sum(dtype=torch.int64)))
             for p, t in frozen.items()}
    tokens = A * B * T
    pair = train_pair(
        lambda cg: make_sft_train_step(config, opt, trainable_pred=lora_trainable,
                                       lora_dropout=BIG_LORA["dropout"],
                                       compute_dtype=torch.bfloat16, device=device,
                                       cuda_graph=cg),
        fresh, batches, {"flash_attention_fwd": A * L, "flash_attention_bwd": A * L},
        tokens_per_step=tokens,
        flops_per_step=model_flops_per_token(config, T, frozen=True) * tokens,
        step_args=lambda: (torch.Generator(device=device).manual_seed(SEED),))
    assert all((t._version, int(t.view(torch.int16).sum(dtype=torch.int64))) == marks[p]
               for p, t in frozen.items()), "a frozen leaf changed"

    params = add_lora(base, lora0)
    micro_ids = torch.as_tensor(batches[0]["input_ids"][0], device=device)
    micro_labels = torch.as_tensor(batches[0]["labels"][0], device=device)
    got_loss, got = lora_grads(params, micro_ids, micro_labels, config, device, SEED)
    with mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_fwd",
                    flash_attention_fwd_ref), \
         mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_bwd",
                    flash_attention_bwd_ref):
        want_loss, want = lora_grads(params, micro_ids, micro_labels, config, device, SEED)
    grad_rel = {name: ((a.float() - b.float()).norm() / b.float().norm()).item()
                for name, a, b in zip(("lora_A", "lora_B"), got, want)}
    assert np.isfinite(grad_rel["lora_B"]) and grad_rel["lora_B"] <= GRAD_REL_TOL, grad_rel
    n_lora = sum(t.numel() for t in lora0.values() if t.dim() > 1)
    emit({"phase": "lora_7B", "config": FT_BIG, "n_layer": L, "base_dtype": "bfloat16",
          "lora": {k: BIG_LORA[k] for k in ("r", "alpha", "dropout")}, "lora_values": n_lora,
          "micro_batch": B, "grad_accum": A, "T": T,
          "losses": pair["captured"]["losses"], "step_ms": pair["captured"]["step_ms"],
          "eager_step_ms": pair["eager"]["step_ms"],
          "tokens_per_s": pair["captured"]["tokens_per_s"],
          "peak_mem_bytes": pair["captured"]["peak_mem_bytes"],
          "eager_peak_mem_bytes": pair["eager"]["peak_mem_bytes"],
          "flop_formula": "4 * linear weights (frozen: no weight gradient) + 6 * L * T * D "
                          "per token",
          "frozen_leaves_untouched": len(frozen), "steps": pair,
          "grad_check": {"loss": got_loss, "plain_loss": want_loss, "rel_err": grad_rel}})
    launches = pair["captured"]["launches"]
    del params, base, lora0, frozen, got, want, pair
    release_programs()
    return {k: launches.get(k, 0) for k in KERNELS}


def phase_adapter_7b(device):
    """(c) LLaMA-Adapter v1 generation on a LLaMA-7B int4 base (`synth_7b_params`): a
    prefix of 10 rows N(0, 1) and gating N(0, 0.1) from the seed (nonzero, so the prefix
    branch shows), a 500-token prompt prefilled with ``prefill_attn`` into a bf16 cache,
    32 greedy tokens. Gates: K1 launches per forward (161 linears and the 32 prefix
    projections), repeatable tokens, prefill logits against the plain versions; prefill
    and decode times through `utils/profiling.timeit`."""
    config = LLaMAConfig.from_name(FT_BIG)
    acfg = AdapterConfig(**dataclasses.asdict(config))
    L, T, new = config.n_layer, ADAPTER_PROMPT, ADAPTER_NEW
    g = torch.Generator(device=device).manual_seed(SEED)
    params = synth_7b_params(config, g, device, "int4")
    adapter = init_adapter_params(g, acfg, dtype=torch.bfloat16, device=device)
    adapter["gating_factor"] = (0.1 * torch.randn(adapter["gating_factor"].shape, generator=g,
                                                  device=device)).to(torch.bfloat16)
    params = add_adapter(params, adapter)
    prompt = torch.randint(0, config.vocab_size, (1, T), generator=g, device=device)
    cache = init_kv_cache(acfg, 1, T + new, torch.bfloat16, device=device)

    def prefill():
        return adapter_forward_with_cache(params, prompt, torch.arange(T), cache, acfg,
                                          prefill_attn=True, device=device)[0]

    def decode(tok, pos):
        return adapter_forward_with_cache(params, tok.view(1, 1), torch.tensor([pos]), cache,
                                          acfg, device=device)[0]

    def run():
        tok = prefill()[0, -1].argmax()
        out = [tok]
        for i in range(new - 1):
            tok = decode(tok, T + i)[0, -1].argmax()
            out.append(tok)
        return torch.stack(out).cpu().numpy()

    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    tokens = run()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    per_forward = 5 * L + 1 + L
    expect_launches(launches, {"quant_matmul_int4": per_forward * new, "flash_attention_fwd": L})
    assert np.array_equal(tokens, run()), "greedy adapter generation is not repeatable"
    assert ((tokens >= 0) & (tokens < config.padded_vocab_size)).all()

    got = prefill().float()
    with plain_versions():
        want = prefill().float()
    assert got.shape == (1, T, config.padded_vocab_size) and torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)

    t_prefill = timeit(prefill, iters=5, warmup=1)
    tok = torch.as_tensor(tokens[:1], device=device)
    t_decode = timeit(decode, tok, T, iters=20, warmup=2)
    emit({"phase": "adapter_7B", "config": FT_BIG, "weights": "int4, G=1", "kv_cache": "bf16",
          "adapter_prompt_length": acfg.adapter_prompt_length,
          "adapter_start_layer": acfg.adapter_start_layer, "prompt": T, "new_tokens": new,
          "launches": {k: v for k, v in launches.items() if v},
          "launches_per_forward": {"quant_matmul_int4": per_forward},
          "logits_rel_err": rel, "argmax_agree": agree, "peak_mem_bytes": peak,
          "prefill_ms": t_prefill.wall_s * 1e3, "prefill_cuda_ms": t_prefill.cuda_s * 1e3,
          "prefill_cpu_ms": t_prefill.cpu_s * 1e3,
          "decode_ms_per_token": t_decode.wall_s * 1e3,
          "decode_cuda_ms_per_token": t_decode.cuda_s * 1e3,
          "decode_cpu_ms_per_token": t_decode.cpu_s * 1e3, "tokens": tokens.tolist()})
    del params, cache, got, want
    release_programs()
    return launches


def write_moe_corpus(root: Path):
    """The moe phase's line-based corpus from the seed: MOE_TEXT_FILES files of lines,
    each line one of MOE_SENTENCES random lowercase sentences (a structure the model
    can learn within a few steps)."""
    rng = np.random.default_rng(SEED + 7)
    sentences = ["".join(chr(97 + c) for c in rng.integers(0, 26, n))
                 for n in rng.integers(40, 200, MOE_SENTENCES)]
    root.mkdir(parents=True)
    lines = []
    for i in range(MOE_TEXT_FILES):
        part = [sentences[j] for j in rng.integers(0, MOE_SENTENCES, MOE_LINES)]
        (root / f"part{i}.txt").write_text("\n".join(part) + "\n")
        lines += part
    return lines


def moe_flops(config: MoEConfig, n_tokens: int, T: int) -> float:
    """Training flops of one micro-batch of ``n_tokens`` without recompute, counting the
    expert rows the layer computes (E * C, the dropped and empty slots included), not a
    dense MLP: 6 per weight per row of the attention linears, the router, the experts
    and the lm_head, plus 6 * L * T * D per token for q k^T and p v."""
    D, H, L, E = config.n_embd, config.n_hidden, config.n_layer, config.n_expert
    rows = E * config.capacity(n_tokens)
    per_layer = 6.0 * n_tokens * (D * 3 * D + D * D + D * E) + 6.0 * rows * 3 * D * H
    return L * per_layer + 6.0 * n_tokens * D * config.padded_vocab_size \
        + 6.0 * L * T * D * n_tokens


def moe_loss_and_grads(params, micro, config, device):
    """Loss, layer-mean aux and gradients of one micro-batch with bf16 compute (the
    router f32), as the MoE train step computes them."""
    leaves = flatten_tree(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        logits, aux = forward_moe(cast_floating(params, torch.bfloat16), micro[:, :-1], config,
                                  device=device)
        loss = cross_entropy_loss(logits, micro[:, 1:]) + moe_penalty(config, aux)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()},
            dict(zip(leaves, grads)))


def phase_moe(g, device):
    """MoE on one card, the user's path from text to serving, at the 125M ja config's
    full width and depth with 8 experts, top 2: (a) `prepare_cli.prepare_any_text` on
    a corpus written here (the finetune phase's character stand-in tokenizer), read
    back through `PackedDataset`; (b) the C++ reader against the Python reader and
    resumed with ``skip_batches``; (c) `pretrain_cli.main --moe-experts 8` through the
    C++ reader, MOE_ITERS steps and a ``--resume`` from the state saved after the
    second, with a gradient check against the plain K2/K6; (d) `generate` from its
    checkpoint (int4 KV cache) with the prefill logits against the plain versions; (e)
    `PagedEngine` over an int8 pool at serve_cli's defaults. Returns the launches of
    each main-path run."""
    config = MoEConfig.from_name(TRAIN_MODEL, **MOE)
    L, T, mb = config.n_layer, config.block_size, MOE_TRAIN["micro_batch_size"]
    accum = MOE_TRAIN["batch_size"] // mb
    root = WORK_DIR / "moe"
    shutil.rmtree(root, ignore_errors=True)
    tok = CharTokenizer(config)
    paths = {}
    phase_t0 = time.perf_counter()

    # (a) prepare
    lines = write_moe_corpus(root / "text")
    t0 = time.perf_counter()
    with mock.patch.object(prepare_cli, "_tokenizer", lambda _: tok):
        quiet(prepare_cli.prepare_any_text, source_path=str(root / "text"),
              tokenizer_path="char", destination_path=str(root / "data"),
              chunk_size=MOE_CHUNK, prefix="moe")
    prepare_s = time.perf_counter() - t0
    files = sorted(map(str, (root / "data").glob("moe_*.bin")))
    stream = np.concatenate([tok.encode(s, bos=True, eos=True) for s in lines])
    assert len(files) == -(-len(stream) // MOE_CHUNK), (len(files), len(stream))
    py_rows = np.stack(list(PackedDataset(files, len(files), T + 1, shuffle=False)))
    flat = py_rows.reshape(-1)  # the stream, then the last chunk's BOS padding
    assert np.array_equal(flat[: len(stream)], stream) and (flat[len(stream):] == tok.bos_id).all()

    # (b) the C++ reader: build, equal to the Python reader, resumed
    t0 = time.perf_counter()
    native_loader.build_native()
    native_build_s = time.perf_counter() - t0
    unshuffled = np.concatenate(list(NativePackedBatches(files, mb, T + 1, shuffle=False)))
    assert unshuffled.shape == py_rows.shape and np.array_equal(unshuffled, py_rows)
    kw = dict(batch_size=mb, block_size=T + 1, seed=SEED, wrap=True)
    drained = NativePackedBatches(files, **kw)
    want = [next(drained) for _ in range(MOE_SKIP + 3)][MOE_SKIP:]
    skipped = NativePackedBatches(files, skip_batches=MOE_SKIP, **kw)
    assert all(np.array_equal(next(skipped), w) for w in want)
    drained.close()
    skipped.close()

    # (c) pretraining through the CLI; the state after the second step is kept for the
    # resumed run, the intermediate parameter checkpoints are not written
    run_dir, resumed_dir = root / "run", root / "resumed"
    mid = MOE_TRAIN["save_interval"] - 1
    final = f"iter-{MOE_TRAIN['max_iters']:06d}-ckpt"
    save_state, save_params = pretrain_cli.save_train_state, pretrain_cli.save_checkpoint

    def keep_mid_state(path, params, opt_state, cfg, meta):
        if meta["iter"] == mid:
            save_state(resumed_dir / "state-latest", params, opt_state, cfg, meta)

    def final_params(path, params, cfg):
        if Path(path).name == final:
            save_params(path, params, cfg)

    log = root / "cli.log"
    run = dict(MOE_TRAIN, model_size=TRAIN_MODEL, train_data_dir=str(root / "data"),
               train_prefixes="moe", moe_experts=MOE["n_expert"], moe_topk=MOE["n_expert_active"],
               device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    t0 = time.perf_counter()
    with mock.patch.object(pretrain_cli, "save_train_state", keep_mid_state), \
         mock.patch.object(pretrain_cli, "save_checkpoint", final_params), \
         open(log, "w") as f, contextlib.redirect_stdout(f), probed_graphs() as caps:
        pretrain_cli.main(out_dir=str(run_dir), **run)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _counts()
    n_steps = MOE_TRAIN["max_iters"]
    # one captured step graph: its warm-up and capture launch, the replays do not
    one_step = {"flash_attention_fwd": accum * L, "flash_attention_bwd": accum * L}
    expect_captures(caps, one_step, n=1, kind="train")
    expect_launches(launches, {k: 2 * v for k, v in one_step.items()})
    text = log.read_text()
    assert "using native C++ packed reader" in text, text[-2000:]
    losses = _losses(run_dir)
    assert sorted(losses) == list(range(n_steps)), losses
    assert all(np.isfinite(x) for x in losses.values())
    assert losses[n_steps - 1] < losses[0], losses
    step_ms = [float(m) for m in re.findall(r"iter \d+: loss \S+, time: (\S+)ms", text)]
    paths["moe_train"] = launches

    t0 = time.perf_counter()
    with mock.patch.object(pretrain_cli, "save_train_state", lambda *a, **k: None), \
         mock.patch.object(pretrain_cli, "save_checkpoint", lambda *a, **k: None), \
         open(log, "a") as f, contextlib.redirect_stdout(f):
        pretrain_cli.main(out_dir=str(resumed_dir), resume=str(resumed_dir / "state-latest"),
                          **run)
    torch.cuda.synchronize()
    resumed_run_s = time.perf_counter() - t0
    resumed = _losses(resumed_dir)
    assert sorted(resumed) == list(range(mid + 1, n_steps)), resumed
    resume_rel = max(abs(resumed[i] - losses[i]) / abs(losses[i]) for i in resumed)
    assert resume_rel <= RESUME_REL_TOL, (resumed, losses)
    release_programs()

    # one micro-batch of the corpus through the trained model: K2/K6 against the plain
    # versions, and the routing statistics
    params, loaded = load_checkpoint(run_dir / final, device=device)
    assert isinstance(loaded, MoEConfig) and loaded == config, loaded
    micro = torch.as_tensor(py_rows[:mb], device=device).long()
    got_loss, aux, got = moe_loss_and_grads(params, micro, config, device)
    with mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_fwd",
                    flash_attention_fwd_ref), \
         mock.patch("lit_llama_ja_tpu_torch.ops.cuda.flash_attention.flash_attention_bwd",
                    flash_attention_bwd_ref):
        want_loss, _, want = moe_loss_and_grads(params, micro, config, device)
    checked = ("blocks/moe/c_fc1/weight", "blocks/moe/router/weight", "blocks/attn/c_attn/weight")
    grad_rel = {k: ((got[k].float() - want[k].float()).norm() / want[k].float().norm()).item()
                for k in checked}
    assert abs(got_loss - want_loss) <= GRAD_LOSS_TOL, (got_loss, want_loss)
    assert all(np.isfinite(r) and r <= GRAD_REL_TOL for r in grad_rel.values()), grad_rel
    del got, want
    release_programs()
    # TRAIN_STEPS optimizer steps of the CLI's kind over MOE_PROFILE_ACCUM micro-batches
    # of the corpus, captured and eager from the loaded params, then one replay under
    # the profiler (`train_pair`; generation reloads the checkpoint)
    opt = make_adamw(1e-4)
    rows = MOE_PROFILE_ACCUM * mb
    batches = [py_rows[np.arange(i * rows, (i + 1) * rows) % len(py_rows)]
               .reshape(MOE_PROFILE_ACCUM, mb, T + 1) for i in range(TRAIN_STEPS)]

    def fresh():
        tree = clone_tree(params)
        return tree, opt.init(tree)

    pair = train_pair(
        lambda cg: make_moe_train_step(config, opt, compute_dtype=torch.bfloat16,
                                       device=device, cuda_graph=cg),
        fresh, batches, {"flash_attention_fwd": MOE_PROFILE_ACCUM * L,
                         "flash_attention_bwd": MOE_PROFILE_ACCUM * L},
        tokens_per_step=rows * T, flops_per_step=MOE_PROFILE_ACCUM * moe_flops(config, mb * T, T))
    emit({"phase": "moe_train_steps", "micro_batches": MOE_PROFILE_ACCUM, **pair})
    del opt
    release_programs()

    tokens = accum * mb * T
    flops = accum * moe_flops(config, mb * T, T)
    step_s = min(step_ms[1:]) / 1e3  # iteration 0 is the warm-up and the capture
    emit({"phase": "moe_train", "config": TRAIN_MODEL, **MOE, "n_layer": L,
          "n_embd": config.n_embd, "T": T, "micro_batch": mb, "grad_accum": accum,
          "capacity": config.capacity(mb * T), "tokens_per_step": tokens,
          "params": sum(t.numel() for t in _leaves(params)), "compute_dtype": "bfloat16",
          "router_dtype": "float32", "prepare_s": prepare_s, "native_build_s": native_build_s,
          "chunk_files": len(files), "losses": [losses[i] for i in range(n_steps)],
          "resumed_losses": resumed, "resume_max_rel_diff": resume_rel, "cli_run_s": run_s,
          "resumed_cli_run_s": resumed_run_s,
          "launches": {k: v for k, v in launches.items() if v}, "step_ms": step_ms,
          "cli_graphs": capture_kinds(caps),
          "tokens_per_s": tokens / step_s, "model_tflops_per_s": flops / step_s / 1e12,
          "model_flop_share_of_989": flops / step_s / BF16_FLOPS_PER_S,
          "flop_formula": "6 * (attention linears + router) per token + 6 * 3 * D * H per "
                          "expert row (E * C rows a layer) + 6 * D * V per token + "
                          "6 * L * T * D per token",
          "peak_mem_bytes": peak, "aux": aux,
          "grad_check": {"loss": got_loss, "plain_loss": want_loss, "leaf_rel_err": grad_rel}})

    # (d) generation from the checkpoint
    params = cast_params(load_checkpoint(run_dir / final, device=device)[0], torch.bfloat16)
    Tp, new = MOE_PROMPT, MOE_NEW
    prompt = torch.randint(1, config.vocab_size, (Tp,), generator=g, device=device).cpu().numpy()
    gen_kw = dict(temperature=0.0, cache_dtype=torch.bfloat16, quantize_kv="int4", device=device)
    generate(params, config, prompt, 2, **gen_kw)  # warm-up
    _counts_zero()
    out = generate(params, config, prompt, new, **gen_kw)
    launches = _counts()
    # the held program's first call: its prefill span's warm-up and capture
    expect_launches(launches, {"flash_attention_fwd": 2 * L})
    _counts_zero()
    assert np.array_equal(out, generate(params, config, prompt, new, **gen_kw)), \
        "greedy MoE generation is not repeatable"
    assert not any(_counts().values()), "the held MoE program's second call launched"
    assert out.shape == (Tp + new,) and ((out >= 0) & (out < config.padded_vocab_size)).all()
    paths["moe_generate"] = launches
    P = bucket_length(Tp)
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :Tp] = torch.as_tensor(prompt, device=device)
    cache = init_kv_cache(config, 1, max(Tp + new, P), torch.bfloat16, "int4", device=device)

    def prefill():
        return forward_moe_with_cache(params, idx, torch.arange(P), cache, config,
                                      prefill_attn=True, device=device)[0]

    def decode(tok_, pos):
        return forward_moe_with_cache(params, tok_.view(1, 1), torch.tensor([pos]), cache,
                                      config, device=device)[0]

    got_l = prefill().float()
    with plain_versions():
        want_l = prefill().float()
    assert torch.isfinite(got_l).all()
    rel = ((got_l - want_l).norm() / want_l.norm()).item()
    agree = (got_l.argmax(-1) == want_l.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    t_prefill = timeit(prefill, iters=5, warmup=1)
    t_decode = timeit(decode, torch.as_tensor(out[Tp:Tp + 1], device=device), Tp,
                      iters=20, warmup=2)
    emit({"phase": "moe_generate", "config": TRAIN_MODEL, **MOE, "kv_cache": "int4",
          "prompt": Tp, "bucket": P, "new_tokens": new,
          "launches": {k: v for k, v in launches.items() if v},
          "logits_rel_err": rel, "argmax_agree": agree,
          "prefill_ms": t_prefill.wall_s * 1e3, "prefill_cuda_ms": t_prefill.cuda_s * 1e3,
          "decode_ms_per_token": t_decode.wall_s * 1e3,
          "decode_cuda_ms_per_token": t_decode.cuda_s * 1e3,
          "decode_cpu_ms_per_token": t_decode.cpu_s * 1e3, "tokens": out[Tp:].tolist()})
    del cache, got_l, want_l

    # (e) serving through the paged engine over an int8 pool
    _, prompts = serve_mix(config)
    prompts = prompts[:MOE_REQUESTS]
    timer = Timer(device)
    eager = dict(SERVE, cuda_graph=False)
    drive(PagedEngine(params, config, quantize_kv="int8", device=device, **eager), prompts[:1])
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **eager)
    with timed_runs() as runs:
        (tokens_a, spans, steps, first, wall), launches = counted_drive(engine, prompts)
    eager_span_ms = span_ms(runs, engine.span_step, False)
    stats = engine.stats()
    n_decode, n_from0 = stats["steps"], sum(s == 0 for s in spans)
    expect_launches(launches, {"flash_attention_fwd": L * n_from0,
                               "paged_decode_attention": L * n_decode})
    check_tokens(tokens_a, config)
    assert stats["completed_requests"] == MOE_REQUESTS and stats["queued"] == 0, stats
    paths["moe_serve_eager"] = launches
    eager_pool = host_pool(engine.pool)
    gate = {}
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **eager)
    tokens_b = drive(engine, prompts,
                     on_step=lambda e: decode_step_gate(e, timer, device, gate))[0]
    assert tokens_b == tokens_a, "greedy MoE serving is not repeatable"
    assert gate, "no step with every slot decoding"
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **SERVE)
    with probed_graphs() as caps, timed_runs() as runs:
        (tokens_c, spans_c, steps_c, first_c, wall_c), launches_c = counted_drive(
            engine, prompts)
    captured = captured_serve_gate(engine, caps, launches_c, spans_c,
                                   {"paged_decode_attention": L}, {}, tokens_a, tokens_c,
                                   eager_pool)
    captured["span_ms"] = span_ms(runs, engine.span_step, True)
    paths["moe_serve"] = launches_c
    emit({"phase": "moe_serve", "config": TRAIN_MODEL, **MOE, "kv_pool": "int8", **SERVE,
          "requests": MOE_REQUESTS, "prompt_lengths": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW, **serve_stats(tokens_c, steps_c, first_c, wall_c),
          "decode_steps": n_decode, "prefill_spans": len(spans),
          "prefill_spans_from_0": int(n_from0),
          "launches": {k: v for k, v in launches_c.items() if v}, "captured": captured,
          "tokens_equal_eager": True,
          "eager": {**serve_stats(tokens_a, steps, first, wall), "span_ms": eager_span_ms,
                    "launches": {k: v for k, v in launches.items() if v}},
          "repeatable": True, "decode_step_gate": gate, "phase_s": time.perf_counter() - phase_t0})
    del engine, params, timer, caps, runs
    release_programs()
    return paths


def mixed_positions(B: int, page: int):
    """Positions from the seed in [0, 2047], with 0 and the page edges page - 1, page
    and 2047 where the batch has room for them."""
    pos = np.random.default_rng(SEED + 31 * B + page).integers(0, MAX_POS + 1, B)
    if B > 1:
        n = min(B, 4)
        pos[:n] = [0, page - 1, page, MAX_POS][:n]
    return [int(p) for p in pos]


def at_offset(t, elems):
    """A contiguous copy of ``t`` whose storage starts ``elems`` elements into a larger
    buffer: int8 pages at an odd byte offset, f32 scales 4 bytes past a 16-byte line."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = flat[elems:].view(t.shape)
    out.copy_(t)
    return out


def paged_inputs(g, device, B, nh, hd, page, pos, extra=0, layered=False, odd=False):
    """K7/K8 arguments: random int8 pages and scales around 0.01, a bf16 q, and per-slot
    tables of shuffled pages that hold each slot's visible tokens (``pos[b] // page + 1``
    pages), padded with ``extra`` trash entries past the widest slot. The trash page
    holds finite junk (scales of 1e4) that a kernel must never weigh. ``layered``: the
    pages are layer 1 of a stacked 3-layer pool, a view at an offset; ``odd``: the pages
    start at an odd byte offset and the scales 4 bytes past a 16-byte line, so no run
    is 16-byte aligned."""
    need = [p // page + 1 for p in pos]
    AP, P = max(need) + extra, 1 + sum(need)
    lead = (3,) if layered else ()

    def levels():
        return torch.randint(-127, 128, (*lead, P, nh, page, hd), generator=g,
                             device=device).to(torch.int8)

    def scales():
        t = torch.rand((*lead, P, nh, page), generator=g, device=device) * 0.01 + 0.005
        t[..., 0, :, :] = 1e4  # the trash page
        return t

    k, ks, v, vs = levels(), scales(), levels(), scales()
    if layered:
        k, ks, v, vs = k[1], ks[1], v[1], vs[1]
    if odd:
        k, ks, v, vs = at_offset(k, 1), at_offset(ks, 1), at_offset(v, 1), at_offset(vs, 1)
    perm = (torch.randperm(P - 1, generator=g, device=device) + 1).cpu()
    tables = torch.zeros((B, AP), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at: at + n]
        at += n
    q = torch.randn((B, nh, hd), generator=g, device=device).to(torch.bfloat16)
    return (q, k, ks, v, vs, tables.to(device), torch.tensor(pos, dtype=torch.int32, device=device))


def paged_bound(args):
    """(bound_ms, bound_by) of one K7/K8 call: each visible token's k, v and scales
    read once (2 * hd + 8 bytes per head), q, tables and pos read, o written."""
    q, tables, pos = args[0], args[5], args[6]
    B, nh, hd = q.shape
    page = args[1].shape[2]
    n_tok = (pos.long() + 1).clamp(max=tables.shape[1] * page).sum().item()
    n_bytes = n_tok * nh * (2 * hd + 8) + 2 * 2 * B * nh * hd + 4 * tables.numel() + 4 * B
    return bound_ms(n_bytes, 4.0 * hd * nh * n_tok)


def check_paged(fn, args, want, case):
    """K7 or K8 against the plain version's ``want`` on the same inputs: (err, tol)."""
    got = fn(*args).float()
    torch.cuda.synchronize()
    err = (got - want.float()).abs().max().item()
    tol = REL_TOL * want.float().abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (fn.__name__, case, err, tol)
    return err, tol


def paged_library(args):
    """The yardstick's inputs: the slots' keys and values gathered and dequantized to
    bf16 beforehand, with the visibility mask, for `scaled_dot_product_attention`."""
    q, k, ks, v, vs, tables, pos = args
    kd = (gather_pages(k, tables).float() * gather_pages(ks, tables)[..., None]).bfloat16()
    vd = (gather_pages(v, tables).float() * gather_pages(vs, tables)[..., None]).bfloat16()
    S = kd.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] <= pos[:, None].long())[:, None, None]
    return q[:, :, None], kd, vd, mask


def serve_positions():
    """The serve run's first SERVE["max_batch"] prompt lengths as positions, and the
    table width (pages) the engine buckets them to."""
    lengths = np.random.default_rng(SEED).integers(64, 1001, SERVE_REQUESTS)
    pos = [int(n) for n in lengths[:SERVE["max_batch"]]]
    pages = max(pos) // SERVE["page_size"] + 1
    return pos, bucket_length(pages, minimum=1) - pages


def phase_paged_kernels(timer, g, device):
    """K7 and K8 against their plain version at the 7B shape (B 1, 8 and 32; page 16 and
    128; every slot at 2047, or mixed positions; the serve run's positions) and at the
    125M and 19M heads, timed (CUDA events and graph replay) beside their bound, the
    plain version and SDPA on pre-gathered bf16 k/v."""
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for nh, hd, B, page, fill in PAGED_SHAPES + [PAGED_SERVE] + PAGED_MODELS:
        extra = 0
        if fill == "serve":
            pos, extra = serve_positions()
        else:
            pos = [MAX_POS] * B if fill == "full" else mixed_positions(B, page)
        args = paged_inputs(g, device, B, nh, hd, page, pos, extra)
        want = paged_decode_attention_ref(*args)
        b, by = paged_bound(args)
        lib = paged_library(args)

        def library():
            return sdpa(lib[0], lib[1], lib[2], attn_mask=lib[3])

        common = {"n_head": nh, "head_dim": hd, "B": B, "page": page, "fill": fill,
                  "AP": args[5].shape[1], "positions": pos if B <= 8 else "mixed",
                  "plain_ms": timer.ms(lambda: paged_decode_attention_ref(*args)),
                  "library_ms": timer.ms(library), "library_graph_ms": graph_ms(timer, library),
                  "bound_ms": b, "bound_by": by}
        for name, fn in PAGED_KERNELS.items():
            err, tol = check_paged(fn, args, want, (nh, hd, B, page, fill))
            row = {"kernel": name, **common, "max_abs_err": err, "tol": tol,
                   "ms": timer.ms(lambda: fn(*args)),
                   "graph_ms": graph_ms(timer, lambda: fn(*args))}
            emit({"phase": "kernels", **row})
            rows.append(row)
        del args, want, lib
    release_programs()
    return rows


def phase_paged_host(device):
    """Host time of one K7 and one K8 call at the 7B decode step's shape (B 8, 32 heads
    of 128, page 16, every slot at 2047), as `phase_host` times the GEMVs: the CPU time
    of a loop of HOST_CALLS calls with no synchronization, after a warm-up loop, the
    median of 5 loops, in us a call; and its sum over the 32 layers of a step."""
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    args = paged_inputs(g, device, 8, 32, 128, 16, [MAX_POS] * 8)
    L = llama_configs["7B"]["n_layer"]
    for name, fn in PAGED_KERNELS.items():
        loops = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(*args)
            loops.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
        host_us = statistics.median(loops[1:])
        emit({"phase": "host", "kernel": name, "B": 8, "n_head": 32, "head_dim": 128,
              "page": 16, "calls": HOST_CALLS, "host_us": host_us,
              "host_ms_per_decode_step": L * host_us / 1e3})


def phase_paged_edges(g, device):
    """K7 and K8 off the timed shapes: every slot at position 0, tables far wider than
    the visible pages with trash entries, pages whose runs are not 16-byte aligned
    (page 4 and page 3 at hd 78), scale runs of 12 and 20 bytes, pages at an odd byte
    offset, a table longer than one cluster's splits of one tile, a table of one split,
    layer views at an offset, page 128. Correctness; then two launches that must give
    equal bits, and `structured_paged`."""
    out = []
    for B, nh, hd, page, pos, extra, layered, odd in PAGED_EDGES:
        pos = pos or mixed_positions(B, page)
        args = paged_inputs(g, device, B, nh, hd, page, pos, extra, layered, odd)
        want = paged_decode_attention_ref(*args)
        for name, fn in PAGED_KERNELS.items():
            err, tol = check_paged(fn, args, want, (B, nh, hd, page, pos, extra, layered, odd))
            out.append({"kernel": name, "B": B, "n_head": nh, "head_dim": hd, "page": page,
                        "positions": pos, "AP": args[5].shape[1], "layer_view": layered,
                        "odd_offset": odd, "max_abs_err": err, "tol": tol})
    repeats = []
    for B, nh, hd, page, fill in PAGED_REPEATS:
        pos = [MAX_POS] * B if fill == "full" else mixed_positions(B, page)
        args = paged_inputs(g, device, B, nh, hd, page, pos)
        for name, fn in PAGED_KERNELS.items():
            first, second = fn(*args), fn(*args)
            torch.cuda.synchronize()
            assert torch.equal(first, second), (name, "two launches differ", B, nh, hd, page)
            repeats.append({"kernel": name, "B": B, "n_head": nh, "head_dim": hd, "page": page,
                            "fill": fill, "equal_bits": True})
    emit({"phase": "kernels", "kernel": "paged_decode_attention(_db)", "edges": out,
          "repeats": repeats, "structured": structured_paged(device)})


def structured_paged(device):
    """K7 and K8 on inputs whose output names the token it came from: q is one-hot at
    column 0; in each (slot, head) one target token has k[., 0] = 127 at k scale 32 and
    every other visible token k[., 0] = 0, so the others weigh e^-359 or less, an exact
    0 in f32; every token's v row holds t % 64, t // 64, then (d % 64) - 32 at column
    d >= 2, at v scale 1, so the output is the target's row exactly. Tokens past pos[b]
    in its last page, and a page of them at the end of every table, are traps (k[., 0]
    = 127 at k scale 1e4; the trap page's v rows name token 8191) that must never be
    weighed. The targets cycle over token 0, pos[b] and the page, warp-tile, tile and
    split edges below it. A mismatch prints as (slot, head, wanted token, got token,
    wrong columns)."""
    out = []
    for B, nh, hd, page, pos in STRUCTURED_PAGED:
        plan = paged_wrappers.paged_plan(B, nh, hd, page, max(pos) // page + 2,
                                         _build.sm_count(device.index or 0))
        wt = plan.tile // paged_wrappers.PAGED_WARPS
        need = [p // page + 1 for p in pos]
        AP, P = max(need) + 1, 1 + sum(need)
        tables = torch.zeros((B, AP), dtype=torch.int32)  # page 0: the trap page
        tok_of = torch.full((P, page), 8191)  # each pool row's token in its slot
        limit = torch.full((P,), -1)  # the position of the pool page's slot
        at = 1
        for b, n in enumerate(need):
            tables[b, :n] = torch.arange(at, at + n)
            tok_of[at: at + n] = torch.arange(n * page).view(n, page)
            limit[at: at + n] = pos[b]
            at += n
        targets = torch.zeros((B, nh), dtype=torch.long)
        for b, p in enumerate(pos):
            edges = {0, p}
            for step in (page, wt, plan.tile, plan.span):
                edges |= {e for m in range(step, p + 1, step) for e in (m - 1, m)}
            cand = sorted(e for e in edges if e <= p)
            targets[b] = torch.tensor([cand[(h * 7 + b) % len(cand)] for h in range(nh)])
        trap = tok_of > limit[:, None]
        k = torch.zeros((P, nh, page, hd), dtype=torch.int8)
        k[..., 0] = torch.where(trap, 127, 0).to(torch.int8)[:, None, :]
        ks = torch.where(trap, 1e4, 1.0)[:, None, :].expand(P, nh, page).clone()
        for b in range(B):
            for h in range(nh):
                t = int(targets[b, h])
                row = tables[b, t // page]
                k[row, h, t % page, 0] = 127
                ks[row, h, t % page] = 32.0
        col = torch.arange(hd)
        v = ((col % 64) - 32).expand(P, nh, page, hd).clone()
        v[..., 0] = (tok_of % 64)[:, None, :]
        v[..., 1] = (tok_of // 64)[:, None, :]
        v = v.to(torch.int8)
        q = torch.zeros((B, nh, hd), dtype=torch.bfloat16)
        q[..., 0] = 1
        args = [t.to(device) for t in (q, k, ks, v, torch.ones((P, nh, page)), tables,
                                      torch.tensor(pos, dtype=torch.int32))]
        want = ((col % 64) - 32).float().expand(B, nh, hd).clone()
        want[..., 0] = (targets % 64).float()
        want[..., 1] = (targets // 64).float()
        plain = paged_decode_attention_ref(*args).float().cpu()
        assert torch.equal(plain, want), "structured_paged: the plain version disagrees"
        for name, fn in PAGED_KERNELS.items():
            got = fn(*args).float().cpu()
            bad = (got != want).any(-1).nonzero().tolist()
            report = [(b, h, int(targets[b, h]), int(got[b, h, 0] + 64 * got[b, h, 1]),
                       (got[b, h] != want[b, h]).nonzero().flatten().tolist()[:8])
                      for b, h in bad[:8]]
            assert not bad, (name, (B, nh, hd, page, pos), len(bad), report)
            out.append({"kernel": name, "B": B, "n_head": nh, "head_dim": hd, "page": page,
                        "positions": pos, "targets": int(targets.numel()), "exact": True})
    return out


def serve_mix(config):
    """The serve phase's requests from the seed: prompt lengths in 64-1000, and a
    256-token prefix that the last SERVE_PREFIXED requests continue."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(64, 1001, SERVE_REQUESTS)
    prompts = [rng.integers(1, config.vocab_size, n).astype(np.int32) for n in lengths]
    return rng.integers(1, config.vocab_size, SERVE_PREFIX).astype(np.int32), prompts


def drive(engine, prompts, prefix=None, n_prefixed=0, on_step=None, new=SERVE_NEW):
    """Register the prefix, submit every request at once (``new`` tokens each), step
    the engine until all are done. Returns (tokens by request, start positions of the prefill spans, per-step
    (ms, ran a prefill span), first-token seconds by request, wall seconds)."""
    spans = []
    if isinstance(engine, PagedEngine):
        orig = engine._prefill_span

        def counted(toks, start_pos, table_pages, want_logits=True):
            spans.append(int(start_pos))
            return orig(toks, start_pos, table_pages, want_logits)

        engine._prefill_span = counted
    pid = engine.register_prefix(prefix) if prefix is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = []
    for i, p in enumerate(prompts):
        kw = {"prefix_id": pid} if pid is not None and i >= len(prompts) - n_prefixed else {}
        engine.add_request(p, new, **kw)
        reqs.append(engine.queue[-1])
    first, steps = {}, []
    while not all(r.done for r in reqs):
        n_spans, n_queued, ts = len(spans), len(engine.queue), time.perf_counter()
        engine.step()
        now = time.perf_counter()
        steps.append(((now - ts) * 1e3, len(spans) > n_spans or len(engine.queue) < n_queued))
        for r in reqs:
            if r.tokens and r.req_id not in first:
                first[r.req_id] = now - t0
        if on_step is not None:
            on_step(engine)
    wall = time.perf_counter() - t0
    if isinstance(engine, PagedEngine):
        del engine._prefill_span  # the bound method again
    return {r.req_id: list(r.tokens) for r in reqs}, spans, steps, first, wall


def counted_drive(engine, prompts, **kw):
    """`drive` with every kernel's launch count set to 0 just before it; returns its
    result and the counts read just after."""
    torch.cuda.synchronize()
    _counts_zero()
    res = drive(engine, prompts, **kw)
    torch.cuda.synchronize()
    return res, _counts()


@contextlib.contextmanager
def probed_engines():
    """Record every serving engine that runs inside (``engines``) and the start position
    and length of every prefill span of a paged engine (``spans``): what the launches of
    a CLI run are worked out from; and the bytes the spans staged through the host
    (``span_staged``), which a run's staged bytes less these leave to its decode steps."""
    seen = {"engines": [], "spans": [], "span_staged": 0}
    prefill, runs = PagedEngine._prefill_span, {cls: cls.run for cls in (PagedEngine, Engine)}

    def span(self, toks, start_pos, table_pages, want_logits=True):
        seen["spans"].append((int(start_pos), len(toks)))
        s0 = mesh_mod.STAGED["bytes"]
        out = prefill(self, toks, start_pos, table_pages, want_logits)
        seen["span_staged"] += mesh_mod.STAGED["bytes"] - s0
        return out

    def runner(cls):
        def run(self, *args, **kw):
            seen["engines"].append(self)
            return runs[cls](self, *args, **kw)
        return run

    with mock.patch.object(PagedEngine, "_prefill_span", span), \
            mock.patch.object(PagedEngine, "run", runner(PagedEngine)), \
            mock.patch.object(Engine, "run", runner(Engine)):
        yield seen


def spec_round_widths(engine):
    """The draft forwards' widths of one round of a speculative engine (a chain: the
    (prev, cur) pair and K - 1 single steps; a tree: one forward a level over the
    partial tree, then the whole tree) and the verify's."""
    tree = getattr(engine, "tree", None)
    if tree:
        topo = tree_topology(tree)
        return [int(lv[-1]) + 1 for lv in topo["levels"][:-1]] + [topo["n_nodes"]], \
            topo["n_nodes"]
    return [2] + [1] * (engine.K - 1), engine.K + 1


def spec_round_launches(engine, L: int, L_draft: int):
    """K1's launches in one round of a speculative engine over an int4 target of L
    layers drafting with an int4 model of L_draft layers (one rank, one micro-group)."""
    widths, _ = spec_round_widths(engine)
    return {"quant_matmul_int4": len(widths) * (5 * L_draft + 1) + 5 * L + 1}


def spec_launches(engine, spans, L: int, L_draft: int, n_micro: int = 1, last: int = 1,
                  rounds=None):
    """The K1 and K2 launches of a speculative engine's run on one rank, worked out from
    the code, and how many of the K1 launches take the GEMV route (M <= 16). The rank
    holds L of the int4 target's layers (``last``: and its lm_head) and the int4 draft of
    L_draft layers whole. A prefill span of P tokens (M = P, padded to a power of 2 from
    16) runs the target's linears, K2 on its layers from position 0, and the draft's
    (which attends in plain PyTorch). A round runs the draft's forwards at B x width
    rows (a chain: the (prev, cur) pair and K - 1 single steps; a tree: one forward a
    level over the partial tree, then the whole tree) and the target's verify, once a
    micro-group of B / n_micro slots x (K + 1 or the tree's nodes). No forward runs K7:
    the verify is wider than one token and the draft's pool is bf16. ``rounds``: the
    rounds that launched (default every round; a captured run's warm-ups and captures)."""
    if rounds is None:
        rounds = engine.stats()["spec_rounds"]
    B = engine.B
    widths, verify = spec_round_widths(engine)
    per_t, per_d = 5 * L + last, 5 * L_draft + 1
    k1 = len(spans) * (per_t + per_d) + rounds * (len(widths) * per_d + n_micro * per_t)
    gemv = (sum(bucket_length(n) <= 16 for _, n in spans) * (per_t + per_d)
            + rounds * (per_d * sum(B * w <= 16 for w in widths)
                        + n_micro * per_t * (B // n_micro * verify <= 16)))
    return {"quant_matmul_int4": k1,
            "flash_attention_fwd": L * sum(s == 0 for s, _ in spans)}, gemv


def stripe_launches(engine, L: int, steps=None, prefills=None):
    """The K1 and K2 launches of a stripe `Engine` run of an int4 model: each prefill
    that launched (K2 on every layer; ``prefills``: default one a request, as an eager
    run; a captured run's warm-ups and captures) and each decode step that launched
    (``steps``: default every step) run the 5 L linears and the lm_head."""
    n_req = engine._next_id if prefills is None else prefills
    if steps is None:
        steps = engine.stats()["steps"]
    return {"quant_matmul_int4": (n_req + steps) * (5 * L + 1), "flash_attention_fwd": L * n_req}


def spec_stats(engine):
    st = engine.stats()
    return {"rounds": st["spec_rounds"], "acceptance_rate": st["acceptance_rate"],
            "tokens_per_round": st["tokens_per_round"]}


def share_equal(got, want):
    """The share of the reference's tokens that ``got`` matches, position by position."""
    same = sum(a == b for r in want for a, b in zip(got.get(r, []), want[r]))
    return same / sum(len(t) for t in want.values())


def serve_stats(tokens, steps, first, wall):
    ttft = sorted(first.values())
    decode = [ms for ms, prefilled in steps if not prefilled]
    n_tok = sum(len(t) for t in tokens.values())
    return {"ttft_s_median": float(np.median(ttft)), "ttft_s_p90": float(np.percentile(ttft, 90)),
            "decode_step_ms_median": float(np.median(decode)) if decode else None,
            "decode_steps_timed": len(decode), "steps": len(steps), "wall_s": wall,
            "tokens_out": n_tok, "tokens_per_s": n_tok / wall}


def check_tokens(tokens, config):
    for t in tokens.values():
        assert len(t) == SERVE_NEW, len(t)
        assert all(0 <= x < config.padded_vocab_size for x in t)


def decode_step_gate(engine, timer, device, out):
    """At the first step where every slot decodes: the next decode step's logits
    through K7 against the same step with K7's plain version swapped in (each on its
    own copy of the pool), and K7's time in that step (one launch on layer 0 at this
    step's tables and positions, times the layers) beside its bound."""
    if out or len(engine._decoding()) < engine.B or engine.prefilling:
        return
    engine._ensure_capacity()  # the pages the next step would allocate first
    pos = engine.pos.copy()
    ap = min(bucket_length(int(pos.max()) // engine.page + 1, minimum=1), engine.maxP)
    tables = np.ascontiguousarray(engine.tables[:, :ap])

    def step_logits():
        pool = {k: v.clone() for k, v in engine.pool.items()}
        logits = paged_forward(engine.params, engine.cur[:, None], pos[:, None], tables, pool,
                               engine.config, engine.quantized, device=device,
                               mesh=engine.mesh)[0].float()
        return logits, pool

    got, pool = step_logits()
    with mock.patch("lit_llama_ja_tpu_torch.infer.paged.paged_decode_attention",
                    paged_decode_attention_ref):
        want, _ = step_logits()
    assert torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    cfg = engine.config
    nh = engine.pool["k"].shape[2]  # the pool's heads: a tensor-parallel rank's own
    q = torch.randn((engine.B, nh, cfg.head_dim), device=device).to(torch.bfloat16)
    args = (q, pool["k"][0], pool["k_scale"][0], pool["v"][0], pool["v_scale"][0],
            torch.as_tensor(tables, device=device), torch.as_tensor(pos, device=device))
    b, _ = paged_bound(args)
    out.update(logits_rel_err=rel, argmax_agree=agree, positions=pos.tolist(), AP=ap,
               k7_ms_per_step=cfg.n_layer * timer.ms(lambda: paged_decode_attention(*args)),
               k7_bound_ms_per_step=cfg.n_layer * b)
    del pool


def host_pool(pool):
    """A page pool's bytes, copied to the host, but for the trash page 0: the writes of
    idle slots and padding land there in any order (`infer/paged.commit_writes`)."""
    return {k: v[:, 1:].cpu() for k, v in pool.items()}


def expect_pool_equal(pool, eager_pool, what):
    """A page pool's bytes equal ``eager_pool``'s (the eager run's pool but page 0, on the
    host, `host_pool`, or on the device), every page but the trash page 0."""
    for k, eager in eager_pool.items():
        got, eager = pool[k][:, 1:], eager.to(pool[k].device)
        assert torch.equal(got, eager), (
            f"captured and eager {what} differ in {k}, pages "
            f"{(1 + (got != eager).flatten(2).any(-1).any(0).nonzero()[:8, 0]).tolist()}")


def each_run_ms(runs, kind):
    """The median device ms of one run of ``kind`` (`timed_runs`), each timed by its own
    events: the runs of an engine need not follow one another (prefill spans and the
    host's bookkeeping sit between them)."""
    mine = [r for r in runs if r[0] == kind]
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for _, a, b, _ in mine])) if mine else None


def engine_state(engine):
    """What a captured engine run is held to against its eager run, copied on the
    device: the page pools but the trash page (the target's and a speculative engine's
    draft's), or a stripe engine's whole cache (each slot writes its own rows)."""
    if isinstance(engine, PagedEngine):
        out = {"target pool": engine.pool}
        if hasattr(engine, "dpool"):
            out["draft pool"] = engine.dpool
        return {what: {k: v[:, 1:].clone() for k, v in pool.items()}
                for what, pool in out.items()}
    return {"stripe cache": {k: v.clone() for k, v in engine.cache.items()}}


def expect_state_equal(engine, eager_state):
    for what, eager in eager_state.items():
        if what == "stripe cache":
            bad = [k for k in eager if not torch.equal(engine.cache[k], eager[k])]
            assert not bad, f"captured and eager stripe caches differ in {bad}"
        else:
            pool = engine.pool if what == "target pool" else engine.dpool
            expect_pool_equal(pool, eager, what + "s")


def engine_rounds(engine):
    st = engine.stats()
    return st.get("spec_rounds", st["steps"])


def span_step_of(engine):
    """An engine's `SpanStep`: a paged engine's prefill spans, a stripe engine's slot
    prefills."""
    return engine.prefill_step if isinstance(engine, Engine) else engine.span_step


def gated_engine_runs(make, prompts, per_round, expect, **kw):
    """An engine's run eager, then with its decode steps and prefill spans captured (the
    main path): ``make(cuda_graph)`` builds the engine, `counted_drive` runs it on
    ``prompts`` (``kw`` to `drive`) inside `probed_engines`, `probed_graphs` and
    `timed_runs`. Gates, each a phase failure: the captured run's tokens equal the eager
    run's, and its pools (`engine_state`) too; one graph a key, captured once, each step
    capture's wrapper launches and its graph's own kernel nodes one round's or step's
    (``per_round(engine)``), each span capture's one span's of its key
    (``expect(engine, [span], 0)``); each run's launches ``expect(engine, spans,
    rounds)``, the spans and rounds that launched (every eager one; the captured run's
    warm-up and capture, two a graph, `launched_spans`); every other span and round a
    replay. Returns the captured run's tokens and the line of both: ms a round
    (`each_run_ms`: replays, eager rounds), ms a span by key (`span_ms`), ms a token,
    tokens/s, first-token median and p90, capture ms, the graphs' pool bytes, peak
    memory, launches."""
    line, eager, held = {}, None, 0
    for captured in (False, True):
        engine = make(captured)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with probed_engines() as seen, probed_graphs() as caps, timed_runs() as runs:
            (tokens, _, steps, first, wall), launches = counted_drive(engine, prompts, **kw)
        peak = torch.cuda.max_memory_allocated() - held  # less the eager run's state
        n = engine_rounds(engine)
        graphs, span_step = engine.decode_step.graphs, span_step_of(engine)
        # every request of a stripe engine is prefilled once, from position 0
        every_span = ([(0, len(p)) for p in prompts] if isinstance(engine, Engine)
                      else seen["spans"])
        n_spans = len(every_span)
        spans = launched_spans(caps, span_step) if captured else every_span
        step_caps = of_kind(caps)
        expect_launches(launches, expect(engine, spans, 2 * len(step_caps) if captured else n))
        st = engine.stats()
        ms = each_run_ms(runs, "replay" if captured else "eager")
        row = {**serve_stats(tokens, steps, first, wall), "rounds": n,
               "ms_per_round": ms, "ms_per_token": ms * n / st["tokens_out"],
               "prefill_spans": n_spans, "span_ms": span_ms(runs, span_step, captured),
               "peak_mem_bytes": peak, "launches": {k: v for k, v in launches.items() if v}}
        if "acceptance_rate" in st:
            row.update(acceptance_rate=st["acceptance_rate"],
                       tokens_per_round=st["tokens_per_round"])
        if captured:
            assert tokens == eager[0], "captured and eager tokens differ"
            expect_state_equal(engine, eager[1])
            expect_captures(caps, per_round(engine), n=len(graphs))
            keys = expect_span_captures(
                caps, span_step, lambda from0: expect(engine, [(0 if from0 else 1, 0)], 0))
            replays = sum(gr.replays for gr in graphs.values())
            assert replays == n - len(step_caps), (replays, n, len(step_caps))
            span_replays = sum(gr.replays for gr in span_step.graphs.values())
            assert span_replays == n_spans - len(keys), (span_replays, n_spans, len(keys))
            row.update(graphs=[list(key) for key in graphs], replays=replays,
                       span_graphs=[list(key) for key in keys], span_replays=span_replays,
                       **capture_totals(caps), launches_per_capture=step_caps[0]["launches"],
                       graph_nodes=[c["graph_nodes"] for c in step_caps],
                       graph_kernels=step_caps[0]["graph_kernels"],
                       span_graph_nodes=[c["graph_nodes"] for c in of_kind(caps, "span")],
                       span_graph_kernels=[c["graph_kernels"] for c in of_kind(caps, "span")],
                       tokens_equal_eager=True, pools_equal_eager=True)
            line["captured"] = row
        else:
            assert not caps and all(not gr.capture_enabled for gr in graphs.values())
            assert all(not gr.capture_enabled for gr in span_step.graphs.values())
            eager = (tokens, engine_state(engine))
            held = sum(t.numel() * t.element_size() for leaves in eager[1].values()
                       for t in leaves.values())
            line["eager"] = row
        # `graphs` and `span_step` hold the engine's pools
        del engine, graphs, span_step, seen, caps, step_caps, runs
        release_programs()
    return tokens, line


def span_launches(per_span, L):
    """The launches of one prefill span of a paged or stripe engine: ``per_span`` (the
    linears'), and K2 on every layer of a span from position 0."""
    def one(from0):
        return {**per_span, **({"flash_attention_fwd": L} if from0 else {})}
    return one


def capture_launches(caps, span_step, per_step, one_span):
    """The launches of a captured serve run: the warm-up and capture of each step graph
    (``per_step``) and of each span graph (``one_span(from0)``), two a graph; replays
    launch nothing."""
    want = {k: v * 2 * len(of_kind(caps)) for k, v in per_step.items()}
    for start, _ in launched_spans(caps, span_step):
        for k, v in one_span(start == 0).items():
            want[k] = want.get(k, 0) + v
    return want


def captured_serve_gate(engine, caps, launches, spans, per_step, per_span, eager_tokens,
                        tokens, eager_pool):
    """A captured serve run's gates: its tokens equal the eager run's, and so do its
    page pool's bytes afterwards, every page but the trash page (``eager_pool``,
    `host_pool` of the eager run's); one graph a (width, top-k, top-p) key captured once
    each, each capture's wrapper launches and its graph's own kernel nodes one step's
    (``per_step``); one span graph a (P, attend width, prefill_attn) key captured once
    each, each capture's launches and nodes one span's (``per_span``, and K2 on every
    layer of a span from position 0, `span_launches`); the run's launches those of its
    span captures and step captures and their warm-ups, two a graph, the replays every
    other span and decode step. Then one replay of the widest step graph under the
    profiler, its kernels of the port beside the graph's nodes (``trace_equals_graph``;
    the profiler has dropped a kernel record of a serve graph, so the trace is not the
    gate). Returns the run's capture and replay figures."""
    assert tokens == eager_tokens, "captured and eager serving tokens differ"
    expect_pool_equal(engine.pool, eager_pool, "page pools")
    graphs = engine.decode_step.graphs
    expect_captures(caps, per_step, n=len(graphs))
    step_caps = of_kind(caps)
    one_span = span_launches(per_span, engine.config.n_layer)
    span_keys = expect_span_captures(caps, engine.span_step, one_span)
    n_decode = engine.stats()["steps"]
    expect_launches(launches, capture_launches(caps, engine.span_step, per_step, one_span))
    replays = sum(gr.replays for gr in graphs.values())
    assert replays == n_decode - len(step_caps), (replays, n_decode, len(step_caps))
    span_replays = sum(gr.replays for gr in engine.span_step.graphs.values())
    assert span_replays == len(spans) - len(span_keys), (span_replays, len(spans))
    keys = list(graphs)  # in the order of their captures
    widest = max(keys, key=lambda key: key[0])
    prof = profile_replay(graphs[widest].graph.replay)
    nodes = step_caps[keys.index(widest)]["graph_kernels"]
    return {"graphs": [list(key) for key in keys], "replays": replays,
            "span_graphs": [list(key) for key in span_keys], "span_replays": span_replays,
            **capture_totals(caps), "launches_per_capture": step_caps[0]["launches"],
            "graph_nodes": [c["graph_nodes"] for c in step_caps],
            "span_graph_nodes": [c["graph_nodes"] for c in of_kind(caps, "span")],
            "span_graph_kernels": [c["graph_kernels"] for c in of_kind(caps, "span")],
            "pool_equal_eager": True,
            "replay_profile": {"AP": widest[0], **prof, "graph_kernels": nodes,
                               "trace_equals_graph": prof["port_kernels"] == nodes}}


def phase_serve(g, device):
    """LLaMA-7B int4 weights through `PagedEngine` over an int8 page pool at serve_cli's
    defaults (page 16, max_batch 8, 1025 pages, prefill chunk 512): 16 greedy
    requests of 64-1000 tokens, 4 of them over a registered 256-token prefix, 32 new
    tokens each, with every decode step eager (``cuda_graph=False``), twice (the second
    with the K7 logit gate), then with the decode steps captured, the default and the main
    path (`captured_serve_gate`). Then 8 of them over the CLI's default int4 pool (plain
    decode attention), captured and eager, 4 through the stripe `Engine` with an int8
    cache, eager then captured (`gated_engine_runs`), and `phase_spec_generate`."""
    config = LLaMAConfig.from_name("7B")
    L, per_forward = config.n_layer, launches_per_forward("int4", config.n_layer)
    params = synth_7b_params(config, g, device, "int4")
    prefix, prompts = serve_mix(config)
    timer = Timer(device)
    paths = {}
    eager = dict(SERVE, cuda_graph=False)
    # warm-up: allocator, rope tables, the sampling path
    drive(PagedEngine(params, config, quantize_kv="int8", device=device, **eager), prompts[:1])
    release_programs()
    torch.cuda.reset_peak_memory_stats()
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **eager)
    with timed_runs() as runs:
        (tokens, spans, steps, first, wall), launches = counted_drive(
            engine, prompts, prefix=prefix, n_prefixed=SERVE_PREFIXED)
    peak = torch.cuda.max_memory_allocated()
    eager_span_ms = span_ms(runs, engine.span_step, False)
    stats = engine.stats()
    n_decode, n_from0 = stats["steps"], sum(s == 0 for s in spans)
    expect_launches(launches, {**{k: v * (n_decode + len(spans)) for k, v in per_forward.items()},
                               "flash_attention_fwd": L * n_from0,
                               "paged_decode_attention": L * n_decode})
    check_tokens(tokens, config)
    assert stats["completed_requests"] == SERVE_REQUESTS and stats["queued"] == 0, stats
    assert stats["pages_used"] == SERVE_PREFIX // SERVE["page_size"], stats
    paths["serve_int8_eager"] = launches
    eager_pool = host_pool(engine.pool)
    del engine
    release_programs()

    gate = {}
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **eager)
    tokens_b = drive(engine, prompts, prefix=prefix, n_prefixed=SERVE_PREFIXED,
                     on_step=lambda e: decode_step_gate(e, timer, device, gate))[0]
    assert tokens_b == tokens, "greedy serving is not repeatable"
    assert gate, "no step with every slot decoding"
    del engine
    release_programs()

    torch.cuda.reset_peak_memory_stats()
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, **SERVE)
    per_step = {**per_forward, "paged_decode_attention": L}
    with probed_graphs() as caps, timed_runs() as runs:
        (tokens_c, spans_c, steps_c, first_c, wall_c), launches_c = counted_drive(
            engine, prompts, prefix=prefix, n_prefixed=SERVE_PREFIXED)
    peak_c = torch.cuda.max_memory_allocated()
    captured = captured_serve_gate(engine, caps, launches_c, spans_c, per_step, per_forward,
                                   tokens, tokens_c, eager_pool)
    captured["span_ms"] = span_ms(runs, engine.span_step, True)
    paths["serve_int8"] = launches_c
    # the mix again on the same engine, its graphs warm: what a long-running server sees
    torch.cuda.reset_peak_memory_stats()
    with probed_graphs() as caps_w, timed_runs() as runs_w:
        (tokens_w, spans_w, steps_w, first_w, wall_w), launches_w = counted_drive(
            engine, prompts, prefix=prefix, n_prefixed=SERVE_PREFIXED)
    assert list(tokens_w.values()) == list(tokens_c.values()), "the warm pass's tokens differ"
    expect_launches(launches_w, capture_launches(caps_w, engine.span_step, per_step,
                                                 span_launches(per_forward, L)))
    warm = {**serve_stats(tokens_w, steps_w, first_w, wall_w), "prefill_spans": len(spans_w),
            "new_captures": len(of_kind(caps_w)),
            "new_span_captures": len(of_kind(caps_w, "span")),
            "span_ms": span_ms(runs_w, engine.span_step, True),
            "decode_ms_per_step": each_run_ms(runs_w, "replay"),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in launches_w.items() if v}, "tokens_equal_first_pass": True}
    del engine, eager_pool, caps, caps_w, runs, runs_w
    release_programs()
    emit({"phase": "serve", "config": "7B", "weights": "int4, G=1", "kv_pool": "int8",
          **SERVE, "requests": SERVE_REQUESTS, "prompt_lengths": [len(p) for p in prompts],
          "prefix": SERVE_PREFIX, "prefixed_requests": SERVE_PREFIXED, "new_tokens": SERVE_NEW,
          **serve_stats(tokens_c, steps_c, first_c, wall_c), "decode_steps": n_decode,
          "prefill_spans": len(spans_c), "prefill_spans_from_0": int(n_from0),
          "preempts": stats["preempts"], "pages_used_after": stats["pages_used"],
          "peak_mem_bytes": peak_c, "launches": {k: v for k, v in launches_c.items() if v},
          "captured": captured, "tokens_equal_eager": True, "warm_pass": warm,
          "eager": {**serve_stats(tokens, steps, first, wall), "peak_mem_bytes": peak,
                    "span_ms": eager_span_ms,
                    "launches": {k: v for k, v in launches.items() if v}},
          "repeatable": True, "decode_step_gate": gate,
          "tokens_head": {rid: t[:8] for rid, t in tokens.items()}})

    torch.cuda.reset_peak_memory_stats()
    engine = PagedEngine(params, config, quantize_kv="int4", device=device, **eager)
    with timed_runs() as runs:
        (tokens, spans, steps, first, wall), launches = counted_drive(
            engine, prompts[:SERVE_INT4_REQUESTS])
    n_decode, n_from0 = engine.stats()["steps"], sum(s == 0 for s in spans)
    expect_launches(launches, {**{k: v * (n_decode + len(spans)) for k, v in per_forward.items()},
                               "flash_attention_fwd": L * n_from0})
    check_tokens(tokens, config)
    eager_line = {**serve_stats(tokens, steps, first, wall),
                  "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                  "span_ms": span_ms(runs, engine.span_step, False),
                  "launches": {k: v for k, v in launches.items() if v}}
    eager_pool = host_pool(engine.pool)
    del engine
    release_programs()
    torch.cuda.reset_peak_memory_stats()
    engine = PagedEngine(params, config, quantize_kv="int4", device=device, **SERVE)
    with probed_graphs() as caps, timed_runs() as runs:
        (tokens_c, spans_c, steps_c, first_c, wall_c), launches_c = counted_drive(
            engine, prompts[:SERVE_INT4_REQUESTS])
    peak_c = torch.cuda.max_memory_allocated()
    captured = captured_serve_gate(engine, caps, launches_c, spans_c, per_forward, per_forward,
                                   tokens, tokens_c, eager_pool)
    captured["span_ms"] = span_ms(runs, engine.span_step, True)
    paths["serve_int4"] = launches_c
    emit({"phase": "serve_int4_pool", "config": "7B", "kv_pool": "int4",
          "requests": SERVE_INT4_REQUESTS, **serve_stats(tokens_c, steps_c, first_c, wall_c),
          "decode_steps": engine.stats()["steps"], "prefill_spans": len(spans_c),
          "peak_mem_bytes": peak_c, "launches": {k: v for k, v in launches_c.items() if v},
          "captured": captured, "tokens_equal_eager": True, "eager": eager_line})
    del engine, eager_pool, caps, runs
    release_programs()

    def stripe(captured):
        return Engine(params, config, max_batch=SERVE["max_batch"], max_seq_length=2048,
                      quantize_kv="int8", device=device, cuda_graph=captured)

    tokens, line = gated_engine_runs(stripe, prompts[:STRIPE_REQUESTS],
                                     lambda e: per_forward,
                                     lambda e, spans, steps: stripe_launches(e, L, steps,
                                                                             len(spans)))
    check_tokens(tokens, config)
    paths["serve_stripe"] = line["captured"]["launches"]
    emit({"phase": "serve_stripe", "config": "7B", "kv_cache": "int8 stripes (8 x 2048)",
          "requests": STRIPE_REQUESTS, **line})
    paths["spec_generate"] = phase_spec_generate(params, config, device)
    del params, timer
    release_programs()
    return paths, gate


def phase_spec_generate(params, config, device):
    """`speculative_generate` with the 7B int4 weights drafting for themselves: a
    SPEC_GEN_PROMPT-token prompt, SPEC_GEN_NEW greedy tokens, K SPEC_GEN_K, an int4
    target KV cache (the draft's bf16), its bodies eager (a fresh program), then on the
    held program of its key, built and captured by the call (the main path), then a
    second call of that key (`held_calls`). Gates: tokens and both caches' bytes equal;
    one round graph, its capture's wrapper launches and its own kernel nodes one
    round's (K + 1 forwards: the pair, K - 1 single steps, the verify; 805 K1 at K 4);
    one prologue span graph, its nodes both prefills' (K1 and K2); each run's launches:
    the eager run's prefills and rounds, the captured run's span and round warm-ups and
    captures; the second call builds, captures and launches nothing and gives the
    eager tokens and caches. Prints ms a round and a token (CUDA events around the
    replays and the eager rounds), tokens/s, acceptance, capture ms, the program's pool
    bytes, peak memory and the second call's wall and prologue replay ms. Returns the
    captured run's launches."""
    L, K, new = config.n_layer, SPEC_GEN_K, SPEC_GEN_NEW
    per_forward = launches_per_forward("int4", L)
    per_round = {k: v * (K + 1) for k, v in per_forward.items()}
    prefill = {**{k: 2 * v for k, v in per_forward.items()}, "flash_attention_fwd": 2 * L}
    prompt = np.random.default_rng(SEED + 23).integers(1, config.vocab_size, SPEC_GEN_PROMPT)
    kw = dict(K=K, temperature=0.0, cache_dtype=torch.bfloat16, quantize_kv="int4",
              device=device)
    runs, line = {}, {}
    release_programs()
    for captured in (False, True):
        caches = []

        def kept(*args, **kwargs):
            caches.append(init_kv_cache(*args, **kwargs))
            return caches[-1]

        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _counts_zero()
        t0 = time.perf_counter()
        with probed_graphs() as caps, timed_runs() as times, \
                mock.patch("lit_llama_ja_tpu_torch.infer.speculative.init_kv_cache", kept):
            out = speculative_generate(params, config, params, config, prompt, new,
                                       stats_out=stats, cuda_graph=captured, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, peak = _counts(), torch.cuda.max_memory_allocated()
        if captured:  # the span's and the round's warm-ups and captures
            want = {k: 2 * prefill.get(k, 0) + 2 * per_round.get(k, 0)
                    for k in {**prefill, **per_round}}
        else:
            want = {k: prefill.get(k, 0) + stats["rounds"] * per_round.get(k, 0)
                    for k in {**prefill, **per_round}}
        expect_launches(launches, want)
        assert out.shape == (SPEC_GEN_PROMPT + new,) and (out[:SPEC_GEN_PROMPT] == prompt).all()
        assert ((out >= 0) & (out < config.padded_vocab_size)).all()
        ms = each_run_ms(times, "replay" if captured else "eager")
        tokens_per_round = (stats["accepted"] + stats["rounds"]) / stats["rounds"]
        row = {"wall_s": wall, "tokens_per_s": new / wall, "rounds": stats["rounds"],
               "acceptance": stats["acceptance"], "tokens_per_round": tokens_per_round,
               "ms_per_round": ms, "ms_per_token": ms / tokens_per_round,
               "peak_mem_bytes": peak, "launches": {k: v for k, v in launches.items() if v}}
        if captured:
            program = speculative_mod.PROGRAMS.last
            caches = [program.tcache, program.dcache]
            expect_captures(caps, per_round, n=1)
            expect_span_captures(caps, program.span, lambda _: prefill)
            step_caps = of_kind(caps)
            row.update(**capture_totals(caps), launches_per_capture=step_caps[0]["launches"],
                       graph_nodes=step_caps[0]["graph_nodes"],
                       graph_kernels=step_caps[0]["graph_kernels"],
                       span_graph_nodes=of_kind(caps, "span")[0]["graph_nodes"],
                       program_pool_bytes=graph_pool_bytes(program.span.pool))
        else:
            assert not caps
        runs[captured] = (out, [{k: v.clone() for k, v in c.items()} for c in caches])
        line["captured" if captured else "eager"] = row
    (out_c, caches_c), (out_e, caches_e) = runs[True], runs[False]
    assert (out_c == out_e).all(), "captured and eager speculative tokens differ"
    for which, a, b in zip(("target", "draft"), caches_c, caches_e):
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        assert not bad, f"captured and eager {which} caches differ in {bad}"

    def second():
        t0 = time.perf_counter()
        out = speculative_generate(params, config, params, config, prompt, new, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        program = speculative_mod.PROGRAMS.last
        return out, ms, [{k: v.clone() for k, v in c.items()}
                         for c in (program.tcache, program.dcache)]

    torch.cuda.synchronize()
    line["held_calls"] = held_calls((("same_prompt", second),), lambda _: runs[False])
    release_programs()
    emit({"phase": "spec_generate", "config": "7B", "weights": "int4, G=1",
          "draft": "the target itself", "kv_cache": "int4 target, bf16 draft",
          "prompt": SPEC_GEN_PROMPT, "new_tokens": new, "k": K, **line,
          "round_launches": per_round, "tokens_equal_eager": True, "caches_equal_eager": True,
          "tokens": out_c[SPEC_GEN_PROMPT:].tolist()})
    del runs, caches_c, caches_e
    release_programs()
    return line["captured"]["launches"]


def phase_spec(g, device):
    """Speculative serving: the 125M ja model as the target and the 19M ja model as
    the draft (both vocab 35,000), bf16 weights drawn from ``g``, an int8 target pool
    at the serve phase's page settings. First the target alone through an eager `PagedEngine`
    (its decode runs K7 at 10 heads of 78), then `SpeculativePagedEngine` (K = 4) and
    `TreeSpeculativePagedEngine` (tree 4,2,2) on the same 8 greedy requests of
    64-512 tokens, 32 new tokens each, eager and then with the rounds captured
    (`gated_engine_runs`: tokens and both pools equal, one round's kernels a graph):
    launch counts, acceptance, ms a round, tokens/s, and the share of requests whose
    tokens equal the target-only engine's. That share has no gate: with random bf16
    weights the logits hold near-ties that the verify forward (K + 1 or 29 tokens wide)
    and the one-token decode may break differently."""
    tcfg, dcfg = LLaMAConfig.from_name(SPEC_TARGET), LLaMAConfig.from_name(SPEC_DRAFT)
    assert tcfg.vocab_size == dcfg.vocab_size == 35000
    tparams = init_params(g, tcfg, dtype=torch.bfloat16, device=device)
    dparams = init_params(g, dcfg, dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(SPEC_PROMPTS[0], SPEC_PROMPTS[1] + 1, SPEC_REQUESTS)]
    kw = dict(SERVE, quantize_kv="int8", device=device)
    paths = {}

    # the target alone with eager decode steps, as the speculative engines run theirs
    engine = PagedEngine(tparams, tcfg, **kw, cuda_graph=False)
    drive(engine, prompts[:1])  # warm-up
    engine = PagedEngine(tparams, tcfg, **kw, cuda_graph=False)
    (plain, spans, steps, first, wall), launches = counted_drive(engine, prompts)
    n_decode, n_from0 = engine.stats()["steps"], sum(s == 0 for s in spans)
    L = tcfg.n_layer
    expect_launches(launches, {"flash_attention_fwd": L * n_from0,
                               "paged_decode_attention": L * n_decode})
    check_tokens(plain, tcfg)
    paths["spec_target_only"] = launches
    emit({"phase": "spec", "engine": "PagedEngine", "target": SPEC_TARGET,
          "kv_pool": "int8", "requests": SPEC_REQUESTS, **serve_stats(plain, steps, first, wall),
          "decode_steps": n_decode, "launches": {k: v for k, v in launches.items() if v}})

    for name, cls, extra in (("SpeculativePagedEngine", SpeculativePagedEngine, {"draft_k": 4}),
                             ("TreeSpeculativePagedEngine", TreeSpeculativePagedEngine,
                              {"tree": (4, 2, 2)})):
        def make(captured, cls=cls, extra=extra):
            return cls(tparams, tcfg, draft_params=dparams, draft_config=dcfg, **kw, **extra,
                       cuda_graph=captured)

        drive(make(True), prompts[:1])  # warm-up
        # the verify forward is K + 1 (or 29) tokens wide and the draft's pool is bf16,
        # so neither reaches K7, and the bf16 linears are the library's: a round holds
        # no kernel of the port; K2 runs in the target's prefill spans from position 0
        tokens, line = gated_engine_runs(
            make, prompts, lambda e: {},
            lambda e, spans, rounds: {"flash_attention_fwd": L * sum(s == 0 for s, _ in spans)})
        check_tokens(tokens, tcfg)
        same = sum(tokens[r] == plain[r] for r in plain) / len(plain)
        paths[f"spec_{name}"] = line["captured"]["launches"]
        emit({"phase": "spec", "engine": name, "target": SPEC_TARGET, "draft": SPEC_DRAFT,
              **{k: list(v) if isinstance(v, tuple) else v for k, v in extra.items()},
              "kv_pool": "int8", "requests": SPEC_REQUESTS, **line,
              "share_equal_to_target_only": same})
    del tparams, dparams
    release_programs()
    return paths


def phase_micro_step(device):
    """The 125M model at full width and depth on random tokens from the seed: one
    micro-batch's loss and gradients (forward and backward through K2 and K6, bf16
    compute, as the train step runs them), median of MICRO_REPS after a warm-up, and one
    captured optimizer step over the CLI's 8 micro-batches (best of two replays after the
    warm-up and the capture). Host clock around work that ends in a synchronize; the K2
    and K6 launches are counted."""
    config = LLaMAConfig.from_name(TRAIN_MODEL)
    T, mb = config.block_size, TRAIN["micro_batch_size"]
    accum = TRAIN["batch_size"] // mb
    rng = np.random.default_rng(SEED)
    batch = rng.integers(0, config.vocab_size, (accum, mb, T + 1), dtype=np.int64)
    params = init_params(torch.Generator().manual_seed(SEED), config, device=device)
    micro = torch.as_tensor(batch[0], device=device)
    loss_and_grads(params, micro, config, device)  # warm-up
    _counts_zero()
    times = []
    for _ in range(MICRO_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_and_grads(params, micro, config, device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    micro_counts = {k: v // MICRO_REPS for k, v in _counts().items() if v}
    opt = make_adamw(1e-4)
    opt_state = opt.init(params)
    step = make_train_step(config, opt, compute_dtype=torch.bfloat16, device=device)
    step(params, opt_state, batch)  # the warm-up and the capture
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(params, opt_state, batch)[2])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    assert np.isfinite(loss), loss
    emit({"phase": "micro_step", "config": TRAIN_MODEL, "micro_batch": mb, "T": T,
          "loss": loss, "micro_fwd_bwd_ms": statistics.median(times),
          "micro_fwd_bwd_ms_all": times, "launches_per_micro": micro_counts,
          "grad_accum": accum, "step_ms": min(step_ms), "step_ms_all": step_ms})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def summary(k1_rows, k2_rows, k6_rows, q_rows, paged_rows, gate, paths, w4a8_rows, a8_rows):
    """Per-forward or per-step sums: K1, K3, K4 and K5 over one 7B decode step of their
    format (161 launches at M = 1, whole-column scales; and over the prefill at
    M = 512), K2 over one 7B prefill, K6 over one 125M training step. ``paths`` holds
    the launch counts of each main-path run; a row's ``launches`` is its kernel's
    count on its own path (K1 and K2: the int4 generation, K3: llm.int8, K4:
    gptq.int2, K5: gptq.int3, K6: training, K7 and K8: the int8-pool serve run, which
    runs K7 and, as in the JAX package, never K8), and ``launches_by_path`` its count
    on every path that launched it (the MoE paths of K2, K6 and K7 among them). K7 and K8 are summed over the 32
    layers of one 7B decode step at B = 8 with every slot at position 2047, page 16;
    K7 also carries its time in one step of the serve run (``serve_*``). K1's W4A8
    kernel is summed over one 7B decode step (161 launches at M = 1, whole-column) with
    the exact K1's time on the same inputs beside it (``exact_*``; no single PyTorch
    call computes W4A8, so ``library_ms`` is null); K3's W8A8 and K4/K5's W2A8/W3A8
    likewise; each A8 mode's launches from its `generate_a8` run."""
    L = llama_configs["7B"]["n_layer"]
    weight = LINEARS_PER_FORWARD["7B"]
    pre = [r for r in k2_rows if (r["n_head"], r["head_dim"], r["T"]) == (32, 128, 512)][0]
    step = [r for r in k6_rows if (r["B"], r["n_head"], r["head_dim"]) == (4, 10, 78)][0]
    n6 = llama_configs[TRAIN_MODEL]["n_layer"] * TRAIN["batch_size"] // TRAIN["micro_batch_size"]

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items() if c.get(kernel)}

    def step_sums(rows):
        """decode (M = 1), serve-step (M = 8, where measured) and prefill (M = 512) sums
        over the 161 linears of one step"""
        out = {}
        for M, prefix in ((1, ""), (SERVE_M, "m8_"), (512, "prefill_")):
            at = {(r["K"], r["N"]): r for r in rows if r["M"] == M}
            if set(at) != set(weight):
                continue
            for key in TIMED_KEYS:
                out[prefix + key] = sum(c * at[s][key] for s, c in weight.items())
        return out

    def quant_row(name, rows, path, source, replaces, fmt):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": paths[path][name], "launches_by_path": by_path(name),
                "max_abs_err": max(r["max_abs_err"] for r in rows), **step_sums(rows),
                "bound_by": "bytes", "prefill_bound_by": "operations",
                "per": f"one 7B decode step of {fmt}: 161 launches at M=1 "
                       "(m8_*: at M=8, the serve step at 8 slots; prefill_*: the "
                       "512-token prefill)"}

    k1 = [r for r in k1_rows if r["groups"] == 1 and r["model"] == "7B"]

    def q7b(name, gs, signed=False):
        return [r for r in q_rows if r["kernel"] == name and r["model"] == "7B"
                and r["groupsize"] == gs and r["signed"] == signed]

    def paged_row(name, replaces):
        rows = [r for r in paged_rows if r["kernel"] == name]
        at = [r for r in rows if (r["n_head"], r["B"], r["page"], r["fill"]) == (32, 8, 16, "full")][0]
        row = {"name": name, "route": "cuda",
               "source": "lit_llama_ja_tpu_torch/csrc/paged_attention.cu", "replaces": replaces,
               "launches": paths["serve_int8"][name], "launches_by_path": by_path(name),
               "max_abs_err": max(r["max_abs_err"] for r in rows),
               **{key: L * at[key] for key in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                               "library_ms")},
               "bound_by": at["bound_by"],
               "per": "one 7B decode step at B=8, every slot at position 2047, page 16: "
                      "32 launches"}
        if name == "paged_decode_attention":
            row.update(serve_ms_per_step=gate["k7_ms_per_step"],
                       serve_bound_ms_per_step=gate["k7_bound_ms_per_step"])
        return row

    return [
        quant_row("quant_matmul_int4", k1, "generate_int4",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_int4.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul.py:325", "int4, G=1"),
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "lit_llama_ja_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "lit_llama_ja_tpu/ops/pallas/flash_attention.py:78",
         "launches": paths["generate_int4"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"),
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": L * pre["ms"], "plain_ms": L * pre["plain_ms"], "bound_ms": L * pre["bound_ms"],
         "bound_by": pre["bound_by"], "library_ms": L * pre["library_ms"],
         "per": "one 7B prefill: 32 launches at n_head=32, T=512, head_dim=128"},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "lit_llama_ja_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "lit_llama_ja_tpu/ops/pallas/flash_attention.py:207",
         "launches": paths["train"]["flash_attention_bwd"],
         "launches_by_path": by_path("flash_attention_bwd"),
         "max_abs_err": max(r["max_abs_err"] for r in k6_rows),
         "ms": n6 * step["ms"], "plain_ms": n6 * step["plain_ms"],
         "bound_ms": n6 * step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": n6 * step["library_ms"],
         "per": f"one 125M training step: {n6} launches at B=4, n_head=10, T=2048, "
                "head_dim=78"},
        quant_row("quant_matmul_int8", q7b("quant_matmul_int8", -1, True), "generate_llm.int8",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_int8.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul.py:451",
                  "int8 (symmetric, whole-column)"),
        quant_row("quant_matmul_int2", q7b("quant_matmul_int2", -1), "generate_gptq.int2",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_sub4.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:447", "int2, G=1"),
        quant_row("quant_matmul_int3", q7b("quant_matmul_int3", -1), "generate_gptq.int3",
                  "lit_llama_ja_tpu_torch/csrc/quant_matmul_sub4.cu",
                  "lit_llama_ja_tpu/ops/pallas/quant_matmul_sub4.py:323", "int3, G=1"),
        paged_row("paged_decode_attention", "lit_llama_ja_tpu/ops/pallas/paged_attention.py:99"),
        paged_row("paged_decode_attention_db",
                  "lit_llama_ja_tpu/ops/pallas/paged_attention.py:228"),
        a8_row(w4a8_rows, paths, "quant_matmul_int4_w4a8", "generate_int4_a8",
               by_path("quant_matmul_int4_w4a8"), "quant_matmul.py:325",
               "int4 in JAX's W4A8 mode (unpack=\"int8dot_bias\"), G=1",
               "lit_llama_ja_tpu_torch/csrc/quant_matmul_w4a8.cu"),
        a8_row(a8_rows, paths, "quant_matmul_int8_w8a8", "generate_llm.int8-dyn_a8",
               by_path("quant_matmul_int8_w8a8"), "quant_matmul.py:451",
               "llm.int8-dyn's bulk in JAX's W8A8 mode (unpack=\"int8dot\"), int8 "
               "symmetric whole-column"),
        a8_row(a8_rows, paths, "quant_matmul_int2_a8", "generate_gptq.int2_a8",
               by_path("quant_matmul_int2_a8"), "quant_matmul_sub4.py:447",
               "int2 in JAX's W2A8 mode (unpack=\"int8dot_bc\"), G=1", SUB4_A8_SOURCE),
        a8_row(a8_rows, paths, "quant_matmul_int3_a8", "generate_gptq.int3_a8",
               by_path("quant_matmul_int3_a8"), "quant_matmul_sub4.py:323",
               "int3 in JAX's W3A8 mode (unpack=\"int8dot_bc\"), G=1", SUB4_A8_SOURCE),
    ]


SUB4_A8_SOURCE = "lit_llama_ja_tpu_torch/csrc/quant_matmul_sub4_a8.cu"


def a8_row(rows, paths, name, path, launches_by_path, replaces, what,
           source="lit_llama_ja_tpu_torch/csrc/quant_matmul_a8.cu"):
    """The summary row of an A8 mode of K1, K3, K4 or K5 (see `summary`)."""
    launches = paths[path][name]
    assert launches > 0, f"{path} launched no {name}"
    return {"name": name, "route": "cuda", "source": source,
            "replaces": f"lit_llama_ja_tpu/ops/pallas/{replaces}",
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            **a8_step_sums(rows, name), "bound_by": "bytes", "library_ms": None,
            "per": f"one 7B decode step of {what}: 161 launches at M=1; exact_*: the exact "
                   "kernel on the same inputs"}


# ---------------------------------------------------------------------------
# The parallel phase: 2 ranks on the one card over gloo, then 1 rank over NCCL
# ---------------------------------------------------------------------------

class IntTokenizer:
    """The parallel phase's stand-in tokenizer: a text is its token ids written in
    decimal and separated by spaces, so that the CLIs take the phase's prompts as they
    are and print their tokens."""

    bos_id, eos_id = 1, 2

    def encode(self, text, bos=True, eos=False):
        ids = [int(t) for t in text.split()]
        return np.asarray(([self.bos_id] if bos else []) + ids + ([self.eos_id] if eos else []),
                          np.int32)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


def _ids_text(ids) -> str:
    return " ".join(str(int(i)) for i in ids)


def _rel_agree(got, want):
    rel = ((got - want).norm() / want.norm()).item()
    return rel, (got.argmax(-1) == want.argmax(-1)).float().mean().item()


def par_7b_config():
    """The 7B's widths at PAR_LAYERS layers: the checkpoints PAR_CUT and PAR_GEN_CUT."""
    return LLaMAConfig.from_name("7B").replace(n_layer=PAR_LAYERS)


def par_generate(mesh, root: Path, ref, device, fmt="int4", ckpt=None, config=None):
    """7B int4 (the PAR_GEN_CUT checkpoint; or ``fmt``: a checkpoint of that format, or
    one quantized at load with ``--quantize llm.int8-dyn``) through `generate_cli.main
    --tp <world>` (a
    500-token prompt, the `kv_mode` KV cache, 16 greedy tokens): its launch counts; then
    `generate` on the same shards (the tokens repeat) and the prefill logits against
    the single-rank run's. A sub-4-bit format also holds K4 or K5 at this rank's row
    shard of layer 0's ``mlp.c_proj`` against its plain version (`row_shard_check`).
    ``config``: the checkpoint's (`par_7b_config` by default)."""
    config = par_7b_config() if config is None else config
    L, new, world = config.n_layer, PAR_GEN_NEW, mesh.world
    ckpt = root / PAR_GEN_CUT if ckpt is None else Path(ckpt)
    quantize = fmt if fmt == "llm.int8-dyn" else None
    kv = kv_mode(config, world)
    kw = dict(checkpoint_path=str(ckpt), tokenizer_path="ids", quantize=quantize,
              prompt=ref["text"], max_new_tokens=new, temperature=0.0,
              quantize_kv=kv, tp=world, fsdp=1, device="cuda")
    buf = io.StringIO()
    torch.cuda.synchronize()
    _counts_zero()
    staged0, t0 = mesh_mod.STAGED["bytes"], time.perf_counter()
    with mock.patch.object(generate_cli, "load_tokenizer", lambda _: IntTokenizer()), \
            contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()), \
            probed_graphs() as caps:
        generate_cli.main(**kw)
    torch.cuda.synchronize()
    cli_s, launches = time.perf_counter() - t0, _counts()
    staged_cli = mesh_mod.STAGED["bytes"] - staged0
    per_forward = launches_per_forward(fmt, L)
    # the CLI's one-rank run (no mesh) builds a held program: its prefill span's and its
    # decode step's warm-ups and captures launch; a mesh's prefill and steps run eagerly
    assert bool(caps) == (world == 1), (len(caps), world)
    if caps:
        expect_captures(caps, per_forward, n=1)
        assert len(of_kind(caps, "span")) == 1, len(caps)
    forwards = 2 + 2 * len(of_kind(caps)) if caps else new
    expect_launches(launches, {**{k: v * forwards for k, v in per_forward.items()},
                               "flash_attention_fwd": 2 * L if caps else L})
    params, _ = load_model_any(ckpt, quantize, device=device, mesh=mesh)
    params = cast_params(params, torch.bfloat16)
    shard_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    row_check = row_shard_check(params, mesh, device) if fmt.startswith("gptq") else None
    prompt = ref["prompt"]
    gkw = dict(temperature=0.0, cache_dtype=torch.bfloat16, quantize_kv=kv, device=device,
               mesh=mesh)

    def run(n):
        torch.cuda.synchronize()
        s0, t = mesh_mod.STAGED["bytes"], time.perf_counter()
        out = generate(params, config, prompt, n, **gkw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, mesh_mod.STAGED["bytes"] - s0

    torch.cuda.reset_peak_memory_stats()
    out_a, total_ms, staged_total = run(new)
    _, prefill_ms, staged_prefill = run(1)
    T = len(prompt)
    if mesh.rank == 0:  # the CLI printed on rank 0 alone
        cli_tokens = [int(t) for t in buf.getvalue().split()]
        assert cli_tokens == out_a.tolist(), "greedy tp generation is not repeatable"
    P = bucket_length(T)
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :T] = torch.as_tensor(prompt, device=device)
    cache = init_kv_cache(block_config(config, mesh), 1, T + new, torch.bfloat16, kv,
                          device=device)
    got = forward_with_cache(params, idx, torch.arange(P), cache, config, prefill_attn=True,
                             device=device, mesh=mesh)[0].float()
    assert got.shape == (1, P, config.padded_vocab_size) and torch.isfinite(got).all()
    rel, agree = _rel_agree(got, ref["logits"].to(device))
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    same = int((out_a[T:] == ref["tokens"][T:]).sum())
    if world == 1:  # NCCL's one-rank collectives are copies: the one-device math exactly
        assert same == new, (out_a[T:].tolist(), ref["tokens"][T:].tolist())
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    del params, cache, got
    release_programs()
    return {"launches": {k: v for k, v in launches.items() if v},
            "launches_per_forward": {**per_forward, "flash_attention_fwd": L},
            "cli_s": cli_s, "cli_staged_bytes": staged_cli, "shard_bytes": shard_bytes,
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "staged_bytes_prefill": staged_prefill,
            "staged_bytes_per_decode_step": (staged_total - staged_prefill) / (new - 1),
            "logits_rel_err": rel, "argmax_agree": agree, "repeatable": True,
            "tokens_equal_single_rank": same, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            **({"row_shard_check": row_check} if row_check else {})}


def row_shard_check(params, mesh, device):
    """K4 or K5 at this rank's row shard of layer 0's ``mlp.c_proj`` (its ``Kp/tp``
    stored rows of the padded K, the scale rows by `k_shard_groups`, its rows of the
    high-bit plane) against the plain version on the same inputs, at M = 1 and 512; x
    is zero past K, as the sharded forward pads it."""
    leaves = {k: v[0] for k, v in params["blocks"]["mlp"]["c_proj"].items()}
    tp, i = mesh.size("tp"), mesh.index("tp")
    K = LLaMAConfig.from_name("7B").n_hidden
    Ks = 4 * leaves["qweight"].shape[-2]
    leaves["scales"] = k_shard_groups(leaves["scales"], Ks * tp, i * Ks, Ks)
    leaves["zeros"] = k_shard_groups(leaves["zeros"], Ks * tp, i * Ks, Ks)
    name = "quant_matmul_int2"
    if "qweight_hi" in leaves:
        name = "quant_matmul_int3"
        leaves["qweight_hi"] = leaves["qweight_hi"].narrow(-2, i * (Ks // 8), Ks // 8)
    gx = torch.Generator(device=device).manual_seed(SEED + 42 + i)
    live = (torch.arange(i * Ks, (i + 1) * Ks, device=device) < K).to(torch.bfloat16)
    out = {"kernel": name, "stored_rows": Ks, "start": i * Ks, "K": K}
    for M in (1, 512):
        x = torch.randn((M, Ks), generator=gx, device=device).to(torch.bfloat16) * live
        err, tol = check_quant(name, x, leaves, f"row shard {i} M {M}")
        out[f"M{M}"] = {"max_abs_err": err, "tol": tol}
    return out


def par_one_rank_decode(mesh, root: Path, ref, device):
    """`generate` on a mesh of one NCCL rank whose collectives are the identity (the
    default): the single-rank tokens exactly, and the decode ms a token."""
    config = par_7b_config()
    assert not mesh.active("tp")
    params, _ = load_model_any(root / PAR_GEN_CUT, None, device=device, mesh=mesh)
    params = cast_params(params, torch.bfloat16)
    kw = dict(temperature=0.0, cache_dtype=torch.bfloat16, quantize_kv="int4", device=device,
              mesh=mesh)
    times = {}
    for n in (PAR_GEN_NEW, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, config, ref["prompt"], n, **kw)
        torch.cuda.synchronize()
        times[n] = (time.perf_counter() - t0) * 1e3
        if n == PAR_GEN_NEW:
            T = len(ref["prompt"])
            assert out[T:].tolist() == ref["tokens"][T:].tolist()
    del params
    release_programs()
    return {"decode_ms_per_token": (times[PAR_GEN_NEW] - times[1]) / (PAR_GEN_NEW - 1),
            "prefill_ms": times[1], "tokens_equal_single_rank": PAR_GEN_NEW}


def par_serve(mesh, root: Path, device):
    """7B int4 through `serve_cli.main --tp <world>` (int8 pool, 8 requests of 64-1000
    tokens): every request answered; then `PagedEngine` on the same shards twice (the
    tokens repeat, K7's launches a decode step) and one step's logits through K7 on the
    rank's heads against its plain version."""
    config = LLaMAConfig.from_name("7B")
    L, world = config.n_layer, mesh.world
    prompts = serve_mix(config)[1][:PAR_SERVE_REQUESTS]
    (root / f"prompts-{mesh.rank}.txt").write_text("\n".join(_ids_text(p) for p in prompts))
    buf = io.StringIO()
    with mock.patch.object(generate_cli, "load_tokenizer", lambda _: IntTokenizer()), \
            contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        serve_cli.main(prompts_file=str(root / f"prompts-{mesh.rank}.txt"),
                       checkpoint_path=str(root / "int4_7b"), tokenizer_path="ids",
                       max_new_tokens=PAR_SERVE_NEW, temperature=0.0, quantize_kv="int8",
                       max_batch=SERVE["max_batch"], page_size=SERVE["page_size"],
                       n_pages=SERVE["n_pages"], prefill_chunk=SERVE["prefill_chunk"],
                       tp=world, device="cuda")
    if mesh.rank == 0:
        assert buf.getvalue().count("--- request ") == len(prompts), buf.getvalue()[-2000:]
    params, _ = load_model_any(root / "int4_7b", None, device=device, mesh=mesh)
    params = cast_params(params, torch.bfloat16)
    per_forward = launches_per_forward("int4", L)
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, mesh=mesh, **SERVE)
    torch.cuda.reset_peak_memory_stats()
    s0 = mesh_mod.STAGED["bytes"]
    (tokens, spans, steps, first, wall), launches = counted_drive(engine, prompts,
                                                                  new=PAR_SERVE_NEW)
    staged = mesh_mod.STAGED["bytes"] - s0
    stats = engine.stats()
    n_decode, n_from0 = stats["steps"], sum(s == 0 for s in spans)
    expect_launches(launches, {**{k: v * (n_decode + len(spans)) for k, v in per_forward.items()},
                               "flash_attention_fwd": L * n_from0,
                               "paged_decode_attention": L * n_decode})
    assert all(len(t) == PAR_SERVE_NEW and all(0 <= x < config.padded_vocab_size for x in t)
               for t in tokens.values())
    assert stats["completed_requests"] == len(prompts), stats
    del engine
    release_programs()
    gate, timer = {}, Timer(device)
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, mesh=mesh, **SERVE)
    tokens_b = drive(engine, prompts, new=PAR_SERVE_NEW,
                     on_step=lambda e: decode_step_gate(e, timer, device, gate))[0]
    assert tokens_b == tokens, "greedy tp serving is not repeatable"
    assert gate, "no step with every slot decoding"
    pool_heads = engine.pool["k"].shape[2]
    del engine, params
    release_programs()
    return {"requests": len(prompts), "prompt_lengths": [len(p) for p in prompts],
            "pool_heads_per_rank": pool_heads, **serve_stats(tokens, steps, first, wall),
            "decode_steps": n_decode, "prefill_spans": len(spans),
            "launches": {k: v for k, v in launches.items() if v},
            "k7_launches_per_decode_step": launches["paged_decode_attention"] / n_decode,
            "staged_bytes": staged, "repeatable": True, "decode_step_gate": gate,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def one_rank_spec(ckpt: Path, config, device, stripe: bool = True):
    """The one-rank references of the mesh speculative runs, ``ckpt`` drafting for itself:
    `SpeculativePagedEngine` (K MESH_SPEC_K) and `TreeSpeculativePagedEngine`
    (MESH_SPEC_TREE) over an int8 pool and, with ``stripe``, the stripe `Engine` (int8
    cache), on the parallel phase's requests after a BOS (as serve_cli sends them),
    PAR_SERVE_NEW greedy tokens each, each eager and then with its rounds or steps
    captured (`gated_engine_runs`: tokens and pools equal, a round's K1 launches a
    graph): the captured run's tokens (the ranks read them back from JSON), launches
    (gated), acceptance, tokens a round, step and round times, and the eager run's."""
    params, _ = load_model_any(ckpt, None, device=device)
    out = spec_engine_runs(cast_params(params, torch.bfloat16), config, device, stripe)
    del params
    release_programs()
    return out


def spec_engine_runs(params, config, device, stripe: bool = True):
    """`one_rank_spec`'s runs on int4 ``params`` in memory."""
    prompts, _ = pp_prompts(config)
    L, out = config.n_layer, {}
    kw = dict(quantize_kv="int8", device=device, eos_id=IntTokenizer.eos_id)
    engines = [("chain", lambda cg: SpeculativePagedEngine(
                    params, config, draft_params=params, draft_config=config,
                    draft_k=MESH_SPEC_K, **kw, **SERVE, cuda_graph=cg)),
               ("tree", lambda cg: TreeSpeculativePagedEngine(
                   params, config, draft_params=params, draft_config=config,
                   tree=MESH_SPEC_TREE, **kw, **SERVE, cuda_graph=cg))]
    if stripe:
        engines.append(("stripe", lambda cg: Engine(params, config, max_batch=SERVE["max_batch"],
                                                    max_seq_length=2048, **kw, cuda_graph=cg)))

    def per_round(engine):
        if isinstance(engine, Engine):
            return launches_per_forward("int4", L)
        return spec_round_launches(engine, L, L)

    def expect(engine, spans, n):
        if isinstance(engine, Engine):
            return stripe_launches(engine, L, n, len(spans))
        return spec_launches(engine, spans, L, L, rounds=n)[0]

    for name, make in engines:
        tokens, line = gated_engine_runs(make, prompts, per_round, expect, new=PAR_SERVE_NEW)
        out[name] = {"tokens": tokens, **line["captured"], "eager": line["eager"]}
    return out


def cli_serve(root: Path, tag: str, rank: int, raw, prompts, expect, want, **kw):
    """`serve_cli.main` on the ``raw`` requests (IntTokenizer text) at the parallel
    phase's settings (int8 pool, PAR_SERVE_NEW greedy tokens, serve_cli's paged
    defaults), every kernel's count set to 0 just before and read just after, its engine
    probed (`probed_engines`). Gates every request answered and the launches at
    ``expect(engine, spans) -> (counts, GEMV launches or None)``; returns the CLI's
    seconds, launches, and on rank 0 the share of ``want``'s tokens that the printed
    requests match (``want``: the one-rank engine's tokens by request)."""
    path = root / f"{tag}-prompts-{rank}.txt"
    path.write_text("\n".join(_ids_text(p) for p in raw))
    buf = io.StringIO()
    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    with probed_engines() as seen, \
            mock.patch.object(generate_cli, "load_tokenizer", lambda _: IntTokenizer()), \
            contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        serve_cli.main(prompts_file=str(path), tokenizer_path="ids",
                       max_new_tokens=PAR_SERVE_NEW, temperature=0.0, quantize_kv="int8",
                       max_batch=SERVE["max_batch"], page_size=SERVE["page_size"],
                       n_pages=SERVE["n_pages"], prefill_chunk=SERVE["prefill_chunk"],
                       device="cuda", **kw)
    torch.cuda.synchronize()
    cli_s, launches = time.perf_counter() - t0, _counts()
    (engine,) = seen["engines"]
    counts, gemv = expect(engine, seen["spans"])
    expect_launches(launches, counts)
    stats = engine.stats()
    assert engine._next_id == len(prompts) and not engine.queue, stats
    assert all(r is None for r in engine.slot_req), stats
    row = {"cli_s": cli_s, "launches": {k: v for k, v in launches.items() if v},
           "steps": stats["steps"], "prefill_spans": len(seen["spans"])}
    if gemv is not None:
        row.update(spec_stats(engine), k1_gemv_launches=gemv)
    del engine, seen
    release_programs()
    if rank == 0:
        printed = _ids_from_cli(buf.getvalue())
        assert len(printed) == len(prompts), buf.getvalue()[-2000:]
        got = {rid: ids[len(prompts[rid]):] for rid, ids in printed.items()}
        row["share_equal_one_rank"] = share_equal(got, want)
    return row


def par_spec_serve(mesh, root: Path):
    """7B int4 through `serve_cli.main --tp <world>` with the checkpoint as its own draft,
    whole on every rank (a chain of MESH_SPEC_K, and ``--draft-tree`` MESH_SPEC_TREE),
    and with ``--paged false`` (the stripe engine: its cache of the rank's 16 heads, K2
    in each prefill, K1 GEMVs in each decode step): every request answered, the K1 and
    K2 launches worked out from the code, and the share of tokens equal to the one-rank
    engine's (printed: tp sums the row-parallel products in another order)."""
    config = par_7b_config()
    L, ckpt = config.n_layer, str(root / PAR_CUT)
    prompts, raw = pp_prompts(config)
    ref = json.loads((root / "spec_ref.json").read_text())
    tree = ",".join(str(b) for b in MESH_SPEC_TREE)
    runs = {"chain": (dict(draft_checkpoint_path=ckpt, draft_k=MESH_SPEC_K),
                      lambda e, sp: spec_launches(e, sp, L, L)),
            "tree": (dict(draft_checkpoint_path=ckpt, draft_tree=tree),
                     lambda e, sp: spec_launches(e, sp, L, L)),
            "stripe": (dict(paged=False), lambda e, sp: (stripe_launches(e, L), None))}
    out = {}
    for name, (kw, expect) in runs.items():
        want = {int(k): v for k, v in ref[name]["tokens"].items()}
        out[name] = cli_serve(root, f"tp-{name}", mesh.rank, raw, prompts, expect, want,
                              checkpoint_path=ckpt, tp=mesh.shape["tp"], **kw)
    return out


def sequential_hops(x, full, K, mesh):
    """This rank's columns of `ring_quant_matmul`, the hops run one after the other
    without the ring, in the ring's order (hop i multiplies K-shard ``(d + i) mod n``),
    each shard cut by `k_shard` for its rank on a mesh without a process group."""
    n, d = mesh.world, mesh.index("fsdp")
    K_loc = K // n
    y = None
    for i in range(n):
        k_idx = (d + i) % n
        shard = k_shard(full, K, Mesh({"dp": 1, "fsdp": n, "tp": 1}, k_idx, distributed=False))
        part = quant_matmul(x[:, k_idx * K_loc:(k_idx + 1) * K_loc],
                            {"qweight": shard["qweight"][d], "scales": shard["scales"][d],
                             "zeros": shard["zeros"][d]}).float()
        y = part if y is None else y + part
    return y.to(x.dtype)


def par_ring(mesh, device):
    """`ring_quant_matmul` over all ranks (int4 K1 hops, int8 K3 hops) at 4096 x 4096 and
    4096 x 11008, M 1 and 512, against ``x @ dequantize_with_k`` of the whole pack on
    the card; this rank's columns equal in bits to the same hops run one after the other
    (`sequential_hops`: the order before the hops overlapped); no bytes copied a call
    (`k_shard` blocks the shard once); launches a call; ms beside the one-rank kernel on
    the whole pack."""
    n, d = mesh.world, mesh.index("fsdp")
    g = torch.Generator(device=device).manual_seed(SEED + 15)
    rows, copy0, launches = [], RING_COPY["bytes"], {}
    for bits, (K, N) in [(b, s) for b in (4, 8) for s in PAR_RING_SHAPES]:
        if bits == 4:
            qw, s, z = synth_int4(g, K, N, 1, device)
            full = {"qweight": qw, "scales": s, "zeros": z}
        else:
            full = synth_quant(g, 8, K, N, -1, device, signed=True)
        name = "quant_matmul_int4" if bits == 4 else "quant_matmul_int8"
        shard = k_shard(full, K, mesh, "fsdp")
        w = dequantize_with_k(full, K, dtype=torch.float32)
        for M in PAR_RING_M:
            x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
            _counts_zero()
            copy_before = RING_COPY["bytes"]
            got = ring_quant_matmul(x, shard, mesh, axis="fsdp", grouped=False)
            copied = RING_COPY["bytes"] - copy_before
            hops = _counts()[name]
            assert hops == n and copied == 0, (name, hops, copied)
            launches[name] = launches.get(name, 0) + hops
            want = x.float() @ w
            err = (got.float() - want).abs().max().item()
            assert err <= REL_TOL * want.abs().max().item(), (bits, K, N, M, err)
            seq = sequential_hops(x, full, K, mesh)
            assert torch.equal(got[:, d * (N // n):(d + 1) * (N // n)], seq), (bits, K, N, M)
            t0 = time.perf_counter()
            for _ in range(5):
                ring_quant_matmul(x, shard, mesh, axis="fsdp", grouped=False)
            torch.cuda.synchronize()
            ring_ms = (time.perf_counter() - t0) / 5 * 1e3
            kern = QUANT_KERNELS[name][0]
            one_ms = Timer(device).ms(lambda: kern(x, *quant_args(name, full)))
            rows.append({"kernel": name, "K": K, "N": N, "M": M, "hop_shape": [K // n, N // n],
                         "launches_per_call": hops, "max_abs_err": err,
                         "bits_equal_sequential_hops": True, "copy_bytes_per_call": copied,
                         "ring_wall_ms": ring_ms, "one_rank_kernel_ms": one_ms})
        del full, shard, w
    return {"rows": rows, "launches": launches,
            "column_block_copy_bytes": RING_COPY["bytes"] - copy0}


def par_pretrain(mesh, root: Path, ref_losses):
    """125M ja through `pretrain_cli.main` on the train phase's data and seed: ``--fsdp``
    over every rank (1 step, a save after it), ``--tp`` (1 step), then a ``--resume`` of
    the fsdp run's state for a second step; each against the single-rank CLI's losses
    (the same 2 micro-batches of 4 a step)."""
    world = mesh.world
    data = dict(train_data_dir=str(root / "data" / "train"))
    runs = {"fsdp": dict(fsdp=world, tp=1, max_iters=1, save_interval=1),
            "tp": dict(fsdp=1, tp=world, max_iters=1),
            "fsdp_resume": dict(fsdp=world, tp=1, max_iters=2,
                                resume=str(root / "fsdp" / "state-latest"))}
    out = {}
    for name, kw in runs.items():
        torch.cuda.synchronize()
        _counts_zero()
        s0, t0 = mesh_mod.STAGED["bytes"], time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        with open(root / f"pretrain-{mesh.rank}.log", "a") as f, contextlib.redirect_stdout(f):
            pretrain_cli.main(**{**TRAIN, **PAR_TRAIN, "batch_size": PAR_TRAIN_BATCH * world,
                                 "model_size": TRAIN_MODEL, "out_dir": str(root / name),
                                 **data, **kw})
        torch.cuda.synchronize()
        steps = kw["max_iters"] - (1 if "resume" in kw else 0)
        launches = _counts()
        per_step = llama_configs[TRAIN_MODEL]["n_layer"] * PAR_TRAIN_BATCH // TRAIN["micro_batch_size"]
        assert launches["flash_attention_bwd"] == per_step * steps, (name, launches)
        row = {"steps": steps, "wall_s": time.perf_counter() - t0,
               "staged_bytes_per_step": (mesh_mod.STAGED["bytes"] - s0) / steps,
               "launches": {k: v for k, v in launches.items() if v},
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if mesh.rank == 0:  # rank 0 writes the metrics
            losses = _losses(root / name)
            want = {i: ref_losses[i] for i in losses}
            assert len(losses) == steps and all(
                abs(losses[i] - want[i]) <= RESUME_REL_TOL * abs(want[i]) for i in losses), (
                name, losses, want)
            row.update(losses=losses, single_rank_losses=want)
        out[name] = row
    return out


def par_moe(mesh, device):
    """`forward_moe_ep` and one `make_moe_train_step_ep` step with ep over every rank on
    the 125M ja MoE (8 experts, top 2, room for every token) against `forward_moe` and
    the one-device step on the same weights and batch (bf16 compute)."""
    cfg = MoEConfig.from_name(TRAIN_MODEL, **PAR_MOE)
    g = torch.Generator(device=device).manual_seed(SEED + 16)
    full = init_moe_params(g, cfg, device=device)
    local = shard_params_ep(full, mesh)
    B, T = PAR_MOE_BT
    batch = torch.randint(1, cfg.vocab_size, (B, T + 1), generator=g, device=device)
    bf16 = torch.bfloat16
    _counts_zero()
    got, aux = forward_moe_ep(cast_params(local, bf16), batch[:, :-1], cfg, mesh)
    fwd_launches = _counts()
    want, want_aux = forward_moe(cast_params(full, bf16), batch[:, :-1], cfg, device=device)
    rel, agree = _rel_agree(got.float(), want.float())
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    assert float(aux["dropped"]) == 0.0 and float(want_aux["dropped"]) == 0.0
    opt = make_adamw(1e-4)
    step = make_moe_train_step_ep(cfg, opt, mesh, compute_dtype=bf16).jit_with(local)
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    _, _, loss = step(local, init_opt_state(opt, local), batch)
    step_launches = _counts()
    opt1 = make_adamw(1e-4)
    one = make_moe_train_step(cfg, opt1, compute_dtype=bf16, device=device)
    _, _, want_loss = one(full, init_opt_state(opt1, full), batch[None])
    loss, want_loss = float(loss), float(want_loss)
    assert math.isfinite(loss) and abs(loss - want_loss) <= RESUME_REL_TOL * abs(want_loss), (
        loss, want_loss)
    del full, local, one  # the captured step's graph holds its params and its pool
    release_programs()
    return {"experts_per_rank": cfg.n_expert // mesh.world, "B": B, "T": T,
            "logits_rel_err": rel, "argmax_agree": agree,
            "load_balance": float(aux["load_balance"]),
            "load_balance_one_device": float(want_aux["load_balance"]),
            "loss": loss, "loss_one_device": want_loss,
            "forward_launches": {k: v for k, v in fwd_launches.items() if v},
            "step_launches": {k: v for k, v in step_launches.items() if v},
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def sp_grads(params, idx, cfg, mesh):
    """The next-token loss of `forward_sp` (ring) on ``idx`` and its gradients: one
    forward and backward, timed; the gradients (f32, flat, in `_leaves` order) are this
    rank's partial sums."""
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = forward_sp(params, idx, cfg, mesh, attn_impl="ring")
    loss = cross_entropy_loss(logits[:, :-1], idx[:, 1:])
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    flat = torch.cat([t.grad.float().flatten() for t in leaves])
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return loss.item(), flat, ms


def par_sp(mesh, device):
    """`forward_sp` with the ring attention over every rank on the 125M ja config at
    T = 2 x block_size, against the same function on one rank; then its backward (f32
    weights): the ranks' gradients summed over the axis against one rank's
    (`PAR_SP_GRAD_TOL`), the step's ms and the all-reduce's."""
    cfg = LLaMAConfig.from_name(TRAIN_MODEL)
    g = torch.Generator(device=device).manual_seed(SEED + 17)
    p32 = init_params(g, cfg, device=device)
    params = cast_params(p32, torch.bfloat16)
    idx = torch.randint(1, cfg.vocab_size, (1, PAR_SP_T), generator=g, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = forward_sp(params, idx, cfg, mesh, attn_impl="ring").float()
    torch.cuda.synchronize()
    sp_ms = (time.perf_counter() - t0) * 1e3
    want = forward_sp(params, idx, cfg, single_device_mesh(), attn_impl="ring").float()
    assert got.shape == (1, PAR_SP_T, cfg.padded_vocab_size) and torch.isfinite(got).all()
    rel, agree = _rel_agree(got, want)
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE, (rel, agree)
    del params, got, want
    release_programs()
    torch.cuda.reset_peak_memory_stats()
    s0 = mesh_mod.STAGED["bytes"]
    loss, flat, step_ms = sp_grads(p32, idx, cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summed = all_reduce(flat, mesh, "tp")
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3
    bwd = {"loss": loss, "step_ms": step_ms, "grad_all_reduce_ms": reduce_ms,
           "staged_bytes": mesh_mod.STAGED["bytes"] - s0,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del flat
    release_programs()
    mesh_mod.barrier(mesh)
    if mesh.rank == 0:  # one rank's gradients, the reference, once the ranks' are freed
        one_loss, one, one_ms = sp_grads(p32, idx, cfg, single_device_mesh())
        sizes = [t.numel() for t in _leaves(p32)]
        worst = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                    for a, b in zip(summed.split(sizes), one.split(sizes)))
        assert torch.isfinite(summed).all() and worst <= PAR_SP_GRAD_TOL, worst
        assert abs(loss - one_loss) <= PAR_SP_GRAD_TOL * abs(one_loss), (loss, one_loss)
        bwd.update(one_rank_loss=one_loss, one_rank_step_ms=one_ms,
                   worst_leaf_grad_rel_err=worst, tol=PAR_SP_GRAD_TOL)
        del one
    del summed, p32
    release_programs()
    mesh_mod.barrier(mesh)
    return {"T": PAR_SP_T, "block_size": cfg.block_size, "logits_rel_err": rel,
            "argmax_agree": agree, "wall_ms": sp_ms, "backward": bwd}


def _parallel_rank(rank, world, root, backend, ref):
    """One rank of the parallel phase: every sub-phase in turn, its result written to
    ``root/<backend>-<rank>.json``. Any failure ends the process with an error, and so
    the run."""
    import torch.distributed as dist

    root = Path(root)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous-{backend}",
                            rank=rank, world_size=world)
    try:
        device = torch.device("cuda")
        out = {"backend": backend, "world": world, "rank": rank}
        if backend == "nccl":  # the one-rank NCCL collectives as device copies
            mesh_mod.ONE_RANK_COLLECTIVES["nccl"] = True
        mesh_tp = make_mesh(dp=1, fsdp=1, tp=world)
        out["generate"] = par_generate(mesh_tp, root, ref, device)
        if world > 1:
            t0 = time.perf_counter()
            for fmt, (name, tag) in PAR_QUANT.items():
                q = ref["quant"][fmt]
                out[name] = par_generate(mesh_tp, root, {**ref, **q}, device, fmt, q["ckpt"],
                                         q["config"])
            out["generate_quant_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["finetune"] = par_finetune(root, ref["ckpt125"])
            out["finetune_s"] = time.perf_counter() - t0
        if backend == "nccl":
            mesh_mod.ONE_RANK_COLLECTIVES["nccl"] = False
            out["generate_one_rank_identity"] = par_one_rank_decode(mesh_tp, root, ref,
                                                                    device)
        if world > 1:
            out["serve"] = par_serve(mesh_tp, root, device)
            out["spec_serve"] = par_spec_serve(mesh_tp, root)
            out["ring"] = par_ring(make_mesh(dp=1, fsdp=world, tp=1), device)
            out["pretrain"] = par_pretrain(mesh_tp, root, ref["losses"])
            out["moe_ep"] = par_moe(make_mesh(dp=1, fsdp=1, tp=1, ep=world), device)
            out["sp_ring"] = par_sp(mesh_tp, device)
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        (root / f"{backend}-{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def kv_mode(config, world=PAR_WORLD):
    """The KV cache of the tp generations: int4, or int8 where a rank's heads do not
    pair (the 125M's 10 heads over tp 2)."""
    return "int4" if (config.n_head // world) % 2 == 0 else "int8"


def one_rank_generation(params, config, prompt, device):
    """The one-rank reference of a tp generation: 16 greedy tokens after ``prompt``
    (the `kv_mode` cache) and the prefill logits (on the host)."""
    kv = kv_mode(config)
    tokens = generate(params, config, prompt, PAR_GEN_NEW, temperature=0.0,
                      cache_dtype=torch.bfloat16, quantize_kv=kv, device=device)
    P = bucket_length(len(prompt))
    idx = torch.zeros((1, P), dtype=torch.long, device=device)
    idx[0, :len(prompt)] = torch.as_tensor(prompt, device=device)
    cache = init_kv_cache(config, 1, len(prompt) + PAR_GEN_NEW, torch.bfloat16, kv,
                          device=device)
    logits = forward_with_cache(params, idx, torch.arange(P), cache, config, prefill_attn=True,
                                device=device)[0].float().cpu()
    return tokens, logits


def phase_parallel(g, device, ckpt125: Path):
    """2 ranks on the one card over gloo (host-staged collectives), then 1 rank over
    NCCL; see the module docstring. ``ckpt125``: the train phase's checkpoint (for
    llm.int8-dyn at load). Returns the launch counts of each rank-0 path."""
    import torch.multiprocessing as mp

    phase_t0 = time.perf_counter()
    root = WORK_DIR / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = LLaMAConfig.from_name("7B")
    params = synth_7b_params(config, g, device, "int4")
    t0 = time.perf_counter()
    save_checkpoint(root / "int4_7b", params, config)
    save_s = time.perf_counter() - t0
    del params
    release_programs()
    rng = np.random.default_rng(SEED + 15)
    prompt = np.concatenate([[1], rng.integers(3, config.vocab_size, PAR_GEN_PROMPT - 1)])
    # the tp-2 int4 generation's checkpoint and its one-rank run
    gen_cfg = par_7b_config()
    params = synth_7b_params(gen_cfg, torch.Generator(device=device).manual_seed(SEED + 46),
                             device, "int4", unit_gain=True)
    save_checkpoint(root / PAR_GEN_CUT, params, gen_cfg)
    tokens, logits = one_rank_generation(params, gen_cfg, prompt, device)
    del params
    release_programs()
    # the tp-2 generations of the sub-4-bit formats (the 7B's widths cut to
    # PAR_QUANT_LAYERS layers) and of llm.int8-dyn (quantized at load from the train
    # phase's 125M checkpoint): their checkpoints and one-rank runs
    t0 = time.perf_counter()
    g_quant = torch.Generator(device=device).manual_seed(SEED + 41)
    quant_refs = {}
    for fmt, (_, tag) in PAR_QUANT.items():
        if tag is None:
            params, qcfg = load_model_any(ckpt125, fmt, device=device)
            params, qckpt = cast_params(params, torch.bfloat16), ckpt125
        else:
            qcfg, qckpt = config.replace(n_layer=PAR_QUANT_LAYERS), root / tag
            params = synth_7b_params(qcfg, g_quant, device, fmt)
            save_checkpoint(qckpt, params, qcfg)
        quant_refs[fmt] = {"ckpt": str(qckpt), "config": qcfg, **dict(zip(
            ("tokens", "logits"), one_rank_generation(params, qcfg, prompt, device)))}
        del params
        release_programs()
    quant_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft_ref = par_finetune_refs(root, ckpt125, device)
    finetune_setup_s = time.perf_counter() - t0
    tcfg = LLaMAConfig.from_name(TRAIN_MODEL)
    write_synth_data(root / "data", tcfg)
    with open(root / "pretrain-single.log", "w") as f, contextlib.redirect_stdout(f):
        pretrain_cli.main(**{**TRAIN, **PAR_TRAIN, "batch_size": PAR_TRAIN_BATCH, "max_iters": 2,
                             "model_size": TRAIN_MODEL, "out_dir": str(root / "single"),
                             "train_data_dir": str(root / "data" / "train")})
    release_programs()  # the CLI's graph pool, for the ranks that share the card
    # the CLI encodes the prompt's ids after a BOS: the reference ran on BOS + ids
    ref = {"prompt": prompt.astype(np.int32), "text": _ids_text(prompt[1:]), "tokens": tokens,
           "logits": logits, "losses": _losses(root / "single"), "quant": quant_refs,
           "ckpt125": str(ckpt125)}
    # the speculative and pipeline paths' checkpoint, cut to PAR_LAYERS layers, and the
    # one-rank speculative and stripe runs that the tp and pp ranks are held to
    t0 = time.perf_counter()
    cut_cfg = par_7b_config()
    params = synth_7b_params(cut_cfg, torch.Generator(device=device).manual_seed(SEED + 45),
                             device, "int4")
    save_checkpoint(root / PAR_CUT, params, cut_cfg)
    del params
    release_programs()
    cut_save_s = time.perf_counter() - t0
    spec_ref = one_rank_spec(root / PAR_CUT, cut_cfg, device)
    (root / "spec_ref.json").write_text(json.dumps(spec_ref))
    emit({"phase": "parallel_spec_one_rank", "draft": "the target itself",
          "k": MESH_SPEC_K, "tree": list(MESH_SPEC_TREE),
          "runs": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                   for k, v in spec_ref.items()}})
    setup_s = time.perf_counter() - phase_t0
    paths = {}
    for backend, world in (("gloo", PAR_WORLD), ("nccl", 1)):
        t0 = time.perf_counter()
        mp.spawn(_parallel_rank, args=(world, str(root), backend, ref), nprocs=world, join=True)
        ranks = [json.loads((root / f"{backend}-{r}.json").read_text()) for r in range(world)]
        wall = time.perf_counter() - t0
        if backend == "gloo":
            ranks_quant_s = ranks[0]["generate_quant_s"]
            paths.update(par_finetune_gate(ranks, ft_ref, finetune_setup_s))
        for sub in ("generate", "generate_int3", "generate_mix", "generate_int8dyn",
                    "generate_one_rank_identity", "serve", "spec_serve", "ring",
                    "pretrain", "moe_ep", "sp_ring"):
            if sub not in ranks[0]:
                continue
            emit({"phase": f"parallel_{sub}", "backend": backend, "world": world,
                  "ranks": [r[sub] for r in ranks]})
            rows = ranks[0][sub] if sub in ("pretrain", "spec_serve") else {"": ranks[0][sub]}
            for name, row in rows.items():
                for key in ("launches", "forward_launches", "step_launches"):
                    if key in row:
                        paths[f"parallel_{sub}{name and '_' + name}_{key}_{backend}{world}"] = (
                            row[key])
        emit({"phase": "parallel", "backend": backend, "world": world, "wall_s": wall,
              "peak_mem_bytes_by_rank": [r["peak_mem_bytes"] for r in ranks]})
    for _, tag in PAR_QUANT.values():
        if tag is not None:
            shutil.rmtree(root / tag)
    emit({"phase": "parallel_total", "setup_s": setup_s, "checkpoint_save_s": save_s,
          "cut_checkpoint_save_s": cut_save_s,
          "quant_setup_s": quant_setup_s, "quant_generate_s_rank0": ranks_quant_s,
          "wall_s": time.perf_counter() - phase_t0})
    return paths  # the pipeline phase reads the checkpoint and the data, then removes them


# ---------------------------------------------------------------------------
# The pipeline phase: 2 stages on the one card over gloo
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def deterministic():
    """Deterministic CUDA algorithms (the embedding backward and the MoE dispatch add in
    a fixed order instead of with atomics), so that two runs of one step sum alike."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _ids_from_cli(text: str):
    """The generated ids of each request that `serve_cli.main` printed (IntTokenizer)."""
    parts = re.split(r"--- request (\d+) ---\n", text)[1:]
    return {int(rid): [int(t) for t in body.split()] for rid, body in zip(parts[::2],
                                                                          parts[1::2])}


def gpipe_case(device):
    """The 125M config, f32 weights and a (PP_M, PP_MB, T + 1) batch from the seed."""
    cfg = LLaMAConfig.from_name(TRAIN_MODEL)
    g = torch.Generator(device=device).manual_seed(SEED + 18)
    params = init_params(g, cfg, device=device)
    batch = torch.randint(1, cfg.vocab_size, (PP_M, PP_MB, cfg.block_size + 1), generator=g,
                          device=device)
    return cfg, params, batch


def moe_case(device):
    """The 125M MoE config at the CLI's capacity factor, weights and a PAR_TRAIN_BATCH-row
    micro-batch from the seed."""
    cfg = MoEConfig.from_name(TRAIN_MODEL, **PP_MOE)
    g = torch.Generator(device=device).manual_seed(SEED + 19)
    params = init_moe_params(g, cfg, device=device)
    batch = torch.randint(1, cfg.vocab_size, (PP_WORLD * 2, cfg.block_size), generator=g,
                          device=device)
    return cfg, params, batch


def pp_prompts(config):
    """The parallel phase's requests as the serve CLI sends them (after a BOS), and the
    text that the CLI reads (IntTokenizer)."""
    raw = serve_mix(config)[1][:PAR_SERVE_REQUESTS]
    return [np.concatenate([[IntTokenizer.bos_id], p]).astype(np.int32) for p in raw], raw


def moe_cli_run(root: Path, name: str, **kw):
    """One 125M MoE step through `pretrain_cli.main` (no checkpoint written); its loss,
    read from the metrics that rank 0 writes (None on the other ranks)."""
    with mock.patch.object(pretrain_cli, "save_train_state", lambda *a, **k: None), \
            mock.patch.object(pretrain_cli, "save_checkpoint", lambda *a, **k: None), \
            open(root / f"moe-{name}.log", "a") as f, contextlib.redirect_stdout(f), \
            deterministic():
        pretrain_cli.main(**{**TRAIN, **PAR_TRAIN, "max_iters": 1, "model_size": TRAIN_MODEL,
                             "moe_experts": PP_MOE["n_expert"],
                             "moe_topk": PP_MOE["n_expert_active"], "out_dir": str(root / name),
                             "train_data_dir": str(root / "data" / "train"), **kw})
    if torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
        return None  # the file may hold rank 0's partial writes
    return _losses(root / name)[0]


def pp_serve(mesh, root: Path, ref, device):
    """7B int4 through `serve_cli.main --pp-stages 2 --pp-microbatches 2` (int8 pool,
    the parallel phase's 8 requests, 16 greedy tokens): the one-rank engine's tokens;
    then `PagedEngine(pp_mesh=)` on this stage's layers: the same tokens, its launches,
    step times and staged bytes."""
    config = par_7b_config()
    L, S, s = config.n_layer, mesh.shape["pp"], mesh.index("pp")
    L_local, last = L // S, int(s == S - 1)
    prompts, raw = pp_prompts(config)
    (root / f"pp-prompts-{mesh.rank}.txt").write_text("\n".join(_ids_text(p) for p in raw))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(generate_cli, "load_tokenizer", lambda _: IntTokenizer()), \
            contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        serve_cli.main(prompts_file=str(root / f"pp-prompts-{mesh.rank}.txt"),
                       checkpoint_path=str(root / PAR_CUT), tokenizer_path="ids",
                       max_new_tokens=PAR_SERVE_NEW, temperature=0.0, quantize_kv="int8",
                       max_batch=SERVE["max_batch"], page_size=SERVE["page_size"],
                       n_pages=SERVE["n_pages"], prefill_chunk=SERVE["prefill_chunk"],
                       pp_stages=S, pp_microbatches=PP_MICRO, device="cuda")
    cli_s = time.perf_counter() - t0
    want = ref["serve_tokens"]
    if mesh.rank == 0:
        printed = _ids_from_cli(buf.getvalue())
        assert len(printed) == len(prompts), buf.getvalue()[-2000:]
        for rid, ids in printed.items():
            assert ids[len(ids) - len(want[rid]):] == want[rid], (rid, ids[-20:], want[rid])
    params, _ = load_model_any(root / PAR_CUT, None, device=device, mesh=mesh)
    params = cast_params(params, torch.bfloat16)
    assert params["blocks"]["rms_1"]["scale"].shape[0] == L_local
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, pp_mesh=mesh,
                         pp_microbatches=PP_MICRO, eos_id=IntTokenizer.eos_id, **SERVE)
    torch.cuda.reset_peak_memory_stats()
    s0 = mesh_mod.STAGED["bytes"]
    (tokens, spans, steps, first, wall), launches = counted_drive(engine, prompts,
                                                                  new=PAR_SERVE_NEW)
    staged = mesh_mod.STAGED["bytes"] - s0
    assert tokens == want, "pipeline serving differs from the one-rank engine"
    n_decode, n_from0 = engine.stats()["steps"], sum(sp == 0 for sp in spans)
    gemv = n_decode * PP_MICRO * (5 * L_local + last)
    gemm = len(spans) * (5 * L_local + last)
    expect_launches(launches, {"quant_matmul_int4": gemv + gemm,
                               "flash_attention_fwd": L_local * n_from0,
                               "paged_decode_attention": L_local * PP_MICRO * n_decode})
    pool_layers = engine.pool["k"].shape[0]
    del engine, params
    release_programs()
    return {"stage": s, "layers": L_local, "pool_layers": pool_layers, "cli_s": cli_s,
            "requests": len(prompts), **serve_stats(tokens, steps, first, wall),
            "decode_steps": n_decode, "prefill_spans": len(spans),
            "launches": {k: v for k, v in launches.items() if v},
            "k1_gemv_launches": gemv, "k1_gemm_launches": gemm,
            "k7_launches_per_decode_step": launches["paged_decode_attention"] / n_decode,
            "staged_bytes": staged, "staged_bytes_per_step": staged / len(steps),
            "tokens_equal_one_rank": True,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def pp_spec_serve(mesh, root: Path, device):
    """7B int4 speculative serving at pp 2, the checkpoint drafting for itself (whole on
    every stage, with a whole bf16 pool): `serve_cli.main --pp-stages 2
    --pp-microbatches 2 --draft-checkpoint-path` (a chain of MESH_SPEC_K), then
    `SpeculativePagedEngine(pp_mesh=)` and `TreeSpeculativePagedEngine(pp_mesh=)`
    (MESH_SPEC_TREE): tokens equal to the one-rank engines', the K1 (GEMV and GEMM) and
    K2 launches of this stage worked out from the code, acceptance, tokens a round, the
    round's time, tokens/s and the bytes staged through the host."""
    release_programs()  # the plain pipeline engine before it
    config = par_7b_config()
    L, S, s = config.n_layer, mesh.shape["pp"], mesh.index("pp")
    L_local, last = L // S, int(s == S - 1)
    prompts, raw = pp_prompts(config)
    ref = json.loads((root / "spec_ref.json").read_text())
    want = {name: {int(k): v for k, v in ref[name]["tokens"].items()} for name in ref}
    ckpt = str(root / PAR_CUT)

    def expect(engine, spans):
        return spec_launches(engine, spans, L_local, L, PP_MICRO, last)

    out = {"stage": s, "layers": L_local}
    out["cli_chain"] = cli_serve(root, "pp-chain", mesh.rank, raw, prompts, expect,
                                 want["chain"], checkpoint_path=ckpt, pp_stages=S,
                                 pp_microbatches=PP_MICRO, draft_checkpoint_path=ckpt,
                                 draft_k=MESH_SPEC_K)
    if mesh.rank == 0:
        assert out["cli_chain"]["share_equal_one_rank"] == 1.0, out["cli_chain"]
    whole, _ = load_model_any(root / PAR_CUT, None, device=device)
    whole = cast_params(whole, torch.bfloat16)
    for name, cls, extra in (("chain", SpeculativePagedEngine, {"draft_k": MESH_SPEC_K}),
                             ("tree", TreeSpeculativePagedEngine, {"tree": MESH_SPEC_TREE})):
        engine = cls(whole, config, draft_params=whole, draft_config=config,
                     quantize_kv="int8", device=device, pp_mesh=mesh, pp_microbatches=PP_MICRO,
                     eos_id=IntTokenizer.eos_id, **SERVE, **extra)
        torch.cuda.reset_peak_memory_stats()
        s0 = mesh_mod.STAGED["bytes"]
        with probed_engines() as seen:
            (tokens, spans, steps, first, wall), launches = counted_drive(engine, prompts,
                                                                          new=PAR_SERVE_NEW)
        staged = mesh_mod.STAGED["bytes"] - s0
        assert tokens == want[name], f"pp {name} speculation differs from the one-rank engine"
        counts, gemv = expect(engine, seen["spans"])
        expect_launches(launches, counts)
        out[name] = {**spec_stats(engine), **serve_stats(tokens, steps, first, wall),
                     "prefill_spans": len(spans),
                     "launches": {k: v for k, v in launches.items() if v},
                     "k1_gemv_launches": gemv,
                     "k1_gemm_launches": launches["quant_matmul_int4"] - gemv,
                     "staged_bytes": staged, "staged_bytes_per_step": staged / len(steps),
                     "staged_bytes_per_round": ((staged - seen["span_staged"])
                                                / engine.stats()["spec_rounds"]),
                     "tokens_equal_one_rank": True,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        del engine, seen
        release_programs()
    del whole
    release_programs()
    return out


def pp_gpipe(mesh, ref, device):
    """The 125M GPipe step at pp 2 (PP_M micro-batches of PP_MB x 2048, bf16 compute)
    PP_STEPS times: the losses against the one-rank `make_train_step` on the same
    batch, the step times and the K2/K6 launches of this stage."""
    cfg, params, batch = gpipe_case(device)
    S, s = mesh.shape["pp"], mesh.index("pp")
    local = shard_params_pp(params, mesh)
    del params
    opt = make_adamw(1e-4)
    state = init_opt_state(opt, local)
    step = make_pp_train_step(cfg, opt, mesh, compute_dtype=torch.bfloat16, device=device)
    losses, times, launches = [], [], []
    s0 = mesh_mod.STAGED["bytes"]
    torch.cuda.reset_peak_memory_stats()
    with deterministic():
        for _ in range(PP_STEPS):
            torch.cuda.synchronize()
            _counts_zero()
            t0 = time.perf_counter()
            local, state, loss = step(local, state, batch)
            loss = float(loss)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(_counts())
            losses.append(loss)
    per_step = PP_M * cfg.n_layer // S
    for c in launches:
        expect_launches(c, {"flash_attention_fwd": per_step, "flash_attention_bwd": per_step})
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["gpipe_losses"])]
    assert max(rel) <= PP_REL_TOL, (losses, ref["gpipe_losses"])
    del local, state
    release_programs()
    return {"stage": s, "M": PP_M, "mb": PP_MB, "T": cfg.block_size, "losses": losses,
            "one_rank_losses": ref["gpipe_losses"], "loss_rel_err": rel, "step_ms": times,
            "one_rank_step_ms": ref["gpipe_step_ms"],
            "launches": {k: v for k, v in launches[0].items() if v},
            "staged_bytes_per_step": (mesh_mod.STAGED["bytes"] - s0) / PP_STEPS,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def pp_moe_fsdp(root: Path, ref, device):
    """The MoE repair at the CLI's capacity factor: the routing statistics of the fsdp-2
    forward (this rank's rows of the batch) against one device on the whole batch, then
    one `pretrain_cli --moe-experts 8 --fsdp 2` step against the one-rank CLI."""
    world = PP_WORLD
    mesh = make_mesh(dp=1, fsdp=world, tp=1)
    cfg, params, batch = moe_case(device)
    local = cast_params(shard_params(params, mesh), torch.bfloat16)
    del params
    with deterministic(), torch.no_grad():
        _, aux = forward_moe(local, local_rows(batch, mesh, dim=0), cfg, device=device,
                             mesh=mesh)
    aux = {k: float(v) for k, v in aux.items()}
    assert abs(aux["dropped"] - ref["moe_aux"]["dropped"]) <= PP_REL_TOL, (aux, ref["moe_aux"])
    del local
    release_programs()
    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    loss = moe_cli_run(root, "moe-fsdp", fsdp=world, tp=1, batch_size=PAR_TRAIN_BATCH * world)
    torch.cuda.synchronize()
    cli_s, launches = time.perf_counter() - t0, _counts()
    want = ref["moe_cli_loss"]
    if mesh.rank == 0:  # rank 0 writes the metrics
        assert abs(loss - want) <= PP_REL_TOL * abs(want), (loss, want)
    return {"capacity_factor": cfg.capacity_factor, "dropped": aux["dropped"],
            "dropped_one_device": ref["moe_aux"]["dropped"], "aux": aux,
            "cli_loss": loss, "cli_loss_one_rank": want, "cli_s": cli_s,
            "launches": {k: v for k, v in launches.items() if v}}


def pp_tp_serve(mesh, root: Path, ref, device):
    """7B-wide int4 at PP_TP_LAYERS layers through `serve_cli.main --tp 2 --pp-stages 2`
    (every request answered), then `PagedEngine(pp_mesh=)` on this rank's heads of its
    stage's layers: launches, step times, staged bytes, and the share of tokens equal
    to the one-rank engine's."""
    config = LLaMAConfig.from_name("7B").replace(n_layer=PP_TP_LAYERS)
    S, L_local = mesh.shape["pp"], PP_TP_LAYERS // mesh.shape["pp"]
    last = int(mesh.index("pp") == S - 1)
    prompts, raw = pp_prompts(config)
    (root / f"pptp-prompts-{mesh.rank}.txt").write_text("\n".join(_ids_text(p) for p in raw))
    buf = io.StringIO()
    with mock.patch.object(generate_cli, "load_tokenizer", lambda _: IntTokenizer()), \
            contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        serve_cli.main(prompts_file=str(root / f"pptp-prompts-{mesh.rank}.txt"),
                       checkpoint_path=str(root / "int4_7b_pp_tp"), tokenizer_path="ids",
                       max_new_tokens=PAR_SERVE_NEW, temperature=0.0, quantize_kv="int8",
                       max_batch=SERVE["max_batch"], page_size=SERVE["page_size"],
                       n_pages=SERVE["n_pages"], prefill_chunk=SERVE["prefill_chunk"],
                       pp_stages=S, pp_microbatches=PP_MICRO, tp=mesh.shape["tp"],
                       device="cuda")
    if mesh.rank == 0:
        assert len(_ids_from_cli(buf.getvalue())) == len(prompts), buf.getvalue()[-2000:]
    params, _ = load_model_any(root / "int4_7b_pp_tp", None, device=device, mesh=mesh)
    params = cast_params(params, torch.bfloat16)
    engine = PagedEngine(params, config, quantize_kv="int8", device=device, pp_mesh=mesh,
                         pp_microbatches=PP_MICRO, eos_id=IntTokenizer.eos_id, **SERVE)
    s0 = mesh_mod.STAGED["bytes"]
    (tokens, spans, steps, first, wall), launches = counted_drive(engine, prompts,
                                                                  new=PAR_SERVE_NEW)
    staged = mesh_mod.STAGED["bytes"] - s0
    n_decode, n_from0 = engine.stats()["steps"], sum(sp == 0 for sp in spans)
    assert engine.stats()["completed_requests"] == len(prompts)
    expect_launches(launches, {
        "quant_matmul_int4": (n_decode * PP_MICRO + len(spans)) * (5 * L_local + last),
        "flash_attention_fwd": L_local * n_from0,
        "paged_decode_attention": L_local * PP_MICRO * n_decode})
    want = ref["pp_tp_tokens"]
    same = sum(a == b for r in want for a, b in zip(tokens[r], want[r]))
    heads = engine.pool["k"].shape[2]
    del engine, params
    release_programs()
    ckpt, spec = str(root / "int4_7b_pp_tp"), {}
    for name, kw in (("chain", dict(draft_k=MESH_SPEC_K)),
                     ("tree", dict(draft_tree=",".join(str(b) for b in MESH_SPEC_TREE)))):
        spec[name] = cli_serve(
            root, f"pptp-{name}", mesh.rank, raw, prompts,
            lambda e, sp: spec_launches(e, sp, L_local, PP_TP_LAYERS, PP_MICRO, last),
            ref["spec"][name]["tokens"], checkpoint_path=ckpt, draft_checkpoint_path=ckpt,
            pp_stages=S, pp_microbatches=PP_MICRO, tp=mesh.shape["tp"], **kw)
    return {"stage": mesh.index("pp"), "tp_rank": mesh.index("tp"), "layers": L_local,
            "pool_heads": heads, **serve_stats(tokens, steps, first, wall),
            "decode_steps": n_decode, "prefill_spans": len(spans),
            "launches": {k: v for k, v in launches.items() if v},
            "staged_bytes_per_step": staged / len(steps),
            "tokens_equal_one_rank": same, "tokens": sum(len(t) for t in want.values()),
            "spec_cli": spec}


def _pipeline_tp_rank(rank, world, root, ref):
    """One rank of the pp 2 x tp 2 serve, its result in ``root/pptp-<rank>.json``."""
    import torch.distributed as dist

    root = Path(root)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous-pptp", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(dp=1, fsdp=1, tp=2, pp=world // 2)
        out = pp_tp_serve(mesh, root, ref, torch.device("cuda"))
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        (root / f"pptp-{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _pipeline_rank(rank, world, root, ref):
    """One rank of the pipeline phase (one stage), its result written to
    ``root/pp-<rank>.json``. Any failure ends the process with an error, and so the run."""
    import torch.distributed as dist

    root = Path(root)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous-pp", rank=rank,
                            world_size=world)
    try:
        device = torch.device("cuda")
        mesh = make_mesh(dp=1, fsdp=1, tp=1, pp=world)
        out = {"rank": rank, "world": world, "mesh": mesh.shape}
        out["serve"] = pp_serve(mesh, root, ref, device)
        out["spec_serve"] = pp_spec_serve(mesh, root, device)
        out["gpipe"] = pp_gpipe(mesh, ref, device)
        out["moe_fsdp"] = pp_moe_fsdp(root, ref, device)
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        (root / f"pp-{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_pipeline(device):
    """2 stages on the one card over gloo (host-staged hops, counted in ``STAGED``); see
    the module docstring. The one-rank references run here first, in this process.
    Returns the launch counts of rank 0's paths."""
    import torch.multiprocessing as mp

    phase_t0 = time.perf_counter()
    root = WORK_DIR / "parallel"  # the parallel phase's 7B checkpoint and 125M data
    config = par_7b_config()
    params, _ = load_model_any(root / PAR_CUT, None, device=device)
    params = cast_params(params, torch.bfloat16)
    engine = PagedEngine(params, config, quantize_kv="int8", device=device,
                         eos_id=IntTokenizer.eos_id, **SERVE)
    prompts, _ = pp_prompts(config)
    (tokens, spans, steps, first, wall), serve_launches = counted_drive(
        engine, prompts, new=PAR_SERVE_NEW)
    one_rank_serve = {**serve_stats(tokens, steps, first, wall),
                      "decode_steps": engine.stats()["steps"], "prefill_spans": len(spans),
                      "launches": {k: v for k, v in serve_launches.items() if v}}
    del engine, params
    release_programs()
    cfg, params, batch = gpipe_case(device)
    opt = make_adamw(1e-4)
    state = init_opt_state(opt, params)
    step = make_train_step(cfg, opt, compute_dtype=torch.bfloat16, device=device)
    gpipe_losses, gpipe_ms = [], []
    with deterministic():
        for _ in range(PP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, batch)
            gpipe_losses.append(float(loss))
            gpipe_ms.append((time.perf_counter() - t0) * 1e3)
    del params, state, step  # the captured step's graph holds its params and its pool
    mcfg, mparams, mbatch = moe_case(device)
    with deterministic(), torch.no_grad():
        _, maux = forward_moe(cast_params(mparams, torch.bfloat16), mbatch, mcfg, device=device)
    del mparams
    release_programs()
    moe_loss = moe_cli_run(root, "moe-single", batch_size=PAR_TRAIN_BATCH)
    release_programs()  # the CLI's graph pool, for the ranks that share the card
    ref = {"serve_tokens": tokens, "gpipe_losses": gpipe_losses, "gpipe_step_ms": gpipe_ms,
           "moe_aux": {k: float(v) for k, v in maux.items()}, "moe_cli_loss": moe_loss}
    setup_s = time.perf_counter() - phase_t0
    t0 = time.perf_counter()
    mp.spawn(_pipeline_rank, args=(PP_WORLD, str(root), ref), nprocs=PP_WORLD, join=True)
    ranks = [json.loads((root / f"pp-{r}.json").read_text()) for r in range(PP_WORLD)]
    wall = time.perf_counter() - t0
    paths = {}
    for sub in ("serve", "gpipe", "moe_fsdp"):
        emit({"phase": f"pipeline_{sub}", "backend": "gloo", "world": PP_WORLD,
              "one_rank": one_rank_serve if sub == "serve" else None,
              "ranks": [r[sub] for r in ranks]})
        for r in ranks:
            paths[f"pipeline_{sub}_stage{r['rank']}"] = r[sub]["launches"]
    spec_ref = json.loads((root / "spec_ref.json").read_text())
    emit({"phase": "pipeline_spec_serve", "backend": "gloo", "world": PP_WORLD,
          "draft": "the target itself", "k": MESH_SPEC_K, "tree": list(MESH_SPEC_TREE),
          "plain_pp": [{k: r["serve"][k] for k in ("decode_step_ms_median", "tokens_per_s")}
                       for r in ranks],
          "one_rank": {k: {kk: spec_ref[k][kk] for kk in
                           ("acceptance_rate", "tokens_per_round", "decode_step_ms_median",
                            "tokens_per_s")} for k in ("chain", "tree")},
          "ranks": [r["spec_serve"] for r in ranks]})
    for r in ranks:
        for name in ("cli_chain", "chain", "tree"):
            paths[f"pipeline_spec_{name}_stage{r['rank']}"] = r["spec_serve"][name]["launches"]
    # pp 2 x tp 2 at a cut depth: the one-rank reference here, then 4 ranks
    t0 = time.perf_counter()
    cfg_tp = LLaMAConfig.from_name("7B").replace(n_layer=PP_TP_LAYERS)
    params = synth_7b_params(cfg_tp, torch.Generator(device=device).manual_seed(SEED + 20),
                             device, "int4")
    save_checkpoint(root / "int4_7b_pp_tp", params, cfg_tp)
    engine = PagedEngine(params, cfg_tp, quantize_kv="int8", device=device,
                         eos_id=IntTokenizer.eos_id, **SERVE)
    ref_tp = {"pp_tp_tokens": drive(engine, pp_prompts(cfg_tp)[0], new=PAR_SERVE_NEW)[0]}
    del engine, params
    release_programs()
    ref_tp["spec"] = one_rank_spec(root / "int4_7b_pp_tp", cfg_tp, device, stripe=False)
    mp.spawn(_pipeline_tp_rank, args=(2 * PP_WORLD, str(root), ref_tp), nprocs=2 * PP_WORLD,
             join=True)
    tp_ranks = [json.loads((root / f"pptp-{r}.json").read_text()) for r in range(2 * PP_WORLD)]
    emit({"phase": "pipeline_pp_tp_serve", "backend": "gloo", "world": 2 * PP_WORLD,
          "layers": PP_TP_LAYERS, "ranks": tp_ranks, "wall_s": time.perf_counter() - t0})
    for r, out in enumerate(tp_ranks):
        paths[f"pipeline_pp_tp_serve_rank{r}"] = out["launches"]
        for name, row in out["spec_cli"].items():
            paths[f"pipeline_pp_tp_spec_{name}_rank{r}"] = row["launches"]
    emit({"phase": "pipeline", "backend": "gloo", "world": PP_WORLD, "setup_s": setup_s,
          "ranks_wall_s": wall, "wall_s": time.perf_counter() - phase_t0,
          "peak_mem_bytes_by_rank": [r["peak_mem_bytes"] for r in ranks]})
    shutil.rmtree(root, ignore_errors=True)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = phase_device()
    g = torch.Generator(device=device).manual_seed(SEED)
    timer = Timer(device)
    if sys.argv[1:2] == ["--gemms-of"]:
        print(json.dumps({"package": qmm_wrappers.__file__}), flush=True)
        phase_k1(timer, g, device)
        phase_quant_kernels(timer, g, device)
        phase_host(device)
        for fmt in PROFILED_FORMATS:
            phase_generate(g, device, fmt)
        return 0
    if sys.argv[1:2] == ["--host-of"]:
        print(json.dumps({"package": qmm_wrappers.__file__}), flush=True)
        phase_host(device)
        return 0
    if sys.argv[1:2] == ["--paged-of"]:
        print(json.dumps({"package": paged_wrappers.__file__}), flush=True)
        phase_paged_kernels(timer, g, device)
        phase_paged_host(device)
        return 0
    if sys.argv[1:2] == ["--a8-of"]:
        print(json.dumps({"package": qmm_wrappers.__file__}), flush=True)
        phase_a8_of(timer, device)
        return 0
    if sys.argv[1:2] == ["--attention-of"]:
        print(json.dumps({"package": flash_wrappers.__file__}), flush=True)
        phase_k2(timer, g, device)
        phase_k6(timer, g, device)
        phase_micro_step(device)
        return 0
    k1_rows = phase(phase_k1, timer, g, device)
    k2_rows = phase(phase_k2, timer, g, device)
    phase(phase_edges, g, device)
    phase(gemv_checks, device)
    k6_rows = phase(phase_k6, timer, g, device)
    phase(structured_attention, device)
    w4a8_rows = phase(phase_w4a8, timer, device)
    a8_rows = phase(phase_a8, timer, device)
    # the int4 generation draws its weights where it always has, after K6's phase
    paths = {}
    paths["generate_int4"] = phase(phase_generate, g, device, "int4", paths)
    q_rows = phase(phase_quant_kernels, timer, g, device)
    phase(phase_quant_edges, g, device)
    del timer
    for fmt in GEN_FORMATS:
        paths[f"generate_{fmt}"] = phase(phase_generate, g, device, fmt, paths)
    paths["train"], ckpt = phase(phase_train, device)
    phase(phase_micro_step, device)
    paths["evaluate"] = phase(phase_quant_eval, device, ckpt)
    phase(phase_gptq_7b, device)
    paths.update(phase(phase_finetune, device, ckpt))
    paths.update(phase(phase_moe, g, device))
    ckpt125 = WORK_DIR.parent / "chip_smoke_125m"  # the parallel phase quantizes it at load
    shutil.rmtree(ckpt125, ignore_errors=True)
    shutil.move(str(ckpt), str(ckpt125))
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    paged_rows = phase(phase_paged_kernels, Timer(device), g, device)
    phase(phase_paged_edges, g, device)
    serve_paths, gate = phase(phase_serve, g, device)
    paths.update(serve_paths)
    paths.update(phase(phase_parallel, g, device, ckpt125))
    shutil.rmtree(ckpt125, ignore_errors=True)
    paths.update(phase(phase_pipeline, device))
    paths.update(phase(phase_dryrun))
    paths.update(phase(phase_spec, g, device))
    emit({"kernels": summary(k1_rows, k2_rows, k6_rows, q_rows, paged_rows, gate, paths,
                             w4a8_rows, a8_rows)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
