"""A decode step as one device program: the counterpart of the JAX package's compiled
decode loops (`lit_llama_ja_tpu/infer/generate.py::_generate_jit`, whose ``lax.scan``
puts every step of a generation in one program, and `lit_llama_ja_tpu/infer/paged.py::
_paged_decode_and_sample`, the serving engine's batched step and sampling in one).

A step is a **body**: a plain function of static device buffers (the token, the
position, a step counter, the output tokens; for the engine the slots' tokens,
positions, tables and temperatures) that reads nothing back to the host and writes its
results into those buffers. `DecodeGraph` runs a body. With ``capture`` (a CUDA
device) it captures the body in a `torch.cuda.CUDAGraph` at its first run and replays
the graph after that, so the host launches a whole step, some 3,500 kernels at 7B, with
one ``replay()``; without it it calls the body, and the CPU tests run the same body in
a host loop.

The first run of a graph is its warm-up: the body runs once, eagerly, on a side stream,
so that every kernel wrapper builds and loads its library, sets its shared memory,
plans and allocates outside the capture; that run is a real step, its results kept.
Then the body is captured, which runs nothing. A sampling generator is registered with
the graph, so every replay draws fresh numbers; greedy steps draw none. Graphs that
never run at the same time share one memory pool (``pool``). A failed capture or
replay raises: there is no quiet return to the host loop.

A serving engine's prefill span is a body of its own kind (`SpanStep`): the JAX
package's jitted spans (`lit_llama_ja_tpu/infer/paged.py::_prefill_span`, the stripe
engine's `_prefill_slot`), one graph a span shape, fed from the host as the steps are.
So are a training step and a validation loss (`TrainGraphs`, kinds "train" and "val"):
the JAX package's jitted train steps (`lit_llama_ja_tpu/train/step.py::jit_train_step`)
and validation losses, one graph a batch shape, the forward, the backward and the
optimizer update in one. So is the column loop of one block of the GPTQ solver (kind
"gptq", `quant/gptq.GPTQGraphs`): the JAX package's jitted solve, one graph a block
shape.

`generate` and `speculative_generate` hold their programs across calls, as the JAX
package's jit cache holds `_generate_jit` and `_spec_generate_jit`: a `HeldPrograms`
maps a key (the jit's static arguments, the prompt's bucket, the generator) to a program
that owns its buffers, its caches and its graphs (the prefill span and the decode steps
in one pool), for one set of param trees at a time. A second call with a key stages the
prompt and replays; it captures nothing.
"""
from __future__ import annotations

import collections
import functools
import gc
from typing import Callable, Dict, Hashable, Iterable, List, Optional

import numpy as np
import torch

from lit_llama_ja_tpu_torch.io.checkpoint import flatten_tree


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The one stream of ``device`` on which every warm-up and every capture runs.
    cuBLAS and cuBLASLt keep a workspace a (handle, stream), allocated at the stream's
    first product and kept for the process: made by a warm-up it comes from the common
    pool, where a capture on a stream never used before would take it from its graph's
    pool and pin that pool's segment after the graph is freed."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class DecodeGraph:
    """``body`` run eagerly, or captured once and replayed (see the module docstring).

    ``device``: where the body's buffers live; ``capture``: capture the body (a CUDA
    device only), else call it. ``pool``: a `torch.cuda.graph_pool_handle`
    shared with graphs that never run at the same time as this one. ``generators``: the
    generators the body draws from (None entries are skipped); each is registered with
    the graph, so that replays advance it. ``kind``: "step" (a decode step, round, token
    or window), "span" (a prefill span), "train" (a training step), "val" (a
    validation loss) or "gptq" (a block of the GPTQ solver), for whoever counts or times
    the runs.
    """

    def __init__(self, body: Callable[[], None], device, *, capture: bool, pool=None,
                 generators: Iterable[Optional[torch.Generator]] = (), kind: str = "step"):
        self.body = body
        self.kind = kind
        self.device = torch.device(device)
        self.capture_enabled = capture
        if capture and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {self.device}")
        self.pool = pool
        self.generators = [g for g in generators if g is not None]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0

    def run(self) -> None:
        """One step: the body (no capture), the warm-up and the capture (first run), or
        one replay."""
        if not self.capture_enabled:
            self.body()
        elif self.graph is None:
            self.capture()
        else:
            self.graph.replay()
            self.replays += 1

    def capture(self) -> None:
        """Run the body once on the device's side stream (the warm-up, a real step),
        then capture it on the same stream."""
        current = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body()
        current.wait_stream(side)
        self.graph = self._record(side)

    def _record(self, stream: torch.cuda.Stream) -> torch.cuda.CUDAGraph:
        """The body captured in a new graph on ``stream`` (nothing runs). The cyclic
        garbage collector is held off meanwhile: a dead cycle that it freed in the
        middle could hold another graph, whose teardown would break the capture."""
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                self.body()
        finally:
            if collecting:
                gc.enable()
        return graph


class GenerateStep:
    """`infer/generate.generate`'s decode step over static buffers.

    ``forward(tok, pos, roll)``: the cached forward of one token ``tok`` ``(1, 1)`` at
    the device position ``pos`` ``(1,)``, rolling the cache left first when ``roll``,
    returning logits ``(1, 1, V)``; ``sample(logits (V,))``: the next token, an int64
    scalar on the device. The body writes the sampled token into ``tok`` and into
    ``out[step]``, then advances ``pos`` and ``step``, all on the device. ``out`` holds
    ``n_new`` tokens, the first at index 0. The carry is set by `start` from the host,
    or on the device by a prefill span that writes ``tok``, ``out[0]``, ``pos`` and
    ``step`` (`infer/generate.GenerateProgram`), followed by `start` without a token.

    The roll-left eviction is a second variant of the body, with a graph of its own in
    the same pool: `run` takes it once the host's count of positions reaches the
    cache's ``S`` slots, and never reads ``pos``. ``pool``: shared with the prefill
    span's graph, which never runs during a step (a new pool unless given one).
    """

    def __init__(self, forward, sample, n_new: int, S: int, device, *, capture: bool,
                 generator: Optional[torch.Generator] = None, pool=None):
        dev = torch.device(device)
        # the carry, allocated here: outside every graph pool
        tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
        pos = torch.zeros((1,), dtype=torch.long, device=dev)
        step = torch.ones((1,), dtype=torch.long, device=dev)
        out = torch.zeros((n_new,), dtype=torch.long, device=dev)

        def body(roll: bool) -> None:
            logits = forward(tok, pos, roll)
            nxt = sample(logits[0, -1]).reshape(1)
            tok.copy_(nxt.view(1, 1))
            out.index_copy_(0, step, nxt)
            pos.add_(1)
            step.add_(1)

        # the body closes over the buffers, not over this object: no reference cycle
        # keeps a graph (and its pool) alive past the step's last reference
        self.tok, self.pos, self.step, self.out = tok, pos, step, out
        self.S, self.host_pos = S, 0
        if capture and pool is None:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.graphs = {roll: DecodeGraph(functools.partial(body, roll), dev, capture=capture,
                                         pool=pool, generators=[generator])
                       for roll in (False, True)}

    def start(self, start_pos: int, first: Optional[torch.Tensor] = None) -> None:
        """The host's count of positions at ``start_pos``; with ``first`` (the sampled
        first token) the carry set from the host too: ``tok`` and ``out[0]`` the token,
        ``pos`` ``start_pos``, ``step`` 1."""
        self.host_pos = start_pos
        if first is not None:
            self.tok.copy_(first.reshape(1, 1))
            self.out[:1] = self.tok[0]
            self.pos.fill_(start_pos)
            self.step.fill_(1)

    def run(self) -> None:
        """One decode step, the roll variant past the cache's end."""
        self.graphs[self.host_pos >= self.S].run()
        self.host_pos += 1


class _StagedGraphs:
    """Static device buffers fed from host arrays, and one `DecodeGraph` a key over them:
    what `PagedStep` and `SpanStep` share.

    ``body(*static, out=out, **buffers)`` writes its results into ``out`` (of
    ``out_shape`` and ``out_dtype``); it must not hold the engine, or a reference cycle
    keeps the graphs alive. `_launch` copies each named host array into a device buffer
    of its name and shape (on a CUDA device from a pinned staging twin, with
    non-blocking copies, after the previous launch's copies have finished; an array of
    another shape gets buffers of its own) and runs the graph of its key (captured on
    first use, every graph in ``pool``: a new pool unless given one). The key is
    everything that shapes the body: the widths of the 2-D arrays (a page table's attend
    width, a span's length), then ``static``, so a key's graph always finds the buffers
    it was captured on.
    """

    kind = "step"

    def __init__(self, device, body: Callable, out_shape, out_dtype: torch.dtype, *,
                 capture: bool, generator: Optional[torch.Generator] = None, pool=None,
                 out: Optional[torch.Tensor] = None):
        self.device = torch.device(device)
        self.body = body
        self.capture = capture
        self.generator = generator
        if capture and pool is None:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.graphs: Dict[Hashable, DecodeGraph] = {}
        self.buffers: Dict[Hashable, torch.Tensor] = {}
        self.staged: Dict[Hashable, torch.Tensor] = {}
        # the body's output, allocated here (or by the caller, ``out``): outside every
        # graph pool
        if out is None:
            out = torch.zeros(out_shape, dtype=out_dtype, device=self.device)
        self.out = out
        # recorded after each launch's staging copies: the pinned twins are rewritten
        # only once the copies that read them are done
        self.copied = torch.cuda.Event() if self.device.type == "cuda" else None

    def _fill(self, name: str, host) -> torch.Tensor:
        """The device buffer of ``name`` at ``host``'s shape, holding ``host``."""
        if isinstance(host, torch.Tensor):
            slot = (name, tuple(host.shape))
            buf = self.buffers.get(slot)
            if buf is None:
                buf = self.buffers[slot] = torch.zeros(host.shape, dtype=host.dtype,
                                                       device=self.device)
            buf.copy_(host, non_blocking=True)
            return buf
        host = np.ascontiguousarray(host)
        slot = (name, host.shape)
        buf = self.buffers.get(slot)
        if buf is None:
            dtype = torch.from_numpy(host[:0]).dtype
            buf = self.buffers[slot] = torch.zeros(host.shape, dtype=dtype, device=self.device)
            if self.device.type == "cuda":
                self.staged[slot] = torch.zeros(host.shape, dtype=dtype, pin_memory=True)
        stage = self.staged.get(slot)
        if stage is None:
            buf.copy_(torch.from_numpy(host))
        else:
            np.copyto(stage.numpy(), host)
            buf.copy_(stage, non_blocking=True)
        return buf

    def _launch(self, static: tuple, **host: np.ndarray) -> None:
        """Stage the ``host`` arrays (by the body's argument names) and run the graph of
        their key, the body given ``static`` first."""
        if self.copied is not None:
            self.copied.synchronize()
        bufs = {name: self._fill(name, arr) for name, arr in host.items()}
        if self.copied is not None:
            self.copied.record()
        key = self._key(host, static)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = DecodeGraph(
                functools.partial(self.body, *static, out=self.out, **bufs), self.device,
                capture=self.capture, pool=self.pool, generators=[self.generator],
                kind=self.kind)
        graph.run()

    def _key(self, host: dict, static: tuple) -> tuple:
        """The key of a launch: the widths of its 2-D arrays, then ``static``."""
        return (*(a.shape[1] for a in host.values() if a.ndim == 2), *static)


class PagedStep(_StagedGraphs):
    """A serving engine's step over static buffers fed from the host: `PagedEngine`'s
    batched decode step (`infer/paged.py`), the stripe `Engine`'s (`infer/serving.py`) and
    the speculative engines' rounds (`infer/spec_serving.py`, `infer/tree_spec.py`).

    ``out`` is an int32 buffer of ``out_shape`` (the sampled tokens); `run` stages the
    host arrays, runs the key's graph (`_StagedGraphs`; the key: the attend width, then
    ``static``, K, top-k and top-p) and reads ``out`` back: the step's one device-to-host
    transfer. ``pool``: shared with the engine's `SpanStep`, whose graphs never run at
    the same time as these.
    """

    def __init__(self, device, body: Callable, out_shape, *, capture: bool,
                 generator: Optional[torch.Generator] = None, pool=None):
        super().__init__(device, body, out_shape, torch.int32, capture=capture,
                         generator=generator, pool=pool)

    def run(self, static: tuple, **host: np.ndarray) -> np.ndarray:
        """One step over the ``host`` arrays (by the body's argument names), the body
        given ``static`` first; returns ``out`` on the host."""
        self._launch(static, **host)
        return self.out.cpu().numpy()


class SpanStep(_StagedGraphs):
    """A serving engine's prefill span over static buffers fed from the host: the JAX
    package's jitted span programs (`PagedEngine._prefill_span` in `infer/paged.py`, with
    the draft's span in `infer/spec_serving.py`; the stripe `Engine`'s slot prefill in
    `infer/serving.py`).

    ``out``: the buffer the body writes the last real token's logits into, ``(V,)`` of
    the logits' dtype, outside every graph pool, so that no other graph's replay reuses
    it (`generate`'s and `speculative_generate`'s spans: their output tokens, given as
    ``out``). `run` stages the span's host arrays (tokens ``(1, P)``, positions, a page
    table ``(1, AP)``, device indices such as the last real row), runs the graph of the
    key (P, AP, then ``static``: ``prefill_attn``), captured at the key's first span, and
    returns ``out`` on the device without reading it back. The graphs take the engine's
    decode pool (``pool``): a span never runs during a step.
    """

    kind = "span"

    def run(self, static: tuple, **host: np.ndarray) -> torch.Tensor:
        """One span over the ``host`` arrays, the body given ``static`` first; returns
        ``out`` (on the device)."""
        self._launch(static, **host)
        return self.out


class Bound:
    """The trees a training body updates or reads (the params, the optimizer state),
    passed to it as its static argument: equal to another when it holds the same leaf
    tensors, so that a graph is found again for the same trees, rebuilt around a tree
    whose leaves were replaced (a loaded state)."""

    def __init__(self, *trees):
        self.trees = trees
        self.ids = tuple(id(t) for tree in trees for t in flatten_tree(tree).values())

    def __hash__(self) -> int:
        return hash(self.ids)

    def __eq__(self, other) -> bool:
        return isinstance(other, Bound) and self.ids == other.ids


class TrainGraphs(_StagedGraphs):
    """A training step (``kind`` "train": the forward, the backward and the optimizer
    update of every micro-batch) or a validation loss (``kind`` "val") over static
    buffers fed from the host: the JAX package's jitted train steps
    (`lit_llama_ja_tpu/train/step.py::jit_train_step`) and its jitted validation losses
    (`train/trainer.py`, `cli/finetune_cli.py`).

    `run(trees, **host)` stages the host arrays (the batch, the SFT labels, the dropout
    seeds), runs the graph of their shapes over ``trees`` (a `Bound`: the params and
    the optimizer state, updated in place by the body), captured at the first run of a
    shape, and returns ``out`` (f32, of ``out_shape``, outside every graph pool) on the
    device, unread. The graphs hold the trees they were captured over; a run over other
    leaves drops them first. ``pool``: shared with the other graphs of a training
    loop (its validation's), which never run at the same time.
    """

    def __init__(self, device, body: Callable, out_shape, *, capture: bool, kind: str,
                 pool=None):
        super().__init__(device, body, out_shape, torch.float32, capture=capture, pool=pool)
        self.kind = kind
        self.bound: Optional[Bound] = None

    def run(self, trees: Bound, **host) -> torch.Tensor:
        if trees != self.bound:
            self.graphs.clear()
            self.bound = trees
        self._launch((trees,), **host)
        return self.out

    def _key(self, host: dict, static: tuple) -> tuple:
        """The shapes of every host array: one graph a batch shape, as JAX compiles one
        program a shape."""
        return (*(tuple(a.shape) for a in host.values()), *static)


class HeldPrograms:
    """Programs held across calls, keyed as a jit cache keys its compiled programs: the
    counterpart of the JAX jit caches of `_generate_jit` and `_spec_generate_jit`.

    `get(trees, key, build)` returns the program of ``key`` over ``trees`` (a `Bound`:
    the param trees its graphs were captured over), built by ``build()`` at the key's
    first call. The holder keeps ``trees``, so no leaf that a graph reads is freed while
    the graph is held; a call over other leaves drops every program first, as
    `TrainGraphs.run` does. At most ``max_keys`` keys are held, the least recently used
    dropped first. `release` drops everything; ``built`` counts the programs built.
    """

    held: List["HeldPrograms"] = []  # every holder, for `release_programs`
    max_keys = 4

    def __init__(self):
        self.bound: Optional[Bound] = None
        self.programs: "collections.OrderedDict[Hashable, object]" = collections.OrderedDict()
        self.last = None  # the program of the latest call
        self.built = 0
        HeldPrograms.held.append(self)

    def get(self, trees: Bound, key: Hashable, build: Callable[[], object]):
        if trees != self.bound:
            self.release()
            self.bound = trees
        program = self.programs.get(key)
        if program is None:
            program = self.programs[key] = build()
            self.built += 1
            while len(self.programs) > self.max_keys:
                self.programs.popitem(last=False)
        else:
            self.programs.move_to_end(key)
        self.last = program
        return program

    def release(self) -> None:
        """Drop every program and the trees they were bound to."""
        self.programs.clear()
        self.bound = self.last = None


def release_programs() -> None:
    """Free every held program (`HeldPrograms`) of `generate` and `speculative_generate`:
    their graphs, pools, caches and the param trees they hold, the device's cached
    segments with them."""
    for holder in HeldPrograms.held:
        holder.release()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
