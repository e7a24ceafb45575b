"""Device mesh over `torch.distributed` (counterpart of `lit_llama_ja_tpu/parallel/mesh.py`).

Axes, in the JAX package's order, ranks laid out row-major over them:
  * ``dp``   — pure data parallel (the batch splits, parameters replicate);
  * ``fsdp`` — parameter and optimizer sharding (ZeRO-3: a leaf is all-gathered just
               before use, its gradient reduce-scattered);
  * ``tp``   — tensor parallel over attention heads and the MLP hidden dim;
  * ``pp``   — pipeline parallel over the stacked layer axis (`parallel/pipeline.py`,
               `parallel/pp_decode.py`), appended only when ``pp > 1``;
  * ``ep``   — expert parallel (`parallel/ep.py`), appended only when ``ep > 1``.

Every rank is one process. `make_mesh` builds one process group per axis (the ranks
that differ only along it) and one over ``("dp", "fsdp")``, the batch axes. The
collective helpers below take a mesh and axis names and act on those groups; each is
the identity on a group of one rank, whatever the backend. ``ONE_RANK_COLLECTIVES``
(off by default) makes an NCCL group of one rank run its collectives all the same, as
device copies, so that one rank takes the code path of larger meshes; it exists to
measure that path.

Pipeline stages hand their activations on with `stage_hop`, one ``batch_isend_irecv``
a tick that sends to the next stage and receives from the previous one (not
cyclic: the first stage receives nothing and the last sends nothing, as JAX's
``ppermute`` over ``[(i, i + 1)]``); `StageHop` is its differentiable form, whose
backward runs the same hop the other way with the gradients. `ring_shift` moves
tensors around a ring (`ring_shift_async` posts the move and returns, for a caller that
computes meanwhile); `RingHop` is its differentiable form, whose backward shifts the
gradients back.

Backends: NCCL when every rank has a card of its own, gloo on the CPU. Gloo takes CPU
tensors; where a gloo group is handed CUDA tensors (several ranks sharing one card),
the helpers copy them to the host and back EXPLICITLY and count the bytes in
``STAGED`` (both directions), so that the staging is never silent.

Differentiable forms (the Megatron-LM conjugates): `copy_to` is the identity forward
and an all-reduce backward (the input of a column-parallel linear), `reduce_from` an
all-reduce forward and the identity backward (the output of a row-parallel linear),
`mean_over` the mean forward and backward (a statistic every rank's loss reads),
`gather` an all-gather forward and a reduce-scatter backward (ZeRO-3's use of a
sharded leaf), `gather_replicated` an all-gather forward whose backward keeps the
rank's own slice (an output that every rank then uses whole), and `all_to_all` its
own mirror.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")
STAGED = {"bytes": 0}  # bytes copied between device and host for gloo collectives
# run the collectives of a one-rank NCCL group (device copies) instead of skipping them
ONE_RANK_COLLECTIVES = {"nccl": False}

Axes = Union[str, Sequence[str]]


def maybe_init_distributed(backend: Optional[str] = None) -> bool:
    """Initialize the default process group from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``). Does nothing, and returns False, when a
    group already exists or the environment names no launcher.

    ``backend`` defaults to NCCL when CUDA is available and every local rank has a
    card of its own, else gloo. A CUDA rank selects card ``LOCAL_RANK`` modulo the
    card count."""
    if dist.is_initialized():
        return False
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if backend is None:
        own_cards = torch.cuda.is_available() and torch.cuda.device_count() >= local_world
        backend = "nccl" if own_cards else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend)
    return True


class Mesh:
    """This rank's place in a ``(dp, fsdp, tp[, pp][, ep])`` grid of processes.

    ``shape`` maps axis name to size, in axis order; ``coords`` this rank's index along
    each. ``index(axes)`` and ``size(axes)`` read several axes as one, row-major in mesh
    order (``("dp", "fsdp")`` is the batch axis of `specs.BATCH_SPEC`). With
    ``distributed=False`` (or no process group) it builds no group and every collective
    is the identity."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, distributed: bool = True):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.world = math.prod(shape.values())
        self.rank = rank
        self.backend = dist.get_backend() if distributed and dist.is_initialized() else None
        coords, r = {}, rank
        for name in reversed(self.axis_names):
            coords[name] = r % shape[name]
            r //= shape[name]
        self.coords = {name: coords[name] for name in self.axis_names}
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        if self.backend is not None:
            for axes in [(a,) for a in self.axis_names] + [("dp", "fsdp"), self.axis_names]:
                self._build_groups(axes)

    def _norm(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._norm(axes))

    def index(self, axes: Axes) -> int:
        i = 0
        for a in self._norm(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _members(self, axes: Tuple[str, ...], coords: Dict[str, int]) -> List[int]:
        """Global ranks of the group along ``axes`` through ``coords``, in index order."""
        ranks = []
        for i in range(self.size(axes)):
            c, rest = dict(coords), i
            for a in reversed(axes):
                c[a] = rest % self.shape[a]
                rest //= self.shape[a]
            ranks.append(self._rank_of(c))
        return ranks

    def _build_groups(self, axes: Tuple[str, ...]) -> None:
        """Every rank creates every group (``new_group`` is collective) and keeps its own."""
        if axes in self._groups:
            return
        others = [a for a in self.axis_names if a not in axes]
        seen = []
        for r in range(self.world):
            c, rest = {}, r
            for a in reversed(self.axis_names):
                c[a] = rest % self.shape[a]
                rest //= self.shape[a]
            key = tuple(c[a] for a in others)
            if key in seen:
                continue
            seen.append(key)
            ranks = self._members(axes, c)
            group = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[axes] = (group, ranks)

    def group(self, axes: Axes):
        """``(process group, its global ranks)`` along ``axes``; None without a group."""
        axes = self._norm(axes)
        return self._groups.get(axes)

    def active(self, axes: Axes) -> bool:
        """Whether a collective along ``axes`` does anything: a group exists and has
        more than one rank, or it is NCCL's and ``ONE_RANK_COLLECTIVES`` asks for it
        (see the module docstring)."""
        if self.group(axes) is None:
            return False
        return self.size(axes) > 1 or (self.backend == "nccl" and ONE_RANK_COLLECTIVES["nccl"])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"


def make_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1, pp: int = 1, ep: int = 1,
              world: Optional[int] = None) -> Mesh:
    """A ``(dp, fsdp, tp[, pp][, ep])`` mesh over the default process group; one axis
    may be -1 (the remaining ranks). ``pp`` and ``ep`` are appended only when above 1,
    innermost, as in the JAX package. Without a process group the world is one rank."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dims = {"dp": dp, "fsdp": fsdp, "tp": tp, **({"pp": pp} if pp > 1 else {}),
            **({"ep": ep} if ep > 1 else {})}
    unknown = [a for a, d in dims.items() if d == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one axis may be -1, got {dims}")
    if unknown:
        known = math.prod(d for d in dims.values() if d != -1)
        if world % known:
            raise ValueError(f"mesh {dims} does not cover {world} ranks")
        dims[unknown[0]] = world // known
    if math.prod(dims.values()) != world:
        raise ValueError(f"mesh {dims} does not cover {world} ranks")
    return Mesh(dims, rank)


def single_device_mesh() -> Mesh:
    """A mesh of one rank whose collectives are all the identity (it builds no group,
    so one rank of a larger process group may use it alone)."""
    return Mesh({"dp": 1, "fsdp": 1, "tp": 1}, 0, distributed=False)


# ---------------------------------------------------------------------------
# Collectives (non-differentiable)
# ---------------------------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: on the host for gloo (counted), else as it is."""
    if mesh.backend == "gloo" and t.is_cuda:
        STAGED["bytes"] += t.numel() * t.element_size()
        return t.detach().cpu()
    return t.detach().contiguous()


def _empty_like(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """An uninitialized receive buffer shaped as ``t`` where the backend takes it (on the
    host for gloo); nothing is copied."""
    dev = "cpu" if mesh.backend == "gloo" else t.device
    return torch.empty(t.shape, dtype=t.dtype, device=dev)


def _back(mesh: Mesh, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device:
        STAGED["bytes"] += t.numel() * t.element_size()
        return t.to(like.device)
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Sum of ``t`` over the group along ``axes``; a new tensor."""
    if not mesh.active(axes):
        return t
    buf = _staged(mesh, t).clone()
    dist.all_reduce(buf, group=mesh.group(axes)[0])
    return _back(mesh, buf, t)


def all_gather(t: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in index order."""
    if not mesh.active(axes):
        return t
    src = _staged(mesh, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, src, group=mesh.group(axes)[0])
    return _back(mesh, torch.cat(parts, dim=dim), t)


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """The sum over the group, cut along ``dim``; this rank's piece. NCCL reduce-scatters;
    gloo all-reduces and cuts (its reduce-scatter does not take every layout)."""
    if not mesh.active(axes):
        return t
    n, i = mesh.size(axes), mesh.index(axes)
    group = mesh.group(axes)[0]
    if mesh.backend == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    buf = _staged(mesh, t).clone()
    dist.all_reduce(buf, group=group)
    piece = buf.shape[dim] // n
    return _back(mesh, buf.narrow(dim, i * piece, piece).contiguous(), t)


def all_to_all_dim0(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``all_to_all_single`` over equal chunks of dim 0: chunk ``j`` goes to rank ``j``
    of the group, and chunk ``j`` of the result came from rank ``j``."""
    if not mesh.active(axis):
        return t
    src = _staged(mesh, t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis)[0])
    return _back(mesh, out, t)


def ring_shift_async(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
                     step: int = 1) -> Callable[[], List[torch.Tensor]]:
    """`ring_shift` without the wait: posts the sends and receives (one
    ``batch_isend_irecv``) and returns at once a function that waits for them and
    returns the received tensors. The caller must not write the sent tensors before
    calling it."""
    n = mesh.size(axis)
    if n == 1 or not mesh.active(axis):
        return lambda: list(tensors)
    ranks = mesh.group(axis)[1]
    i = mesh.index(axis)
    dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
    sends = [_staged(mesh, t).contiguous() for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, dst) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, src) for r in recvs]
    requests = dist.batch_isend_irecv(ops)

    def finish(_sends=sends):  # holds the send buffers until the wait
        for req in requests:
            req.wait()
        return [_back(mesh, r, t) for r, t in zip(recvs, tensors)]

    return finish


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               step: int = 1) -> List[torch.Tensor]:
    """Send each tensor to the rank ``step`` places on along ``axis`` (cyclically) and
    receive the one from ``step`` places back, with one ``batch_isend_irecv``."""
    return ring_shift_async(tensors, mesh, axis, step)()


class RingHop(torch.autograd.Function):
    """`ring_shift` as a differentiable function of the tensors it sends: the forward
    shifts them ``step`` places along the ring, the backward shifts their gradients
    ``-step`` places, which is the transpose of the forward's permutation (``ppermute``'s,
    as JAX differentiates it). Every rank's backward runs its hops in reverse order, so
    the ranks' hops stay matched."""

    @staticmethod
    def forward(ctx, mesh, axis, step, *tensors):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return tuple(ring_shift([t.detach() for t in tensors], mesh, axis, step))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *ring_shift(grads, ctx.mesh, ctx.axis, -ctx.step))


def ring_hop(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
             step: int = 1) -> List[torch.Tensor]:
    """`ring_shift`, differentiable (`RingHop`) when a tensor needs a gradient."""
    if all(_grad_free(t) for t in tensors) or not mesh.active(axis):
        return ring_shift(tensors, mesh, axis, step)
    return list(RingHop.apply(mesh, axis, step, *tensors))


def stage_hop(send: Optional[torch.Tensor], recv_like: Optional[torch.Tensor], mesh: Mesh,
              axis: str = "pp", reverse: bool = False) -> Optional[torch.Tensor]:
    """One tick of a pipeline: send ``send`` (when given) to the next stage along
    ``axis`` and receive a tensor shaped as ``recv_like`` (when given) from the
    previous one, with one ``batch_isend_irecv``. ``reverse`` runs the hop the other
    way (to the previous stage, from the next), as the backward does. Returns the
    received tensor on ``recv_like``'s device, or None. The two neighbours of a tick
    must agree: a stage that sends is matched by a receive on the stage it sends to."""
    n, i = mesh.size(axis), mesh.index(axis)
    step = -1 if reverse else 1
    ranks = mesh.group(axis)[1] if mesh.group(axis) is not None else None
    ops, recv = [], None
    if send is not None and 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, _staged(mesh, send).contiguous(), ranks[i + step]))
    if recv_like is not None and 0 <= i - step < n:
        recv = _empty_like(mesh, recv_like)
        ops.append(dist.P2POp(dist.irecv, recv, ranks[i - step]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if recv is None else _back(mesh, recv, recv_like)


class StageHop(torch.autograd.Function):
    """`stage_hop` as a differentiable function of the tensor it sends: forward sends
    ``y`` to the next stage (when ``send``) and returns what the previous stage sent
    (when ``recv``; shaped as ``fallback``), else ``fallback`` passed through; backward
    sends the gradient of that result to the previous stage and receives the gradient
    of ``y`` from the next (zero where nothing was sent). The hops of one rank form a
    chain through its stage computations, so autograd runs their backwards in reverse
    tick order on every rank, and the ticks stay matched."""

    @staticmethod
    def forward(ctx, y, fallback, mesh, axis, send, recv):
        ctx.mesh, ctx.axis, ctx.send, ctx.recv = mesh, axis, send, recv
        ctx.y_meta = (y.shape, y.dtype, y.device)
        got = stage_hop(y.detach() if send else None, fallback.detach() if recv else None,
                        mesh, axis)
        return got if got is not None else fallback.detach().clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.y_meta
        gy = torch.zeros(shape, dtype=dtype, device=device)
        got = stage_hop(g if ctx.recv else None, gy if ctx.send else None, ctx.mesh, ctx.axis,
                        reverse=True)
        return (gy if got is None else got), (None if ctx.recv else g), None, None, None, None


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """``t`` of the rank at index ``src`` along ``axis``, on every rank of the group
    (``t`` gives the shape and dtype elsewhere)."""
    if not mesh.active(axis):
        return t
    group, ranks = mesh.group(axis)
    if mesh.index(axis) == src:
        dist.broadcast(_staged(mesh, t).contiguous(), ranks[src], group=group)
        return t
    buf = _empty_like(mesh, t)
    dist.broadcast(buf, ranks[src], group=group)
    return _back(mesh, buf, t)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.backend is not None:
        dist.barrier()


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t, mesh, axes) / mesh.size(axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes) / ctx.mesh.size(ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.piece = t.shape[dim]
        return all_gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.piece, ctx.piece), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all_dim0(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.mesh, ctx.axis), None, None


def _grad_free(t: torch.Tensor) -> bool:
    return not (torch.is_grad_enabled() and t.requires_grad)


def copy_to(t: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Identity forward, all-reduce backward."""
    if _grad_free(t) or not mesh.active(axes):
        return t
    return _CopyTo.apply(t, mesh, axes)


def reduce_from(t: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """All-reduce forward, identity backward."""
    if _grad_free(t) or not mesh.active(axes):
        return all_reduce(t, mesh, axes)
    return _ReduceFrom.apply(t, mesh, axes)


def mean_over(t: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """The mean over the group, forward and (as its transpose) backward: a statistic
    that every rank's loss then reads, as ``jax.lax.pmean``."""
    if _grad_free(t) or not mesh.active(axes):
        return all_reduce(t, mesh, axes) / mesh.size(axes)
    return _MeanOver.apply(t, mesh, axes)


def gather(t: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """All-gather forward, reduce-scatter backward."""
    if _grad_free(t) or not mesh.active(axes):
        return all_gather(t, mesh, axes, dim)
    return _Gather.apply(t, mesh, axes, dim)


def gather_replicated(t: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """All-gather forward; the backward keeps this rank's slice of the gradient."""
    if _grad_free(t) or not mesh.active(axes):
        return all_gather(t, mesh, axes, dim)
    return _GatherReplicated.apply(t, mesh, axes, dim)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`all_to_all_dim0`, differentiable (its backward is the same exchange)."""
    if _grad_free(t) or not mesh.active(axis):
        return all_to_all_dim0(t, mesh, axis)
    return _AllToAll.apply(t, mesh, axis)
