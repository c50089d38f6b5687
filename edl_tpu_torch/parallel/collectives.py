"""Collectives of the process pool — the one module through which the
port's mesh code talks to ``torch.distributed``.

The reference's collectives are XLA's, inserted from shardings over ICI.
Here every rank of a mesh is a process and every collective is a
``torch.distributed`` call on a process group (:class:`Group`, built by
:meth:`edl_tpu_torch.parallel.mesh.MeshPlan.build`).

**The backend follows the topology** (:func:`choose_backend`): NCCL when
every rank owns a card of its own, gloo when the ranks share one card or
run on the CPU. NCCL does not run two ranks on one device.

**Host staging.** Under gloo a collective on CUDA tensors goes through
pinned host memory here, explicitly: the tensor is copied to a pinned
buffer, the collective runs on the host copy, and the result is copied
back. The copies and the collective are timed and their bytes counted
(:func:`stats`, and the registry's ``edl_collective_staged_bytes_total``
and ``edl_collective_seconds_total`` by op), so a staged byte is never
hidden. Gloo's own CUDA support differs by op and by build (on the
card's torch 2.11 it ran all-reduce, broadcast, the all-gathers and
reduce-scatter on CUDA tensors, and its ``send`` of one aborted the
process); staging every op keeps one path whose cost the counters see.

Nothing here retries and nothing falls back: a collective that fails
raises, and a CUDA tensor is never computed on the CPU — only its bytes
visit the host under gloo.

The differentiable ops are the tensor-parallel pair (:func:`copy_to`,
identity forward and all-reduce backward; :func:`reduce_from`, all-reduce
forward and identity backward), :func:`gather`, the fsdp gather whose
backward reduce-scatters (sums) over a batch axis or slices over a model
axis, and the sequence and pipeline exchanges: :func:`ppermute` (the
reference's ``lax.ppermute``: each rank sends to and receives from the
ring neighbours a permutation names; the backward runs the inverse
permutation) and :func:`all_to_all` (the tiled ``lax.all_to_all``; the
backward is the inverse exchange). A ppermute posts all of a rank's
sends and receives before it waits on any (``batch_isend_irecv``), so no
cycle of blocking sends can deadlock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from edl_tpu_torch.obs import metrics as obs_metrics


def choose_backend(device_type: str, n_cards: int, world: int
                   ) -> Tuple[str, str]:
    """(backend, why) for a pool of ``world`` ranks on ``device_type``
    ("cpu" or "cuda") over ``n_cards`` visible cards."""
    if device_type == "cpu":
        return "gloo", "cpu tensors"
    if n_cards >= world:
        return "nccl", f"one card a rank ({world} ranks, {n_cards} cards)"
    return "gloo", (f"{world} ranks share {n_cards} card(s): NCCL runs one "
                    f"rank a device, gloo stages through pinned host memory")


@dataclass(frozen=True)
class Group:
    """A process group of a mesh axis: ``pg`` (None = the default
    group), its size and this process's rank in it. Size 1 makes every
    collective a no-op."""

    pg: Any = None
    size: int = 1
    rank: int = 0

    @property
    def trivial(self) -> bool:
        return self.size <= 1


ONE = Group()

_STATS: Dict[str, Dict[str, float]] = {}
_BACKENDS: Dict[int, str] = {}


def reset_stats() -> None:
    _STATS.clear()


def stats() -> Dict[str, Dict[str, float]]:
    """{op: {"calls", "bytes", "staged_bytes", "seconds"}} since the last
    :func:`reset_stats`: the collective's payload bytes, the bytes copied
    through host memory (both ways), and the host seconds of the call
    (copies included; under NCCL the enqueue only)."""
    return {k: dict(v) for k, v in _STATS.items()}


def _record(op: str, nbytes: int, staged: int, dt: float) -> None:
    s = _STATS.setdefault(op, {"calls": 0, "bytes": 0, "staged_bytes": 0,
                               "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["staged_bytes"] += staged
    s["seconds"] += dt
    r = obs_metrics.default_registry()
    r.counter("edl_collective_seconds_total",
              "host seconds in pool collectives", ("op",)).inc(dt, op=op)
    if staged:
        r.counter("edl_collective_staged_bytes_total",
                  "bytes pool collectives copied through host memory",
                  ("op",)).inc(staged, op=op)


def backend_of(group: Group) -> str:
    import torch.distributed as dist

    key = id(group.pg)
    if key not in _BACKENDS:
        _BACKENDS[key] = str(dist.get_backend(group.pg))
    return _BACKENDS[key]


def _staged(t: torch.Tensor, group: Group) -> bool:
    """Whether a collective on ``t`` goes through host memory: a CUDA
    tensor on a group with no NCCL."""
    return t.is_cuda and "nccl" not in backend_of(group)


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (``op`` sum, max or
    min); returns ``t``."""
    import torch.distributed as dist

    if group.trivial:
        return t
    t0 = time.perf_counter()
    rop = getattr(dist.ReduceOp, _OPS[op])
    staged = _staged(t, group)
    if staged:
        h = _host(t)
        dist.all_reduce(h, rop, group=group.pg)
        t.copy_(h)
    else:
        dist.all_reduce(t, rop, group=group.pg)
    nb = t.numel() * t.element_size()
    _record("all_reduce", nb, 2 * nb if staged else 0,
            time.perf_counter() - t0)
    return t


def all_gather(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group-rank order: a new tensor on ``t``'s device."""
    import torch.distributed as dist

    if group.trivial:
        return t
    t0 = time.perf_counter()
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts, dim=dim)
    nb = out.numel() * out.element_size()
    if staged:
        out = out.to(t.device)
    _record("all_gather", nb, (src.numel() * src.element_size() + nb)
            if staged else 0, time.perf_counter() - t0)
    return out


def reduce_scatter(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Sum ``t`` over the group and keep this rank's part of ``dim`` (the
    group-rank-th of ``group.size`` equal chunks): one
    ``reduce_scatter_tensor`` over ``dim`` moved first."""
    import torch.distributed as dist

    if group.trivial:
        return t
    if t.shape[dim] % group.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split {group.size} ways")
    t0 = time.perf_counter()
    src = t.movedim(dim, 0).contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = torch.empty((src.shape[0] // group.size,) + src.shape[1:],
                      dtype=src.dtype, device=src.device,
                      pin_memory=staged)
    dist.reduce_scatter_tensor(out, src, group=group.pg)
    nb = src.numel() * src.element_size()
    if staged:
        out = out.to(t.device)
    _record("reduce_scatter", nb,
            nb + out.numel() * out.element_size() if staged else 0,
            time.perf_counter() - t0)
    return out.movedim(0, dim)


def broadcast(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """In-place broadcast of ``t`` from group rank ``src``."""
    import torch.distributed as dist

    if group.trivial:
        return t
    t0 = time.perf_counter()
    root = src if group.pg is None else dist.get_global_rank(group.pg, src)
    staged = _staged(t, group)
    buf = _host(t) if staged else t
    dist.broadcast(buf, root, group=group.pg)
    if staged:
        t.copy_(buf)
    nb = t.numel() * t.element_size()
    _record("broadcast", nb, 2 * nb if staged else 0,
            time.perf_counter() - t0)
    return t


def broadcast_object(obj: Any, src: int, group: Group) -> Any:
    """A picklable object from group rank ``src`` to every rank."""
    import torch.distributed as dist

    if group.trivial:
        return obj
    root = src if group.pg is None else dist.get_global_rank(group.pg, src)
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, root, group=group.pg)
    return box[0]


def send(t: torch.Tensor, dst: int, group: Group) -> None:
    """Send ``t`` (any strides) to group rank ``dst`` (blocking)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    peer = dst if group.pg is None else dist.get_global_rank(group.pg, dst)
    dist.send(src, peer, group=group.pg)
    nb = src.numel() * src.element_size()
    _record("send", nb, nb if staged else 0, time.perf_counter() - t0)


def recv(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Receive into ``t`` (any strides; a view writes through) from
    group rank ``src``."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    staged = _staged(t, group)
    if staged:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    else:
        buf = t if t.is_contiguous() else torch.empty_like(
            t, memory_format=torch.contiguous_format)
    peer = src if group.pg is None else dist.get_global_rank(group.pg, src)
    dist.recv(buf, peer, group=group.pg)
    if buf is not t:
        t.copy_(buf)
    nb = t.numel() * t.element_size()
    _record("recv", nb, nb if staged else 0, time.perf_counter() - t0)
    return t


def _peer(group: Group, r: int) -> int:
    import torch.distributed as dist

    return r if group.pg is None else dist.get_global_rank(group.pg, r)


def exchange(x: Optional[torch.Tensor], perm, group: Group, like=None
             ) -> Optional[torch.Tensor]:
    """One step of a permutation ``perm`` [(source, destination)] of
    group ranks: this rank sends ``x`` to its destination and receives
    into a new tensor shaped like ``like`` (default ``x``) from its
    source, both posted before either is waited on. Returns what it
    received, or None when no pair names this rank as a destination. A
    rank that is its own destination gets a copy of ``x``. Not
    differentiable (:func:`ppermute` is)."""
    import torch.distributed as dist

    me = group.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"exchange: {perm} is not a permutation")
    like = x if like is None else like
    if dst == [me]:
        return x.clone()
    if not dst and not src:
        return None
    t0 = time.perf_counter()
    staged = _staged(like, group)
    ops, sent, out, buf = [], 0, None, None
    if dst:
        sbuf = _host(x) if staged else x.contiguous()
        ops.append(dist.P2POp(dist.isend, sbuf, _peer(group, dst[0]),
                              group.pg))
        sent = sbuf.numel() * sbuf.element_size()
    if src:
        if staged:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        else:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device=like.device)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(group, src[0]),
                              group.pg))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    got = 0
    if buf is not None:
        got = buf.numel() * buf.element_size()
        out = buf.to(like.device) if staged else buf
    _record("ppermute", sent, (sent + got) if staged else 0,
            time.perf_counter() - t0)
    return out


def all_to_all_raw(x: torch.Tensor, split_dim: int, concat_dim: int,
                   group: Group) -> torch.Tensor:
    """The tiled all-to-all: ``x`` cut into ``group.size`` equal chunks
    along ``split_dim``, chunk ``i`` sent to group rank ``i``, and the
    chunks received concatenated along ``concat_dim`` in group-rank
    order (``lax.all_to_all(..., tiled=True)``). Not differentiable
    (:func:`all_to_all` is)."""
    import torch.distributed as dist

    n = group.size
    if group.trivial:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    t0 = time.perf_counter()
    src = torch.stack(x.chunk(n, split_dim))  # [n, ...chunk]
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                      pin_memory=staged)
    dist.all_to_all_single(out, src, group=group.pg)
    nb = src.numel() * src.element_size()
    if staged:
        out = out.to(x.device)
    _record("all_to_all", nb, 2 * nb if staged else 0,
            time.perf_counter() - t0)
    return torch.cat(out.unbind(0), dim=concat_dim)


class PeerError(Exception):
    """Raised by :func:`agree` on every rank that did not fail itself:
    the group ranks that failed (``ranks``) and whether each failure was
    a ``ValueError``, ``TypeError`` or ``RuntimeError`` (``recoverable``:
    the kinds a caller's fallback catches). Not itself a
    ``RuntimeError``, so a fallback for its own errors takes it only when
    it asks."""

    def __init__(self, ranks: List[int], recoverable: bool):
        super().__init__(f"failed on group rank(s) {ranks}")
        self.ranks, self.recoverable = ranks, recoverable


_RECOVERABLE = (ValueError, TypeError, RuntimeError)


def agree(err: Optional[BaseException], group: Group) -> None:
    """Every rank of ``group`` says whether its local part of a step
    failed (``err``) and learns the others' (one all-reduce, on the
    host): when none did this returns on every rank; otherwise a rank
    that failed raises its own error and every other rank raises
    :class:`PeerError`, so the group leaves the step together and no
    rank goes on into collectives its peers will not join."""
    code = 0 if err is None else (1 if isinstance(err, _RECOVERABLE) else 2)
    if group.trivial:
        if err is not None:
            raise err
        return
    flags = torch.zeros(group.size, dtype=torch.int64)
    flags[group.rank] = code
    all_reduce(flags, group, "max")
    if err is not None:
        raise err
    if int(flags.max()):
        raise PeerError([r for r, f in enumerate(flags.tolist()) if f],
                        int(flags.max()) == 1)


# -- differentiable ------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            out = reduce_scatter(g, ctx.dim, ctx.group)
        else:
            n = g.shape[ctx.dim] // ctx.group.size
            out = g.narrow(ctx.dim, ctx.group.rank * n, n)
        return out, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        out = exchange(x, perm, group)
        return torch.zeros_like(x) if out is None else out

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        out = exchange(g.contiguous(), inv, ctx.group)
        return (torch.zeros_like(g) if out is None else out), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all_raw(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (all_to_all_raw(g, concat_dim, split_dim, ctx.group), None,
                None, None)


def ppermute(x: torch.Tensor, perm, group: Group) -> torch.Tensor:
    """``lax.ppermute`` over ``group``: for each (source, destination)
    pair of group ranks in ``perm`` the source's ``x`` lands on the
    destination; a rank no pair sends to gets zeros. Differentiable:
    the backward sends each gradient back along the inverse
    permutation."""
    if group.trivial:
        return x
    return _PPermute.apply(x, tuple(tuple(p) for p in perm), group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group: Group) -> torch.Tensor:
    """The tiled all-to-all over ``group`` (:func:`all_to_all_raw`),
    differentiable: the backward is the inverse exchange (split along
    ``concat_dim``, concatenate along ``split_dim``)."""
    if group.trivial:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Enter a tensor-parallel region: identity forward; the backward
    sums the group's gradients (each rank's covers its own columns)."""
    return x if group.trivial else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Leave a tensor-parallel region: the forward sums the group's
    partial results; identity backward."""
    return x if group.trivial else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, dim: int, group: Group,
           reduce_grad: bool = True) -> torch.Tensor:
    """All-gather along ``dim``, differentiable. The backward sums the
    group's gradients and keeps this rank's part (``reduce_grad``: the
    ranks saw different rows, a batch axis) or keeps this rank's part of
    its own gradient (the ranks computed the same thing, a model axis)."""
    if group.trivial:
        return x
    return _Gather.apply(x, dim, group, reduce_grad)
