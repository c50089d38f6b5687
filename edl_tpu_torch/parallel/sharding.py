"""Parameter sharding and host staging — the port of
``edl_tpu/parallel/sharding.py``.

**Layout at rest is the reference's PartitionSpec.** A spec here is a
tuple with one entry a dimension (an axis name, a tuple of names, or
None); ``()`` replicates. :func:`fsdp_pspec`, :func:`fit_pspec` and
:func:`param_pspecs` are the reference's rules, entry for entry, so a
rank holds exactly the slice the reference gives its device (the
undivided-axis drop of ``fit_pspec`` included): its local shape is the
reference's ``addressable_shards`` shape.

The port holds that slice as a plain local tensor, not as a DTensor or
under FSDP2. FSDP2's ``fully_shard`` pads dimension 0 into equal chunks
(another layout), and a plain tensor goes straight into the Hopper
kernels. What a placed leaf needs to know of its place rides on it as a
:class:`ShardInfo` (global shape, spec and mesh; :func:`info`), which the
step, the optimizer's whole-tensor reductions, the checkpoint and the
reshard read.

- :func:`shard_tree`: a whole (host) tree onto a mesh: each member keeps
  its slices, with their :class:`ShardInfo`.
- :func:`gather`: a leaf's slices gathered back over some axes,
  differentiable (the fsdp gather before use; its backward
  reduce-scatters).
- :func:`redistribute`: leaves moved from one mesh's layout to
  another's over the pool's collectives (point-to-point pieces, each
  sent once to the rank that needs it) — the device path of a reshard,
  and the exchange between hosts of the host path.
- :func:`stage_pspec` and :func:`stage_stack`: a stacked layer leaf
  split over ``pp`` seen as ``[pp, layers / pp, ...]`` stages, and
  :func:`sequence_part`: this rank's part of a ``[B, T, ...]`` array
  laid out by ``MeshPlan.sequence_pspec`` (the sequence over ``sp``).
- :func:`to_host` (device → host RAM, the snapshot half of the reshard
  protocol) and :func:`stream_reshard` (device → host → device as one
  overlapped pipeline, the host fallback), on a process's own tensors.

The reference moves ``jax.Array`` pieces with ``copy_to_host_async``
and ``device_put``. Here a piece goes device → pinned host memory on a
download stream and host → device on an upload stream, ordered by CUDA
events only, so the host never waits inside the pipeline and the two
copy directions overlap (the stall is ~max(d2h, h2d), not the sum).
Policies shared with the reference: leaves over 2 x ``_CHUNK_BYTES``
(and with more than one row) are cut into row pieces of about
``_CHUNK_BYTES``, and at most ``_CHUNK_WINDOW`` pieces are in flight:
they are the slots of one pinned staging ring, and a slot's next
download waits on the event of its last upload.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.utils.device import DeviceLike, resolve_device
from edl_tpu_torch.utils.tree import leaves as _leaves
from edl_tpu_torch.utils.tree import replace_leaves

Spec = tuple  # one entry a dim: an axis name, a tuple of names, or None


def fsdp_pspec(shape, fsdp_size: int, tp_size: int = 1,
               axis: str = "fsdp") -> Spec:
    """ZeRO-3 placement for one param: shard the largest dimension
    divisible by the fsdp axis; replicate (``()``) if nothing divides."""
    if fsdp_size <= 1 or not shape:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0:
            spec: list = [None] * len(shape)
            spec[i] = axis
            return tuple(spec)
    return ()


def fit_pspec(plan, shape, *axes) -> Spec:
    """Each dim on its requested axis ONLY when the axis divides it — a
    6-way fsdp mesh must still run; the undivided dim is replicated on
    that axis instead (the reference's rule)."""
    parts = []
    for dim, ax in zip(shape, axes):
        ok = ax is not None and dim % plan.axis_size(ax) == 0
        parts.append(ax if ok else None)
    return tuple(parts)


def param_pspecs(params, plan) -> Any:
    """Spec tree for a tree of whole (global-shape) params: fsdp sharding
    when the plan has an fsdp axis, else replicated. Models with tensor
    parallelism give their own (``models/llama.param_pspecs``)."""
    fsdp = plan.axis_size("fsdp")
    return replace_leaves(params, [fsdp_pspec(tuple(p.shape), fsdp)
                                   for p in _leaves(params)])


@dataclass(frozen=True)
class Sharding:
    """The reference's ``NamedSharding``: a mesh and a spec."""

    mesh: Any
    spec: Spec


def named(tree, mesh) -> Any:
    """Spec tree → :class:`Sharding` tree."""
    if _is_spec(tree):
        return Sharding(mesh, tree)
    if isinstance(tree, dict):
        return {k: named(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(named(v, mesh) for v in tree)
    return Sharding(mesh, tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def full_spec(spec: Spec, ndim: int) -> Spec:
    """``spec`` padded with None to ``ndim`` entries (the reference's
    trailing dims are replicated)."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in entry_axes(e))


def local_box(shape, spec: Spec, plan, coords: Dict[str, int]
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offset, extent) of the slice of a ``shape`` leaf laid out by
    ``spec`` that the rank at mesh ``coords`` holds. An entry of several
    axes splits row-major over them."""
    shape = tuple(shape)
    off, ext = [], []
    for dim, e in zip(shape, full_spec(spec, len(shape))):
        n, idx = 1, 0
        for a in entry_axes(e):
            s = plan.axis_size(a)
            n, idx = n * s, idx * s + coords.get(a, 0)
        if dim % n:
            raise ValueError(f"spec {spec} splits dim {dim} of {shape} "
                             f"{n} ways")
        off.append(idx * (dim // n))
        ext.append(dim // n)
    return tuple(off), tuple(ext)


def global_shape(local_shape, spec: Spec, plan) -> Tuple[int, ...]:
    """The whole leaf's shape from a slice's."""
    out = []
    for dim, e in zip(local_shape, full_spec(spec, len(local_shape))):
        out.append(dim * math.prod(plan.axis_size(a) for a in entry_axes(e)))
    return tuple(out)


@dataclass(frozen=True)
class ShardInfo:
    """Where a placed leaf sits: the whole leaf's shape, its spec and
    the mesh (``parallel/mesh.Mesh``)."""

    shape: Tuple[int, ...]
    spec: Spec
    mesh: Any

    def box(self):
        """(offset, extent) of this process's slice."""
        return local_box(self.shape, self.spec, self.mesh.layout,
                         self.mesh.coords())

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes (of size > 1) that split dimension ``dim``."""
        e = full_spec(self.spec, len(self.shape))[dim]
        return tuple(a for a in entry_axes(e)
                     if self.mesh.layout.axis_size(a) > 1)

    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a in spec_axes(self.spec)
                     if self.mesh.layout.axis_size(a) > 1)

    def sum(self, t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        """All-reduce (sum, in place) of a partial sum over the local
        parts of ``dims``: over every axis that splits one of them."""
        for a in dict.fromkeys(a for d in dims for a in self.dim_axes(d)):
            coll.all_reduce(t, self.mesh.group(a))
        return t


def info(t) -> Optional[ShardInfo]:
    """The :class:`ShardInfo` of a placed leaf, or None (whole)."""
    return getattr(t, "_edl_shard", None)


def attach(t: torch.Tensor, inf: Optional[ShardInfo]) -> torch.Tensor:
    """Mark ``t`` as the local slice described by ``inf``; returns ``t``."""
    t._edl_shard = inf
    return t


def _box_slices(off, ext) -> Tuple[slice, ...]:
    return tuple(slice(o, o + e) for o, e in zip(off, ext))


def place_leaf(x: torch.Tensor, spec: Spec, mesh,
               device: DeviceLike = None) -> Optional[torch.Tensor]:
    """This member's slice of the whole leaf ``x`` (a copy on
    ``device``, default the mesh's) with its :class:`ShardInfo`; None
    outside the mesh."""
    if not mesh.member:
        return None
    dev = torch.device(device) if device is not None else mesh.device
    inf = ShardInfo(tuple(x.shape), tuple(spec), mesh)
    off, ext = inf.box()
    part = x.detach()[_box_slices(off, ext)]
    return attach(part.to(dev, copy=True).contiguous(), inf)


def shard_tree(tree, mesh, pspecs) -> Any:
    """Place a whole (host or device) tree onto ``mesh`` with the spec
    tree ``pspecs``: every member keeps its slices (:func:`place_leaf`);
    a process outside the mesh gets None."""
    if not mesh.member:
        return None
    return replace_leaves(tree, [
        place_leaf(x, s, mesh)
        for x, s in zip(_leaves(tree), specs_for(tree, pspecs))])


def spec_leaves(pspecs) -> List[Spec]:
    """The specs of a spec tree in leaf order."""
    if _is_spec(pspecs):
        return [pspecs]
    if isinstance(pspecs, dict):
        return [s for k in pspecs for s in spec_leaves(pspecs[k])]
    if isinstance(pspecs, (list, tuple)):
        return [s for v in pspecs for s in spec_leaves(v)]
    raise TypeError(f"not a spec tree: {pspecs!r}")


def spec_items(pspecs, prefix: str = "") -> List[Tuple[str, Spec]]:
    """[(key, spec)] of a spec tree, keyed as the checkpoint keys its
    leaves (dict keys and list positions joined by '/')."""
    if _is_spec(pspecs):
        return [(prefix, pspecs)]
    items = (pspecs.items() if isinstance(pspecs, dict)
             else enumerate(pspecs))
    return [kv for k, v in items
            for kv in spec_items(v, f"{prefix}/{k}" if prefix else str(k))]


def _leaf_keys(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, torch.Tensor):
        return [prefix]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [k2 for k, v in items
            for k2 in _leaf_keys(v, f"{prefix}/{k}" if prefix else str(k))]


def specs_for(tree, pspecs) -> List[Spec]:
    """The spec of each leaf of ``tree`` (in :func:`leaves` order) from
    the spec tree ``pspecs``, matched by key path, not by order."""
    by_key = dict(spec_items(pspecs))
    keys = _leaf_keys(tree)
    missing = [k for k in keys if k not in by_key]
    if missing:
        raise KeyError(f"no spec for leaves {missing}")
    return [by_key[k] for k in keys]


def gather(x: torch.Tensor, inf: ShardInfo, axes: Sequence[str],
           batch_axes: Sequence[str] = ("dp", "fsdp"),
           dim_offset: int = 0) -> torch.Tensor:
    """``x`` (this rank's slice, or a view of it whose leading
    ``dim_offset`` dims ``inf`` describes and ``x`` lacks) gathered over
    the mesh axes ``axes`` wherever they split a dim, differentiably:
    the backward sums over a batch axis (the ranks saw other rows) and
    slices over a model axis (the ranks computed the same thing)."""
    spec = full_spec(inf.spec, len(inf.shape))[dim_offset:]
    for d, e in enumerate(spec):
        for a in reversed(entry_axes(e)):
            if a in axes and inf.mesh.layout.axis_size(a) > 1:
                x = coll.gather(x, d, inf.mesh.group(a),
                                reduce_grad=a in batch_axes)
    return x


def stage_pspec(spec: Spec, ndim: int, axis: str = "pp") -> Spec:
    """The spec of a ``[n, L / n, ...]`` stage view of a stacked leaf
    laid out by ``spec`` (``ndim`` dims, its layer dim over ``axis``):
    the stage dim over ``axis``, the layers within a stage whole, the
    rest as they were."""
    full = full_spec(spec, ndim)
    if entry_axes(full[0]) != (axis,):
        raise ValueError(f"stage_pspec: dim 0 of {spec} is not split over "
                         f"{axis!r} alone")
    return (axis, None) + full[1:]


def stage_stack(x: torch.Tensor, n_stages: int, axis: str = "pp"
                ) -> torch.Tensor:
    """This rank's slice ``[L / n, ...]`` of a stacked leaf split over
    ``axis`` on its layer dim, viewed as ``[1, L / n, ...]``: its stage
    of the ``[n, L / n, ...]`` stack, carrying that layout
    (:func:`stage_pspec`), so ``parallel/pipeline.pipeline_apply`` sees
    its leading dim is ``n`` stages. Differentiable (a view)."""
    inf = info(x)
    if inf is None or inf.dim_axes(0) != (axis,):
        raise ValueError(f"stage_stack: the leaf is not split over "
                         f"{axis!r} on its layer dim")
    if inf.shape[0] % n_stages:
        raise ValueError(f"stage_stack: {inf.shape[0]} layers do not "
                         f"split into {n_stages} stages")
    shape = (n_stages, inf.shape[0] // n_stages) + tuple(inf.shape[1:])
    return attach(x.unsqueeze(0), ShardInfo(
        shape, stage_pspec(inf.spec, len(inf.shape), axis), inf.mesh))


def sequence_part(x, mesh, dim: int = 1) -> Tuple[Any, int]:
    """(this rank's part of ``x`` along its sequence dim ``dim``, the
    part's first position): the sequence split over the mesh's ``sp``
    axis, as ``MeshPlan.sequence_pspec`` lays it out; ``x`` whole when
    the mesh has no sp."""
    sp = mesh.layout.axis_size("sp")
    if sp <= 1:
        return x, 0
    t = x.shape[dim]
    if t % sp:
        raise ValueError(f"sequence {t} not divisible by sp={sp}")
    n = t // sp
    off = mesh.coords()["sp"] * n
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(off, off + n)
    return x[tuple(sl)], off


def gather_tree(tree, axes: Optional[Sequence[str]] = None) -> Any:
    """Every placed leaf of ``tree`` gathered whole (over ``axes``,
    default all of its axes), differentiably (:func:`gather`)."""
    out = []
    for x in _leaves(tree):
        inf = info(x)
        out.append(x if inf is None else gather(
            x, inf, inf.axes() if axes is None else axes))
    return replace_leaves(tree, out)


@dataclass(frozen=True)
class LeafPlan:
    """One leaf of a :func:`redistribute`: its whole shape and dtype,
    its spec on the source and on the target mesh, and the device the
    target slice lives on."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    src_spec: Spec
    dst_spec: Spec
    device: Any = "cpu"


def _intersect(a, b):
    lo = tuple(max(x, y) for x, y in zip(a[0], b[0]))
    hi = tuple(min(x + e, y + f) for x, e, y, f in zip(a[0], a[1], b[0], b[1]))
    if any(h <= l for l, h in zip(lo, hi)):
        return None
    return lo, tuple(h - l for l, h in zip(lo, hi))


def _rel(box, base) -> Tuple[slice, ...]:
    return tuple(slice(o - b, o - b + e)
                 for o, e, b in zip(box[0], box[1], base[0]))


class Redistribution:
    """A :func:`redistribute` whose target slices are allocated and
    whose transfers have not started (:func:`prepare_redistribute`);
    :meth:`run` moves the pieces."""

    def __init__(self, walks, me: int):
        self._walks, self._me = walks, me

    def run(self) -> List[Optional[torch.Tensor]]:
        """Move every piece and return this process's slices on the
        target mesh (None outside it). A piece is received straight into
        its slice: under gloo through pinned host memory, so no device
        memory is allocated here (under NCCL a strided target view goes
        through a contiguous device buffer)."""
        me = self._me
        world = coll.Group(None, 0, 0)  # point to point on the default group
        out: List[Optional[torch.Tensor]] = []
        for x, dranks, dboxes, owners, held, mine in self._walks:
            for r, dbox in enumerate(dboxes):
                target = dranks[r]
                if target == me and mine is x and x is not None:
                    continue
                for sbox, owner in owners.items():
                    inter = _intersect(sbox, dbox)
                    if inter is None:
                        continue
                    source = target if held.get(target) == sbox else owner
                    if source == target:
                        if me == target:
                            mine[_rel(inter, dbox)] = x[_rel(inter, sbox)]
                    elif me == source:
                        coll.send(x[_rel(inter, sbox)], target, world)
                    elif me == target:
                        coll.recv(mine[_rel(inter, dbox)], source, world)
            out.append(mine)
        return out


def prepare_redistribute(tensors: Sequence[Optional[torch.Tensor]],
                         plans: Sequence[LeafPlan], src, dst, me: int,
                         alias: bool = True) -> Redistribution:
    """The local half of :func:`redistribute`: the pieces' walk and this
    process's target slices, allocated. Nothing here talks to another
    process, so a failure here (a layout, device memory) is this
    process's alone and can be agreed on (``collectives.agree``) before
    any transfer starts."""
    (splan, sranks), (dplan, dranks) = src, dst
    walks = []
    for x, lp in zip(tensors, plans):
        sboxes = [local_box(lp.shape, lp.src_spec, splan, splan.coords(r))
                  for r in range(len(sranks))]
        dboxes = [local_box(lp.shape, lp.dst_spec, dplan, dplan.coords(r))
                  for r in range(len(dranks))]
        owners: Dict[Any, int] = {}
        for r, b in enumerate(sboxes):
            owners.setdefault(b, sranks[r])
        held = {sranks[r]: b for r, b in enumerate(sboxes)}
        mine = None
        if me in dranks:
            dbox = dboxes[dranks.index(me)]
            dev = torch.device(lp.device)
            if (alias and held.get(me) == dbox and x is not None
                    and x.device == dev):
                mine = x  # the same slice: no copy
            else:
                mine = torch.empty(dbox[1], dtype=lp.dtype, device=dev)
        walks.append((x, list(dranks), dboxes, owners, held, mine))
    return Redistribution(walks, me)


def redistribute(tensors: Sequence[Optional[torch.Tensor]],
                 plans: Sequence[LeafPlan], src, dst, me: int,
                 alias: bool = True) -> List[Optional[torch.Tensor]]:
    """Move leaves from the layout of mesh ``src`` onto mesh ``dst``.

    ``tensors[i]`` is this process's slice of leaf ``i`` on ``src`` (None
    outside it); ``src`` and ``dst`` are (plan, world ranks in mesh
    order) pairs; ``me`` is this process's world rank. Every process of
    either mesh calls this with the same ``plans``. Returns this
    process's slices on ``dst`` (None outside it).

    Every rank walks one list of pieces in one order: for each leaf, each
    target rank and each distinct source slice it overlaps, the overlap
    comes from the target's own source slice when it holds that slice,
    else from the first source rank holding it, point to point. A piece
    that stays on its process is a local copy, and a target slice equal
    to the process's own source slice is the same tensor (``alias``; a
    copy without). The walk's
    total order makes the blocking sends and receives deadlock-free: the
    earliest unfinished piece always has both ends waiting on it.
    (:func:`prepare_redistribute`, then :meth:`Redistribution.run`.)"""
    return prepare_redistribute(tensors, plans, src, dst, me, alias).run()


_CHUNK_BYTES = 8 << 20  # split large leaves into ~8 MB row pieces
_CHUNK_WINDOW = 8  # pieces in flight: the slots of the pinned ring


def to_host(tree) -> Any:
    """Fetch a tree of tensors to host memory (pinned where a leaf comes
    from the card): every device → host copy is queued on one download
    stream before the host waits once. Whole leaves, not pieces: a copy
    lands in its final host buffer, so pieces would only add copies
    (the reference pieces leaves to open concurrent streams on slow
    links; one copy engine serves them in turn here). CPU leaves are
    cloned."""
    leaves = [x.detach() for x in _leaves(tree)]
    # pinned only where a card takes part (pinning needs the runtime)
    outs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            for x in leaves]
    cuda = [x.is_cuda for x in leaves]
    if any(cuda):
        down = torch.cuda.Stream()
        down.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(down):
            for x, o, c in zip(leaves, outs, cuda):
                if c:
                    o.copy_(x, non_blocking=True)
        down.synchronize()
    for x, o, c in zip(leaves, outs, cuda):
        if not c:
            o.copy_(x)
    return replace_leaves(tree, outs)


def _schedule(leaves: Sequence[torch.Tensor]
              ) -> List[Tuple[int, Optional[int], Optional[int]]]:
    """(leaf index, row start, row end) pieces; None rows = the whole
    leaf. The reference's rule: a leaf over 2 x ``_CHUNK_BYTES`` with
    more than one row is cut into min(rows, max(2, bytes //
    _CHUNK_BYTES)) pieces of equal row count (the last ragged)."""
    out = []
    for i, x in enumerate(leaves):
        nbytes = x.numel() * x.element_size()
        rows = None
        if nbytes > 2 * _CHUNK_BYTES and x.dim() and x.shape[0] > 1:
            n = min(x.shape[0], max(2, nbytes // _CHUNK_BYTES))
            rows = -(-x.shape[0] // n)
        if rows is None or rows >= x.shape[0]:
            out.append((i, None, None))
        else:
            for s in range(0, x.shape[0], rows):
                out.append((i, s, min(s + rows, x.shape[0])))
    return out


def stream_reshard(leaves: Sequence[torch.Tensor],
                   targets: Sequence[DeviceLike]) -> List[torch.Tensor]:
    """Device → host → device as ONE overlapped pipeline: leaf ``i``
    lands as a new tensor on ``targets[i]`` (a device, CUDA or CPU),
    through host memory. Pieces (:func:`_schedule`) rotate through a
    pinned ring of ``_CHUNK_WINDOW`` slots: a download is queued on the
    download stream behind the upload that last used its slot, an upload
    on the upload stream behind its own download. CPU sides copy on the
    host (waiting on the piece's event first). The caller's stream waits
    on both streams before this returns, so its next op sees every
    placed leaf; the host does not wait for the copies."""
    leaves = [x.detach() for x in leaves]
    devs = [resolve_device(t) for t in targets]
    sched = _schedule(leaves)
    outs = [torch.empty(x.shape, dtype=x.dtype, device=d)
            for x, d in zip(leaves, devs)]
    cuda = any(x.is_cuda for x in leaves) or any(d.type == "cuda"
                                                 for d in devs)
    align = 64

    def piece(t, s, e):
        return t if s is None else t[s:e]

    sizes = [piece(leaves[i], s, e).numel() * leaves[i].element_size()
             for i, s, e in sched]
    slot_bytes = -(-max(sizes, default=1) // align) * align
    n_slots = max(1, min(_CHUNK_WINDOW, len(sched)))
    ring = torch.empty(n_slots * slot_bytes, dtype=torch.uint8,
                       pin_memory=cuda)
    if cuda:
        cur = torch.cuda.current_stream()
        down, up = torch.cuda.Stream(), torch.cuda.Stream()
        down.wait_stream(cur)  # sources are written on the caller's stream
        up.wait_stream(cur)  # and so are the fresh outputs
    freed: List[Optional[torch.cuda.Event]] = [None] * n_slots
    for k, ((i, s, e), size) in enumerate(zip(sched, sizes)):
        src = piece(leaves[i], s, e)
        dst = piece(outs[i], s, e)
        j = k % n_slots
        slot = ring[j * slot_bytes: j * slot_bytes + size]
        slot = slot.view(src.dtype).view(src.shape)
        landed = None
        if src.is_cuda:
            with torch.cuda.stream(down):
                if freed[j] is not None:
                    down.wait_event(freed[j])
                slot.copy_(src, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record(down)
        else:
            if freed[j] is not None:
                freed[j].synchronize()
            slot.copy_(src)
        if dst.is_cuda:
            with torch.cuda.stream(up):
                if landed is not None:
                    up.wait_event(landed)
                dst.copy_(slot, non_blocking=True)
                freed[j] = torch.cuda.Event()
                freed[j].record(up)
        else:
            if landed is not None:
                landed.synchronize()
            dst.copy_(slot)
            freed[j] = None
    if cuda:
        cur.wait_stream(down)
        cur.wait_stream(up)
    return outs
