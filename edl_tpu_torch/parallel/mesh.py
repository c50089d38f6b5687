"""Device mesh — the port of ``edl_tpu/parallel/mesh.py``.

:class:`MeshPlan` keeps the reference's grammar and arithmetic (axis
order, ``create``, ``from_spec``, ``parse`` of the EDL_MESH string,
``batch_shards``, the partition-spec helpers). A spec is a tuple with
one entry a dimension — an axis name, a tuple of axis names, or None —
and ``()`` replicates (the reference's ``PartitionSpec``).

What the port builds from a plan is a :class:`Mesh` over processes: the
ranks of the ``torch.distributed`` world (the pool of
``utils/platform.py``, or the elastic process runtime's epoch group),
one device each. :meth:`MeshPlan.build` lays the plan's axes over the
first ``plan.size()`` ranks (or the ``ranks`` given) in the reference's
axis order, rank-major, so ``tp`` varies fastest, and builds one process
group for each axis (``parallel/collectives.Group``). Every rank of the
world must call it — also a rank outside the mesh, which gets a mesh
with ``member`` False — because a process group is made by all ranks
together. Groups are built once per set of ranks and reused.

The axes ``dp``, ``pp``, ``fsdp``, ``sp`` and ``tp`` are ported (sp:
``parallel/ring_attention`` and ``ulysses``; pp: ``parallel/pipeline``).
``ep`` (ROADMAP Queue A item 2e) raises in :meth:`MeshPlan.build`.
The elastic process runtime still runs one device a process on a dp
mesh: an EDL_MESH that names another axis, and ``EDL_LOCAL_DEVICES >
1``, raise (item 2h: workers of other meshes).

The device of a worker process comes from ``EDL_LOCAL_DEVICES``
(:func:`process_device`): 0 (the default) is the card, ``cuda:0``, and
raises without one; 1 is the CPU, what the tests ask for.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from edl_tpu_torch.parallel.collectives import ONE, Group
from edl_tpu_torch.utils.device import resolve_device

AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "sp", "ep", "tp")
# axes that split the batch (edl_tpu/api/job.py BATCH_AXES): only they
# may absorb a membership change
BATCH_AXES: Tuple[str, ...] = ("dp", "fsdp")
# the ROADMAP item each axis the port's mesh does not run waits for (it
# runs dp, pp, fsdp, sp and tp)
WAITING = {"ep": "2e, of item 2b's second half (the MoE's ep)"}

_ITEM_WORKERS = ("not ported yet (ROADMAP Queue A item 2h, of item 2b's "
                 "second half: workers of other meshes; the elastic "
                 "process runtime runs dp meshes, one device a process)")


def _not_dp(what: str, axes) -> NotImplementedError:
    return NotImplementedError(f"{what}: mesh axes {axes} are {_ITEM_WORKERS}")


def foreign_mesh(mesh, what: str) -> NotImplementedError:
    """The error for a mesh object that is not the port's :class:`Mesh`
    (a JAX mesh, say)."""
    return NotImplementedError(
        f"{what}: a mesh other than the port's parallel/mesh.Mesh "
        f"({type(mesh).__name__}) is not ported yet")


def require_ported(plan, what: str = "this path") -> None:
    """Raise ``NotImplementedError`` for a plan with an axis the port's
    mesh does not run yet, naming the ROADMAP item it waits for."""
    for a, n in getattr(plan, "axes", ()):
        if n > 1 and a in WAITING:
            raise NotImplementedError(
                f"{what}: mesh axis {a}={n} is not ported yet (ROADMAP "
                f"Queue A item {WAITING[a]})")


@dataclass(frozen=True)
class MeshPlan:
    """A named-axis factorization of a device count."""

    axes: Tuple[Tuple[str, int], ...]  # ordered (name, size), all sizes >= 1

    @classmethod
    def create(cls, **sizes: int) -> "MeshPlan":
        bad = set(sizes) - set(AXIS_ORDER)
        if bad:
            raise ValueError(f"unknown mesh axes {sorted(bad)}")
        axes = tuple((a, int(sizes.get(a, 1))) for a in AXIS_ORDER
                     if sizes.get(a, 1) > 1)
        return cls(axes=axes if axes else (("dp", 1),))

    @classmethod
    def from_spec(cls, spec, n_devices: int) -> "MeshPlan":
        """Complete a user MeshSpec against an actual device count: the
        given axes must divide ``n_devices``; the remainder goes to dp
        (elastic growth lands on the data axis)."""
        sizes = spec.axis_sizes()
        prod = math.prod(sizes.values()) if sizes else 1
        if n_devices % prod:
            raise ValueError(
                f"mesh axes {sizes} (={prod}) do not divide {n_devices} "
                f"devices")
        sizes["dp"] = sizes.get("dp", 1) * (n_devices // prod)
        return cls.create(**sizes)

    @classmethod
    def parse(cls, mesh: str, n_devices: int) -> "MeshPlan":
        """Parse an elastic mesh string against a device count, with the
        reference's grammar: comma-separated terms, ``axis=K`` pins a
        size, a bare ``axis`` is the growth axis (default ``dp``) that
        takes the rest of the devices."""
        s = (mesh or "dp").strip()
        fixed: Dict[str, int] = {}
        grow = "dp"
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                k, v = part.split("=", 1)
                size = int(v)
                if size < 1:
                    raise ValueError(
                        f"mesh axis size must be >= 1: {part!r} in {s!r}")
                fixed[k.strip()] = size
            else:
                grow = part
        unknown = (set(fixed) | {grow}) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)} in {s!r}")
        if grow in fixed:
            raise ValueError(f"axis {grow!r} is both fixed and the growth axis")
        if grow not in BATCH_AXES:
            raise ValueError(
                f"growth axis must be one of {BATCH_AXES}, got {grow!r}")
        prod = math.prod(fixed.values()) if fixed else 1
        if n_devices % prod:
            raise ValueError(
                f"fixed mesh axes {fixed} (={prod}) do not divide "
                f"{n_devices} devices")
        sizes = dict(fixed)
        sizes[grow] = n_devices // prod
        return cls.create(**sizes)

    @classmethod
    def data_parallel(cls, n_devices: int) -> "MeshPlan":
        return cls.create(dp=n_devices)

    @classmethod
    def fsdp_only(cls, n_devices: int) -> "MeshPlan":
        return cls.create(fsdp=n_devices)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        for a, s in self.axes:
            if a == name:
                return s
        return 1

    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.names if a in BATCH_AXES)

    def batch_shards(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes()) or 1

    def coords(self, mesh_rank: int) -> Dict[str, int]:
        """{axis: index} of the mesh's ``mesh_rank``-th rank (row-major
        over the plan's axes: the last axis varies fastest)."""
        out, r = {}, mesh_rank
        for a, s in reversed(self.axes):
            out[a] = r % s
            r //= s
        return out

    def build(self, devices: Optional[Sequence[torch.device]] = None,
              ranks: Optional[Sequence[int]] = None) -> "Mesh":
        """The mesh over the world's ranks ``ranks`` (default the first
        ``self.size()``), with this process's device (``devices``: one,
        default the card) and one process group an axis. A world of one
        process with no process group is a mesh of one rank. Every rank
        of the world calls this, members or not."""
        require_ported(self, "MeshPlan.build")
        devs = list(devices) if devices is not None else [resolve_device()]
        if len(devs) != 1:
            raise NotImplementedError(
                f"MeshPlan.build: {len(devs)} devices in one process are "
                f"{_ITEM_WORKERS}")
        world, me = _group_shape()
        n = self.size()
        ranks = tuple(range(n)) if ranks is None else tuple(ranks)
        if len(ranks) != n or n > world:
            raise ValueError(
                f"mesh needs {n} processes, the group has {world}"
                + ("" if ranks is None else f" (ranks {ranks})"))
        groups: Dict[str, Group] = {}
        for a in self.names:
            if self.axis_size(a) > 1:
                groups[a] = _axis_group(self, ranks, a, world, me)
        member = me in ranks
        mrank = ranks.index(me) if member else -1
        return Mesh(device=torch.device(devs[0]), world=n,
                    rank=mrank, plan=self, ranks=ranks, member=member,
                    groups=groups)

    def slice_layout(self, devices=None, slices=None) -> Dict[str, int]:
        """{slice id -> device count}: one card a process has no slice
        index, so every device counts under ``"None"`` unless ``slices``
        names them."""
        n = len(devices) if devices is not None else self.size()
        marks = list(slices) if slices is not None else [None] * n
        out: Dict[str, int] = {}
        for m in marks:
            out[str(m)] = out.get(str(m), 0) + 1
        return out

    # -- partition specs (tuples: one entry a dim, () replicated) -----------

    def _batch_entry(self):
        # a spec entry of one axis is its name (as PartitionSpec keeps it)
        ba = self.batch_axes()
        return ba[0] if len(ba) == 1 else (ba if ba else None)

    def batch_pspec(self) -> tuple:
        """Batch dimension split over every batch axis, rest replicated."""
        return (self._batch_entry(),)

    def batch_sharding(self, mesh: "Mesh"):
        from edl_tpu_torch.parallel.sharding import Sharding

        return Sharding(mesh, self.batch_pspec())

    def sequence_pspec(self, rank: int = 2) -> tuple:
        """[B, T, ...] activations: batch over the batch axes, the
        sequence dim over ``sp``, rest replicated."""
        sp = "sp" if self.axis_size("sp") > 1 else None
        return (self._batch_entry(), sp) + (None,) * (rank - 2)

    def sequence_sharding(self, mesh: "Mesh", rank: int = 2):
        from edl_tpu_torch.parallel.sharding import Sharding

        return Sharding(mesh, self.sequence_pspec(rank))

    def replicated(self, mesh: "Mesh"):
        from edl_tpu_torch.parallel.sharding import Sharding

        return Sharding(mesh, ())

    def describe(self) -> Dict[str, int]:
        return dict(self.axes)


@dataclass(frozen=True)
class Mesh:
    """A mesh over processes: this process's device, the mesh's size
    (``world``) and this process's place in it (``rank``, -1 and
    ``member`` False outside it), the plan, the world ranks of the mesh
    in mesh order, and one :class:`~edl_tpu_torch.parallel.collectives.
    Group` for each axis of size > 1. ``Mesh(device)`` is one process;
    ``Mesh(device, world, rank)`` the elastic runtime's dp mesh over the
    whole default group."""

    device: torch.device
    world: int = 1
    rank: int = 0
    plan: Optional[MeshPlan] = None
    ranks: Tuple[int, ...] = ()
    member: bool = True
    groups: Dict[str, Group] = field(default_factory=dict, compare=False,
                                     hash=False, repr=False)

    @property
    def layout(self) -> MeshPlan:
        return self.plan if self.plan is not None else \
            MeshPlan.data_parallel(self.world)

    def coords(self) -> Dict[str, int]:
        return self.layout.coords(self.rank)

    def group(self, axis: str) -> Group:
        """The process group of ``axis`` (a size-1 group when the axis
        is absent or of size 1)."""
        if axis in self.groups:
            return self.groups[axis]
        if self.plan is None and axis == "dp" and self.world > 1:
            return Group(None, self.world, self.rank)  # the default group
        return ONE

    def world_ranks(self) -> Tuple[int, ...]:
        return self.ranks or tuple(range(self.world))


_GROUPS: Dict[Any, Any] = {}


def _axis_group(plan: MeshPlan, ranks: Tuple[int, ...], axis: str,
                world: int, me: int) -> Group:
    """This process's group along ``axis``: the ranks whose coordinates
    differ only on ``axis``. Every group of the axis is made (by every
    rank, in one order), so all ranks make the same calls."""
    import torch.distributed as dist

    n = plan.size()
    key_of = {}
    for mr in range(n):
        c = plan.coords(mr)
        key = tuple(v for a, v in c.items() if a != axis)
        key_of.setdefault(key, []).append(ranks[mr])
    mine = Group()
    default = dist.distributed_c10d._get_default_group()
    for key in sorted(key_of):
        members = tuple(key_of[key])
        if members == tuple(range(world)):
            pg = None  # the whole world in its own order: the default group
        else:
            ck = (id(default), members)
            if ck not in _GROUPS:
                _GROUPS[ck] = dist.new_group(list(members))
            pg = _GROUPS[ck]
        if me in members:
            mine = Group(pg, len(members), members.index(me))
    return mine


def _group_shape() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def pool_group(ranks: Sequence[int]) -> Group:
    """This process's group over the world ranks ``ranks`` (every rank
    of the world calls it): the default group when ``ranks`` is the
    whole world, a size-1 group for one rank."""
    import torch.distributed as dist

    world, me = _group_shape()
    ranks = tuple(ranks)
    if len(ranks) <= 1:
        return ONE
    if ranks == tuple(range(world)):
        return Group(None, world, me)
    default = dist.distributed_c10d._get_default_group()
    ck = (id(default), ranks)
    if ck not in _GROUPS:
        _GROUPS[ck] = dist.new_group(list(ranks))
    if me not in ranks:
        return Group(_GROUPS[ck], len(ranks), -1)
    return Group(_GROUPS[ck], len(ranks), ranks.index(me))


def require_dp(plan, what: str = "this path") -> None:
    """Raise unless ``plan`` (the port's or the reference's MeshPlan,
    duck typed by ``axes``) splits devices over dp alone — for the
    paths that run dp meshes only (the elastic process runtime)."""
    sharded = [(a, n) for a, n in getattr(plan, "axes", ())
               if n > 1 and a != "dp"]
    if sharded:
        raise _not_dp(what, sharded)


def check_dp_only(mesh: str) -> None:
    """Raise for an EDL_MESH string that names any axis but dp — also at
    a world size where that axis would have size 1, so the job fails at
    start, not at its first rescale."""
    named = [p.split("=", 1)[0].strip() for p in (mesh or "dp").split(",")
             if p.strip()]
    others = [a for a in named if a != "dp"]
    if others:
        raise _not_dp(f"mesh {mesh!r}", others)


def process_device(local_devices: int) -> torch.device:
    """A worker process's device from ``EDL_LOCAL_DEVICES``: 0 is the
    card (``cuda:0``; raises when there is none — a worker never falls
    back to the CPU), 1 is the CPU, more raises (one device a process)."""
    if local_devices == 0:
        dev = resolve_device("cuda:0")
        torch.cuda.set_device(dev)
        return dev
    if local_devices == 1:
        return torch.device("cpu")
    raise NotImplementedError(
        f"EDL_LOCAL_DEVICES={local_devices}: several devices in one worker "
        f"process are {_ITEM_WORKERS}")
