"""Checkpointing — the one-process part of the port of
``edl_tpu/runtime/checkpoint.py``: the reshard mechanism and the dense
disk format.

- :func:`snapshot` / :func:`restore`: device state ⇄ host RAM, the fast
  path of an elastic rescale (no disk in the loop).
- :func:`staged_reshard`: device → host → device as one overlapped
  pipeline (:func:`edl_tpu_torch.parallel.sharding.stream_reshard`),
  the host fallback, with the optimizer moments optionally compressed
  for the trip (``stage``: int8 by default, bf16, or f32 = exact).
- :func:`state_nbytes` and the stall models that extrapolate a measured
  staging bandwidth (:func:`host_fallback_stall_model`,
  :func:`p2p_migrate_stall_model`).
- :func:`save` / :func:`load` / :func:`load_params` /
  :func:`load_metadata`: one atomic npz. Param keys are the reference's
  (``p:mlp/0/w``), so :func:`load_params` reads a checkpoint the
  reference wrote; moment keys are the port's own
  (``o:<param key>/<state name>``, e.g. ``o:embedding/exp_avg``), since
  the port's optimizer is a ``torch.optim`` instance, not an optax tree.

A TrainState's optimizer holds its moments keyed by Parameter identity,
so every function here returns a state whose optimizer is a new
instance bound to the new params (:func:`trainer.rebind_state`); moments
are found by membership in the optimizer's state, never by position.

The reference's hooks are here: the ``ckpt.commit`` fault site (the
dense save is its own commit), the ``ckpt.commit`` / ``ckpt.load``
flight events keyed by step, and the I/O telemetry
(``edl_checkpoint_save_seconds`` / ``edl_checkpoint_restore_seconds``
by kind, ``edl_checkpoint_bytes_total`` by op).

Over a mesh (``parallel/mesh.Mesh``) a placed state is each process's
slices, every param carrying its ``sharding.ShardInfo``. :func:`snapshot`
keeps them (host copies with the same layout), :func:`restore` and
:func:`staged_reshard` put a whole or placed state onto another mesh's
layout (``trainer.reshard_state``: the pieces move over the pool's
collectives), and the int8 staging takes each moment row's absmax over
the whole row, whatever splits it, so its bytes equal the reference's.

The multi-process sharded format: :func:`snapshot_local` (a process's
slices as pieces at their offsets; a piece is primary on the rank that
holds replica 0 of it), :func:`save_shards`, :func:`write_manifest`,
:func:`latest_manifest`, :func:`gc_step_dirs`, :func:`load_sharded`
(whole leaves, or each member's slices of a mesh),
:func:`load_sharded_params` and :func:`restore_local`. The manifest and
the ``p:`` pieces are the reference's format.

The peer restore's half (the p2p shard plane,
``runtime/shard_server.py`` and ``runtime/p2p_restore.py``):
:class:`_PieceIndex` takes remote peers' pieces beside RAM and disk,
:func:`template_state` / :func:`template_schema` give the leaf schema
without a manifest, :func:`peer_coverage_ok` decides whether peers'
pieces tile the state and :func:`load_from_pieces` assembles it.

bfloat16 leaves are held on the host as uint16 views with
``"bfloat16"`` in ``dtypes`` (numpy has no bf16; the export format's
rule), so a piece is the same bytes as the reference's ml_dtypes one,
on disk and on the wire.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.ops import quant
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.train.trainer import (TrainState, leaves,
                                         optimizer_tensors, rebind_state,
                                         replace_leaves, reshard_state,
                                         shard_state)
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)
from edl_tpu_torch.utils import faults, tracing
from edl_tpu_torch.utils.logging import kv_logger


def _obs_io(direction: str, kind: str, dt_s: float, nbytes: int) -> None:
    """Checkpoint I/O telemetry: duration histograms by format kind
    (``dense``) + a bytes counter."""
    r = obs_metrics.default_registry()
    name = (
        "edl_checkpoint_save_seconds"
        if direction == "write"
        else "edl_checkpoint_restore_seconds"
    )
    help = (
        "checkpoint write time" if direction == "write"
        else "checkpoint read/restore time"
    )
    r.histogram(name, help, ("kind",)).observe(dt_s, kind=kind)
    if nbytes:
        r.counter(
            "edl_checkpoint_bytes_total", "checkpoint bytes moved", ("op",)
        ).inc(nbytes, op=direction)


def _emit_ckpt(event: str, step: int, **attrs) -> None:
    """Flight-recorder entry (ckpt.commit / ckpt.load) keyed by step —
    the restore points a postmortem needs when explaining which state a
    recovery rolled back to. ``attrs`` carries the format (``fmt``)."""
    from edl_tpu_torch.obs import events

    events.emit(event, step=step, **attrs)


def snapshot(state: TrainState) -> TrainState:
    """Device → host RAM (step one of the reshard protocol): params and
    every optimizer tensor in one :func:`~sharding.to_host` pipeline; the
    result's optimizer is bound to the host params. A placed state's
    host params keep their ``ShardInfo``: the snapshot is this process's
    slices."""
    params = leaves(state.params)
    ot = optimizer_tensors(state)
    host = shd.to_host(params + [t for _, _, t, _ in ot])
    for p, h in zip(params, host):
        if shd.info(p) is not None:
            shd.attach(h, shd.info(p))
    moved = {(i, name): h for (i, name, _, _), h in zip(ot, host[len(params):])}
    return rebind_state(state, host[:len(params)], moved)


def _placed(state: Optional[TrainState]) -> bool:
    return state is not None and any(
        shd.info(p) is not None for p in leaves(state.params))


def restore(host_state: Optional[TrainState], plan=None, mesh=None,
            device: DeviceLike = None, param_pspecs=None, pool=None,
            src_mesh=None) -> Optional[TrainState]:
    """Host RAM → device (step three of the reshard protocol): a whole
    state is placed by :func:`~trainer.shard_state` (each member takes
    its slices); with a ``pool`` (a ``collectives.Group``) a placed
    snapshot moves onto ``mesh``'s layout over the pool's collectives
    (:func:`~trainer.reshard_state`; every process of the pool calls
    it, those with no slices with None)."""
    if pool is not None:
        return reshard_state(host_state, plan, mesh, pool, param_pspecs,
                             device=device, src_mesh=src_mesh)
    return shard_state(host_state, plan, mesh, device, param_pspecs)


def staged_reshard(state: Optional[TrainState], plan=None, mesh=None,
                   stage: Optional[str] = None,
                   device: DeviceLike = None, param_pspecs=None, pool=None,
                   src_mesh=None) -> Optional[TrainState]:
    """Device → host → device as ONE overlapped pipeline — the host
    fallback of the reshard protocol (``snapshot`` + ``restore`` would
    run the two directions back to back). Lands on ``device`` (CUDA
    unless ``"cpu"`` is named; a mesh's own device). With a ``pool`` (a
    ``collectives.Group``) a placed state moves onto ``mesh``'s layout
    through host memory (:func:`_staged_mesh_reshard`): every process of
    the pool calls it, those with no slices with None.

    ``stage`` compresses the OPTIMIZER-MOMENT tensors (never params: the
    f32 masters move exactly) for the host round trip:

    - ``"int8"`` (default, env ``EDL_RESHARD_STAGE``): blockwise-absmax
      int8 along the last axis (``ops/quant.py``): Adam state bytes 3P
      → ~1.5P. Moments move by at most 1/254 of their row's absmax.
    - ``"bf16"``: a cast on the source device, 3P → 2P.
    - ``"f32"``: no compression (bit-identical staging).

    A moment is compressed when it is an f32 tensor of the optimizer's
    state with at least one dim and 4096 elements (the reference's
    ``_compressible``: the WHOLE tensor's size); the per-param ``step``
    never is."""
    stage = stage or os.environ.get("EDL_RESHARD_STAGE", "int8")
    if stage not in ("int8", "bf16", "f32"):
        raise ValueError(f"unknown reshard staging mode {stage!r}")
    if stage != "f32":
        # lossy staging is the default for the stall win: say so on every
        # use, so operators know the moments were perturbed
        kv_logger("checkpoint").info(
            "staged reshard with lossy moment compression", stage=stage,
            override="EDL_RESHARD_STAGE=f32 for exact staging")
    if pool is not None:
        return _staged_mesh_reshard(state, plan, mesh, stage, device,
                                    param_pspecs, pool, src_mesh)
    if mesh is not None and not isinstance(mesh, _port_mesh()):
        from edl_tpu_torch.parallel.mesh import foreign_mesh

        raise foreign_mesh(mesh, "staged_reshard")
    require_unsharded(plan, None, "staged_reshard")
    dev = resolve_device(device)
    moved: List[torch.Tensor] = []
    targets: List[torch.device] = []

    def put(x, target) -> int:
        moved.append(x)
        targets.append(target)
        return len(moved) - 1

    params = [put(p.detach(), dev) for p in leaves(state.params)]
    plan_ops: List[Tuple[Tuple[int, str], str, Tuple[int, ...]]] = []
    for i, name, t, host in optimizer_tensors(state):
        target = torch.device("cpu") if host else dev
        if (stage != "f32" and t.dtype == torch.float32 and t.dim() >= 1
                and t.numel() >= 4096):
            if stage == "bf16":
                plan_ops.append(((i, name), "bf16",
                                 (put(t.to(torch.bfloat16), target),)))
            else:
                q, s = quant.quantize_int8(t)
                plan_ops.append(((i, name), "int8",
                                 (put(q, target), put(s, target))))
        else:
            plan_ops.append(((i, name), "raw", (put(t, target),)))
    placed = shd.stream_reshard(moved, targets)
    tensors = {}
    for key, op, slots in plan_ops:
        if op == "raw":
            tensors[key] = placed[slots[0]]
        elif op == "bf16":
            tensors[key] = placed[slots[0]].to(torch.float32)
        else:
            q, s = placed[slots[0]], placed[slots[1]]
            tensors[key] = quant.dequantize_to(q, s, q.device)
    return rebind_state(state, [placed[j] for j in params], tensors)


def _port_mesh():
    from edl_tpu_torch.parallel.mesh import Mesh

    return Mesh


def _row_absmax_int8(t: torch.Tensor, inf: Optional[shd.ShardInfo]):
    """(q int8, scale f32 [...]) of ``t`` with each row's absmax taken
    over the WHOLE last dim (all-reduced over the axes that split it),
    so the bytes equal those of ``quant.quantize_int8`` of the whole
    tensor."""
    m = t.abs().amax(dim=-1, keepdim=True)
    if inf is not None:
        from edl_tpu_torch.parallel import collectives as coll

        for a in inf.dim_axes(len(inf.shape) - 1):
            coll.all_reduce(m, inf.mesh.group(a), "max")
    s = torch.where(m > 0, m / 127.0, 1.0)
    q = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def _staged_mesh_reshard(state, plan, mesh, stage, device, param_pspecs,
                         pool, src_mesh) -> Optional[TrainState]:
    """The host path of a reshard between meshes: each source member
    compresses its moment slices on its device (int8 rows with whole-row
    absmax, or bf16) and copies everything to host memory
    (:func:`~sharding.to_host`); the pieces move between the processes'
    host buffers over the pool (``sharding.redistribute``, target the
    CPU); each target member uploads its slices through the overlapped
    pipeline (:func:`~sharding.stream_reshard`) and decompresses them on
    its device."""
    from edl_tpu_torch.parallel import collectives as coll
    from edl_tpu_torch.parallel.mesh import _group_shape
    from edl_tpu_torch.train import trainer as tr

    schema = None
    if state is not None:
        src = src_mesh
        if src is None:
            src = next(shd.info(p).mesh for p in leaves(state.params)
                       if shd.info(p) is not None)
        schema = tr.state_schema(state, src)
    schema = coll.broadcast_object(schema, 0, pool)
    _, me = _group_shape()
    dev = torch.device(device) if device is not None else mesh.device
    cpu = torch.device("cpu")
    dst_specs, base = tr.reshard_plans(schema, plan, mesh, param_pspecs, dev)
    n = len(schema.params)
    src_t = tr.state_tensors(state) if state is not None else None
    ps = leaves(state.params) if state is not None else None
    moved: List[Optional[torch.Tensor]] = []
    plans: List[shd.LeafPlan] = []
    ops = []  # (kind, slots, target device)

    def put(t, lp) -> int:
        moved.append(t)
        plans.append(dataclasses.replace(lp, device=cpu))
        return len(moved) - 1

    for j, lp in enumerate(base):
        x = src_t[j] if src_t is not None else None
        if j < n:
            ops.append(("raw", (put(x, lp),), lp.device))
            continue
        i, name, shape, dt, spec, host = schema.opt[j - n]
        if not (stage != "f32" and dt == torch.float32 and len(shape) >= 1
                and int(np.prod(shape)) >= 4096):
            ops.append(("raw", (put(x, lp),), lp.device))
        elif stage == "bf16":
            y = None if x is None else x.to(torch.bfloat16)
            ops.append(("bf16", (put(y, dataclasses.replace(
                lp, dtype=torch.bfloat16)),), lp.device))
        else:
            q = sc = None
            if x is not None:
                pinf = shd.info(ps[i])
                inf = (shd.ShardInfo(shape, spec, pinf.mesh)
                       if pinf is not None else None)
                q, sc = _row_absmax_int8(x, inf)
            jq = put(q, dataclasses.replace(lp, dtype=torch.int8))
            sfull = shd.full_spec(lp.src_spec, len(shape))
            dfull = shd.full_spec(lp.dst_spec, len(shape))
            js = put(sc, shd.LeafPlan(shape[:-1], torch.float32,
                                      sfull[:-1], dfull[:-1], cpu))
            ops.append(("int8", (jq, js), lp.device))
    if state is not None:
        idx = [k for k, t in enumerate(moved) if t is not None]
        for k, h in zip(idx, shd.to_host([moved[k] for k in idx])):
            moved[k] = h
    got = shd.redistribute(moved, plans, (schema.plan, schema.ranks),
                           (plan, mesh.world_ranks()), me)
    if not mesh.member:
        return None
    slots = [k for _, ks, _ in ops for k in ks]
    targets = [t for _, ks, t in ops for _ in ks]
    placed = dict(zip(slots, shd.stream_reshard([got[k] for k in slots],
                                                targets)))
    out = []
    for kind, ks, target in ops:
        if kind == "raw":
            out.append(placed[ks[0]])
        elif kind == "bf16":
            out.append(placed[ks[0]].to(torch.float32))
        else:
            out.append(quant.dequantize_to(placed[ks[0]], placed[ks[1]],
                                           target))
    return tr.assemble_state(schema, out, mesh, dst_specs)


def state_nbytes(state) -> int:
    """Bytes of a TrainState (params, moments and step tensors), of an
    optimizer (its moments and step tensors) or of a tree of tensors."""
    if isinstance(state, TrainState):
        return (state_nbytes(state.params)
                + sum(t.nbytes for _, _, t, _ in optimizer_tensors(state)))
    if isinstance(state, torch.optim.Optimizer):
        return sum(t.nbytes for st in state.state.values()
                   for t in st.values() if isinstance(t, torch.Tensor))
    return sum(t.nbytes for t in leaves(state))


STAGE_MOMENT_FACTOR = {"f32": 1.0, "bf16": 0.5, "int8": 0.26}


def host_fallback_stall_model(
    state_bytes: int,
    hosts_after: int,
    host_bw_bytes_s: float,
    moment_bytes: int = 0,
    stage: str = "f32",
) -> float:
    """Worst-case host-staged reshard stall, in seconds: each surviving
    host ingests its share of the full post-reshard state through its
    own host-device link, and with the overlapped pipeline the stall is
    ~one direction's bytes over the link bandwidth. Compressed moments
    cost ``moment_bytes`` x :data:`STAGE_MOMENT_FACTOR` on the wire
    (int8: 1/4 payload + ~1/D scales); params always move at full
    fidelity. ``host_bw_bytes_s`` is the RAW link bandwidth, derived
    from an uncompressed (f32) staging measurement."""
    if hosts_after <= 0 or host_bw_bytes_s <= 0:
        raise ValueError("hosts_after and host_bw_bytes_s must be positive")
    if stage not in STAGE_MOMENT_FACTOR:
        raise ValueError(f"unknown reshard staging mode {stage!r}")
    if not 0 <= moment_bytes <= state_bytes:
        raise ValueError(
            f"moment_bytes {moment_bytes} outside [0, {state_bytes}]"
        )
    factor = STAGE_MOMENT_FACTOR[stage]
    wire = (state_bytes - moment_bytes) + moment_bytes * factor
    return (wire / hosts_after) / host_bw_bytes_s


def p2p_migrate_stall_model(
    state_bytes: int, hosts_after: int, link_bw_bytes_s: float
) -> float:
    """Worst-case stall of a disjoint-set migration over a peer-to-peer
    shard plane: each of the ``hosts_after`` new hosts ingests its 1/H
    share of the full state concurrently over its own network link."""
    if hosts_after <= 0 or link_bw_bytes_s <= 0:
        raise ValueError("hosts_after and link_bw_bytes_s must be positive")
    return (state_bytes / hosts_after) / link_bw_bytes_s


# -- disk format -------------------------------------------------------------


def _leaf_keys(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """[(key, leaf)] in :func:`leaves` order with the reference's keys:
    dict keys and list positions joined by '/' (``mlp/0/w``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [kv for k, v in items
            for kv in _leaf_keys(v, f"{prefix}/{k}" if prefix else str(k))]


def _on_host(state: TrainState) -> bool:
    return all(not p.is_cuda for p in leaves(state.params))


def save(path: str, state: TrainState,
         metadata: Optional[Dict[str, Any]] = None) -> None:
    """Atomic npz checkpoint: params + optimizer tensors + step +
    metadata in ONE file, published by a single rename (no torn
    meta/state pair). A device state is snapshotted first."""
    # chaos site: the dense save IS its own commit (single rename)
    faults.fault_point("ckpt.commit")
    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    host = state if _on_host(state) else snapshot(state)
    keys = _leaf_keys(host.params)
    payload = {
        "step": np.asarray(host.step),
        "meta": np.frombuffer(json.dumps(metadata or {}).encode(),
                              dtype=np.uint8),
    }
    payload.update({f"p:{k}": v.detach().numpy() for k, v in keys})
    payload.update({f"o:{keys[i][0]}/{name}": t.numpy()
                    for i, name, t, _ in optimizer_tensors(host)})
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, os.path.join(path, "state.npz"))
    _obs_io(
        "write", "dense", time.perf_counter() - t0,
        sum(int(v.nbytes) for v in payload.values()),
    )
    # the dense save is the commit (single rename): one timeline entry
    _emit_ckpt("ckpt.commit", int(host.step), fmt="dense")


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(path, "state.npz")) as z:
        return {k: z[k] for k in z.files}


def _fill_params(data: Dict[str, np.ndarray], like) -> List[torch.Tensor]:
    out = []
    for key, leaf in _leaf_keys(like):
        stored = data[f"p:{key}"]
        if stored.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: "
                             f"{stored.shape} vs {tuple(leaf.shape)}")
        out.append(torch.from_numpy(stored))
    return out


def load_params(path: str, like) -> Any:
    """The params of a checkpoint (the port's or the reference's: the
    ``p:`` keys are shared) as CPU tensors in the structure of the param
    tree ``like``."""
    return replace_leaves(like, _fill_params(_read(path), like))


def load(path: str, like: TrainState) -> TrainState:
    """Load a checkpoint :func:`save` wrote into the structure of
    ``like`` (a template state, e.g. freshly created): a host state
    whose optimizer, of ``like``'s class and hyperparameters, holds the
    stored moments and steps. Place it with :func:`restore`."""
    t0 = time.perf_counter()
    data = _read(path)
    _obs_io(
        "read", "dense", time.perf_counter() - t0,
        sum(int(v.nbytes) for v in data.values()),
    )
    _emit_ckpt("ckpt.load", int(data["step"]), fmt="dense")
    params = _fill_params(data, like.params)
    index = {key: i for i, (key, _) in enumerate(_leaf_keys(like.params))}
    tensors = {}
    for k, v in data.items():
        if k.startswith("o:"):
            key, name = k[2:].rsplit("/", 1)
            if key not in index:
                raise ValueError(f"checkpoint moment {k} has no param")
            tensors[(index[key], name)] = torch.from_numpy(v)
    state = TrainState(step=int(data["step"]), params=like.params,
                       opt_state=like.opt_state)
    return rebind_state(state, params, tensors)


def load_metadata(path: str) -> Dict[str, Any]:
    with np.load(os.path.join(path, "state.npz")) as z:
        if "meta" in z.files:
            return json.loads(bytes(z["meta"]).decode())
    return {}


# -- the multi-process sharded format (dp: whole-leaf pieces) ---------------
#
# npz entry key: "<p|o>:<leaf path>@<comma-joined offsets>@<comma-joined
# extent>" — the piece's position and extent in the global array, the
# reference's format byte for byte. The manifest carries global
# shapes/dtypes, the step, metadata and the exact file list; a loader
# trusts only manifest-listed files. ``p:`` keys are the reference's;
# ``o:`` keys are the port's optimizer layout, as in the dense format.


@dataclass
class LocalSnapshot:
    """One process's addressable fraction of a TrainState, on host.

    ``pieces[key]`` maps a flattened leaf key to ``[(offset, array)]``;
    ``primary[key]`` lists the offsets this process writes to disk —
    across all processes the primary pieces tile every leaf exactly
    once. Under dp every process holds every leaf whole, and replica 0
    of every leaf lives on rank 0 (:func:`snapshot_local`)."""

    step: int
    pieces: Dict[str, List[Tuple[Tuple[int, ...], np.ndarray]]]
    primary: Dict[str, List[Tuple[int, ...]]]
    shapes: Dict[str, Tuple[int, ...]]
    dtypes: Dict[str, str]
    # the reference's plain-host leaves (claimed by every process, so
    # only the writer leader puts them on disk); the port has none
    host_only: Dict[str, bool] = field(default_factory=dict)

    def is_complete(self) -> bool:
        """True when this process alone holds every byte of the state
        (dp-replicated or single-process) — the condition for a solo
        crash-checkpoint write."""
        for key, shape in self.shapes.items():
            total = int(np.prod(shape)) if shape else 1
            have = sum(int(np.prod(p.shape)) if p.shape else 1
                       for _, p in self.pieces.get(key, []))
            if have < total:
                return False
        return True


def _state_leaf_items(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """Flattened (key, tensor) pairs with the ``p:``/``o:`` prefixes of
    the dense format."""
    keys = _leaf_keys(state.params)
    items = [(f"p:{k}", v.detach()) for k, v in keys]
    items += [(f"o:{keys[i][0]}/{name}", t)
              for i, name, t, _ in optimizer_tensors(state)]
    return items


def host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host numpy array, dtype name) of a CPU tensor: a bfloat16
    tensor becomes its uint16 view named ``"bfloat16"``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf named ``name`` is held in on the host."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor of a host array whose leaf dtype is ``name`` (a
    copy: the array may be a read-only npz member or a peer's buffer)."""
    t = torch.from_numpy(np.array(arr, storage_dtype(name)))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _leaf_layouts(state: TrainState) -> List[Optional[shd.ShardInfo]]:
    """The ``ShardInfo`` of each item of :func:`_state_leaf_items` (None
    for a whole leaf): a moment's from its param's
    (``trainer.moment_spec``)."""
    from edl_tpu_torch.train.trainer import moment_spec

    ps = leaves(state.params)
    out = [shd.info(p) for p in ps]
    for i, name, t, _ in optimizer_tensors(state):
        inf = out[i]
        if inf is None:
            out.append(None)
            continue
        shape, spec = moment_spec(name, t.shape, inf.shape, ps[i].shape,
                                  inf.spec)
        out.append(shd.ShardInfo(shape, spec, inf.mesh))
    return out


def _replica0(inf: shd.ShardInfo) -> bool:
    """Whether this process holds replica 0 of its slice: its coordinate
    is 0 on every axis that does not split the leaf."""
    split = set(inf.axes())
    c = inf.mesh.coords()
    return all(c[a] == 0 for a, n in inf.mesh.layout.axes
               if n > 1 and a not in split)


def snapshot_local(state: TrainState, rank: int = 0) -> LocalSnapshot:
    """Device → host of this process's state (one
    :func:`~sharding.to_host` pipeline). A whole state (dp: every leaf
    whole on every process) is one piece a leaf at offset 0, primary on
    ``rank`` 0. A state placed on a mesh is this process's slices at
    their offsets in the whole leaves, each primary where this process
    holds replica 0 of it (its coordinate 0 on every axis that does not
    split the leaf), so the primary pieces of all ranks tile every leaf
    once."""
    items = _state_leaf_items(state)
    layouts = _leaf_layouts(state)
    host = shd.to_host([t for _, t in items])
    pieces, primary, shapes, dtypes = {}, {}, {}, {}
    for (key, _), h, inf in zip(items, host, layouts):
        arr, name = host_array(h)
        if inf is None:
            off = tuple(0 for _ in arr.shape)
            prim = rank == 0
            shapes[key] = tuple(arr.shape)
        else:
            off = inf.box()[0]
            prim = _replica0(inf)
            shapes[key] = tuple(inf.shape)
        pieces[key] = [(off, arr)]
        primary[key] = [off] if prim else []
        dtypes[key] = name
    return LocalSnapshot(step=int(state.step), pieces=pieces,
                         primary=primary, shapes=shapes, dtypes=dtypes)


def _piece_key(key: str, off: Tuple[int, ...], shape: Tuple[int, ...]) -> str:
    """Entry name carries position AND extent, so a loader tests overlap
    without touching the bytes."""
    return f"{key}@{','.join(map(str, off))}@{','.join(map(str, shape))}"


def _parse_piece_key(k: str) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    key, _, shape_s = k.rpartition("@")
    key, _, off_s = key.rpartition("@")
    off = tuple(int(x) for x in off_s.split(",")) if off_s else ()
    shape = tuple(int(x) for x in shape_s.split(",")) if shape_s else ()
    return key, off, shape


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step-{step:08d}")


def shard_filename(rank: int, world: int) -> str:
    return f"shards-r{rank:04d}-of-{world:04d}.npz"


def save_shards(
    root: str,
    snap: LocalSnapshot,
    rank: int,
    world: int,
    host_leaves: bool = False,
    all_pieces: bool = False,
) -> str:
    """Write this process's primary pieces into the step directory
    (atomic tmp+rename); a rank that owns none writes an empty file, as
    the reference's do. ``host_leaves`` includes the host-only leaves
    (the writer leader); ``all_pieces`` writes every local piece — the
    solo crash write of a survivor whose snapshot is complete. Returns
    the shard filename (for the leader's manifest)."""
    faults.fault_point("ckpt.save")
    t0 = time.perf_counter()
    d = step_dir(root, snap.step)
    os.makedirs(d, exist_ok=True)
    payload: Dict[str, np.ndarray] = {}
    for key, plist in snap.pieces.items():
        if all_pieces:
            chosen = plist
        else:
            if snap.host_only.get(key) and not host_leaves:
                continue
            prim = set(snap.primary.get(key, ()))
            chosen = [(o, a) for o, a in plist if o in prim]
        for off, arr in chosen:
            payload[_piece_key(key, off, tuple(arr.shape))] = arr
    fname = shard_filename(rank, world)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    with tracing.span("checkpoint.save_shards", step=snap.step, rank=rank):
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, os.path.join(d, fname))
    _obs_io("write", "shards", time.perf_counter() - t0,
            sum(int(a.nbytes) for a in payload.values()))
    _emit_ckpt("ckpt.save", snap.step, fmt="shards", rank=rank, world=world)
    return fname


def write_manifest(
    root: str,
    snap: LocalSnapshot,
    files: List[str],
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Commit the checkpoint: manifest.json names the step, the leaf
    schema and the exact shard files; written atomically and LAST — a
    step dir without a manifest is an aborted write, ignored by loaders
    and reaped by :func:`gc_step_dirs`."""
    faults.fault_point("ckpt.commit")
    d = step_dir(root, snap.step)
    doc = {
        "step": snap.step,
        "files": sorted(set(files)),
        "shapes": {k: list(v) for k, v in snap.shapes.items()},
        "dtypes": snap.dtypes,
        "meta": metadata or {},
    }
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    os.close(fd)
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, os.path.join(d, "manifest.json"))
    _emit_ckpt("ckpt.commit", snap.step, fmt="shards", files=len(doc["files"]))


def latest_manifest(root: str) -> Optional[Dict[str, Any]]:
    """Newest committed checkpoint's manifest (with its directory under
    key ``_dir``), or None."""
    if not os.path.isdir(root):
        return None
    for name in sorted(os.listdir(root), reverse=True):
        if not name.startswith("step-"):
            continue
        mpath = os.path.join(root, name, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                best = json.load(f)
            best["_dir"] = os.path.join(root, name)
            return best
    return None


def gc_step_dirs(root: str, keep: int = 2) -> None:
    """Drop all but the newest ``keep`` committed checkpoints, plus any
    aborted (manifest-less) dirs older than the newest committed one."""
    if not os.path.isdir(root):
        return
    dirs = sorted(d for d in os.listdir(root) if d.startswith("step-"))
    committed = [d for d in dirs
                 if os.path.exists(os.path.join(root, d, "manifest.json"))]
    victims = set(committed[:-keep] if keep else committed)
    if committed:
        newest = committed[-1]
        victims |= {d for d in dirs if d < newest and d not in committed}
    for d in victims:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


class _PieceIndex:
    """Piece lookup across a RAM snapshot, the manifest-listed shard
    files and remote peers (``shard_server.RemotePieces``). Entry keys
    carry (offset, shape), so overlap is decided without I/O; disk
    pieces load lazily (npz members decompress on access) and remote
    ones are fetched lazily or by :meth:`prefetch`. Priority at equal
    geometry: disk < remote peer < local RAM (the same bytes
    everywhere; the cheaper source wins). With ``shapes`` (the expected
    leaf shapes), an entry whose rank differs from its leaf's — a stale
    or version-skewed peer — is dropped here."""

    def __init__(self, manifest: Optional[Dict[str, Any]],
                 ram: Optional[LocalSnapshot], remotes: Sequence[Any] = (),
                 shapes: Optional[Dict[str, Tuple[int, ...]]] = None):
        ranks = ({k: len(tuple(v)) for k, v in shapes.items()}
                 if shapes is not None else None)

        def ok(key: str, off, shape) -> bool:
            return (ranks is None or key not in ranks
                    or (len(off) == ranks[key] and len(shape) == ranks[key]))

        # {leaf key: {(offset, shape): source}}: a host array or an
        # (indexable, entry) handle — an NpzFile or a RemotePieces
        self._index: Dict[str, Dict[Tuple[Tuple[int, ...], Tuple[int, ...]],
                                    Any]] = {}
        self._files: List[Any] = []
        # pieces assembled, by the kind of source they came from
        self.reads = {"ram": 0, "peer": 0, "disk": 0}
        if manifest is not None:
            for fname in manifest["files"]:
                z = np.load(os.path.join(manifest["_dir"], fname),
                            allow_pickle=False)
                self._files.append(z)
                for entry in z.files:
                    key, off, shape = _parse_piece_key(entry)
                    if ok(key, off, shape):
                        self._index.setdefault(key, {})[(off, shape)] = (
                            z, entry)
        for src in remotes:
            for entry in src.entries():
                key, off, shape = _parse_piece_key(entry)
                if ok(key, off, shape):
                    self._index.setdefault(key, {})[(off, shape)] = (src,
                                                                     entry)
        if ram is not None:
            for key, plist in ram.pieces.items():
                for off, arr in plist:
                    self._index.setdefault(key, {})[
                        (off, tuple(arr.shape))] = arr

    def close(self) -> None:
        for z in self._files:
            z.close()

    def _read(self, src) -> np.ndarray:
        if isinstance(src, np.ndarray):
            self.reads["ram"] += 1
            return src
        self.reads["disk" if isinstance(src[0], np.lib.npyio.NpzFile)
                   else "peer"] += 1
        return src[0][src[1]]

    def prefetch(self, wants: Sequence[Tuple[str, Tuple[int, ...],
                                             Tuple[int, ...]]]) -> None:
        """Fetch every remote piece that overlaps the wanted boxes
        (``(leaf key, starts, stops)``) before assembly: grouped by
        peer, each peer drained through its pooled ``get_many``, the
        peers concurrently. A failure here only logs: the piece is
        fetched again by :meth:`assemble`, whose coverage check raises."""
        by_src: Dict[int, Tuple[Any, set]] = {}
        for key, starts, stops in wants:
            for (off, pshape), src in self._index.get(key, {}).items():
                if not isinstance(src, tuple) or not hasattr(src[0],
                                                             "get_many"):
                    continue
                if pshape and starts and any(
                        max(b, o) >= min(e, o + s) for b, e, o, s in
                        zip(starts, stops, off, pshape)):
                    continue
                by_src.setdefault(id(src[0]), (src[0], set()))[1].add(src[1])
        if not by_src:
            return
        errs: List[BaseException] = []

        def drain(holder, entries) -> None:
            try:
                holder.get_many(sorted(entries))
            except BaseException as e:  # noqa: BLE001 - surfaced at assembly
                errs.append(e)

        threads = [threading.Thread(target=drain, args=(h, es), daemon=True)
                   for h, es in by_src.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            kv_logger("checkpoint").warn("p2p prefetch incomplete",
                                         err=str(errs[0]))

    def assemble(self, key: str, idx: Tuple, shape: Tuple[int, ...],
                 dtype) -> np.ndarray:
        """The slice ``idx`` of leaf ``key`` from its stored pieces.
        Coverage is proved geometrically (:func:`_boxes_tile`), so
        overlapping pieces are handled and a hole raises."""
        starts = [(s.start or 0) if isinstance(s, slice) else 0 for s in idx]
        stops = [(s.stop if s.stop is not None else shape[i])
                 if isinstance(s, slice) else shape[i]
                 for i, s in enumerate(idx)]
        out_shape = tuple(e - b for b, e in zip(starts, stops))
        pieces = self._index.get(key, {})
        whole = pieces.get((tuple(0 for _ in shape), tuple(shape)))
        if whole is not None and out_shape == tuple(shape):
            # a dp piece: the whole leaf, no copy into a new buffer
            return np.asarray(self._read(whole), dtype).reshape(shape)
        out = np.empty(out_shape, dtype)
        boxes: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        for (off, pshape), src in pieces.items():
            if not shape:  # scalar leaf
                out[...] = self._read(src)
                boxes.append(((), ()))
                break
            lo = [max(b, o) for b, o in zip(starts, off)]
            hi = [min(e, o + s) for e, o, s in zip(stops, off, pshape)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            arr = self._read(src)
            out[tuple(slice(a - b, h - b) for a, b, h in zip(lo, starts, hi))] = \
                arr[tuple(slice(a - o, h - o) for a, o, h in zip(lo, off, hi))]
            boxes.append((tuple(a - b for a, b in zip(lo, starts)),
                          tuple(h - a for a, h in zip(lo, hi))))
        if not _boxes_tile(out_shape, boxes):
            raise ValueError(
                f"checkpoint piece coverage incomplete for {key}{idx}: "
                f"{len(boxes)} pieces leave a hole in {out_shape}")
        return out


def _whole(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, s) for s in shape)


def _leaf_from_index(index: _PieceIndex, fq: str, shape,
                     name: str, box=None) -> torch.Tensor:
    """Leaf ``fq`` whole, or its ``box`` ((offset, extent))."""
    shape = tuple(shape)
    idx = _whole(shape) if box is None else tuple(
        slice(o, o + e) for o, e in zip(*box))
    return to_tensor(index.assemble(fq, idx, shape, storage_dtype(name)),
                     name)


def _params_from_index(index: _PieceIndex, shapes, dtypes,
                       dev: torch.device) -> Any:
    """The param tree (``p:`` leaves in the writer's order) on ``dev``."""
    # the export format's tree rule (lists from dense integer keys)
    from edl_tpu_torch.runtime.export import _restore_lists, _tree_insert

    params: Dict[str, Any] = {}
    for fq, shape in shapes.items():
        if fq.startswith("p:"):
            _tree_insert(params, fq[2:].split("/"),
                         _leaf_from_index(index, fq, shape,
                                          dtypes[fq]).to(dev))
    return _restore_lists(params)


def _mesh_state_from_index(index: _PieceIndex, step: int, shapes, dtypes,
                           tx, mesh, param_pspecs) -> Optional[TrainState]:
    """This member's slices of a stored state on ``mesh`` (None outside
    it): params by ``param_pspecs`` (default ``sharding.param_pspecs``
    of the whole shapes), each moment by its param's layout
    (``trainer.moment_spec``). Only this member's boxes are read."""
    from edl_tpu_torch.runtime.export import _restore_lists, _tree_insert
    from edl_tpu_torch.train import trainer as tr

    if not mesh.member:
        return None
    plan = mesh.layout
    pkeys = [fq for fq in shapes if fq.startswith("p:")]
    meta: Dict[str, Any] = {}
    for fq in pkeys:
        _tree_insert(meta, fq[2:].split("/"), torch.empty(
            tuple(shapes[fq]), device="meta"))
    meta = _restore_lists(meta)
    spec_of = dict(shd.spec_items(param_pspecs if param_pspecs is not None
                                  else shd.param_pspecs(meta, plan)))
    order = [k for k, _ in _leaf_keys(meta)]
    coords = plan.coords(mesh.rank)

    def box(fq, spec):
        return shd.local_box(tuple(shapes[fq]), spec, plan, coords)

    wants = []
    pspec = {f"p:{k}": spec_of[k] for k in order}
    mspec = {}
    for fq in shapes:
        if fq.startswith("o:"):
            key, name = fq[2:].rsplit("/", 1)
            mspec[fq] = tr._moment_dst_spec(name, tuple(shapes[fq]),
                                            tuple(shapes[f"p:{key}"]),
                                            spec_of[key])
    for fq, sp in list(pspec.items()) + list(mspec.items()):
        off, ext = box(fq, sp)
        wants.append((fq, off, tuple(o + e for o, e in zip(off, ext))))
    index.prefetch(wants)
    params: Dict[str, Any] = {}
    for k in order:
        fq = f"p:{k}"
        t = _leaf_from_index(index, fq, shapes[fq], dtypes[fq],
                             box(fq, pspec[fq])).to(mesh.device)
        shd.attach(t, shd.ShardInfo(tuple(shapes[fq]), tuple(pspec[fq]),
                                    mesh))
        _tree_insert(params, k.split("/"), t)
    params = _restore_lists(params)
    state = TrainState.create(params, tx)
    index_of = {k: i for i, (k, _) in enumerate(_leaf_keys(state.params))}
    tensors = {}
    for fq, sp in mspec.items():
        key, name = fq[2:].rsplit("/", 1)
        t = _leaf_from_index(index, fq, shapes[fq], dtypes[fq], box(fq, sp))
        tensors[(index_of[key], name)] = t if name == "step" else \
            t.to(mesh.device)
    state = rebind_state(state, leaves(state.params), tensors)
    state.step = int(step)
    return state


def _state_from_index(index: _PieceIndex, step: int, shapes, dtypes, tx,
                      dev: torch.device) -> TrainState:
    """A TrainState of ``tx``'s optimizer from stored ``p:`` and ``o:``
    leaves; the optimizer's ``step`` counts stay on the CPU, where
    torch keeps them. Remote pieces of every leaf are fetched first in
    one parallel pass."""
    index.prefetch([(fq, tuple(0 for _ in shape), tuple(shape))
                    for fq, shape in shapes.items()])
    params = _params_from_index(index, shapes, dtypes, dev)
    state = TrainState.create(params, tx)
    index_of = {k: i for i, (k, _) in enumerate(_leaf_keys(state.params))}
    tensors = {}
    for fq, shape in shapes.items():
        if not fq.startswith("o:"):
            continue
        key, name = fq[2:].rsplit("/", 1)
        if key not in index_of:
            raise ValueError(f"checkpoint moment {fq} has no param")
        t = _leaf_from_index(index, fq, shape, dtypes[fq])
        tensors[(index_of[key], name)] = t if name == "step" else t.to(dev)
    state = rebind_state(state, leaves(state.params), tensors)
    state.step = int(step)
    return state


def load_sharded(
    root: str,
    tx,
    ram: Optional[LocalSnapshot] = None,
    manifest: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    plan=None,
    mesh=None,
    param_pspecs=None,
) -> Optional[TrainState]:
    """Restore a TrainState of ``tx``'s optimizer (an
    :class:`~edl_tpu_torch.train.trainer.Optimizer`) on ``device`` (CUDA
    unless ``"cpu"`` is named) from the newest committed sharded
    checkpoint, or the one ``manifest`` pins, preferring RAM pieces when
    ``ram`` is at the manifest's step. The param tree follows the
    writer's leaf order. With a ``mesh`` that has fsdp or tp, each
    member reads only its slices (``param_pspecs``, default
    ``sharding.param_pspecs``) onto the mesh's device, whatever mesh
    wrote the pieces; a process outside the mesh gets None."""
    sharded = mesh is not None and any(
        n > 1 and a != "dp" for a, n in mesh.layout.axes)
    dev = mesh.device if sharded else resolve_device(device)
    if manifest is None:
        manifest = latest_manifest(root)
    if manifest is None:
        raise FileNotFoundError(f"no committed sharded checkpoint under {root}")
    if ram is not None and ram.step != manifest["step"]:
        ram = None  # stale/ahead RAM: the disk manifest is the agreed truth
    index = _PieceIndex(manifest, ram, shapes=manifest["shapes"])
    t0 = time.perf_counter()
    try:
        with tracing.span("checkpoint.load_sharded", step=manifest["step"]):
            if sharded:
                return _mesh_state_from_index(
                    index, int(manifest["step"]), manifest["shapes"],
                    manifest["dtypes"], tx, mesh, param_pspecs)
            return _state_from_index(index, int(manifest["step"]),
                                     manifest["shapes"], manifest["dtypes"],
                                     tx, dev)
    finally:
        index.close()
        _obs_io("read", "shards", time.perf_counter() - t0, 0)
        _emit_ckpt("ckpt.load", int(manifest["step"]), fmt="shards")


def load_sharded_params(root: str, manifest: Optional[Dict[str, Any]] = None,
                        device: DeviceLike = None) -> Any:
    """The ``p:`` leaves of a sharded checkpoint (the port's or the
    reference's: the keys are shared) as a param tree on ``device``."""
    dev = resolve_device(device)
    manifest = manifest or latest_manifest(root)
    if manifest is None:
        raise FileNotFoundError(f"no committed sharded checkpoint under {root}")
    index = _PieceIndex(manifest, None)
    try:
        return _params_from_index(index, manifest["shapes"],
                                  manifest["dtypes"], dev)
    finally:
        index.close()


def template_state(params, tx) -> TrainState:
    """A structure template of ``TrainState.create(params, tx)`` after
    its first step, on the meta device (no memory): params and the
    optimizer's state with their shapes and dtypes — the port's
    ``jax.eval_shape`` of a state, since a torch optimizer makes its
    moments at its first step."""
    meta = replace_leaves(params, [
        torch.empty_like(p, device="meta") for p in leaves(params)])
    like = TrainState.create(meta, tx)
    for p in leaves(like.params):
        if p.requires_grad:
            p.grad = torch.zeros_like(p)
    like.opt_state.step()
    return like


def template_schema(like: TrainState) -> Tuple[Dict[str, Tuple[int, ...]],
                                               Dict[str, str]]:
    """(shapes, dtypes) keyed like the sharded format, from a structure
    template (:func:`template_state`): what a peer-only restore uses in
    place of a manifest."""
    from edl_tpu_torch.models.meta import dtype_name

    shapes, dtypes = {}, {}
    for key, leaf in _state_leaf_items(like):
        shapes[key] = tuple(leaf.shape)
        dtypes[key] = dtype_name(leaf.dtype)
    return shapes, dtypes


def _boxes_tile(shape: Tuple[int, ...],
                boxes: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]]
                ) -> bool:
    """Whether the boxes ``(offset, extent)`` cover every element of
    ``shape`` — a geometric union (coordinate-compressed grid), not an
    element count, so overlapping pieces cannot hide a hole."""
    if not shape:
        return bool(boxes)
    if any(s == 0 for s in shape):
        return True
    cuts: List[List[int]] = []
    for d, size in enumerate(shape):
        c = {0, size}
        for off, ext in boxes:
            c.add(min(max(off[d], 0), size))
            c.add(min(max(off[d] + ext[d], 0), size))
        cuts.append(sorted(c))
    grid_shape = tuple(len(c) - 1 for c in cuts)
    if int(np.prod(grid_shape)) > (1 << 24):
        return False  # pathological offsets: the conservative answer
    grid = np.zeros(grid_shape, dtype=bool)
    for off, ext in boxes:
        grid[tuple(slice(
            int(np.searchsorted(cuts[d], min(max(off[d], 0), size))),
            int(np.searchsorted(cuts[d], min(max(off[d] + ext[d], 0), size))))
            for d, size in enumerate(shape))] = True
    return bool(grid.all())


def peer_coverage_ok(like: TrainState, piece_entries: Sequence[str]) -> bool:
    """Whether piece entry keys (peers' shard-server indexes) tile every
    leaf of ``like`` — pure key geometry, no bytes moved: the go/no-go
    of a peer restore. Entries of another rank than their leaf's do not
    count."""
    shapes, _ = template_schema(like)
    boxes: Dict[str, set] = {}
    for entry in piece_entries:
        key, off, shape = _parse_piece_key(entry)
        boxes.setdefault(key, set()).add((off, shape))
    for key, shape in shapes.items():
        usable = [(o, e) for o, e in boxes.get(key, ())
                  if len(o) == len(shape) and len(e) == len(shape)]
        if not _boxes_tile(tuple(shape), usable):
            return False
    return True


def load_from_pieces(step: int, like: TrainState, tx,
                     ram: Optional[LocalSnapshot] = None,
                     manifest: Optional[Dict[str, Any]] = None,
                     remotes: Sequence[Any] = (),
                     device: DeviceLike = None) -> TrainState:
    """A TrainState of ``tx``'s optimizer at ``step`` on ``device`` from
    any mix of sources: the local RAM snapshot, a committed manifest AT
    THE SAME STEP, and remote peers (``shard_server.RemotePieces``) —
    the peer-to-peer migration restore. The schema is the template's,
    so a pure-peer restore needs no disk artifact. A vanished peer
    surfaces as a coverage error, never a silent hole. Where RAM and the
    peers tile the state by themselves, no shard file is opened: disk
    pieces rank below theirs at equal geometry. Logs ``pieces read``
    with the pieces taken from each kind of source."""
    if ram is not None and ram.step != step:
        ram = None
    if manifest is not None and manifest["step"] != step:
        manifest = None
    if manifest is not None:
        held = [e for src in remotes for e in src.entries()]
        if ram is not None:
            held += [_piece_key(k, o, tuple(a.shape))
                     for k, plist in ram.pieces.items() for o, a in plist]
        if peer_coverage_ok(like, held):
            manifest = None
    shapes, dtypes = template_schema(like)
    index = _PieceIndex(manifest, ram, remotes=remotes, shapes=shapes)
    try:
        with tracing.span("checkpoint.load_from_pieces", step=step,
                          peers=len(remotes)):
            return _state_from_index(index, step, shapes, dtypes, tx,
                                     resolve_device(device))
    finally:
        kv_logger("checkpoint").info("pieces read", step=step,
                                     disk_files=len(index._files),
                                     **index.reads)
        index.close()


def restore_local(tx, ram: LocalSnapshot,
                  device: DeviceLike = None) -> TrainState:
    """RAM-only restore for a state this process holds completely (dp)
    when no checkpoint dir is configured — the in-RAM reshard path with
    no disk in the loop."""
    if not ram.is_complete():
        raise ValueError(
            "RAM snapshot does not cover the full state; a shared "
            "checkpoint dir is required to reshard this mesh")
    return _state_from_index(_PieceIndex(None, ram), ram.step, ram.shapes,
                             ram.dtypes, tx, resolve_device(device))
