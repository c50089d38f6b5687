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

Not ported yet: the multi-process sharded format (``snapshot_local``,
``save_shards``, ``write_manifest``, ``load_sharded``; ROADMAP Queue A
item 2b).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.ops import quant
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.train.trainer import (TrainState, leaves,
                                         optimizer_tensors, rebind_state,
                                         replace_leaves, shard_state)
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)
from edl_tpu_torch.utils import faults
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
    result's optimizer is bound to the host params."""
    params = leaves(state.params)
    ot = optimizer_tensors(state)
    host = shd.to_host(params + [t for _, _, t, _ in ot])
    moved = {(i, name): h for (i, name, _, _), h in zip(ot, host[len(params):])}
    return rebind_state(state, host[:len(params)], moved)


def restore(host_state: TrainState, plan=None, mesh=None,
            device: DeviceLike = None) -> TrainState:
    """Host RAM → device (step three of the reshard protocol). A
    sharding ``plan``/``mesh`` raises."""
    return shard_state(host_state, plan, mesh, device)


def staged_reshard(state: TrainState, plan=None, mesh=None,
                   stage: Optional[str] = None,
                   device: DeviceLike = None) -> TrainState:
    """Device → host → device as ONE overlapped pipeline — the host
    fallback of the reshard protocol (``snapshot`` + ``restore`` would
    run the two directions back to back). Lands on ``device`` (CUDA
    unless ``"cpu"`` is named); a sharding ``plan``/``mesh`` raises.

    ``stage`` compresses the OPTIMIZER-MOMENT tensors (never params: the
    f32 masters move exactly) for the host round trip:

    - ``"int8"`` (default, env ``EDL_RESHARD_STAGE``): blockwise-absmax
      int8 along the last axis (``ops/quant.py``): Adam state bytes 3P
      → ~1.5P. Moments move by at most 1/254 of their row's absmax.
    - ``"bf16"``: a cast on the source device, 3P → 2P.
    - ``"f32"``: no compression (bit-identical staging).

    A moment is compressed when it is an f32 tensor of the optimizer's
    state with at least one dim and 4096 elements (the reference's
    ``_compressible``); the per-param ``step`` never is."""
    require_unsharded(plan, mesh, "staged_reshard")
    stage = stage or os.environ.get("EDL_RESHARD_STAGE", "int8")
    if stage not in ("int8", "bf16", "f32"):
        raise ValueError(f"unknown reshard staging mode {stage!r}")
    if stage != "f32":
        # lossy staging is the default for the stall win: say so on every
        # use, so operators know the moments were perturbed
        kv_logger("checkpoint").info(
            "staged reshard with lossy moment compression", stage=stage,
            override="EDL_RESHARD_STAGE=f32 for exact staging")
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
