"""Train-step factories — the port of ``edl_tpu/train/trainer.py``
(the one-card half).

The reference compiles the whole update into one XLA program; here a
step is eager PyTorch on one card: forward, ``backward()`` (the flash
kernels' backward sweeps run inside it) and the optimizer's update.
The optimizer is a ``torch.optim`` instance that owns its moments,
built by a factory named after its optax counterpart (:func:`adamw`,
:func:`adam`) with optax's defaults.

As in the reference, ``step(state, batch) -> (state, metrics)``. The
update is in place: the returned state holds the same parameter
tensors and optimizer as the one passed in (the reference donates the
old state's buffers, so neither side may reuse an old state).

Placement on one device: :func:`shard_state` (a TrainState onto the
card, or the host snapshot back onto it), :func:`global_batch` and
:func:`stack_batches` (host batches onto the card); a placed state's
optimizer is a new instance of the same class and hyperparameters,
bound to the placed params (:func:`rebind_state`). Not ported yet
(ROADMAP Queue A item 2b): ``state_pspecs`` and ``LocalSyncStepper``;
a ``plan``/``mesh`` that shards anything raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)
from edl_tpu_torch.utils.tree import leaves, replace_leaves


def _record_dispatch(dt_s: float, n_steps: int = 1) -> None:
    """Step-factory telemetry: counts optimizer steps and times the
    host side of a step call (eager PyTorch enqueues the kernels and
    returns; a long call means the host or a sync held the step up).
    Looked up per call so a test's registry swap takes effect."""
    r = obs_metrics.default_registry()
    r.histogram(
        "edl_train_dispatch_seconds",
        "train-step program dispatch (enqueue) time",
    ).observe(dt_s)
    r.counter("edl_train_steps_total", "optimizer steps completed").inc(n_steps)


def trainable(params):
    """Mark every floating leaf of ``params`` as requiring grad (in
    place); returns ``params``."""
    for p in leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


@dataclass(frozen=True)
class Optimizer:
    """An optimizer factory named after its optax counterpart:
    ``init(params)`` builds the ``torch.optim`` instance over the
    floating leaves of a param tree."""

    make: Callable[[List[torch.Tensor]], torch.optim.Optimizer]

    def init(self, params) -> torch.optim.Optimizer:
        return self.make([p for p in leaves(params) if p.is_floating_point()])


def _check_adam(b1, b2, eps, eps_root):
    if eps_root != 0.0:
        raise NotImplementedError(
            "eps_root != 0 is not ported (torch's Adam has no eps_root)")
    return (b1, b2), eps


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> Optimizer:
    """``optax.adamw`` with optax's defaults (weight_decay 1e-4, where
    torch's AdamW defaults to 1e-2): decoupled decay, ``p − lr·(m̂ /
    (√v̂ + eps) + wd·p)``, which is torch's AdamW update."""
    betas, eps = _check_adam(b1, b2, eps, eps_root)
    return Optimizer(lambda ps: torch.optim.AdamW(
        ps, lr=learning_rate, betas=betas, eps=eps,
        weight_decay=weight_decay))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Optimizer:
    """``optax.adam`` with optax's defaults."""
    betas, eps = _check_adam(b1, b2, eps, eps_root)
    return Optimizer(lambda ps: torch.optim.Adam(
        ps, lr=learning_rate, betas=betas, eps=eps))


@dataclass
class TrainState:
    """step count, params tree, and the optimizer (which owns the
    moments) — the reference's TrainState with ``opt_state`` as a
    ``torch.optim`` instance."""

    step: int
    params: Any
    opt_state: torch.optim.Optimizer

    @classmethod
    def create(cls, params, tx: Optimizer) -> "TrainState":
        return cls(step=0, params=trainable(params), opt_state=tx.init(params))


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor]):
    """``fn(params, batch) -> (loss, grads)``, grads a tree like params
    (None for leaves that do not require grad) — ``jax.value_and_grad``
    over the params argument. Leaves no ``.grad`` behind."""

    def fn(params, batch):
        loss = loss_fn(params, batch)
        ps = [p for p in leaves(params) if p.requires_grad]
        gs = dict(zip(map(id, ps), torch.autograd.grad(loss, ps)))

        def tree(node):
            if isinstance(node, dict):
                return {k: tree(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [tree(v) for v in node]
            return gs.get(id(node))

        return loss.detach(), tree(params)

    return fn


def _apply_update(loss_fn, state: TrainState, batch) -> Tuple[TrainState,
                                                              torch.Tensor]:
    """One optimizer update — the single source of the update rule,
    shared by the per-step and multi-step factories."""
    opt = state.opt_state
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, batch)
    loss.backward()
    opt.step()
    return (TrainState(step=state.step + 1, params=state.params,
                       opt_state=opt), loss.detach())


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    tx: Optimizer,
    plan=None,
    mesh=None,
):
    """Build ``step(state, batch) -> (state, {"loss"})``. The loss stays
    on the device (no host sync). ``tx`` built the state's optimizer
    (:meth:`TrainState.create`) and is not read again; a sharding
    ``plan``/``mesh`` raises. The update is in place."""
    require_unsharded(plan, mesh, "make_train_step")

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        t = time.perf_counter()
        state, loss = _apply_update(loss_fn, state, batch)
        _record_dispatch(time.perf_counter() - t)
        return state, {"loss": loss}

    return step


def make_train_multistep(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    tx: Optimizer,
    plan=None,
    mesh=None,
):
    """Build ``multi(state, batches) -> (state, metrics)`` running K
    steps over a leading steps axis of ``batches`` (every leaf
    [K, ...]) in one call. ``metrics["losses"]`` holds all K per-step
    losses, ``"loss"`` the last. Semantically K calls of
    :func:`make_train_step`."""
    require_unsharded(plan, mesh, "make_train_multistep")

    def multi(state: TrainState, batches) -> Tuple[TrainState, Dict]:
        t = time.perf_counter()
        k = leaves(batches)[0].shape[0]
        losses = []
        for i in range(k):
            batch = {name: x[i] for name, x in batches.items()}
            state, loss = _apply_update(loss_fn, state, batch)
            losses.append(loss)
        losses = torch.stack(losses)
        _record_dispatch(time.perf_counter() - t, n_steps=k)
        return state, {"loss": losses[-1], "losses": losses}

    return multi


# -- placement on one device ----------------------------------------------


def optimizer_tensors(state: TrainState) -> List[Tuple[int, str,
                                                       torch.Tensor, bool]]:
    """Every tensor the optimizer holds, as ``(param leaf index, state
    name, tensor, host)``: the moments (``exp_avg``, ``exp_avg_sq``, ...)
    and the per-param ``step``. The index is the param's position in
    :func:`leaves` of ``state.params``, found by identity. ``host`` marks
    a tensor torch keeps on the CPU whatever its param's device (the
    ``step`` of an optimizer that is neither capturable nor fused), so
    a placement leaves it there."""
    index = {id(p): i for i, p in enumerate(leaves(state.params))}
    out = []
    for group in state.opt_state.param_groups:
        on_dev = bool(group.get("capturable") or group.get("fused"))
        for p in group["params"]:
            for name, t in state.opt_state.state.get(p, {}).items():
                if isinstance(t, torch.Tensor):
                    out.append((index[id(p)], name, t,
                                name == "step" and not on_dev))
    return out


def rebind_state(state: TrainState, new_params: Sequence[torch.Tensor],
                 new_tensors: Dict[Tuple[int, str], torch.Tensor]
                 ) -> TrainState:
    """A TrainState over ``new_params`` (replacing :func:`leaves` of
    ``state.params`` in order; each keeps its ``requires_grad``) whose
    optimizer is a new instance of ``state.opt_state``'s class and
    hyperparameters, bound to the new params and holding
    ``new_tensors[(param leaf index, state name)]`` in place of each
    tensor :func:`optimizer_tensors` lists (and beside the entries of a
    fresh optimizer that holds none yet). The next step of the result
    is the step ``state`` would take."""
    old = leaves(state.params)
    for p, q in zip(old, new_params):
        q.requires_grad_(p.requires_grad)
    index = {id(p): i for i, p in enumerate(old)}
    opt = state.opt_state
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [new_params[index[id(p)]] for p in g["params"]]}
              for g in opt.param_groups]
    new_opt = type(opt)(groups, **opt.defaults)
    for p, st in opt.state.items():
        new_opt.state[new_params[index[id(p)]]] = dict(st)
    for (i, name), t in new_tensors.items():
        new_opt.state[new_params[i]][name] = t
    return TrainState(step=state.step,
                      params=replace_leaves(state.params, new_params),
                      opt_state=new_opt)


def shard_state(state: TrainState, plan=None, mesh=None,
                device: DeviceLike = None) -> TrainState:
    """Place a TrainState — a host snapshot, or a state on another
    device — on ``device`` (CUDA unless ``"cpu"`` is named): every param
    and moment is copied there, the host-kept ``step`` tensors are
    copied on the CPU, and the optimizer is rebound to the copies. A
    sharding ``plan``/``mesh`` raises."""
    require_unsharded(plan, mesh, "shard_state")
    dev = resolve_device(device)
    params = [p.detach().to(dev, copy=True) for p in leaves(state.params)]
    tensors = {(i, name): t.to("cpu" if host else dev, copy=True)
               for i, name, t, host in optimizer_tensors(state)}
    return rebind_state(state, params, tensors)


def global_batch(batch, plan=None, mesh=None, device: DeviceLike = None):
    """Place a host batch (a dict of arrays) on ``device``: on one
    device the batch axes split nothing. A sharding plan raises."""
    require_unsharded(plan, mesh, "global_batch")
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def stack_batches(batches, plan=None, mesh=None, device: DeviceLike = None):
    """Stack host batches along a new leading steps axis and place them
    on ``device`` for :func:`make_train_multistep`. A sharding plan
    raises."""
    require_unsharded(plan, mesh, "stack_batches")
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.stack([np.asarray(b[k]) for b in batches]),
                               device=dev)
            for k in batches[0]}
