"""Train-step factories — the port of ``edl_tpu/train/trainer.py``
(the one-card half).

The reference compiles the whole update into one XLA program; here a
step is eager PyTorch on one card: forward, ``backward()`` (the flash
kernels' backward sweeps run inside it) and the optimizer's update.
The optimizer is a ``torch.optim`` instance that owns its moments,
built by a factory named after its optax counterpart (:func:`adamw`,
:func:`adam`, :func:`adafactor`) with optax's defaults.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch.obs import compilewatch
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


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)``'s chain with optax's other defaults, step
    for step (optax 0.2.6, ``_src/factorized.py`` and ``_src/alias.py``),
    for one tensor at a time:

    1. ``scale_by_factored_rms``: with ``t`` the steps taken so far and
       ``β = 1 - (t + 1)^-0.8``, ``g² + 1e-30`` feeds the second-moment
       estimate. A tensor is factored over its TWO LARGEST dims
       ``(d1, d0)`` (``np.argsort`` of the shape, so a tie keeps the
       earlier axis first) when the second largest is at least 128:
       ``v_row`` (the mean over d0) and ``v_col`` (over d1) decay by β,
       and the update is ``g · (v_row / mean(v_row over d1))^-½ ·
       v_col^-½``. Otherwise ``v`` (full size) decays by β and the
       update is ``g · v^-½``.
    2. ``clip_by_block_rms(1.0)``: the update divided by
       ``max(1, rms(u))``, the RMS over the whole tensor.
    3. ``scale_by_learning_rate``: times ``lr``.
    4. ``scale_by_param_block_rms``: times ``max(rms(p), 1e-3)``, the
       RMS over the whole tensor.
    5. ``scale(-1)``, then added to the param.

    State per param, under optax's names: ``v_row`` and ``v_col`` for a
    factored tensor, ``v`` for the others (optax's 1-element
    placeholders for the unused ones are not kept), and ``step``, the
    count, a CPU tensor as torch's Adam keeps it. ``torch.optim.
    Adafactor`` is another algorithm (it factors the last two dims of
    every tensor of 2 or more dims, does not clip, and steps by
    ``min(lr, 1/sqrt(t))``)."""

    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    EPS = 1e-30

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @classmethod
    def factored_dims(cls, shape):
        """optax's ``_factored_dims`` at its defaults: ``(d1, d0)``, the
        second largest and the largest axis, or None when the tensor is
        not factored."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group["lr"])
        return loss

    def _update(self, p: torch.Tensor, lr: float) -> None:
        g = p.grad
        dims = self.factored_dims(tuple(p.shape))
        st = self.state[p]
        if not st:
            st["step"] = torch.tensor(0.0)
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                st["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                st["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        # optax computes the decay in f32
        i = np.float32(int(st["step"]) + 1)
        beta = float(np.float32(1.0) - i ** np.float32(-self.DECAY_RATE))
        keep = float(np.float32(1.0) - np.float32(beta))
        g2 = g * g + self.EPS
        if dims is None:
            v = st["v"].mul_(beta).add_(g2 * keep)
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row = st["v_row"].mul_(beta).add_(g2.mean(dim=d0) * keep)
            v_col = st["v_col"].mul_(beta).add_(g2.mean(dim=d1) * keep)
            r1 = d1 - 1 if d1 > d0 else d1
            row = (v_row / v_row.mean(dim=r1, keepdim=True)).pow(-0.5)
            u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        del g2
        u = u / torch.clamp(u.square().mean().sqrt(), min=1.0)
        u = lr * u * torch.clamp(p.square().mean().sqrt(), min=1e-3)
        p.add_(-1 * u)
        st["step"] += 1


# optax.adafactor's options and defaults; the port carries the defaults
# only (a non-default value raises)
_ADAFACTOR_DEFAULTS = dict(
    min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0,
    multiply_by_parameter_scale=True, clipping_threshold=1.0,
    momentum=None, weight_decay_rate=None, eps=1e-30, factored=True,
    weight_decay_mask=None)


def adafactor(learning_rate: Optional[float] = None,
              min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0,
              momentum: Optional[float] = None, dtype_momentum=None,
              weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
              factored: bool = True, weight_decay_mask=None) -> Optimizer:
    """``optax.adafactor`` with optax's signature, as :class:`Adafactor`:
    a constant learning rate and optax's defaults for everything else.
    Any other value (no learning rate, a schedule, momentum, weight
    decay, another factoring, decay, clip or eps) is not ported and
    raises ``NotImplementedError``; ``dtype_momentum`` shapes only a
    momentum and is ignored."""
    given = dict(
        min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
        decay_offset=decay_offset,
        multiply_by_parameter_scale=multiply_by_parameter_scale,
        clipping_threshold=clipping_threshold, momentum=momentum,
        weight_decay_rate=weight_decay_rate, eps=eps, factored=factored,
        weight_decay_mask=weight_decay_mask)
    del dtype_momentum  # shapes only a momentum
    if not isinstance(learning_rate, (int, float)):
        raise NotImplementedError(
            "adafactor without a constant learning rate is not ported")
    for name, val in given.items():
        if val != _ADAFACTOR_DEFAULTS[name]:
            raise NotImplementedError(
                f"adafactor {name}={val!r} is not ported (only "
                f"{_ADAFACTOR_DEFAULTS[name]!r})")
    return Optimizer(lambda ps: Adafactor(ps, lr=learning_rate))


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
        return loss.detach(), replace_leaves(
            params, [gs.get(id(p)) for p in leaves(params)])

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
    ``plan``/``mesh`` raises. The update is in place. The factory's first
    step lands in ``edl_compile_seconds{program="train.step"}`` (the
    compile watch: what a first call costs, where the reference times
    its jit)."""
    require_unsharded(plan, mesh, "make_train_step")
    update = compilewatch.wrap(_apply_update, "train.step")

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        t = time.perf_counter()
        state, loss = update(loss_fn, state, batch)
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
    :func:`make_train_step`. The factory's first call lands in
    ``edl_compile_seconds{program="train.multistep"}``."""
    require_unsharded(plan, mesh, "make_train_multistep")

    def run(state: TrainState, batches, k: int):
        losses = []
        for i in range(k):
            batch = {name: x[i] for name, x in batches.items()}
            state, loss = _apply_update(loss_fn, state, batch)
            losses.append(loss)
        return state, torch.stack(losses)

    run = compilewatch.wrap(run, "train.multistep")

    def multi(state: TrainState, batches) -> Tuple[TrainState, Dict]:
        t = time.perf_counter()
        k = leaves(batches)[0].shape[0]
        state, losses = run(state, batches, k)
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
