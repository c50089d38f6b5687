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
bound to the placed params (:func:`rebind_state`).

Training over a mesh of processes (:class:`edl_tpu_torch.parallel.mesh.
Mesh`, one rank a process):

- dp alone: every process holds the whole state; :func:`make_train_step`
  all-reduces each step's gradients over the dp group, and
  :class:`LocalSyncStepper` takes K local steps between averages.
- fsdp and tp (with or without dp): every process holds the slices the
  reference's PartitionSpecs give its device (:func:`state_pspecs`,
  :func:`shard_state`; each placed leaf carries its
  ``parallel/sharding.ShardInfo``). A step's loss either takes the local
  slices itself (a loss made for the mesh, such as ``llama.
  make_loss_fn(cfg, plan, mesh)``, marked ``local_shards``) or gets the
  leaves gathered whole (``sharding.gather_tree``; the backward
  reduce-scatters over fsdp). Gradients are then summed over the batch
  axes that do not split the leaf, and the optimizer steps the local
  slices. Adafactor's factored moments and whole-tensor RMS reduce over
  every slice (:class:`Adafactor`), so the sharded step is the
  unsharded one.
- The loss is the global batch's: each batch shard weighs its share by
  its rows' weight over the global weight (Σ ``_w``, as the dp step's
  Σw·loss / Σw).
- sp and pp: a loss made for the mesh (``local_shards``) returns this
  rank's part: its sequence positions' share of the rows' means over
  sp, the loss on the last pp stage and a zero on the others. The
  parts, and the gradients of every leaf the axis does not split, are
  summed over sp and pp; the batch rows (and the row weight) are split
  over the batch axes only, so the ranks of an sp or pp group read the
  same rows.

ep plans raise (ROADMAP Queue A item 2e).
"""

from __future__ import annotations

import inspect
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch.models.losses import batch_weight
from edl_tpu_torch.obs import compilewatch
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.utils.device import DeviceLike, resolve_device
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


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Optimizer:
    """``optax.sgd``: ``p − lr·g``, with optax's momentum (a trace
    ``m = g + momentum·m``, torch's SGD momentum with no dampening)."""
    return Optimizer(lambda ps: torch.optim.SGD(
        ps, lr=learning_rate, momentum=momentum or 0.0, nesterov=nesterov))


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
    ``min(lr, 1/sqrt(t))``).

    A param that is a mesh slice (``sharding.info``) is factored by its
    WHOLE shape, and every mean and RMS above spans the whole tensor: a
    local partial sum is all-reduced over the axes that split the
    reduced dims. ``v_row`` (``v_col``) is then split like the param
    with ``d0`` (``d1``) removed (:func:`moment_spec`)."""

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
        inf = shd.info(p)
        gshape = inf.shape if inf is not None else tuple(p.shape)
        dims = self.factored_dims(gshape)

        def mean(x, dim, d_global, keepdim=False):
            # a mean over the param's (global) dim ``d_global``
            if inf is None:
                return x.mean(dim=dim, keepdim=keepdim)
            out = inf.sum(x.sum(dim=dim, keepdim=keepdim), [d_global])
            return out / gshape[d_global]

        def rms(x):
            if inf is None:
                return x.square().mean().sqrt()
            out = inf.sum(x.square().sum(), range(len(gshape)))
            return (out / math.prod(gshape)).sqrt()

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
            v_row = st["v_row"].mul_(beta).add_(mean(g2, d0, d0) * keep)
            v_col = st["v_col"].mul_(beta).add_(mean(g2, d1, d1) * keep)
            r1 = d1 - 1 if d1 > d0 else d1
            row = (v_row / mean(v_row, r1, d1, keepdim=True)).pow(-0.5)
            u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        del g2
        u = u / torch.clamp(rms(u), min=1.0)
        u = lr * u * torch.clamp(rms(p), min=1e-3)
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


def _mesh_kind(plan, mesh, what: str):
    """("one", None) on one process; ("dp", mesh) for a dp mesh of more
    than one process; ("sharded", mesh) for a mesh with fsdp or tp. A
    plan that shards with no port mesh raises."""
    from edl_tpu_torch.parallel.mesh import (Mesh, foreign_mesh, require_dp,
                                             require_ported)

    if isinstance(mesh, Mesh):
        if mesh.plan is None:  # the elastic process runtime's dp mesh
            require_dp(plan, what)
        require_ported(mesh.layout, what)
        if any(n > 1 and a != "dp" for a, n in mesh.layout.axes):
            return "sharded", mesh
        return ("dp", mesh) if mesh.world > 1 else ("one", None)
    if mesh is not None:
        raise foreign_mesh(mesh, what)
    require_ported(plan, what)
    if any(n > 1 for _, n in getattr(plan, "axes", ())):
        raise ValueError(f"{what}: plan {dict(plan.axes)} shards; pass its "
                         f"mesh (MeshPlan.build)")
    return "one", None


def _sum_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        coll.all_reduce(t, mesh.group(a))
    return t


def sharded_value_and_grad(loss_fn, params, batch, mesh, weight_fn=None
                           ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                      float]:
    """The loss over the global batch and the gradients of this rank's
    slices (one a param of :func:`leaves` that requires grad, laid out
    like it) over a mesh of more than one process, as
    :func:`_mesh_update` takes them; and the seconds of the gradient
    all-reduces.

    The global weight W (Σ over the batch axes of ``weight_fn(batch)``)
    is all-reduced first; this rank's loss, weighed by ``max(W_local,
    1) / max(W, 1)``, is its share of the global batch's loss, so the
    shares' gradients sum to the global one. The loss sees the local
    slices (a ``local_shards`` loss) or the leaves gathered whole. After
    the backward each gradient is summed over the batch axes that do not
    split its leaf and, for a ``local_shards`` loss (whose value is this
    rank's part over sp and pp), over sp and over pp unless pp splits
    the leaf (one flat all-reduce a set of axes). A leaf this rank's
    part does not reach (the embedding off the first pp stage) has a
    zero gradient. The loss is summed over the same axes."""
    plan = mesh.layout
    batch_axes = plan.batch_axes()
    local = getattr(loss_fn, "local_shards", False)
    parts = tuple(a for a in ("pp", "sp") if local and plan.axis_size(a) > 1)
    ps = [p for p in leaves(params) if p.requires_grad]
    w = batch_weight(batch, weight_fn).to(torch.float32)
    dev = ps[0].device if ps else mesh.device
    wl = w.to(dev).reshape(1)
    wg = _sum_over(wl.clone(), mesh, batch_axes)
    full = params if local else shd.gather_tree(params)
    loss = loss_fn(full, batch)
    share = loss * (wl.clamp_min(1.0) / wg.clamp_min(1.0))[0]
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        ps, torch.autograd.grad(share, ps, allow_unused=True))]
    buckets: Dict[Tuple[str, ...], List[int]] = {}
    for i, p in enumerate(ps):
        inf = shd.info(p)
        split = inf.axes() if inf is not None else ()
        axes = tuple(a for a in batch_axes + parts if a not in split)
        buckets.setdefault(axes, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(ps)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    t = time.perf_counter()
    total = share.detach().float().reshape(1)
    for axes, idx in buckets.items():
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        _sum_over(flat, mesh, axes)
        off = 0
        for i in idx:
            n = ps[i].numel()
            out[i] = flat[off:off + n].view_as(ps[i]).to(ps[i].dtype)
            off += n
    _sum_over(total, mesh, batch_axes + parts)
    return total[0], out, time.perf_counter() - t


def _mesh_update(loss_fn, state: TrainState, batch, mesh, weight_fn
                 ) -> Tuple[TrainState, torch.Tensor, float]:
    """One update over a mesh of more than one process (dp, fsdp, tp,
    and the process runtime's planless dp mesh): the gradients of
    :func:`sharded_value_and_grad`, then the optimizer on the local
    slices (the whole leaves under dp alone), only after every
    collective returned, so a failed collective (a dead peer) leaves
    params and moments as they were. Returns (state, loss over the
    global batch, seconds in the gradient all-reduces)."""
    opt = state.opt_state
    loss, grads, reduce_s = sharded_value_and_grad(loss_fn, state.params,
                                                   batch, mesh, weight_fn)
    for p, g in zip([p for p in leaves(state.params) if p.requires_grad],
                    grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)
    return (TrainState(step=state.step + 1, params=state.params,
                       opt_state=opt), loss, reduce_s)


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    tx: Optimizer,
    plan=None,
    mesh=None,
    param_pspecs=None,
    donate: bool = True,
    weight_fn: Optional[Callable[[Any], torch.Tensor]] = None,
):
    """Build ``step(state, batch) -> (state, {"loss"})``, the reference's
    signature. The loss stays on the device (no host sync). ``tx`` built
    the state's optimizer (:meth:`TrainState.create`) and is not read
    again. The update is in place.

    With a :class:`~edl_tpu_torch.parallel.mesh.Mesh` of more than one
    process the step is :func:`_mesh_update`; ``metrics`` also holds
    ``allreduce_s``, and the loss is the loss over the global batch.
    ``weight_fn(batch)`` gives a process's share of the loss's
    denominator (default :func:`~edl_tpu_torch.models.losses.
    batch_weight`, Σ ``_w``). The state must be placed on the mesh
    (:func:`shard_state`), whose leaves carry their layout, so
    ``param_pspecs`` is read there and not here; ``donate`` is the
    reference's flag and changes nothing here: the optimizer steps only
    after every collective of the step has returned, so a failed step
    leaves the state as it was either way. A sharding plan without its
    mesh raises. The factory's first step lands in
    ``edl_compile_seconds{program="train.step"}`` (the compile watch)."""
    kind, mesh = _mesh_kind(plan, mesh, "make_train_step")
    if kind == "one":
        update = compilewatch.wrap(_apply_update, "train.step")

        def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
            t = time.perf_counter()
            state, loss = update(loss_fn, state, batch)
            _record_dispatch(time.perf_counter() - t)
            return state, {"loss": loss}

        return step

    update = compilewatch.wrap(_mesh_update, "train.step")

    def mesh_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        t = time.perf_counter()
        state, loss, allreduce_s = update(loss_fn, state, batch, mesh,
                                          weight_fn)
        _record_dispatch(time.perf_counter() - t)
        return state, {"loss": loss, "allreduce_s": allreduce_s}

    return mesh_step


def make_train_multistep(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    tx: Optimizer,
    plan=None,
    mesh=None,
    param_pspecs=None,
    donate: bool = True,
):
    """Build ``multi(state, batches) -> (state, metrics)`` running K
    steps over a leading steps axis of ``batches`` (every leaf
    [K, ...]) in one call. ``metrics["losses"]`` holds all K per-step
    losses, ``"loss"`` the last. Semantically K calls of
    :func:`make_train_step` (over a mesh, K of its mesh steps). The
    factory's first call lands in
    ``edl_compile_seconds{program="train.multistep"}``."""
    kind, mesh = _mesh_kind(plan, mesh, "make_train_multistep")
    update = None if kind == "one" else _mesh_update

    def run(state: TrainState, batches, k: int):
        losses = []
        for i in range(k):
            batch = {name: x[i] for name, x in batches.items()}
            if update is None:
                state, loss = _apply_update(loss_fn, state, batch)
            else:
                state, loss, _ = update(loss_fn, state, batch, mesh, None)
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


def moment_spec(name: str, local_shape, param_shape, param_local_shape,
                param_spec) -> Tuple[Tuple[int, ...], tuple]:
    """(whole shape, spec) of the optimizer tensor ``name`` of a param
    whose whole shape, local shape and spec are given: an elementwise
    moment (``exp_avg``, ``exp_avg_sq``, Adafactor's ``v``) is laid out
    like its param, a scalar (``step``) is replicated, and Adafactor's
    ``v_row`` / ``v_col`` are the param's layout without the dim they
    reduced (``d0`` / ``d1``)."""
    param_shape = tuple(param_shape)
    if name in ("v_row", "v_col"):
        d1, d0 = Adafactor.factored_dims(param_shape)
        drop = d0 if name == "v_row" else d1
        full = shd.full_spec(param_spec, len(param_shape))
        return (tuple(n for i, n in enumerate(param_shape) if i != drop),
                tuple(e for i, e in enumerate(full) if i != drop))
    if tuple(local_shape) == tuple(param_local_shape):
        return param_shape, tuple(param_spec)
    if len(local_shape) == 0:
        return (), ()
    raise ValueError(f"optimizer tensor {name} {tuple(local_shape)} of a "
                     f"param {tuple(param_local_shape)} has no known layout")


def state_pspecs(state: TrainState, plan=None, param_pspecs=None
                 ) -> TrainState:
    """The reference's ``state_pspecs``: a TrainState of specs (tuples,
    ``()`` replicated) — ``params`` as a tree (``param_pspecs``, else
    the leaves' own when they are placed, else
    ``sharding.param_pspecs`` over the whole leaves), ``opt_state``
    keyed like :func:`optimizer_tensors` by (param leaf index, state
    name), each moment laid out by :func:`moment_spec`."""
    from edl_tpu_torch.parallel.mesh import require_ported

    require_ported(plan, "state_pspecs")
    ps = leaves(state.params)
    if plan is None or all(n == 1 or a == "dp" for a, n in plan.axes):
        specs = [()] * len(ps)
    elif any(shd.info(p) is not None for p in ps):  # placed: its own
        specs = [shd.info(p).spec if shd.info(p) else () for p in ps]
    elif param_pspecs is not None:
        specs = shd.specs_for(state.params, param_pspecs)
    else:
        specs = shd.spec_leaves(shd.param_pspecs(state.params, plan))
    opt = {}
    for i, name, t, _ in optimizer_tensors(state):
        inf = shd.info(ps[i])
        gshape = inf.shape if inf is not None else tuple(ps[i].shape)
        opt[(i, name)] = moment_spec(name, t.shape, gshape, ps[i].shape,
                                     specs[i])[1]
    return TrainState(step=(), params=replace_leaves(state.params, specs),
                      opt_state=opt)


class LocalSyncStepper:
    """K-step delayed-sync data parallelism (local SGD): the port of the
    reference's ``LocalSyncStepper`` (the --async_mode analog, reference
    example/ctr/ctr/train.py:75-79) for a dp mesh of processes.

    The reference keeps one private copy of the state per dp group on a
    leading group axis of one SPMD program. Here a dp group IS a process
    (:class:`~edl_tpu_torch.parallel.mesh.Mesh`), so the grouped state
    is each process's own state: :meth:`localize` returns it as it is,
    :meth:`step` is the process's own update on its own rows (its one
    collective is a scalar: the mean loss), :meth:`sync` averages the
    params (and the floating moments, by ``sync_moments``) over the
    group, and :meth:`merge` returns the group average as a new state
    and leaves the grouped one as it was. The averages are computed
    into new tensors and copied in only after the all-reduce returned,
    so a failed sync leaves the last state whole. The optimizers' step
    counts are equal on every process and are not averaged."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        tx: Optimizer,
        plan,
        mesh,
        sync_moments: bool = True,
        donate: bool = True,
    ):
        from edl_tpu_torch.parallel.mesh import Mesh

        busy = [a for a in ("pp", "fsdp", "sp", "ep", "tp")
                if plan.axis_size(a) > 1]
        if busy:
            raise ValueError(
                f"local-sync (delayed-sync DP) requires a dp-only mesh; "
                f"axes {busy} shard parameters, which leaves no private "
                f"per-group copy to run ahead on"
            )
        if not isinstance(mesh, Mesh):
            from edl_tpu_torch.parallel.mesh import foreign_mesh

            raise foreign_mesh(mesh, "LocalSyncStepper")
        self.loss_fn = loss_fn
        self.plan = plan
        self.mesh = mesh
        self.group = mesh.group("dp")
        self.dp = mesh.world
        self.sync_moments = sync_moments
        self._update = compilewatch.wrap(_apply_update, "train.localsync")

    def localize(self, state: TrainState) -> TrainState:
        """Replicated TrainState -> grouped form: this process's own."""
        return state

    def _average(self, state: TrainState, moments: bool):
        """(params, {(leaf index, name): moment}) averaged over the
        group into new tensors."""
        params = leaves(state.params)
        ot = [(i, name, t) for i, name, t, _ in optimizer_tensors(state)
              if moments and name != "step" and t.is_floating_point()]
        src = [p.detach() for p in params] + [t for _, _, t in ot]
        flat = torch.cat([x.reshape(-1).float() for x in src])
        if self.dp > 1:
            coll.all_reduce(flat, self.group)
            flat /= self.dp
        out, off = [], 0
        for x in src:
            out.append(flat[off:off + x.numel()].view_as(x).to(x.dtype))
            off += x.numel()
        return out[:len(params)], {(i, name): t for (i, name, _), t in
                                   zip(ot, out[len(params):])}

    def merge(self, lstate: TrainState) -> TrainState:
        """Grouped form -> a new replicated TrainState (group average)."""
        params, moments = self._average(lstate, True)
        return rebind_state(lstate, params, moments)

    def sync(self, lstate: TrainState) -> TrainState:
        """Average params (and moments) across the group — the one
        all-reduce of a K-step round."""
        params, moments = self._average(lstate, self.sync_moments)
        cur = {(i, name): t for i, name, t, _ in optimizer_tensors(lstate)}
        with torch.no_grad():
            for p, new in zip(leaves(lstate.params), params):
                p.copy_(new)
            for key, new in moments.items():
                cur[key].copy_(new)
        return lstate

    def step(self, lstate: TrainState, batch):
        """One local step on this process's rows. Its only collective is
        the loss: the mean of the groups' losses, as the reference
        reports it (its one SPMD step reduces them), and the step's
        lockstep point — no process runs a step ahead of its group."""
        t = time.perf_counter()
        state, loss = self._update(self.loss_fn, lstate, batch)
        if self.dp > 1:
            loss = loss.float().reshape(1)
            coll.all_reduce(loss, self.group)
            loss = (loss / self.dp)[0]
        _record_dispatch(time.perf_counter() - t)
        return state, {"loss": loss}


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


def _init_kwargs(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """The entries of ``opt.defaults`` that its class's ``__init__``
    takes. ``defaults`` may hold more: torch 2.13's ``AdamW`` lists
    ``decoupled_weight_decay``, which its ``__init__`` sets itself and
    rejects as an argument. The groups carry every entry either way."""
    params = inspect.signature(type(opt).__init__).parameters
    return {k: v for k, v in opt.defaults.items()
            if k in params and k not in ("self", "params")}


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
    new_opt = type(opt)(groups, **_init_kwargs(opt))
    for p, st in opt.state.items():
        new_opt.state[new_params[index[id(p)]]] = dict(st)
    for (i, name), t in new_tensors.items():
        new_opt.state[new_params[i]][name] = t
    return TrainState(step=state.step,
                      params=replace_leaves(state.params, new_params),
                      opt_state=new_opt)


def shard_state(state: TrainState, plan=None, mesh=None,
                device: DeviceLike = None, param_pspecs=None) -> TrainState:
    """Place a WHOLE TrainState — a host snapshot, or a state on another
    device — on ``device`` (CUDA unless ``"cpu"`` is named; a mesh's own
    device with a mesh): every param and moment is copied there, the
    host-kept ``step`` tensors are copied on the CPU, and the optimizer
    is rebound to the copies. Over a mesh with fsdp or tp each member
    keeps the slices :func:`state_pspecs` gives it (``param_pspecs``
    over the whole leaves, else ``sharding.param_pspecs``), each with
    its ``ShardInfo``, and a process outside the mesh gets None; under
    dp alone every member keeps the whole state. (A placed state moves
    to another mesh with :func:`reshard_state`.)"""
    kind, m = _mesh_kind(plan, mesh, "shard_state")
    if mesh is not None and not mesh.member:
        return None
    if kind != "sharded":
        dev = (resolve_device(device) if mesh is None or device is not None
               else mesh.device)
        params = [p.detach().to(dev, copy=True) for p in leaves(state.params)]
        tensors = {(i, name): t.to("cpu" if host else dev, copy=True)
                   for i, name, t, host in optimizer_tensors(state)}
        return rebind_state(state, params, tensors)
    specs = state_pspecs(state, m.layout, param_pspecs)
    pspecs = shd.spec_leaves(specs.params)
    params = [shd.place_leaf(p, sp, m) for p, sp in
              zip(leaves(state.params), pspecs)]
    tensors = {}
    for i, name, t, host in optimizer_tensors(state):
        tensors[(i, name)] = shd.place_leaf(
            t, specs.opt_state[(i, name)], m,
            device="cpu" if host else m.device)
    return rebind_state(state, params, tensors)


def global_batch(batch, plan=None, mesh=None, device: DeviceLike = None):
    """Place a host batch (a dict of arrays) on ``device`` (a mesh's own
    device with a mesh): on one device whole; over a mesh each member
    keeps its rows, the batch split over the batch axes in order (the
    reference's ``batch_pspec``); None outside the mesh."""
    rows = _batch_rows(plan, mesh, "global_batch")
    if rows is False:
        return None
    dev = mesh.device if mesh is not None and device is None \
        else resolve_device(device)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v) if not isinstance(v, torch.Tensor) else v
        out[k] = torch.as_tensor(_rows(v, rows, 0, k), device=dev)
    return out


def _batch_rows(plan, mesh, what):
    """(shards, index) of this member's rows, None for the whole batch,
    False outside the mesh."""
    kind, m = _mesh_kind(plan, mesh, what)
    if mesh is not None and not mesh.member:
        return False
    if m is None:
        return None
    lay = m.layout
    n, idx, c = 1, 0, m.coords()
    for a in lay.batch_axes():
        n, idx = n * lay.axis_size(a), idx * lay.axis_size(a) + c[a]
    return (n, idx) if n > 1 else None


def _rows(v, rows, dim, key):
    if rows is None:
        return v
    n, idx = rows
    if v.shape[dim] % n:
        raise ValueError(f"batch {key!r}: {v.shape[dim]} rows do not "
                         f"split over {n} batch shards")
    k = v.shape[dim] // n
    sl = [slice(None)] * v.ndim
    sl[dim] = slice(idx * k, (idx + 1) * k)
    return v[tuple(sl)]


def stack_batches(batches, plan=None, mesh=None, device: DeviceLike = None):
    """Stack host batches along a new leading steps axis and place them
    on ``device`` for :func:`make_train_multistep`; over a mesh each
    member keeps its rows of every batch (None outside it)."""
    rows = _batch_rows(plan, mesh, "stack_batches")
    if rows is False:
        return None
    dev = mesh.device if mesh is not None and device is None \
        else resolve_device(device)
    return {k: torch.as_tensor(_rows(np.stack([np.asarray(b[k])
                                                for b in batches]),
                                      rows, 1, k), device=dev)
            for k in batches[0]}


# -- moving a placed state to another mesh ---------------------------------


class _Leaf:
    """A leaf's place in a pickled tree skeleton."""


def _skeleton(tree):
    if isinstance(tree, torch.Tensor):
        return _Leaf
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return tree


def _fill(skel, it):
    if skel is _Leaf:
        return next(it)
    if isinstance(skel, dict):
        return {k: _fill(v, it) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_fill(v, it) for v in skel]
    return skel


@dataclass(frozen=True)
class StateSchema:
    """What every process needs to know of a placed state to take part
    in moving it: the step, the params' tree, whole shapes, dtypes,
    specs and grad flags, the optimizer's class, hyperparameters and
    groups, and each optimizer tensor's (leaf index, name, whole shape,
    dtype, spec, host-kept); and the source mesh's plan and world
    ranks."""

    step: int
    skeleton: Any
    params: Tuple[Tuple[Tuple[int, ...], torch.dtype, tuple, bool], ...]
    opt_cls: Any
    opt_kwargs: Dict[str, Any]
    opt_groups: Tuple[Tuple[Dict[str, Any], Tuple[int, ...]], ...]
    opt: Tuple[Tuple[int, str, Tuple[int, ...], torch.dtype, tuple, bool],
               ...]
    plan: Any
    ranks: Tuple[int, ...]


def state_schema(state: TrainState, mesh) -> StateSchema:
    """The :class:`StateSchema` of a state placed on ``mesh`` (or of a
    whole state on one process: every spec ``()``)."""
    ps = leaves(state.params)
    infos = [shd.info(p) for p in ps]
    pinfo = tuple((i.shape if i else tuple(p.shape), p.dtype,
                   i.spec if i else (), p.requires_grad)
                  for p, i in zip(ps, infos))
    index = {id(p): i for i, p in enumerate(ps)}
    opt = state.opt_state
    groups = tuple(({k: v for k, v in g.items() if k != "params"},
                    tuple(index[id(p)] for p in g["params"]))
                   for g in opt.param_groups)
    ot = []
    for i, name, t, host in optimizer_tensors(state):
        shape, spec = moment_spec(name, t.shape, pinfo[i][0], ps[i].shape,
                                  pinfo[i][2])
        ot.append((i, name, shape, t.dtype, spec, host))
    return StateSchema(
        step=int(state.step), skeleton=_skeleton(state.params),
        params=pinfo, opt_cls=type(opt), opt_kwargs=_init_kwargs(opt),
        opt_groups=groups, opt=tuple(ot), plan=mesh.layout,
        ranks=mesh.world_ranks())


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The params then the optimizer tensors, in :class:`StateSchema`
    order."""
    return ([p.detach() for p in leaves(state.params)]
            + [t for _, _, t, _ in optimizer_tensors(state)])


def assemble_state(schema: StateSchema, tensors: Sequence[torch.Tensor],
                   mesh, specs: Optional[Sequence[tuple]] = None
                   ) -> TrainState:
    """A TrainState over ``tensors`` (the params' then the optimizer's
    local slices, in schema order) placed on ``mesh`` with the params'
    ``specs`` (default the schema's): params carry their ``ShardInfo``
    and grad flags, and a new optimizer of the schema's class holds the
    moments."""
    n = len(schema.params)
    specs = list(specs) if specs is not None else \
        [sp for _, _, sp, _ in schema.params]
    sharded = mesh is not None and any(
        n > 1 and a != "dp" for a, n in mesh.layout.axes)
    params = []
    for t, (shape, _, _, grad), sp in zip(tensors[:n], schema.params, specs):
        if sharded:
            shd.attach(t, shd.ShardInfo(shape, tuple(sp), mesh))
        params.append(t.requires_grad_(grad))
    opt = schema.opt_cls(
        [{**hp, "params": [params[i] for i in idx]}
         for hp, idx in schema.opt_groups], **schema.opt_kwargs)
    for (i, name, *_), t in zip(schema.opt, tensors[n:]):
        opt.state[params[i]][name] = t
    return TrainState(step=schema.step,
                      params=_fill(schema.skeleton, iter(params)),
                      opt_state=opt)


def _moment_dst_spec(name: str, shape, param_shape, param_spec) -> tuple:
    """:func:`moment_spec` from whole shapes."""
    if name in ("v_row", "v_col"):
        return moment_spec(name, (), param_shape, (), param_spec)[1]
    if tuple(shape) == tuple(param_shape):
        return tuple(param_spec)
    if not tuple(shape):
        return ()
    raise ValueError(f"optimizer tensor {name} {tuple(shape)} of a param "
                     f"{tuple(param_shape)} has no known layout")


def reshard_plans(schema: StateSchema, plan, mesh, param_pspecs, dev
                  ) -> Tuple[List[tuple], List[Any]]:
    """(the params' target specs, a ``sharding.LeafPlan`` for each tensor
    of the schema) of a move onto ``plan``: the params' specs from
    ``param_pspecs`` (a spec tree over the whole leaves; default
    ``sharding.param_pspecs`` of the whole shapes, or all ``()`` under
    dp alone), each moment following its param, params on ``dev`` and
    host-kept tensors on the CPU."""
    skel = _fill(schema.skeleton, iter(
        torch.empty(shape, dtype=dt, device="meta")
        for shape, dt, _, _ in schema.params))
    if param_pspecs is not None:
        dst_specs = shd.specs_for(skel, param_pspecs)
    elif all(n == 1 or a == "dp" for a, n in plan.axes):
        dst_specs = [()] * len(schema.params)
    else:
        dst_specs = shd.spec_leaves(shd.param_pspecs(skel, plan))
    lplans = [shd.LeafPlan(shape, dt, sp, tuple(dsp), dev)
              for (shape, dt, sp, _), dsp in zip(schema.params, dst_specs)]
    for i, name, shape, dt, sp, host in schema.opt:
        lplans.append(shd.LeafPlan(
            shape, dt, sp,
            _moment_dst_spec(name, shape, schema.params[i][0], dst_specs[i]),
            torch.device("cpu") if host else dev))
    return dst_specs, lplans


def reshard_state(state: Optional[TrainState], plan, mesh, pool,
                  param_pspecs=None, device: DeviceLike = None,
                  src_mesh=None, alias: bool = True) -> Optional[TrainState]:
    """Move a state placed on one mesh onto ``mesh`` (``plan``) over the
    pool's collectives, slice by slice (``sharding.redistribute``).
    Every process of the pool calls it: a member of the old mesh with its
    state (``src_mesh`` defaults to the params' own mesh), any other
    with None. The old mesh's first rank broadcasts the
    :class:`StateSchema` over ``pool`` (a ``collectives.Group``), so a
    joining process learns the layout. The target layout is
    ``param_pspecs`` (a spec tree over the whole leaves; default
    ``sharding.param_pspecs`` of the whole shapes), each moment following
    its param (:func:`moment_spec`). Params land on ``device`` (default
    the mesh's), the host-kept ``step`` tensors on the CPU. A slice that
    stays where it is keeps its tensor (``alias``; a copy without, so the
    result shares nothing with ``state``). The old mesh's first rank must
    be the pool's first. Returns this process's state on ``mesh``, or
    None outside it.

    Every process first does its local part: the schema, the target
    layout and its target slices, allocated (``sharding.
    prepare_redistribute``). The pool then agrees (``collectives.agree``)
    before any slice moves: if that part failed anywhere, the process
    that failed raises its own error and every other one
    ``collectives.PeerError``, so no process is left in a transfer its
    peers will not join. Under gloo the transfers allocate no device
    memory; a failure during them (a collective) raises on its process
    and fails the pool's waits at the process group's timeout."""
    from edl_tpu_torch.parallel.mesh import _group_shape

    root = 0  # the old mesh's first rank is the pool's first holder
    err: Optional[BaseException] = None
    schema = None
    try:
        if state is not None:
            src = src_mesh
            if src is None:
                inf = next((shd.info(p) for p in leaves(state.params)
                            if shd.info(p) is not None), None)
                src = inf.mesh if inf is not None else mesh
            schema = state_schema(state, src)
        elif pool.rank == root:
            raise ValueError("reshard_state: the pool's first process holds "
                             "no state (the old mesh's first rank must be "
                             "the pool's first)")
    except Exception as e:  # agreed on below
        err, schema = e, None
    schema = coll.broadcast_object(schema, root, pool)
    moves = None
    if err is None and schema is not None:
        try:
            _, me = _group_shape()
            dev = torch.device(device) if device is not None else mesh.device
            dst_specs, lplans = reshard_plans(schema, plan, mesh,
                                              param_pspecs, dev)
            tensors = state_tensors(state) if state is not None else \
                [None] * len(lplans)
            moves = shd.prepare_redistribute(
                tensors, lplans, (schema.plan, schema.ranks),
                (plan, mesh.world_ranks()), me, alias)
        except Exception as e:  # agreed on below
            err = e
    # with no schema the first process failed: agree raises its error
    coll.agree(err, pool)
    out = moves.run()
    if not mesh.member:
        return None
    return assemble_state(schema, out, mesh, dst_specs)


def gather_state(state: Optional[TrainState], src_mesh, pool,
                 device: DeviceLike = "cpu") -> Optional[TrainState]:
    """A copy of the whole state on the mesh's first rank (on
    ``device``, the host by default), None elsewhere:
    :func:`reshard_state` onto a mesh of that one rank. Every process of
    ``pool`` calls it."""
    from edl_tpu_torch.parallel.mesh import MeshPlan

    dev = torch.device(device)
    one = MeshPlan.create().build([dev], ranks=src_mesh.world_ranks()[:1])
    return reshard_state(state, one.layout, one, pool, device=dev,
                         src_mesh=src_mesh, alias=False)
