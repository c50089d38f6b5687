"""ElasticTrainer — the port of ``edl_tpu/runtime/elastic.py``: rescale a
training job between steps, with no restart:

    scale event → snapshot → rebuild the mesh over the new ranks →
    reshard the state onto it → resume at the next step

The reference is one SPMD process over a pool of devices. Here the pool
is a ``torch.distributed`` world of processes, one a device slot
(``utils/platform.ProcessPool``), and every rank runs the same
``ElasticTrainer`` program. At n workers the mesh covers the pool's
first ``n * chips_per_worker`` ranks, laid out dp x pp x fsdp x sp x tp
in the reference's axis order (``MeshPlan.from_spec``: the spec's axes,
the rest on dp; a spec that pins sp or pp rescales over dp, its loss
rebuilt for each mesh by ``make_loss``). A rank outside the mesh holds
no state: at each step it reads the batch (so the data stream stays
aligned) and waits at the step boundary; it takes part in every
rescale's collectives. A world of one process with no process group is
a pool of one.

The rescale keeps the reference's spans (``reshard``,
``reshard.build_mesh``, ``reshard.device_transfer``,
``reshard.host_staging``), its ``reshard.begin`` / ``reshard.end`` flight
events, its derived trace root (``disttrace.root("reshard", epoch)``),
its metrics and the memory ledger's re-registration. The device path
(:func:`_device_reshard`) moves each leaf's slices to the new mesh over
the pool's collectives; the host path (``checkpoint.staged_reshard``)
runs only when the device path raises, and its :class:`ReshardEvent`
says so (``fallback=True``). The choice is the pool's, not a rank's:
the ranks agree before any slice moves (``trainer.reshard_state``), so
a failure on one rank sends every rank to the host path together, or
makes every rank raise.

:func:`device_reshard` places a one-device state on a device (the
elastic process runtime's fast path).
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import torch

from edl_tpu_torch.api.job import MeshSpec
from edl_tpu_torch.obs import costmodel as _costmodel
from edl_tpu_torch.obs import disttrace
from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.obs import memledger
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.parallel.mesh import MeshPlan, _group_shape, pool_group
from edl_tpu_torch.runtime import checkpoint as ckpt
from edl_tpu_torch.train.trainer import (LocalSyncStepper, TrainState,
                                         gather_state, global_batch, leaves,
                                         make_train_step, optimizer_tensors,
                                         reshard_state, shard_state)
from edl_tpu_torch.utils import tracing
from edl_tpu_torch.utils.device import DeviceLike, resolve_device
from edl_tpu_torch.utils.logging import Timer, kv_logger

log = kv_logger("elastic")


def device_reshard(state: TrainState, plan=None, mesh=None,
                   device: DeviceLike = None) -> TrainState:
    """Place a live one-device TrainState on ``device`` (CUDA unless
    ``"cpu"`` is named) and fence. Where every tensor already lies there
    it moves nothing and returns ``state`` itself, as the reference's
    ``device_put`` onto the same sharding does; otherwise it is
    :func:`~trainer.shard_state`."""
    dev = resolve_device(device)
    ts = leaves(state.params) + [t for _, _, t, host in
                                 optimizer_tensors(state) if not host]
    if plan is not None or mesh is not None or any(t.device != dev
                                                  for t in ts):
        state = shard_state(state, plan, mesh, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state


def _obs_reshard(ev: "ReshardEvent") -> None:
    """Reshard telemetry: the stall histogram and the path-labeled
    counter."""
    r = obs_metrics.default_registry()
    r.histogram(
        "edl_reshard_stall_seconds", "traffic-stopping reshard window"
    ).observe(ev.stall_s)
    r.counter("edl_reshard_total", "elastic reshards", ("path",)).inc(
        path="host" if ev.fallback else "device"
    )


def _fence(state: Optional[TrainState]) -> None:
    if state is not None:
        for p in leaves(state.params):
            if p.is_cuda:
                torch.cuda.synchronize(p.device)
                return


def _device_reshard(state: Optional[TrainState], plan: MeshPlan, mesh,
                    pspecs, pool, src_mesh) -> Optional[TrainState]:
    """Move the live state onto ``mesh`` over the pool's collectives
    (``trainer.reshard_state``: each slice goes point to point to the
    ranks that need it, a slice that stays put is not copied), then
    fence — the elastic fast path."""
    new_state = reshard_state(state, plan, mesh, pool, pspecs,
                              src_mesh=src_mesh)
    _fence(new_state)
    return new_state


@dataclass
class ReshardEvent:
    """One elastic rescale, as observed by the runtime."""

    from_workers: int
    to_workers: int
    stall_s: float  # snapshot + remesh + reshard (the traffic-stopping window)
    recompile_s: float  # first step on the new mesh
    step: int
    # True when the direct device move failed and the reshard went
    # through host-RAM staging
    fallback: bool = False


@dataclass
class TrainReport:
    steps: int = 0
    examples: int = 0
    losses: List[float] = field(default_factory=list)
    reshards: List[ReshardEvent] = field(default_factory=list)
    train_seconds: float = 0.0

    @property
    def examples_per_sec(self) -> float:
        return self.examples / self.train_seconds if self.train_seconds else 0.0


class ElasticTrainer:
    """Runs a sharded training loop that can rescale between steps; every
    rank of the pool constructs one and makes the same calls.

    Parameters
    ----------
    loss_fn : ``f(params, batch) -> scalar`` (whole params)
    tx : an optimizer factory of ``train/trainer.py``
    mesh_spec : user parallelism plan; remaining device factor goes to dp
    chips_per_worker : ranks (device slots) driven by each worker
    per_chip_batch : per-rank batch — the global batch scales with the
        worker count, the reference's elastic-DP throughput semantics
    param_pspecs : optional spec tree over the whole params, or a
        callable ``plan -> tree`` re-evaluated at every (re)build
    devices : the world ranks of the pool (default every rank)
    device : this rank's device (default the card)
    make_loss : ``(plan, mesh) -> loss_fn``, re-invoked at every
        (re)build (a loss made for the mesh, such as llama's)
    agree_target : ``f(pending) -> pending``, called on every rank at
        each step boundary before a pending rescale is applied, with this
        rank's pending worker target (or None); what it returns is the
        target this rank applies. ``runtime/local.LocalJobRunner`` makes
        every rank apply the pool's first rank's.
    """

    def __init__(
        self,
        loss_fn: Callable,
        tx,
        mesh_spec: Optional[MeshSpec] = None,
        chips_per_worker: int = 1,
        per_chip_batch: int = 32,
        param_pspecs=None,
        devices: Optional[Sequence[int]] = None,
        on_reshard: Optional[Callable[[ReshardEvent], None]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_steps: int = 0,
        sync_every: int = 1,
        make_loss: Optional[Callable] = None,
        flops_per_example: Optional[float] = None,
        hbm_bytes_per_example: Optional[float] = None,
        device: DeviceLike = None,
        agree_target: Optional[Callable[[Optional[int]],
                                        Optional[int]]] = None,
    ):
        self.loss_fn = loss_fn
        self.agree_target = agree_target
        self.make_loss = make_loss
        self.tx = tx
        self.mesh_spec = mesh_spec or MeshSpec()
        self.chips_per_worker = chips_per_worker
        self.per_chip_batch = per_chip_batch
        self.param_pspecs = param_pspecs
        self._pspecs = None  # resolved per plan in _build
        world, self.pool_rank = _group_shape()
        self.pool = list(devices) if devices is not None else list(
            range(world))
        self.device = resolve_device(device)
        self.on_reshard = on_reshard
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_steps = checkpoint_every_steps
        self.sync_every = max(int(sync_every), 1)
        self._stepper: Optional[LocalSyncStepper] = None
        self._pool_group = None

        self.n_workers = 0
        self.mesh = None
        self.plan: Optional[MeshPlan] = None
        self.state: Optional[TrainState] = None
        self._template = None  # whole params on the meta device
        self._host_step = 0  # host mirror of state.step
        self._step_fn = None
        self._scale_target: Optional[int] = None
        self.report = TrainReport()
        self.flops_per_example = flops_per_example
        self.hbm_bytes_per_example = hbm_bytes_per_example
        self._eff: Optional[_costmodel.EfficiencyMeter] = None
        self._ledger = memledger.default_ledger()
        self._ledger_owner = f"trainer-{id(self)}"
        weakref.finalize(self, self._ledger.release_owner, self._ledger_owner)

    # -- lifecycle ---------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return self.n_workers * self.chips_per_worker

    @property
    def global_batch_size(self) -> int:
        return self.per_chip_batch * self.n_devices

    @property
    def member(self) -> bool:
        return self.mesh is not None and self.mesh.member

    @property
    def pool_group(self) -> coll.Group:
        if self._pool_group is None:
            self._pool_group = pool_group(self.pool)
        return self._pool_group

    def start(self, params, n_workers: int) -> None:
        """Initial mesh + state placement (every rank passes the whole
        params; each member keeps its slices)."""
        self._template = _meta(params)
        self._build(n_workers)
        if self.member:
            self.state = shard_state(TrainState.create(params, self.tx),
                                     self.plan, self.mesh,
                                     param_pspecs=self._pspecs)
            if self._stepper is not None:
                self.state = self._stepper.localize(self.state)
        self._ledger_register()
        self._host_step = 0
        log.info("elastic trainer started", workers=n_workers,
                 devices=self.n_devices, mesh=self.plan.describe())

    def resume(self, params, n_workers: int, checkpoint_path: str) -> None:
        """Start from a saved checkpoint: ``params`` only provides the
        tree structure; values and the step counter come from disk and
        are sharded onto the fresh mesh."""
        self._template = _meta(params)
        self._build(n_workers)
        template = TrainState.create(params, self.tx)
        host = ckpt.load(checkpoint_path, template)
        if self.member:
            self.state = ckpt.restore(host, self.plan, self.mesh,
                                      param_pspecs=self._pspecs)
            if self._stepper is not None:
                self.state = self._stepper.localize(self.state)
        self._ledger_register()
        self._host_step = int(host.step)
        log.info("elastic trainer resumed", workers=n_workers,
                 step=int(host.step), checkpoint=checkpoint_path)

    def maybe_checkpoint(self, force: bool = False) -> Optional[str]:
        """Write ``checkpoint_dir/step-N`` when the cadence (or ``force``)
        says so; returns the path written (on the pool's first rank,
        which gathers the whole state and writes it)."""
        if not self.checkpoint_dir or self._template is None:
            return None
        step = self._host_step
        if not force and (
            self.checkpoint_every_steps <= 0
            or step == 0
            or step % self.checkpoint_every_steps != 0
        ):
            return None
        path = os.path.join(self.checkpoint_dir, f"step-{step}")
        if os.path.exists(os.path.join(path, "state.npz")):
            return None
        whole = self._whole_state()
        if whole is None:
            return None
        with tracing.span("checkpoint.save", step=step):
            ckpt.save(path, whole, {"n_workers": self.n_workers})
        return path

    def _whole_state(self) -> Optional[TrainState]:
        """The merged state whole on the pool's first rank (a copy on
        the host for a sharded mesh), None elsewhere."""
        st = self.merged_state
        if not self._sharded():
            return st if self.pool_rank == self.pool[0] else None
        return gather_state(st, self.mesh, self.pool_group)

    def _sharded(self) -> bool:
        return any(n > 1 and a != "dp" for a, n in self.plan.axes)

    def _build(self, n_workers: int) -> None:
        n_dev = n_workers * self.chips_per_worker
        if n_dev > len(self.pool):
            raise ValueError(
                f"{n_workers} workers x {self.chips_per_worker} chips "
                f"exceed device pool ({len(self.pool)})")
        self.plan = MeshPlan.from_spec(self.mesh_spec, n_dev)
        self.mesh = self.plan.build([self.device], ranks=self.pool[:n_dev])
        self.n_workers = n_workers
        if callable(self.param_pspecs):
            self._pspecs = self.param_pspecs(self.plan)
        elif self.param_pspecs is not None:
            self._pspecs = self.param_pspecs
        elif self._sharded():
            self._pspecs = shd.param_pspecs(self._template, self.plan)
        else:
            self._pspecs = None
        loss = (self.make_loss(self.plan, self.mesh)
                if self.make_loss is not None else self.loss_fn)
        self._step_fn = make_train_step(loss, self.tx, self.plan, self.mesh,
                                        self._pspecs)
        self._stepper = (LocalSyncStepper(loss, self.tx, self.plan, self.mesh)
                         if self.sync_every > 1 else None)

    def _ledger_register(self) -> None:
        """(Re)register this rank's live state in the memory ledger under
        stable keys (reshards replace, never accumulate)."""
        st = self.state
        self._ledger.register_tree(
            self._ledger_owner, "params",
            leaves(st.params) if st is not None else [], "params")
        self._ledger.register_tree(
            self._ledger_owner, "opt",
            [t for _, _, t, _ in optimizer_tensors(st)] if st is not None
            else [], "opt")

    @property
    def merged_state(self) -> Optional[TrainState]:
        """The consensus TrainState: in delayed-sync mode the group
        average, otherwise the live state (this rank's slices; None
        outside the mesh)."""
        if self.state is not None and self._stepper is not None:
            return self._stepper.merge(self.state)
        return self.state

    # -- elastic surface ---------------------------------------------------

    def request_rescale(self, n_workers: int) -> None:
        """Signal from the control plane; honored at the next step
        boundary. Every rank must receive the same requests."""
        if n_workers != self.n_workers:
            self._scale_target = n_workers

    def apply_chip_grant(self, total_chips: int) -> int:
        """Consume a chip-lease budget: retarget to as many whole workers
        as ``total_chips`` covers, floored at one worker. Returns the
        worker count requested."""
        if total_chips < 0:
            raise ValueError(f"total_chips must be >= 0, got {total_chips}")
        n_workers = max(1, total_chips // self.chips_per_worker)
        self.request_rescale(n_workers)
        return n_workers

    def _feasible(self, n_workers: int) -> bool:
        n_dev = n_workers * self.chips_per_worker
        if n_workers < 1 or n_dev > len(self.pool):
            return False
        try:
            MeshPlan.from_spec(self.mesh_spec, n_dev)
        except ValueError:
            return False
        return True

    def _resolve_target(self, target: int) -> Optional[int]:
        """Largest feasible worker count <= target, or None."""
        for n in range(min(target, len(self.pool)
                           // max(self.chips_per_worker, 1)), 0, -1):
            if self._feasible(n):
                return n
        return None

    def _maybe_rescale(self) -> None:
        target = self._scale_target
        if target is None:
            return
        self._scale_target = None
        target = self._resolve_target(target)
        if target is None or target == self.n_workers:
            if target is None:
                log.warn("ignoring infeasible rescale target")
            return
        prev = self.n_workers
        step_at = self._host_step
        ep = len(self.report.reshards)
        log.info("reshard begin", from_workers=prev, to_workers=target)
        with disttrace.root("reshard", ep):
            self._rescale_traced(target, prev, step_at, ep)

    def _rescale_traced(self, target, prev, step_at, ep) -> None:
        used_fallback = False
        flight.emit("reshard.begin", reshard_epoch=ep, step=step_at,
                    from_workers=prev, to_workers=target)
        with Timer() as stall, tracing.span(
            "reshard", from_workers=prev, to_workers=target, step=step_at,
            reshard_epoch=ep,
        ):
            old_state = self.merged_state
            old_mesh = self.mesh
            with tracing.span("reshard.build_mesh", to_workers=target):
                self._build(target)
            try:
                with tracing.span("reshard.device_transfer"):
                    self.state = _device_reshard(
                        old_state, self.plan, self.mesh, self._pspecs,
                        self.pool_group, old_mesh)
            except (ValueError, TypeError, RuntimeError,
                    coll.PeerError) as e:
                # transfer-layer failures fall back to host-RAM staging;
                # deterministic spec bugs fail again here and surface.
                # The pool agreed before any slice moved (reshard_state):
                # every rank is here, or every rank raises
                if isinstance(e, coll.PeerError) and not e.recoverable:
                    raise
                used_fallback = True
                log.warn("device reshard failed; staging via host",
                         error=str(e))
                with tracing.span("reshard.host_staging"):
                    self.state = ckpt.staged_reshard(
                        old_state, self.plan, self.mesh,
                        param_pspecs=self._pspecs, pool=self.pool_group,
                        src_mesh=old_mesh)
            if self._stepper is not None and self.state is not None:
                self.state = self._stepper.localize(self.state)
            del old_state
            self._ledger_register()
        ev = ReshardEvent(from_workers=prev, to_workers=target,
                          stall_s=stall.elapsed, recompile_s=0.0,
                          step=step_at, fallback=used_fallback)
        self.report.reshards.append(ev)
        _obs_reshard(ev)
        flight.emit("reshard.end", reshard_epoch=ep, step=step_at,
                    from_workers=prev, to_workers=target,
                    stall_s=round(stall.elapsed, 6),
                    path="host" if used_fallback else "device")
        log.info("reshard done", from_workers=prev, to_workers=target,
                 stall_s=round(stall.elapsed, 4), fallback=used_fallback)
        if self.on_reshard:
            self.on_reshard(ev)

    # -- training loop -----------------------------------------------------

    def train_steps(self, data_fn: Callable[[int], Any],
                    n_steps: int) -> TrainReport:
        """Run ``n_steps`` updates; ``data_fn(global_batch_size)`` yields
        a whole host batch each step, on every rank (a member keeps its
        rows). The losses come from the mesh's first rank, broadcast
        over the pool at the end, so every rank's report is the same.
        Step wall time, data wait and host block land in the process
        registry, as the reference's."""
        reg = obs_metrics.default_registry()
        h_step = reg.histogram(
            "edl_train_step_seconds",
            "full step wall time (data + dispatch + sync)")
        h_data = reg.histogram(
            "edl_train_data_wait_seconds",
            "host wait for the next batch (data stall)")
        h_block = reg.histogram(
            "edl_train_host_block_seconds",
            "host blocked on device results (sync stall)")
        c_examples = reg.counter(
            "edl_train_examples_total", "training rows consumed")
        t0 = time.perf_counter()
        raw_losses: List[Any] = []
        try:
            self._train_steps_inner(data_fn, n_steps, h_step, h_data,
                                    c_examples, raw_losses)
        except Exception as e:
            flight.emit("trainer.crash", severity="error",
                        step=self._host_step,
                        error=f"{type(e).__name__}: {e}")
            flight.crash_dump("trainer", e)
            raise
        tb = time.perf_counter()
        _fence(self.state)
        h_block.observe(time.perf_counter() - tb)
        # a torch optimizer makes its moments at its first step: the
        # ledger's "opt" bytes are known only now
        self._ledger_register()
        self.report.train_seconds += time.perf_counter() - t0
        losses = torch.tensor([float(x) for x in raw_losses]
                              if raw_losses else [0.0] * n_steps,
                              dtype=torch.float64)
        if len(losses) != n_steps:
            losses = torch.zeros(n_steps, dtype=torch.float64)
        coll.broadcast(losses, 0, self.pool_group)
        vals = [float(x) for x in losses]
        self.report.losses.extend(vals)
        if vals:
            reg.gauge("edl_train_loss", "most recent training loss").set(
                vals[-1])
        if self.report.train_seconds > 0:
            reg.gauge("edl_train_examples_per_sec",
                      "training throughput over the last report window"
                      ).set(self.report.examples_per_sec)
        if self.flops_per_example and self.report.train_seconds > 0:
            self._eff = _costmodel.EfficiencyMeter(registry=reg)
            eps_per_dev = self.report.examples_per_sec / max(
                self.n_devices, 1)
            self._eff.set_rates(
                "train", eps_per_dev * self.flops_per_example,
                eps_per_dev * (self.hbm_bytes_per_example or 0.0))
        return self.report

    def _train_steps_inner(self, data_fn, n_steps, h_step, h_data,
                           c_examples, raw_losses) -> None:
        for _ in range(n_steps):
            if self.agree_target is not None:
                self._scale_target = self.agree_target(self._scale_target)
            self._maybe_rescale()
            ts = time.perf_counter()
            batch = data_fn(self.global_batch_size)
            dev_batch = global_batch(batch, self.plan, self.mesh)
            first_on_mesh = (bool(self.report.reshards)
                             and self.report.reshards[-1].recompile_s == 0.0)
            tc = time.perf_counter()
            h_data.observe(tc - ts)
            if self.member:
                if self._stepper is not None:
                    self.state, metrics = self._stepper.step(self.state,
                                                             dev_batch)
                    if (self._host_step + 1) % self.sync_every == 0:
                        self.state = self._stepper.sync(self.state)
                else:
                    self.state, metrics = self._step_fn(self.state,
                                                        dev_batch)
                raw_losses.append(metrics["loss"])
                if first_on_mesh:
                    float(metrics["loss"])  # the first step's end
            if first_on_mesh:
                recompile_s = time.perf_counter() - tc
                self.report.reshards[-1].recompile_s = recompile_s
                tracing.tracer().record("reshard.recompile", tc,
                                        recompile_s,
                                        {"to_workers": self.n_workers})
                obs_metrics.default_registry().histogram(
                    "edl_reshard_recompile_seconds",
                    "first-step compile on the new mesh",
                ).observe(recompile_s)
            self.report.steps += 1
            self._host_step += 1
            self.report.examples += self.global_batch_size
            c_examples.inc(self.global_batch_size)
            self.maybe_checkpoint()
            h_step.observe(time.perf_counter() - ts)


def _meta(params):
    """The params' structure on the meta device (shapes, no memory)."""
    from edl_tpu_torch.utils.tree import replace_leaves

    return replace_leaves(params, [
        torch.empty(p.shape, dtype=p.dtype, device="meta")
        for p in leaves(params)])
