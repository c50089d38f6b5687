"""Autoscaler — retargets elastic jobs' worker counts to keep the fleet loaded.

Faithful port of the reference scaling algorithm
(reference: pkg/autoscaler.go:201-337,451-511) onto the TPU resource
model: the GPU trio becomes TPU chips (exclusively allocated, scaled to
full), CPU keeps the ``max_load_desired`` headroom guard, memory keeps
the hard guard, and host search gains a free-chip check. A pluggable
slice policy (cluster/topology.py) restricts worker counts to
ICI-legal slice shapes — under the default ``flexible`` policy the
algorithm is step-for-step the reference's.

Algorithm per tick (reference: Run, pkg/autoscaler.go:451-485):
  census → pending-job check → candidate set → iterative dry-run to a
  fixed point (scale-up pass over most-starved first, scale-down pass
  over least-starved first) → apply new parallelism with retries.

The port of ``edl_tpu/scheduler/autoscaler.py``, unchanged in
behaviour; it imports no torch. The serving fleet's
:class:`~edl_tpu_torch.serving.fleet.FleetScaler` runs its decisions
through the same :class:`ScaleGate`.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.api.job import Event, TrainingJob
from edl_tpu_torch.cluster import topology
from edl_tpu_torch.cluster.base import Cluster, ConflictError, WorkerGroup
from edl_tpu_torch.cluster.resource import ClusterResource
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("autoscaler")

DEFAULT_LOOP_SECONDS = 5.0  # reference: defaultLoopDur pkg/autoscaler.go:31
UPDATE_RETRIES = 5  # reference: pkg/autoscaler.go:346


class HysteresisGate:
    """Per-key rescale damping — the cooldown machinery shared by the
    cluster autoscaler's job-retarget loop and the serving fleet's
    replica scaler (serving/fleet.py).

    Both loops have the same failure mode: a marginal signal flips the
    decision every tick and each flip is expensive (a reshard stall for
    training, a replica drain+spawn for serving). The gate admits an
    action for ``key`` only when at least ``cooldown_s`` has elapsed
    since that key's last :meth:`record`; ``cooldown_s == 0`` admits
    everything (the undamped reference behavior). Callers may bypass
    the gate when an urgency signal says churn is the lesser evil
    (pending pods for training, an SLO breach for serving)."""

    def __init__(self, cooldown_s: float, clock=time.monotonic):
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._last: Dict[str, float] = {}

    def ready(self, key: str = "") -> bool:
        if self.cooldown_s <= 0:
            return True
        return (
            self.clock() - self._last.get(key, -1e18) >= self.cooldown_s
        )

    def record(self, key: str = "") -> None:
        self._last[key] = self.clock()


class ScaleGate:
    """The one damped scale-decision pipeline every elastic consumer
    shares: ``decide → (cooldown or bypass) → act → record``.

    Before this class the pattern lived copy-pasted in the serving
    fleet's :class:`~edl_tpu_torch.serving.fleet.FleetScaler` and inline in
    the elasticity controller's handover loop — each re-implementing
    the same four lines around a :class:`HysteresisGate` and each free
    to drift (forget the record, invert the bypass). ``apply`` owns the
    sequencing; callers supply only the pure ``decide`` (returns an
    action label or None) and the side-effecting ``act``.

    ``bypass`` is the urgency escape hatch: when it returns True the
    cooldown is ignored (pending pods for training, an SLO breach for
    serving — churn is the lesser evil once users are hurting)."""

    def __init__(
        self,
        key: str,
        cooldown_s: float,
        clock=time.monotonic,
        bypass: Optional[Callable[[], bool]] = None,
    ):
        self.key = key
        self.gate = HysteresisGate(cooldown_s, clock=clock)
        self.bypass = bypass

    def apply(
        self,
        decide: Callable[[], Optional[str]],
        act: Callable[[str], None],
    ) -> Optional[str]:
        """One damped decision. Returns the action applied, or None
        (nothing to do, or held by the cooldown)."""
        action = decide()
        if action is None:
            return None
        if not self.gate.ready(self.key) and not (
            self.bypass is not None and self.bypass()
        ):
            return None
        act(action)
        self.gate.record(self.key)
        return action


@dataclass
class JobState:
    """Autoscaler view of one job (reference: `job`, pkg/autoscaler.go:34-37)."""

    config: TrainingJob
    group: Optional[WorkerGroup] = None

    def chips_per_worker(self) -> int:
        """reference: TrainerGPULimit pkg/autoscaler.go:39-42."""
        return self.config.spec.worker.chips_per_worker

    def cpu_request_milli(self) -> int:
        """reference: TrainerCPURequestMilli pkg/autoscaler.go:44-47."""
        return self.config.spec.worker.resources.requests.cpu_milli

    def mem_request_mega(self) -> int:
        """reference: TrainerMemRequestMega pkg/autoscaler.go:49-52."""
        return self.config.spec.worker.resources.requests.mem_mega

    def fulfillment(self) -> float:
        """Elastic-range satisfaction in [0,1]
        (reference: Fulfillment pkg/autoscaler.go:54-64)."""
        lo = self.config.spec.worker.min_replicas
        hi = self.config.spec.worker.max_replicas
        if lo == hi:
            return 1.0
        cur = self.group.parallelism if self.group else 0
        return (cur - lo) / (hi - lo)


def elastic(j: JobState) -> bool:
    """reference: pkg/autoscaler.go:132-134."""
    return j.config.elastic()


def needs_chips(j: JobState) -> bool:
    """TPU analog of the gpu filter (reference: pkg/autoscaler.go:137-139)."""
    return j.config.need_tpu()


def sorted_jobs(js: List[JobState], *filters: Callable[[JobState], bool]) -> List[JobState]:
    """Ascending by fulfillment; ties by chips, then CPU, then memory asc
    (reference: sortedJobs + jobs.Less, pkg/autoscaler.go:103-125,175-189)."""
    out = [j for j in js if all(f(j) for f in filters)]
    out.sort(
        key=lambda j: (
            j.fulfillment(),
            j.chips_per_worker(),
            j.cpu_request_milli(),
            j.mem_request_mega(),
        )
    )
    return out


def resolve_policy(policy, j: JobState) -> topology.SlicePolicy:
    """Per-job slice legality: the string ``"auto"`` derives it from the
    job's own accelerator_type (VERDICT r1 #5 — the reference applies
    one global rule to all jobs); a callable applies to every job."""
    if policy == "auto":
        return topology.policy_for_job(
            j.config.spec.accelerator_type, j.chips_per_worker()
        )
    return policy


def _fits(r: ClusterResource, name: str, cpu: int, mem: int, chips: int) -> bool:
    return (
        cpu <= r.hosts.cpu_idle_milli.get(name, 0)
        and mem <= r.hosts.mem_free_mega.get(name, 0)
        and chips <= r.hosts.chips_free.get(name, 0)
    )


def _contiguous_window(
    r: ClusterResource, j: JobState, n: int
) -> Optional[List[str]]:
    """An index-aligned run of ``n`` hosts within ONE ICI block, each
    with capacity for one worker — the sub-slice carving rule (the new
    workers of a grow step must be ICI-reachable as a unit; the census
    carries block/index per host, resource.Hosts). Blocks in name order,
    window starts ascending: deterministic and native-twin-matched."""
    cpu, mem, chips = (
        j.cpu_request_milli(),
        j.mem_request_mega(),
        j.chips_per_worker(),
    )
    by_block: Dict[str, Dict[int, str]] = {}
    for host, block in r.hosts.ici_block.items():
        by_block.setdefault(block, {})[r.hosts.ici_index.get(host, -1)] = host
    for block in sorted(by_block):
        idxs = by_block[block]
        for start in sorted(i for i in idxs if i >= 0 and i % n == 0):
            window = [idxs.get(start + k) for k in range(n)]
            if None in window:
                continue
            if all(_fits(r, h, cpu, mem, chips) for h in window):
                return window  # type: ignore[return-value]
    return None


def search_assignable_hosts(
    r: ClusterResource, j: JobState, n: int, contiguous: bool = False
) -> Optional[List[str]]:
    """Hosts (with multiplicity) that can absorb ``n`` more workers, or
    None if they don't all fit. Generalizes the reference's single-worker
    search for multi-worker slice-policy steps
    (reference: searchAssignableNode pkg/autoscaler.go:191-199).

    With ``contiguous`` (ICI-slice jobs) and a census that carries block
    topology, steps must be aligned windows inside one block — including
    single-host steps, which must still land ON a block (a DCN-only host
    can't join an ICI slice); a census without block info falls back to
    free placement (DCN-only fleets, and the reference-parity tests).
    """
    if contiguous and r.hosts.ici_block:
        return _contiguous_window(r, j, n)
    chips = j.chips_per_worker()
    cpu = j.cpu_request_milli()
    mem = j.mem_request_mega()
    free_cpu = dict(r.hosts.cpu_idle_milli)
    free_mem = dict(r.hosts.mem_free_mega)
    free_chip = dict(r.hosts.chips_free)
    placed: List[str] = []
    for _ in range(n):
        for name in sorted(free_cpu):
            if (
                cpu <= free_cpu[name]
                and mem <= free_mem.get(name, 0)
                and chips <= free_chip.get(name, 0)
            ):
                free_cpu[name] -= cpu
                free_mem[name] = free_mem.get(name, 0) - mem
                free_chip[name] = free_chip.get(name, 0) - chips
                placed.append(name)
                break
        else:
            return None
    return placed


def scale_dry_run(
    r: ClusterResource,
    j: JobState,
    cur_diff: int,
    max_load_desired: float,
    scale_down: bool,
    policy: topology.SlicePolicy = topology.flexible,
) -> int:
    """One dry-run step for one job; mutates ``r`` to account the proposed
    delta (reference: scaleDryRun pkg/autoscaler.go:201-291; the deferred
    resource adjustment there is the ``_account`` below).

    Returns the worker delta (±k; ±1 under the flexible policy).
    """
    cpu = j.cpu_request_milli()
    mem = j.mem_request_mega()
    chips = j.chips_per_worker()
    assigned_hosts: List[str] = []

    def _account(n: int) -> int:
        # reference: the deferred func at pkg/autoscaler.go:209-217
        r.chip_limit += chips * n
        r.cpu_request_milli += cpu * n
        r.mem_request_mega += mem * n
        for host in assigned_hosts:  # one entry per added worker
            r.hosts.cpu_idle_milli[host] -= cpu
            r.hosts.mem_free_mega[host] -= mem
            r.hosts.chips_free[host] -= chips
        return n

    planned = (j.group.parallelism if j.group else 0) + cur_diff
    hi = j.config.spec.worker.max_replicas
    lo = j.config.spec.worker.min_replicas

    if scale_down:
        # ---- scale-down pass (reference: pkg/autoscaler.go:230-249) ----
        if planned > hi:
            # over max: walk down one per fixed-point iteration
            # (reference: pkg/autoscaler.go:231-234); once within reach of
            # max, land on a policy-legal count.
            if planned - 1 > hi:
                return _account(-1)
            target = topology.floor_legal(planned - 1, policy, lo, hi)
            return _account(target - planned if target != planned else -1)
        chip_over = r.chip_limit > r.chip_total * max_load_desired
        cpu_over = r.cpu_request_milli > r.cpu_total_milli * max_load_desired
        if chip_over or cpu_over:
            if planned > lo:
                target = topology.next_legal(planned, -1, policy, lo, hi)
                return _account(target - planned)
            return 0  # cannot scale down further
        return 0  # not over target load: do not try to scale up here

    # ---- scale-up pass (reference: pkg/autoscaler.go:252-291) ----
    if planned >= hi:
        # clamp back to max, landing on a policy-legal count
        target = topology.floor_legal(planned, policy, lo, hi)
        return _account(min(target, hi) - planned)

    target = topology.next_legal(planned, +1, policy, lo, hi)
    step = target - planned
    if step <= 0:
        return 0

    if r.mem_total_mega - r.mem_request_mega <= mem * step:
        return 0  # insufficient memory (reference: :259-263)
    found = search_assignable_hosts(
        r, j, step, contiguous=getattr(policy, "contiguous", False)
    )
    if found is None:
        return 0  # the whole step must fit (reference: :264-267)

    # CPU respects the load ceiling; chips scale to full (reference
    # keeps GPU unguarded by maxLoadDesired, :269-278).
    cpu_ok = r.cpu_total_milli * max_load_desired - r.cpu_request_milli >= cpu * step
    if chips > 0 and not (r.chip_total - r.chip_limit >= chips * step):
        return 0
    if not cpu_ok:
        return 0
    assigned_hosts = found  # only account hosts for a step actually taken
    return _account(step)


def scale_all_jobs_dry_run(
    js: List[JobState],
    r: ClusterResource,
    max_load_desired: float,
    policy=topology.flexible,
) -> Dict[str, int]:
    """Iterate scale-up (most starved first) then scale-down (least starved
    first) passes until a fixed point (reference: scaleAllJobsDryRun
    pkg/autoscaler.go:296-337). Mutates ``r``; callers pass a copy.
    ``policy`` is a callable applied to every job, or ``"auto"`` for
    per-job resolution from accelerator_type."""
    diff: Dict[str, int] = {}
    # policies depend only on the static spec: resolve once, not per pass
    resolved = {j.config.qualified_name: resolve_policy(policy, j) for j in js}
    while True:
        no_change = True
        ordered = sorted_jobs(js, elastic)

        def dry_run(j: JobState, is_down: bool) -> None:
            nonlocal no_change
            name = j.config.qualified_name
            additional = scale_dry_run(
                r,
                j,
                diff.get(name, 0),
                max_load_desired,
                is_down,
                resolved[name],
            )
            log.debug(
                "dry run scale job",
                name=name,
                cur_diff=diff.get(name, 0),
                additional=additional,
            )
            diff[name] = diff.get(name, 0) + additional
            if additional != 0:
                no_change = False

        for j in ordered:
            dry_run(j, False)
        for j in reversed(ordered):
            dry_run(j, True)
        if no_change:
            break
    return diff


class Autoscaler:
    """Event-driven scaling loop (reference: Autoscaler pkg/autoscaler.go:67-95).

    ``tick()`` is the synchronous unit of work (one census + plan + apply);
    ``run()`` wraps it in the 5 s ticker/event loop.
    """

    def __init__(
        self,
        cluster: Cluster,
        max_load_desired: float = 1.0,  # reference default, pkg/autoscaler.go:89
        # a callable applied to every job (default: the reference's
        # unconstrained behavior), or "auto" to derive each job's slice
        # legality from its own spec.accelerator_type
        slice_policy=topology.flexible,
        loop_seconds: float = DEFAULT_LOOP_SECONDS,
        rescale_cooldown_s: float = 0.0,
        use_native: bool = False,
    ):
        # rescale_cooldown_s damps the reference algorithm's fulfillment
        # ping-pong (jobs trading one worker back and forth every tick):
        # a job rescaled less than cooldown ago is not retargeted unless
        # some job's pods are pending. 0 reproduces reference behavior.
        # No reference analog — on TPU every retarget is a reshard stall,
        # so churn is far more expensive than on k8s.
        self.cluster = cluster
        self.max_load_desired = max_load_desired
        self.slice_policy = slice_policy
        self.loop_seconds = loop_seconds
        self.rescale_cooldown_s = rescale_cooldown_s
        # plan with the C++ core (native/scheduler) when it is buildable
        # and the policy is a built-in; silently falls back to Python
        self.use_native = use_native
        self.jobs: Dict[str, JobState] = {}
        self._gate = HysteresisGate(rescale_cooldown_s)
        self._events: "queue.Queue[Event]" = queue.Queue()
        self._stop = threading.Event()

    # -- event intake (reference: OnAdd/OnUpdate/OnDel :159-171) -----------

    def on_add(self, job: TrainingJob) -> None:
        self._events.put(Event(Event.Type.ADD, job))

    def on_update(self, job: TrainingJob) -> None:
        self._events.put(Event(Event.Type.UPDATE, job))

    def on_del(self, job: TrainingJob) -> None:
        self._events.put(Event(Event.Type.DEL, job))

    # -- state maintenance -------------------------------------------------

    def _update_job_list(self, ev: Event) -> bool:
        """reference: updateJobList pkg/autoscaler.go:383-402."""
        if ev.type in (Event.Type.ADD, Event.Type.UPDATE):
            j = JobState(config=ev.job)
            self.jobs[ev.job.qualified_name] = j
            return self._retrieve_group(j)
        elif ev.type == Event.Type.DEL:
            self.jobs.pop(ev.job.qualified_name, None)
        return True

    def _retrieve_group(self, j: JobState) -> bool:
        """reference: tryToRetrieveTrainerJobInTrainingJob :424-447."""
        if j.group is None:
            try:
                j.group = self.cluster.get_worker_group(j.config)
            except KeyError:
                log.warn("worker group not yet created", job=j.config.name)
                return False
        return True

    def _find_pending_job(self) -> bool:
        """Any job with ALL pods pending? (reference: findPendingJob :406-422)."""
        for j in self.jobs.values():
            if not self._retrieve_group(j):
                continue
            total, _, pending = self.cluster.job_pods(j.config)
            if total > 0 and total == pending:
                return True
        return False

    def _any_pending_pods(self) -> bool:
        """Any worker pod pending anywhere — the cooldown-bypass signal
        (weaker than _find_pending_job's all-pods-pending)."""
        for j in self.jobs.values():
            if not self._retrieve_group(j):
                continue
            _, _, pending = self.cluster.job_pods(j.config)
            if pending > 0:
                return True
        return False

    def _reschedulable(self, have_pending: bool) -> List[JobState]:
        """Stable jobs (all pods running), or all jobs when something is
        pending (reference: findTrainingJobsMightBeRescheduled :487-511)."""
        out = []
        for j in self.jobs.values():
            if not self._retrieve_group(j):
                continue
            total, running, _ = self.cluster.job_pods(j.config)
            if total == running or have_pending:
                out.append(j)
        return out

    # -- the scaling tick --------------------------------------------------

    def drain_events(self) -> None:
        """Fold queued job events into the tracked set
        (reference: updateJobList on eventCh receipt :453-459)."""
        while True:
            try:
                self._update_job_list(self._events.get_nowait())
            except queue.Empty:
                return

    def tick(self) -> Dict[str, int]:
        """One census→plan→apply cycle; returns the applied target map
        (reference: the loop body of Run, pkg/autoscaler.go:460-484)."""
        self.drain_events()
        try:
            r = self.cluster.inquiry_resource()
        except Exception as e:  # reference: :461-465
            log.error("inquiry_resource failed", error=str(e))
            return {}
        # refresh group snapshots so fulfillment sees current parallelism
        for j in self.jobs.values():
            try:
                j.group = self.cluster.get_worker_group(j.config)
            except KeyError:
                j.group = None

        have_pending = self._find_pending_job()
        candidates = self._reschedulable(have_pending)
        if self.rescale_cooldown_s > 0 and not self._any_pending_pods():
            candidates = [
                j for j in candidates
                if self._gate.ready(j.config.qualified_name)
            ]
        diff = None
        if self.use_native:
            from edl_tpu_torch.scheduler import native as native_sched

            resolved = [resolve_policy(self.slice_policy, j) for j in candidates]
            diff = native_sched.plan_native(
                candidates, r, self.max_load_desired, resolved
            )
        if diff is None:
            diff = scale_all_jobs_dry_run(
                candidates, r.copy(), self.max_load_desired, self.slice_policy
            )
        target = {
            name: self.jobs[name].group.parallelism + d
            for name, d in diff.items()
            if d != 0 and self.jobs.get(name) and self.jobs[name].group
        }
        if target:
            log.info("calculated scaling plan", target=target)
        self._scale_all(target)
        return target

    def _scale_all(self, target: Dict[str, int]) -> None:
        """reference: scaleAllJobs pkg/autoscaler.go:339-376."""
        for name, t in target.items():
            err: Optional[Exception] = None
            for _ in range(UPDATE_RETRIES):
                try:
                    group = self.cluster.get_worker_group(self.jobs[name].config)
                    if group.parallelism == t:
                        err = None
                        break
                    group.parallelism = t
                    self.cluster.update_worker_group(group)
                    self.jobs[name].group = group
                    self._gate.record(name)
                    accel = self.jobs[name].config.spec.accelerator_type
                    log.info(
                        "scaled job",
                        name=name,
                        target=t,
                        slice=topology.topology_name(accel, t)
                        if accel in topology.FAMILIES
                        else "",
                    )
                    err = None
                    break
                except (ConflictError, KeyError) as e:
                    err = e
            if err is not None:
                log.warn("error updating worker group", name=name, error=str(err))

    # -- loop --------------------------------------------------------------

    def run(self) -> None:
        """reference: Run pkg/autoscaler.go:451-485."""
        while not self._stop.is_set():
            try:
                self._update_job_list(self._events.get(timeout=self.loop_seconds))
            except queue.Empty:
                pass
            self.tick()

    def stop(self) -> None:
        self._stop.set()
