"""JobUpdater — per-job lifecycle state machine.

Unified port of the reference's TrainingJobUpdater
(reference: pkg/updater/trainingJobUpdater.go:44-481): parse →
create resources awaited-ready → running → periodic status convert →
terminal release, plus delete draining everything. Differences by
design: the awaited children are coordinator + worker group (no
pserver), the state machine is driven by explicit ``step()`` calls
(the controller owns the clock — no goroutine per job), and a
``SCALING`` phase surfaces in-flight reshards.

The port of ``edl_tpu/controller/updater.py``; it imports no torch. One
repair (ROADMAP Queue C item 11): ``step``, ``convert``,
``release_resources``, ``on_scale``, ``on_reshard_done`` and ``delete``
hold the updater's lock, and a deleted updater steps no more. The controller steps a new job's updater on the watch thread
(``Controller.on_add``) while its ticker steps the same updater, so the
reference's two steps can both create the coordinator or the worker
group (the loser raises "already exists" out of ``on_add``), and a step
racing ``delete`` can create children again after the teardown.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from edl_tpu_torch.api.job import JobPhase, ResourceState, TrainingJob
from edl_tpu_torch.api.parser import JobParser, ValidationError
from edl_tpu_torch.cluster.base import Cluster
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("updater")

CONVERT_INTERVAL_S = 10.0  # reference: convertedTimerTicker :22
CONFIRM_INTERVAL_S = 5.0  # reference: confirmResourceTicker :23
CREATE_TIMEOUT_S = 600.0  # await-ready bound (reference polls forever)


class JobUpdater:
    """Drives one TrainingJob none→creating→running→succeeded/failed.

    ``step()`` advances the machine; call it from the controller loop
    (reference: start() goroutine + tickers,
    trainingJobUpdater.go:453-481).
    """

    def __init__(
        self,
        job: TrainingJob,
        cluster: Cluster,
        parser: Optional[JobParser] = None,
        create_timeout_s: float = CREATE_TIMEOUT_S,
    ):
        self.job = job
        self.cluster = cluster
        self.parser = parser or JobParser()
        self.create_timeout_s = create_timeout_s
        self.warnings: List[str] = []
        self._create_deadline: Optional[float] = None
        self._released = False
        # True while an in-process runtime (runtime/local.py) drives this
        # job and will report reshard completion itself; when False the
        # control plane infers completion from pod convergence.
        self.runtime_attached = False
        self._scaling_since: Optional[float] = None
        # the watch thread (on_add's first step, delete), the ticker
        # (step) and the autoscaler (on_scale) drive one updater: its
        # transitions serialize on this lock (reentrant: convert() ends a
        # reshard through on_reshard_done)
        self._lock = threading.RLock()
        self._deleted = False

    # -- phase helpers -----------------------------------------------------

    @property
    def phase(self) -> JobPhase:
        return self.job.status.phase

    def _set_phase(self, phase: JobPhase, reason: str = "") -> None:
        if self.job.status.phase != phase:
            log.info(
                "phase transition",
                job=self.job.name,
                prev=self.job.status.phase.value or "none",
                next=phase.value,
                reason=reason,
            )
        self.job.status.phase = phase
        self.job.status.reason = reason

    # -- lifecycle ---------------------------------------------------------

    def step(self) -> JobPhase:
        """Advance one notch. Safe to call repeatedly at any cadence,
        from any thread; a no-op after ``delete``."""
        with self._lock:
            if self._deleted:
                return self.phase
            if self.phase == JobPhase.NONE:
                self._parse()
            if self.phase == JobPhase.CREATING:
                self._create()
            if self.phase in (JobPhase.RUNNING, JobPhase.SCALING):
                self._convert()
            if self.phase.terminal():
                self._release_resources()
            return self.phase

    def _parse(self) -> None:
        """reference: parseTrainingJob via InitResource :417-429."""
        try:
            self.warnings = self.parser.validate(self.job)
        except ValidationError as e:
            self._set_phase(JobPhase.FAILED, f"validation error: {e}")
            return
        self._set_phase(JobPhase.CREATING)

    def _create(self) -> None:
        """Create coordinator (fault-tolerant jobs only, like the
        reference's master, trainingJobUpdater.go:283-287), await it
        ready, then create the worker group
        (reference: createTrainingJob :282-293, createResource :209-257)."""
        ns = self.job.namespace
        if self._create_deadline is None:
            self._create_deadline = time.monotonic() + self.create_timeout_s

        if self.job.spec.fault_tolerant:
            cplan = self.parser.parse_to_coordinator(self.job)
            try:
                coord = self.cluster.get_coordinator(ns, cplan.name)
                if coord.endpoint.endswith(":0"):
                    # Deployment exists but the paired Service is
                    # missing (a prior create died between the two
                    # POSTs): re-run create, which is idempotent per
                    # resource and fills in whichever half is absent.
                    coord = self.cluster.create_coordinator(cplan)
            except KeyError:
                coord = self.cluster.create_coordinator(cplan)
            self.job.status.master.state = ResourceState.CREATING
            if coord.ready_replicas < coord.replicas:
                if time.monotonic() > self._create_deadline:
                    self._set_phase(JobPhase.FAILED, "coordinator never became ready")
                return  # await ready; retry on next step
            self.job.status.master.state = ResourceState.READY
            self.job.status.master.ready_replicas = coord.ready_replicas

        wplan = self.parser.parse_to_workers(self.job)
        try:
            group = self.cluster.get_worker_group(self.job)
        except KeyError:
            group = self.cluster.create_worker_group(wplan)
        self.job.status.worker.state = ResourceState.CREATING
        self.job.status.worker.replicas = group.parallelism
        self.job.status.parallelism = group.parallelism
        # reference: createTrainer flips phase to running immediately :259-280
        self._set_phase(JobPhase.RUNNING)

    def convert(self) -> None:
        """Fold worker-group status into the job phase
        (reference: Convert + GetStatus :343-414)."""
        with self._lock:
            self._convert()

    def _convert(self) -> None:
        try:
            group = self.cluster.get_worker_group(self.job)
        except KeyError:
            self._set_phase(JobPhase.FAILED, "worker group disappeared")
            return
        st = self.job.status
        st.worker.replicas = group.parallelism
        st.worker.ready_replicas = group.active
        st.worker.succeeded = group.succeeded
        st.worker.failed = group.failed
        st.parallelism = group.parallelism

        # Without an attached runtime to call on_reshard_done, the control
        # plane marks a rescale complete once the pod set converges on the
        # new target (stall then measures pod churn, not array resharding).
        if (
            self.phase == JobPhase.SCALING
            and not self.runtime_attached
            and group.parallelism > 0
            and group.active == group.parallelism
        ):
            since = self._scaling_since
            self.on_reshard_done(0.0 if since is None else time.monotonic() - since)

        if self.job.spec.fault_tolerant:
            # FT jobs fail only when ALL workers are dead with none
            # succeeded (reference :361-370 compares cumulative Failed
            # against Parallelism, which false-fails a healthy job after
            # replacements or a scale-down; live-count semantics instead).
            if group.failed > 0 and group.active == 0 and group.succeeded == 0:
                self._set_phase(JobPhase.FAILED, "all workers have failed")
            elif group.succeeded > 0 and group.active == 0:
                self._set_phase(JobPhase.SUCCEEDED, "success")
        else:
            # non-FT jobs fail on ANY worker failure (reference :371-380)
            if group.failed > 0:
                self._set_phase(JobPhase.FAILED, "at least one worker failed")
            elif group.succeeded >= group.parallelism and group.active == 0:
                self._set_phase(JobPhase.SUCCEEDED, "all workers have succeeded")

    def on_scale(self, new_parallelism: int) -> None:
        """Autoscaler retarget notification: surface the reshard window
        (new in the TPU design; the reference has no visible state for
        an in-flight rescale)."""
        with self._lock:
            if self.phase == JobPhase.RUNNING:
                self._set_phase(JobPhase.SCALING,
                                f"resharding to {new_parallelism}")
                self.job.status.reshard_count += 1
                self._scaling_since = time.monotonic()

    def on_reshard_done(self, stall_s: float, fallback: bool = False) -> None:
        with self._lock:
            if self.phase == JobPhase.SCALING:
                self.job.status.last_reshard_stall_s = stall_s
                if fallback:
                    self.job.status.reshard_fallbacks += 1
                self._scaling_since = None
                self._set_phase(JobPhase.RUNNING)

    def release_resources(self) -> None:
        """Terminal-state release: coordinator goes away, the worker group
        record remains for status (reference: Convert's release of
        master/pserver :400-412 — trainer Job is already done)."""
        with self._lock:
            self._release_resources()

    def _release_resources(self) -> None:
        if self._released:
            return
        ns = self.job.namespace
        try:
            self.cluster.delete_coordinator(ns, f"{self.job.name}-coordinator")
        except KeyError:
            pass
        self._released = True

    def delete(self) -> None:
        """Full teardown on job deletion
        (reference: deleteTrainingJob :156-207)."""
        with self._lock:
            self._deleted = True
            ns = self.job.namespace
            self.cluster.delete_worker_group(ns, f"{self.job.name}-worker")
            try:
                self.cluster.delete_coordinator(
                    ns, f"{self.job.name}-coordinator")
            except KeyError:
                pass
            self._released = True
        log.info("deleted training job", job=self.job.name)
