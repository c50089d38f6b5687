"""Controller — watches TrainingJobs, owns per-job updaters, feeds the
autoscaler.

Unified port of the reference's two generations (SURVEY §0): the legacy
controller's watch→create→autoscale wiring
(reference: pkg/controller.go:44-161) driving the CRD updater's
lifecycle state machine (reference: pkg/updater/trainingJobUpdater.go).

The port of ``edl_tpu/controller/controller.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from edl_tpu_torch.api.job import Event, JobPhase, TrainingJob
from edl_tpu_torch.api.parser import JobParser
from edl_tpu_torch.cluster import topology
from edl_tpu_torch.cluster.fake import FakeCluster
from edl_tpu_torch.controller.updater import JobUpdater
from edl_tpu_torch.scheduler.autoscaler import Autoscaler
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("controller")


class Controller:
    """reference: New + Run, pkg/controller.go:51-76."""

    def __init__(
        self,
        cluster,
        max_load_desired: float = 0.97,  # reference flag default, cmd/edl/edl.go:19
        slice_policy: topology.SlicePolicy = topology.flexible,
        rescale_cooldown_s: float = 0.0,
        autoscaler: Optional[Autoscaler] = None,
    ):
        self.cluster = cluster
        self.parser = JobParser()
        self.autoscaler = autoscaler or Autoscaler(
            cluster,
            max_load_desired=max_load_desired,
            slice_policy=slice_policy,
            rescale_cooldown_s=rescale_cooldown_s,
        )
        self.updaters: Dict[str, JobUpdater] = {}
        # watch events land on the cluster's watch thread while the
        # updater ticker iterates on its own thread: every access to
        # the updaters map goes through this lock (found by `edl check`
        # lockset-race; pinned by test_controller concurrency test)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []
        if hasattr(cluster, "watch_jobs"):
            cluster.watch_jobs(self.handle_event)
        if hasattr(cluster, "scale_listeners"):
            cluster.scale_listeners.append(self._on_scale)

    # -- event handling (reference: onAdd/onUpdate/onDelete :110-161) ------

    def handle_event(self, ev: Event) -> None:
        if ev.type == Event.Type.ADD:
            self.on_add(ev.job)
        elif ev.type == Event.Type.UPDATE:
            self.on_update(ev.job)
        elif ev.type == Event.Type.DEL:
            self.on_delete(ev.job)

    def on_add(self, job: TrainingJob) -> None:
        """reference: onAdd parses + creates child resources and notifies
        the autoscaler (pkg/controller.go:110-148); here resource creation
        is delegated to the updater's state machine."""
        updater = JobUpdater(job, self.cluster, self.parser)
        with self._lock:
            if job.qualified_name in self.updaters:
                return
            self.updaters[job.qualified_name] = updater
        log.info("job added", job=job.qualified_name)
        updater.step()  # parse + begin creating (outside the map lock)
        self.autoscaler.on_add(job)

    def on_update(self, job: TrainingJob) -> None:
        with self._lock:
            u = self.updaters.get(job.qualified_name)
        if u is None:
            self.on_add(job)
            return
        u.job.spec = job.spec  # reference: Modify event, updater :95-97
        self.autoscaler.on_update(job)

    def on_delete(self, job: TrainingJob) -> None:
        with self._lock:
            u = self.updaters.pop(job.qualified_name, None)
        if u is not None:
            u.delete()
        self.autoscaler.on_del(job)
        log.info("job deleted", job=job.qualified_name)

    def _on_scale(self, job_name: str, new_parallelism: int) -> None:
        with self._lock:
            u = self.updaters.get(job_name)
        if u is not None:
            u.on_scale(new_parallelism)

    # -- loop --------------------------------------------------------------

    def step(self) -> None:
        """One convert pass over all updaters (the 10 s ticker analog,
        reference: trainingJobUpdater.go:471-478). Errors are isolated
        per updater: one job that fails every tick (bad manifest,
        cluster 4xx) must not starve reconciliation of the others."""
        with self._lock:
            updaters = list(self.updaters.values())
        for u in updaters:
            try:
                u.step()
            except Exception as e:
                log.error(
                    "updater step failed",
                    job=u.job.qualified_name,
                    error=str(e),
                )

    def run(self, updater_interval_s: float = 1.0) -> None:
        """Run autoscaler + updater loops in threads
        (reference: Controller.Run spawns WatchTrainingJobs +
        autoscaler.Run goroutines, pkg/controller.go:64-76)."""
        t_asc = threading.Thread(target=self.autoscaler.run, daemon=True)
        t_asc.start()
        self._threads.append(t_asc)

        def _updater_loop():
            while not self._stop.is_set():
                self.step()
                time.sleep(updater_interval_s)

        t_upd = threading.Thread(target=_updater_loop, daemon=True)
        t_upd.start()
        self._threads.append(t_upd)

    def stop(self) -> None:
        self._stop.set()
        self.autoscaler.stop()
        for t in self._threads:
            t.join(timeout=5)

    # -- convenience -------------------------------------------------------

    def phase_of(self, job_name: str) -> JobPhase:
        """job_name is the qualified name (bare name in the default
        namespace)."""
        with self._lock:
            u = self.updaters.get(job_name)
        return u.phase if u else JobPhase.NONE
