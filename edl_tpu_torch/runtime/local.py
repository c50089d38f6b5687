"""LocalJobRunner — the port of ``edl_tpu/runtime/local.py``: the
minimum end-to-end slice, one submitted TrainingJob trained over the
process pool.

It binds the control plane (controller, updater, autoscaler over a
cluster backend) to the elastic runtime (``runtime/elastic.
ElasticTrainer``): the autoscaler's retargets become in-place reshards
at the next step boundary, and each reshard's stall flows back into the
job's status (the reference's pod entrypoint + Paddle runtime,
docker/paddle_k8s start_new_trainer:121-143).

The reference is one process. Here every rank of the pool
(``utils/platform.ProcessPool``) constructs a runner over the same
``TrainingJob`` and makes the same calls; the controller and its
cluster live on the pool's first rank alone (the others pass
``controller=None``). At each step boundary, before a pending rescale
is applied, the first rank's pending retarget and its live worker count
are broadcast over the pool (``collectives.broadcast_object``), so a
retarget the autoscaler makes between two ``train_steps`` calls, or a
membership change ``sync_membership`` sees, reshards every rank at the
same step. The updater's ``on_reshard_done``, ``finish_workers`` and
``controller.step()`` run on the first rank. A world of one process
with no process group is the reference's runner.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from edl_tpu_torch.api.job import TrainingJob
from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.runtime.data import ElasticDataQueue
from edl_tpu_torch.runtime.elastic import (ElasticTrainer, ReshardEvent,
                                           TrainReport)
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("localrun")


class LocalJobRunner:
    """Drive one submitted TrainingJob's training loop over the pool;
    every rank constructs one (the controller on the pool's first rank,
    None on the others)."""

    def __init__(
        self,
        controller,
        job: TrainingJob,
        loss_fn: Callable,
        tx,
        init_params: Any,
        chips_per_worker: Optional[int] = None,
        per_chip_batch: int = 32,
        param_pspecs=None,
        devices=None,
        sync_every: int = 1,
        make_loss: Optional[Callable] = None,
        device=None,
    ):
        self.controller = controller
        self.job = job
        self.trainer = ElasticTrainer(
            loss_fn,
            tx,
            mesh_spec=job.spec.mesh,
            chips_per_worker=chips_per_worker
            if chips_per_worker is not None
            else max(job.chips_per_worker(), 1),
            per_chip_batch=per_chip_batch,
            param_pspecs=param_pspecs,
            devices=devices,
            on_reshard=self._reshard_done,
            sync_every=sync_every,
            make_loss=make_loss,
            device=device,
            agree_target=self._agree,
        )
        self.pool = self.trainer.pool_group
        if (self.pool.rank == 0) != (controller is not None):
            raise ValueError(
                "LocalJobRunner: the controller lives on the pool's first "
                "rank, and only there")
        self.live_workers: Optional[int] = None
        # autoscaler retarget -> in-place reshard at next step boundary
        self._attached = False
        n_workers = None
        if controller is not None:
            cluster = controller.cluster
            n_workers = cluster.get_worker_group(job).parallelism
            if hasattr(cluster, "scale_listeners"):
                cluster.scale_listeners.append(self._on_scale)
                self._attached = True
            u = controller.updaters.get(job.qualified_name)
            if u is not None:
                u.runtime_attached = True  # this runner reports stalls
        n_workers = coll.broadcast_object(n_workers, 0, self.pool)
        self.trainer.start(init_params, n_workers=n_workers)

    def detach(self) -> None:
        """Stop receiving scale events (called when the run completes, so
        a finished runner is neither retargeted nor kept alive)."""
        if self.controller is None:
            return
        if self._attached:
            try:
                self.controller.cluster.scale_listeners.remove(self._on_scale)
            except ValueError:
                pass
            self._attached = False
        u = self.controller.updaters.get(self.job.qualified_name)
        if u is not None:
            u.runtime_attached = False

    def _on_scale(self, job_name: str, parallelism: int) -> None:
        if job_name == self.job.qualified_name:
            self.trainer.request_rescale(parallelism)

    def _reshard_done(self, ev: ReshardEvent) -> None:
        if self.controller is None:
            return
        u = self.controller.updaters.get(self.job.qualified_name)
        if u is not None:
            u.on_reshard_done(ev.stall_s, fallback=ev.fallback)

    def _live(self) -> Optional[int]:
        try:
            return self.controller.cluster.get_worker_group(self.job).active
        except KeyError:
            return None

    def _agree(self, pending: Optional[int]) -> Optional[int]:
        """The step boundary's agreement: the pool's first rank's pending
        target (and live worker count) on every rank."""
        if self.pool.trivial:
            if self.controller is not None:
                self.live_workers = self._live()
            return pending
        live = self._live() if self.controller is not None else None
        pending, self.live_workers = coll.broadcast_object(
            (pending, live), 0, self.pool)
        return pending

    def sync_membership(self) -> None:
        """Reshard down to the live worker count when members die without
        a retarget (failure detection; the coordinator-heartbeat analog of
        Paddle's etcd membership — reference: train_ft.py:105-114
        use_etcd=True). The scheduler's target may still include a
        pending replacement; training proceeds with who's alive. The
        first rank reads the cluster; the target reaches every rank at
        the next step boundary."""
        if self.controller is None:
            return
        live = self._live()
        if live is not None and 0 < live != self.trainer.n_workers:
            log.info("membership change", live=live,
                     workers=self.trainer.n_workers)
            self.trainer.request_rescale(live)

    def run(
        self,
        data_fn: Callable[[int], Any],
        n_steps: Optional[int] = None,
        queue: Optional[ElasticDataQueue] = None,
    ) -> TrainReport:
        """Train until ``n_steps`` or (with a queue) until the data queue
        drains; then mark the worker group complete so the updater's
        convert() lands the job in SUCCEEDED. Every rank's queue sees
        the same calls, so they drain at the same step."""
        try:
            if n_steps is not None:
                report = self.trainer.train_steps(data_fn, n_steps)
            else:
                if queue is None:
                    raise ValueError("need n_steps or a queue")
                report = self.trainer.report
                while not queue.done():
                    self.sync_membership()
                    report = self.trainer.train_steps(data_fn, 1)
            if self.controller is not None:
                cluster = self.controller.cluster
                if hasattr(cluster, "finish_workers"):
                    cluster.finish_workers(
                        self.job.namespace, f"{self.job.name}-worker")
                self.controller.step()
        finally:
            self.detach()
        return report
