"""Cluster interface (L1) — what the controller/autoscaler need from a fleet.

Port of the reference's Cluster wrapper over the k8s clientset
(reference: pkg/cluster.go:79-291). Two implementations ship from day
one (SURVEY §4): ``FakeCluster`` (in-memory, the test backbone — analog
of the generated fake clientset, reference: pkg/client/.../fake) and a
process-backed local cluster for end-to-end runs. A real GKE/jobset
backend plugs in behind the same interface.

The port of ``edl_tpu/cluster/base.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.api.job import TrainingJob
from edl_tpu_torch.api.parser import CoordinatorPlan, WorkerGroupPlan
from edl_tpu_torch.cluster.resource import ClusterResource


class PodPhase:
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


@dataclass
class WorkerGroup:
    """Handle on a job's elastic worker set (the trainer batch Job analog,
    reference: batchv1.Job with Spec.Parallelism)."""

    name: str
    namespace: str
    plan: WorkerGroupPlan
    parallelism: int
    resource_version: int = 0  # optimistic-concurrency token (k8s analog)
    active: int = 0
    succeeded: int = 0
    failed: int = 0


def group_job_name(group: WorkerGroup) -> str:
    """Bare name of the job a worker group belongs to — the single
    derivation rule shared by every backend's scale-listener path:
    the ``edl-job`` label when present (set by JobParser), else the
    ``<job>-worker`` naming convention."""
    labeled = group.plan.labels.get("edl-job") if group.plan else None
    if labeled:
        return labeled
    if group.name.endswith("-worker"):
        return group.name[: -len("-worker")]
    return group.name


@dataclass
class Coordinator:
    """Handle on a job's coordinator (master ReplicaSet analog)."""

    name: str
    namespace: str
    plan: CoordinatorPlan
    replicas: int = 1
    ready_replicas: int = 0
    endpoint: str = ""


class Cluster(abc.ABC):
    """reference: pkg/cluster.go:79-291."""

    # -- census ------------------------------------------------------------

    @abc.abstractmethod
    def inquiry_resource(self) -> ClusterResource:
        """Fleet totals minus non-terminated pod requests
        (reference: InquiryResource pkg/cluster.go:176-242)."""

    # -- worker group CRUD (trainer Job analog) ----------------------------

    @abc.abstractmethod
    def create_worker_group(self, plan: WorkerGroupPlan) -> WorkerGroup:
        """reference: CreateJob pkg/cluster.go:245."""

    @abc.abstractmethod
    def get_worker_group(self, job: TrainingJob) -> WorkerGroup:
        """reference: GetTrainerJob pkg/cluster.go:91."""

    @abc.abstractmethod
    def update_worker_group(self, group: WorkerGroup) -> None:
        """Retarget parallelism; raises ConflictError on a stale
        resource_version (reference: UpdateTrainerJob pkg/cluster.go:110)."""

    @abc.abstractmethod
    def delete_worker_group(self, namespace: str, name: str) -> None:
        """reference: DeleteTrainerJob pkg/cluster.go:270."""

    # -- coordinator CRUD (master ReplicaSet analog) -----------------------

    @abc.abstractmethod
    def create_coordinator(self, plan: CoordinatorPlan) -> Coordinator:
        """reference: CreateReplicaSet pkg/cluster.go:253."""

    @abc.abstractmethod
    def get_coordinator(self, namespace: str, name: str) -> Coordinator:
        """reference: GetReplicaSet pkg/cluster.go:261."""

    @abc.abstractmethod
    def delete_coordinator(self, namespace: str, name: str) -> None:
        """reference: DeleteReplicaSet pkg/cluster.go:281."""

    # -- pod census --------------------------------------------------------

    @abc.abstractmethod
    def job_pods(self, job: TrainingJob) -> Tuple[int, int, int]:
        """(total, running, pending) worker pods for the job
        (reference: JobPods pkg/cluster.go:117-136)."""


class ConflictError(RuntimeError):
    """Stale resource_version on update (k8s conflict analog)."""
