"""FakeCluster — in-memory fleet, the test backbone.

The analog of the reference's generated fake clientset + object tracker
(reference: pkg/client/clientset/versioned/fake/clientset_generated.go:30-50),
which the reference ships but never uses; here it is first-class
(SURVEY §4: "the intended harness for controller/updater integration
tests"). Simulates hosts with TPU chips, pod placement (first-fit),
pending pods under contention, and an API-server-style TrainingJob
store with watch callbacks.

The port of ``edl_tpu/cluster/fake.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from edl_tpu_torch.api.job import Event, TrainingJob, qualify
from edl_tpu_torch.api.parser import CoordinatorPlan, WorkerGroupPlan
from edl_tpu_torch.cluster.base import (
    Cluster,
    ConflictError,
    Coordinator,
    PodPhase,
    WorkerGroup,
    group_job_name,
)
from edl_tpu_torch.cluster.resource import ClusterResource, Hosts
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("fakecluster")


@dataclass
class FakeHost:
    """One host VM attached to ``chips`` TPU chips. ``ici_block`` +
    ``ici_index`` place the host on a physical slice (see
    resource.Hosts); leave defaults for DCN-only hosts."""

    name: str
    cpu_milli: int
    mem_mega: int
    chips: int = 0
    accelerator: str = "v5e"
    ici_block: str = ""
    ici_index: int = -1


@dataclass
class FakePod:
    name: str
    namespace: str
    job_name: str
    role: str  # "worker" | "coordinator" | "external"
    cpu_milli: int
    mem_mega: int
    chips: int
    phase: str = PodPhase.PENDING
    host: Optional[str] = None
    index: int = 0


class FakeCluster(Cluster):
    """In-memory Cluster + TrainingJob store + scheduler-free pod placer."""

    def __init__(self, hosts: Optional[List[FakeHost]] = None):
        self._lock = threading.RLock()
        self.hosts: Dict[str, FakeHost] = {h.name: h for h in (hosts or [])}
        self.pods: Dict[str, FakePod] = {}
        self.groups: Dict[Tuple[str, str], WorkerGroup] = {}
        self.coordinators: Dict[Tuple[str, str], Coordinator] = {}
        self.jobs: Dict[Tuple[str, str], TrainingJob] = {}
        self._watchers: List[Callable[[Event], None]] = []
        self._uid = itertools.count()
        # hooks fired on worker-set membership change, used by the elastic
        # runtime to trigger resharding (no reference analog: the reference
        # relies on k8s killing/creating pods and etcd membership).
        self.scale_listeners: List[Callable[[str, int], None]] = []

    # ------------------------------------------------------------------
    # TrainingJob store (API-server stand-in; reference: k8s API server)
    # ------------------------------------------------------------------

    def watch_jobs(self, cb: Callable[[Event], None]) -> None:
        """reference: WatchTrainingJobs informer, pkg/controller.go:79-108."""
        with self._lock:
            self._watchers.append(cb)

    def submit_job(self, job: TrainingJob) -> None:
        with self._lock:
            key = (job.namespace, job.name)
            is_new = key not in self.jobs
            self.jobs[key] = job
            watchers = list(self._watchers)
        ev = Event(Event.Type.ADD if is_new else Event.Type.UPDATE, job)
        for cb in watchers:
            cb(ev)

    def delete_job(self, namespace: str, name: str) -> None:
        with self._lock:
            job = self.jobs.pop((namespace, name), None)
            watchers = list(self._watchers)
        if job is not None:
            for cb in watchers:
                cb(Event(Event.Type.DEL, job))

    def list_jobs(self) -> List[TrainingJob]:
        with self._lock:
            return list(self.jobs.values())

    # ------------------------------------------------------------------
    # Census
    # ------------------------------------------------------------------

    def inquiry_resource(self) -> ClusterResource:
        """reference: InquiryResource pkg/cluster.go:176-242 — totals from
        host allocatable, requests from non-terminated pods, per-host idle
        maps subtract only *placed* pods (pending pods have no host)."""
        with self._lock:
            r = ClusterResource()
            for h in self.hosts.values():
                r.cpu_total_milli += h.cpu_milli
                r.mem_total_mega += h.mem_mega
                r.chip_total += h.chips
            hosts = Hosts(
                cpu_idle_milli={h.name: h.cpu_milli for h in self.hosts.values()},
                mem_free_mega={h.name: h.mem_mega for h in self.hosts.values()},
                chips_free={h.name: h.chips for h in self.hosts.values()},
                ici_block={
                    h.name: h.ici_block
                    for h in self.hosts.values()
                    if h.ici_block
                },
                ici_index={
                    h.name: h.ici_index
                    for h in self.hosts.values()
                    if h.ici_block
                },
            )
            for p in self.pods.values():
                if p.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                    continue
                r.cpu_request_milli += p.cpu_milli
                r.cpu_limit_milli += p.cpu_milli
                r.mem_request_mega += p.mem_mega
                r.mem_limit_mega += p.mem_mega
                r.chip_request += p.chips
                r.chip_limit += p.chips
                if p.host is not None:
                    hosts.cpu_idle_milli[p.host] -= p.cpu_milli
                    hosts.mem_free_mega[p.host] -= p.mem_mega
                    hosts.chips_free[p.host] -= p.chips
            r.hosts = hosts
            return r

    # ------------------------------------------------------------------
    # Worker groups
    # ------------------------------------------------------------------

    def create_worker_group(self, plan: WorkerGroupPlan) -> WorkerGroup:
        with self._lock:
            key = (plan.namespace, plan.name)
            if key in self.groups:
                raise RuntimeError(f"worker group {key} already exists")
            g = WorkerGroup(
                name=plan.name,
                namespace=plan.namespace,
                plan=plan,
                parallelism=plan.parallelism,
            )
            self.groups[key] = g
        self.reconcile()
        return g

    def get_worker_group(self, job: TrainingJob) -> WorkerGroup:
        return self.get_worker_group_by_name(job.namespace, f"{job.name}-worker")

    def get_worker_group_by_name(self, namespace: str, name: str) -> WorkerGroup:
        with self._lock:
            g = self.groups.get((namespace, name))
            if g is None:
                raise KeyError(f"worker group {namespace}/{name} not found")
            # active is computed live from pods (k8s Job .Status.Active
            # analog); succeeded/failed are cumulative counters.
            active = sum(
                1
                for p in self.pods.values()
                if p.namespace == namespace
                and self._group_name_of(p) == name
                and p.phase == PodPhase.RUNNING
            )
            return WorkerGroup(
                name=g.name,
                namespace=g.namespace,
                plan=g.plan,
                parallelism=g.parallelism,
                resource_version=g.resource_version,
                active=active,
                succeeded=g.succeeded,
                failed=g.failed,
            )

    def update_worker_group(self, group: WorkerGroup) -> None:
        fire = None
        with self._lock:
            key = (group.namespace, group.name)
            cur = self.groups.get(key)
            if cur is None:
                raise KeyError(f"worker group {key} not found")
            if group.resource_version != cur.resource_version:
                raise ConflictError(
                    f"stale resource_version {group.resource_version} != {cur.resource_version}"
                )
            if group.parallelism != cur.parallelism:
                # qualified name: scale listeners address updaters keyed
                # by it (bare names alias across namespaces)
                fire = (
                    qualify(group.namespace, group_job_name(cur)),
                    group.parallelism,
                )
            cur.parallelism = group.parallelism
            cur.resource_version += 1
            listeners = list(self.scale_listeners)
        self.reconcile()
        if fire:
            for cb in listeners:
                cb(*fire)

    def delete_worker_group(self, namespace: str, name: str) -> None:
        with self._lock:
            self.groups.pop((namespace, name), None)
            for pname in [
                p.name
                for p in self.pods.values()
                if p.namespace == namespace and self._group_name_of(p) == name
            ]:
                self._release(self.pods.pop(pname))

    # ------------------------------------------------------------------
    # Coordinators
    # ------------------------------------------------------------------

    def create_coordinator(self, plan: CoordinatorPlan) -> Coordinator:
        with self._lock:
            key = (plan.namespace, plan.name)
            if key in self.coordinators:
                raise RuntimeError(f"coordinator {key} already exists")
            c = Coordinator(
                name=plan.name,
                namespace=plan.namespace,
                plan=plan,
                endpoint=f"{plan.name}:{plan.port}",
            )
            self.coordinators[key] = c
        self.reconcile()
        return c

    def get_coordinator(self, namespace: str, name: str) -> Coordinator:
        with self._lock:
            c = self.coordinators.get((namespace, name))
            if c is None:
                raise KeyError(f"coordinator {namespace}/{name} not found")
            return replace(c)  # snapshot, like get_worker_group

    def delete_coordinator(self, namespace: str, name: str) -> None:
        with self._lock:
            self.coordinators.pop((namespace, name), None)
            pod = self.pods.pop(f"{namespace}/{name}-0", None)
            if pod:
                self._release(pod)

    # ------------------------------------------------------------------
    # Pod census + fault injection
    # ------------------------------------------------------------------

    def job_pods(self, job: TrainingJob) -> Tuple[int, int, int]:
        with self._lock:
            total = running = pending = 0
            for p in self.pods.values():
                if p.job_name == job.name and p.role == "worker":
                    total += 1
                    if p.phase == PodPhase.RUNNING:
                        running += 1
                    elif p.phase == PodPhase.PENDING:
                        pending += 1
            return total, running, pending

    def add_external_pod(
        self, name: str, cpu_milli: int, mem_mega: int, host: Optional[str] = None
    ) -> None:
        """Contention filler (the nginx workload analog,
        reference: example/fit_a_line/nginx.yaml). With ``host`` the pod is
        pinned there (running immediately); otherwise it is placed
        first-fit like any pending pod."""
        with self._lock:
            if host is not None and host not in self.hosts:
                raise KeyError(f"unknown host {host!r}")
            pod = FakePod(
                name=name,
                namespace="default",
                job_name="",
                role="external",
                cpu_milli=cpu_milli,
                mem_mega=mem_mega,
                chips=0,
            )
            if host is not None:
                pod.host = host
                pod.phase = PodPhase.RUNNING
            self.pods[name] = pod
        self.reconcile()

    def remove_host(self, name: str) -> None:
        """Host failure: the host leaves the fleet and every pod on it
        dies (the TPU-slice-preemption analog)."""
        with self._lock:
            if name not in self.hosts:
                raise KeyError(name)
            del self.hosts[name]
            for p in self.pods.values():
                if p.host == name and p.phase == PodPhase.RUNNING:
                    p.phase = PodPhase.FAILED
                    p.host = None
                    g = self.groups.get((p.namespace, self._group_name_of(p)))
                    if g is not None:
                        g.failed += 1

    def kill_pod(self, name: str) -> None:
        """Fault injection: mark a pod failed and free its host."""
        with self._lock:
            p = self.pods.get(name)
            if p is None:
                raise KeyError(name)
            p.phase = PodPhase.FAILED
            key = (p.namespace, self._group_name_of(p))
            g = self.groups.get(key)
            if g is not None:
                g.failed += 1

    def finish_workers(self, namespace: str, group_name: str, success: bool = True):
        """Drive a worker group to completion (test helper)."""
        with self._lock:
            g = self.groups[(namespace, group_name)]
            for p in self.pods.values():
                if p.namespace == namespace and self._group_name_of(p) == group_name:
                    if p.phase in (PodPhase.RUNNING, PodPhase.PENDING):
                        p.phase = PodPhase.SUCCEEDED if success else PodPhase.FAILED
                        if success:
                            g.succeeded += 1
                        else:
                            g.failed += 1
            g.active = 0

    # ------------------------------------------------------------------
    # Reconciliation (k8s Job/RS controllers + kube-scheduler stand-in)
    # ------------------------------------------------------------------

    @staticmethod
    def _group_name_of(p: FakePod) -> str:
        return p.name.rsplit("/", 1)[-1].rsplit("-", 1)[0]

    def reconcile(self) -> None:
        """Create/delete pods to match group parallelism, then place
        pending pods first-fit (reference: the external k8s Job controller
        + scheduler, SURVEY §3.2/§3.3 'external')."""
        with self._lock:
            for (ns, gname), g in self.groups.items():
                if g.succeeded > 0:
                    continue  # completed groups are never resurrected
                live = sorted(
                    (
                        p
                        for p in self.pods.values()
                        if p.namespace == ns
                        and self._group_name_of(p) == gname
                        and p.phase in (PodPhase.PENDING, PodPhase.RUNNING)
                    ),
                    key=lambda p: p.index,
                )
                # scale down: delete highest-index pods first
                while len(live) > g.parallelism:
                    victim = live.pop()
                    self._release(self.pods.pop(victim.name))
                # scale up: create pending pods at fresh indices (terminated
                # pods keep their records and names, like k8s)
                used = {
                    p.index
                    for p in self.pods.values()
                    if p.namespace == ns and self._group_name_of(p) == gname
                }
                idx = 0
                while len(live) < g.parallelism:
                    while idx in used:
                        idx += 1
                    pod = FakePod(
                        name=f"{ns}/{gname}-{idx}",
                        namespace=ns,
                        job_name=g.plan.labels.get("edl-job", gname),
                        role="worker",
                        cpu_milli=g.plan.cpu_milli,
                        mem_mega=g.plan.mem_mega,
                        chips=g.plan.chips_per_worker,
                        index=idx,
                    )
                    self.pods[pod.name] = pod
                    live.append(pod)
                    used.add(idx)
            for (ns, cname), c in self.coordinators.items():
                pname = f"{ns}/{cname}-0"
                existing = self.pods.get(pname)
                # a dead coordinator pod is replaced (ReplicaSet semantics),
                # unlike terminated worker pods which keep their records
                if existing is None or existing.phase in (
                    PodPhase.FAILED,
                    PodPhase.SUCCEEDED,
                ):
                    self.pods[pname] = FakePod(
                        name=pname,
                        namespace=ns,
                        job_name=c.plan.labels.get("edl-job-coordinator", cname),
                        role="coordinator",
                        cpu_milli=c.plan.cpu_milli,
                        mem_mega=c.plan.mem_mega,
                        chips=0,
                    )
            self._place_locked()
            # refresh group/coordinator status counts
            for (ns, gname), g in self.groups.items():
                g.active = sum(
                    1
                    for p in self.pods.values()
                    if p.namespace == ns
                    and self._group_name_of(p) == gname
                    and p.phase == PodPhase.RUNNING
                )
            for (ns, cname), c in self.coordinators.items():
                p = self.pods.get(f"{ns}/{cname}-0")
                c.ready_replicas = 1 if p and p.phase == PodPhase.RUNNING else 0

    def _place_locked(self) -> None:
        free_cpu = {h.name: h.cpu_milli for h in self.hosts.values()}
        free_mem = {h.name: h.mem_mega for h in self.hosts.values()}
        free_chip = {h.name: h.chips for h in self.hosts.values()}
        for p in self.pods.values():
            if p.host is not None and p.phase == PodPhase.RUNNING:
                free_cpu[p.host] -= p.cpu_milli
                free_mem[p.host] -= p.mem_mega
                free_chip[p.host] -= p.chips
        for p in sorted(self.pods.values(), key=lambda p: p.name):
            if p.phase != PodPhase.PENDING:
                continue
            for hname in sorted(self.hosts):
                if (
                    free_cpu[hname] >= p.cpu_milli
                    and free_mem[hname] >= p.mem_mega
                    and free_chip[hname] >= p.chips
                ):
                    p.host = hname
                    p.phase = PodPhase.RUNNING
                    free_cpu[hname] -= p.cpu_milli
                    free_mem[hname] -= p.mem_mega
                    free_chip[hname] -= p.chips
                    break

    def _release(self, pod: FakePod) -> None:
        pod.host = None
        pod.phase = PodPhase.FAILED
