"""Kubernetes cluster backend — the real-fleet implementation of the
L1 Cluster interface.

Port of the reference's client-go wrapper (reference:
pkg/cluster.go:79-291) without the generated clientset: a minimal REST
client over the Kubernetes API (stdlib urllib; no kubernetes package
dependency) plus the resource mapping:

  TrainingJob CRD (deploy/crd.yaml)  <- job source (TPR analog,
                                        reference: k8s/thirdpartyresource.yaml)
  worker group  -> batch/v1 Job with Spec.Parallelism
                                       (reference: ParseToTrainer target,
                                        pkg/jobparser.go:119-165)
  coordinator   -> apps/v1 Deployment + Service
                                       (master ReplicaSet + etcd sidecar analog,
                                        reference: pkg/jobparser.go:186-227)
  census        -> nodes allocatable minus non-terminated pod requests
                                       (reference: InquiryResource
                                        pkg/cluster.go:176-242), with TPU
                                        chips (`google.com/tpu`) replacing
                                        the GPU trio

Everything here is exercised in CI against the in-memory API server in
tests/fake_kube.py (the fake-clientset analog, reference:
pkg/client/clientset/versioned/fake).

The port of ``edl_tpu/cluster/kube.py``, unchanged in behaviour; it imports
no torch. The pods it creates run the port's modules
(``edl_tpu_torch.runtime.worker_main``,
``edl_tpu_torch.runtime.coordinator_main``); the chip resource key and the
node label stay the reference's data.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from edl_tpu_torch.api.job import TrainingJob, qualify
from edl_tpu_torch.api.parser import CoordinatorPlan, WorkerGroupPlan
from edl_tpu_torch.api.resources import chip_count, cpu_milli, mem_mega
from edl_tpu_torch.cluster.base import (
    Cluster,
    ConflictError,
    Coordinator,
    WorkerGroup,
    group_job_name,
)
from edl_tpu_torch.cluster.resource import ClusterResource, Hosts
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("kube")

TJ_GROUP = "edl-tpu.org"
TJ_VERSION = "v1"
TJ_PLURAL = "trainingjobs"

# GKE exposes TPU chips as an extended resource on TPU node pools
CHIP_RESOURCE_KEY = "google.com/tpu"
TPU_ACCELERATOR_NODE_LABEL = "cloud.google.com/gke-tpu-accelerator"

SA_TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
SA_CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


class KubeApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class KubeApi:
    """Minimal typed-enough REST client (the clientset analog,
    reference: pkg/client/clientset/versioned/clientset.go:96)."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_path: Optional[str] = None,
        timeout_s: float = 10.0,
        insecure_skip_verify: bool = False,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        if self.base_url.startswith("https"):
            if insecure_skip_verify:
                # explicit opt-out only — never silently, since the
                # bearer token rides this channel
                self._ssl = ssl.create_default_context()
                self._ssl.check_hostname = False
                self._ssl.verify_mode = ssl.CERT_NONE
            elif ca_path and os.path.exists(ca_path):
                self._ssl = ssl.create_default_context(cafile=ca_path)
            else:  # system trust store
                self._ssl = ssl.create_default_context()
        else:
            self._ssl = None

    @classmethod
    def from_env(cls) -> "KubeApi":
        """In-cluster config (service-account token) or EDL_KUBE_URL
        (reference: rest.InClusterConfig | BuildConfigFromFlags,
        cmd/edl/edl.go:31-36)."""
        url = os.environ.get("EDL_KUBE_URL")
        if url:
            return cls(
                url,
                token=os.environ.get("EDL_KUBE_TOKEN"),
                ca_path=os.environ.get("EDL_KUBE_CA"),
                insecure_skip_verify=os.environ.get("EDL_KUBE_INSECURE") == "1",
            )
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "no EDL_KUBE_URL and not in-cluster "
                "(KUBERNETES_SERVICE_HOST unset)"
            )
        token = None
        if os.path.exists(SA_TOKEN_PATH):
            with open(SA_TOKEN_PATH) as f:
                token = f.read().strip()
        return cls(f"https://{host}:{port}", token=token, ca_path=SA_CA_PATH)

    def _build_request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        params: Optional[Dict[str, str]] = None,
        content_type: str = "application/json",
    ) -> Tuple[str, urllib.request.Request]:
        """One place for URL/params encoding, Accept, auth — shared by
        the unary verbs and the streaming watch so they cannot drift."""
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return url, req

    def request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        params: Optional[Dict[str, str]] = None,
        content_type: str = "application/json",
    ) -> dict:
        url, req = self._build_request(method, path, body, params, content_type)
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout_s, context=self._ssl
            ) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            raise KubeApiError(e.code, e.read().decode(errors="replace")) from e
        except urllib.error.URLError as e:  # connection refused/reset, DNS
            raise KubeApiError(0, f"{method} {url}: {e.reason}") from e
        return json.loads(raw) if raw else {}

    # conventional verbs ---------------------------------------------------

    def get(self, path: str, params=None) -> dict:
        return self.request("GET", path, params=params)

    def post(self, path: str, body: dict) -> dict:
        return self.request("POST", path, body=body)

    def put(self, path: str, body: dict) -> dict:
        return self.request("PUT", path, body=body)

    def merge_patch(self, path: str, body: dict) -> dict:
        return self.request(
            "PATCH", path, body=body, content_type="application/merge-patch+json"
        )

    def delete(self, path: str, params=None) -> dict:
        return self.request("DELETE", path, params=params)

    def watch(self, path: str, resource_version: Optional[str] = None,
              timeout_s: float = 30.0, conn_holder: Optional[list] = None):
        """Streaming watch: yields decoded watch events (``{"type":
        "ADDED"|"MODIFIED"|"DELETED"|..., "object": {...}}``) from a
        ``watch=true`` request held open for ``timeout_s`` (the
        informer transport, reference: cache.NewInformer
        pkg/controller.go:83-104). Returns when the server closes the
        stream (watch window expired) — the caller re-watches from the
        last seen resourceVersion. Connection errors raise
        KubeApiError."""
        params = {
            "watch": "true",
            "timeoutSeconds": str(max(1, int(timeout_s))),
            # without this a real API server never sends BOOKMARK
            # events, so the resume-point advance during quiet periods
            # (handled in the event loop) would only ever exercise
            # against the test fake
            "allowWatchBookmarks": "true",
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        url, req = self._build_request("GET", path, params=params)
        try:
            with urllib.request.urlopen(
                req, timeout=timeout_s + 10, context=self._ssl
            ) as resp:
                if conn_holder is not None:
                    # exposes the live response so the owner can close
                    # the socket to interrupt a blocked read (shutdown
                    # must not wait out the watch window)
                    conn_holder.append(resp)
                # control returns to the caller BEFORE the first blocked
                # read, so it can abort a connection opened after its
                # shutdown began
                yield {"type": "SYNC"}
                for line in resp:
                    line = line.strip()
                    if line:
                        yield json.loads(line)
                    else:
                        # blank-line heartbeat: surface it so the
                        # caller can check its stop flag on idle streams
                        yield {"type": "HEARTBEAT"}
        except urllib.error.HTTPError as e:
            raise KubeApiError(e.code, e.read().decode(errors="replace")) from e
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise KubeApiError(0, f"WATCH {url}: {e}") from e


def _job_path(namespace: str, name: str = "") -> str:
    p = f"/apis/batch/v1/namespaces/{namespace}/jobs"
    return f"{p}/{name}" if name else p


def _deploy_path(namespace: str, name: str = "") -> str:
    p = f"/apis/apps/v1/namespaces/{namespace}/deployments"
    return f"{p}/{name}" if name else p


def _svc_path(namespace: str, name: str = "") -> str:
    p = f"/api/v1/namespaces/{namespace}/services"
    return f"{p}/{name}" if name else p


def _tj_path(namespace: str, name: str = "", subresource: str = "") -> str:
    p = f"/apis/{TJ_GROUP}/{TJ_VERSION}/namespaces/{namespace}/{TJ_PLURAL}"
    if name:
        p = f"{p}/{name}"
        if subresource:
            p = f"{p}/{subresource}"
    return p


def _volumes_block(plan) -> Tuple[list, list]:
    """(pod volumes, container volumeMounts) from a plan's volume specs
    (reference: Volumes/VolumeMounts plumbed into every pod template,
    pkg/apis/paddlepaddle/v1/types.go:54-56)."""
    vols = [{"name": v.name, **v.source} for v in plan.volumes]
    mounts = [
        {
            "name": m.name,
            "mountPath": m.mount_path,
            **({"readOnly": True} if m.read_only else {}),
        }
        for m in plan.volume_mounts
    ]
    return vols, mounts


def _resources_block(cpu_m: int, mem_m: int, chips: int) -> dict:
    req: Dict[str, object] = {}
    if cpu_m:
        req["cpu"] = f"{cpu_m}m"
    if mem_m:
        req["memory"] = f"{mem_m}Mi"
    limits: Dict[str, object] = {}
    if chips:
        # chips are exclusive: request == limit (reference: GPU handling,
        # pkg/cluster.go:34-37 limit-accounted)
        req[CHIP_RESOURCE_KEY] = chips
        limits[CHIP_RESOURCE_KEY] = chips
    out = {}
    if req:
        out["requests"] = req
    if limits:
        out["limits"] = limits
    return out


class KubeCluster(Cluster):
    """reference: pkg/cluster.go:79-291, over the real API server."""

    def __init__(self, api: KubeApi, worker_image: str = "",
                 coordinator_image: str = ""):
        self.api = api
        # deployment-time overrides for jobs that left spec.image at the
        # built-in default (validate() fills DEFAULT_IMAGE before plans
        # are built, so "" never reaches a plan)
        self.worker_image = worker_image
        self.coordinator_image = coordinator_image or worker_image
        # notified (job_name, new_parallelism) after a successful
        # retarget, so updaters can surface the SCALING phase (same hook
        # FakeCluster exposes; consumed by Controller._on_scale)
        self.scale_listeners: List[Callable[[str, int], None]] = []

    # -- census ------------------------------------------------------------

    def inquiry_resource(self) -> ClusterResource:
        """reference: InquiryResource pkg/cluster.go:176-242 — node
        allocatable totals, minus requests of non-terminated pods,
        per-host idle maps for placement."""
        r = ClusterResource()
        node_list = self.api.get("/api/v1/nodes")
        for node in node_list.get("items", []):
            name = node["metadata"]["name"]
            alloc = node.get("status", {}).get("allocatable", {})
            cpu = cpu_milli(alloc.get("cpu", 0))
            mem = mem_mega(alloc.get("memory", 0))
            chips = chip_count(alloc.get(CHIP_RESOURCE_KEY, 0))
            r.cpu_total_milli += cpu
            r.mem_total_mega += mem
            r.chip_total += chips
            r.hosts.cpu_idle_milli[name] = cpu
            r.hosts.mem_free_mega[name] = mem
            r.hosts.chips_free[name] = chips

        # all non-terminated pods, cluster-wide (reference notes the same
        # full scan as inefficient, pkg/cluster.go:197)
        pods = self.api.get(
            "/api/v1/pods",
            params={
                "fieldSelector": "status.phase!=Succeeded,status.phase!=Failed"
            },
        )
        for pod in pods.get("items", []):
            node_name = pod.get("spec", {}).get("nodeName", "")
            for c in pod.get("spec", {}).get("containers", []):
                res = c.get("resources", {})
                req = res.get("requests", {})
                lim = res.get("limits", {})
                cpu = cpu_milli(req.get("cpu", 0))
                mem = mem_mega(req.get("memory", 0))
                chips = chip_count(
                    lim.get(CHIP_RESOURCE_KEY, req.get(CHIP_RESOURCE_KEY, 0))
                )
                r.cpu_request_milli += cpu
                r.cpu_limit_milli += cpu_milli(lim.get("cpu", 0))
                r.mem_request_mega += mem
                r.mem_limit_mega += mem_mega(lim.get("memory", 0))
                r.chip_request += chips
                r.chip_limit += chips
                if node_name in r.hosts.cpu_idle_milli:
                    r.hosts.cpu_idle_milli[node_name] -= cpu
                    r.hosts.mem_free_mega[node_name] -= mem
                    r.hosts.chips_free[node_name] -= chips
        return r

    def _image_for(self, plan_image: str, override: str) -> str:
        from edl_tpu_torch.api.job import DEFAULT_IMAGE

        if override and plan_image in ("", DEFAULT_IMAGE):
            return override
        return plan_image or override

    # -- worker group (batch/v1 Job, reference: CreateJob :245) ------------

    def _job_manifest(self, plan: WorkerGroupPlan) -> dict:
        env = [{"name": k, "value": v} for k, v in sorted(plan.env.items())]
        node_selector = {}
        if plan.accelerator_type:
            node_selector[TPU_ACCELERATOR_NODE_LABEL] = plan.accelerator_type
        vols, mounts = _volumes_block(plan)
        return {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {
                "name": plan.name,
                "namespace": plan.namespace,
                "labels": dict(plan.labels),
            },
            "spec": {
                "parallelism": plan.parallelism,
                # FT jobs tolerate up to `workers` pod failures; non-FT
                # none (reference: check_failed_cnt docker/paddle_k8s:34-42)
                "backoffLimit": plan.max_replicas if plan.fault_tolerant else 0,
                "template": {
                    "metadata": {"labels": dict(plan.labels)},
                    "spec": {
                        "restartPolicy": plan.restart_policy,
                        "nodeSelector": node_selector,
                        **({"volumes": vols} if vols else {}),
                        "containers": [
                            {
                                "name": "worker",
                                "image": self._image_for(
                                    plan.image, self.worker_image
                                ),
                                "command": [
                                    "python", "-m",
                                    "edl_tpu_torch.runtime.worker_main",
                                ],
                                "env": env,
                                **(
                                    {"volumeMounts": mounts} if mounts else {}
                                ),
                                "resources": _resources_block(
                                    plan.cpu_milli,
                                    plan.mem_mega,
                                    plan.chips_per_worker,
                                ),
                            }
                        ],
                    },
                },
            },
        }

    def create_worker_group(self, plan: WorkerGroupPlan) -> WorkerGroup:
        obj = self.api.post(_job_path(plan.namespace), self._job_manifest(plan))
        return self._to_group(obj, plan)

    def _to_group(self, obj: dict, plan: Optional[WorkerGroupPlan] = None
                  ) -> WorkerGroup:
        meta, spec = obj["metadata"], obj.get("spec", {})
        status = obj.get("status", {})
        return WorkerGroup(
            name=meta["name"],
            namespace=meta["namespace"],
            plan=plan,
            parallelism=int(spec.get("parallelism", 0)),
            resource_version=int(meta.get("resourceVersion", "0")),
            active=int(status.get("active", 0) or 0),
            succeeded=int(status.get("succeeded", 0) or 0),
            failed=int(status.get("failed", 0) or 0),
        )

    def get_worker_group(self, job: TrainingJob) -> WorkerGroup:
        try:
            obj = self.api.get(_job_path(job.namespace, f"{job.name}-worker"))
        except KubeApiError as e:
            if e.status == 404:  # KeyError is the interface's missing signal
                raise KeyError(f"worker group {job.name}-worker") from e
            raise
        return self._to_group(obj)

    def update_worker_group(self, group: WorkerGroup) -> None:
        """Retarget parallelism with an optimistic-concurrency
        precondition: a merge patch carrying metadata.resourceVersion is
        rejected with 409 when stale (reference: UpdateTrainerJob
        pkg/cluster.go:110 + the retry loop pkg/autoscaler.go:346-370)."""
        try:
            self.api.merge_patch(
                _job_path(group.namespace, group.name),
                {
                    "metadata": {
                        "resourceVersion": str(group.resource_version)
                    },
                    "spec": {"parallelism": group.parallelism},
                },
            )
        except KubeApiError as e:
            if e.status == 409:
                raise ConflictError(str(e)) from e
            raise
        # scale listeners address updaters, which are keyed by the
        # qualified name — a bare name would silently miss jobs outside
        # the default namespace (and alias same-named jobs across
        # namespaces)
        qualified = qualify(group.namespace, group_job_name(group))
        for listener in list(self.scale_listeners):
            listener(qualified, group.parallelism)

    def delete_worker_group(self, namespace: str, name: str) -> None:
        try:
            self.api.delete(
                _job_path(namespace, name),
                params={"propagationPolicy": "Background"},
            )
        except KubeApiError as e:
            if e.status != 404:  # idempotent, like FakeCluster
                raise

    # -- coordinator (apps/v1 Deployment + Service,
    #    master RS analog, reference: CreateReplicaSet :253) ---------------

    def create_coordinator(self, plan: CoordinatorPlan) -> Coordinator:
        vols, mounts = _volumes_block(plan)
        manifest = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": plan.name,
                "namespace": plan.namespace,
                "labels": dict(plan.labels),
            },
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": dict(plan.labels)},
                "template": {
                    "metadata": {"labels": dict(plan.labels)},
                    "spec": {
                        **({"volumes": vols} if vols else {}),
                        "containers": [
                            {
                                "name": "coordinator",
                                "image": self._image_for(
                                    plan.image, self.coordinator_image
                                ),
                                "command": [
                                    "python", "-m",
                                    "edl_tpu_torch.runtime.coordinator_main",
                                    "--port", str(plan.port),
                                ],
                                "ports": [{"containerPort": plan.port}],
                                **(
                                    {"volumeMounts": mounts} if mounts else {}
                                ),
                                "resources": _resources_block(
                                    plan.cpu_milli, plan.mem_mega, 0
                                ),
                            }
                        ],
                    },
                },
            },
        }
        try:
            obj = self.api.post(_deploy_path(plan.namespace), manifest)
        except KubeApiError as e:
            if e.status != 409:
                raise
            # Deployment survives from a half-finished prior attempt
            # (e.g. the Service POST failed mid-create); fall through
            # and repair the Service below.
            obj = self.api.get(_deploy_path(plan.namespace, plan.name))
        # stable DNS name for worker discovery (etcd-lookup analog,
        # reference: docker/paddle_k8s:125-132 locates master by label)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": plan.name,
                "namespace": plan.namespace,
                "labels": dict(plan.labels),
            },
            "spec": {
                "selector": dict(plan.labels),
                "ports": [{"port": plan.port, "targetPort": plan.port}],
            },
        }
        try:
            self.api.post(_svc_path(plan.namespace), svc)
        except KubeApiError as e:
            if e.status != 409:  # already exists from a prior attempt
                raise
        return self._to_coordinator(obj, plan)

    def _to_coordinator(self, obj: dict, plan: Optional[CoordinatorPlan] = None
                        ) -> Coordinator:
        meta = obj["metadata"]
        status = obj.get("status", {})
        port = plan.port if plan else 0
        return Coordinator(
            name=meta["name"],
            namespace=meta["namespace"],
            plan=plan,
            replicas=int(obj.get("spec", {}).get("replicas", 1)),
            ready_replicas=int(status.get("readyReplicas", 0) or 0),
            endpoint=f"{meta['name']}.{meta['namespace']}.svc:{port}",
        )

    def get_coordinator(self, namespace: str, name: str) -> Coordinator:
        try:
            obj = self.api.get(_deploy_path(namespace, name))
        except KubeApiError as e:
            if e.status == 404:
                raise KeyError(f"coordinator {namespace}/{name}") from e
            raise
        # recover the port from the paired Service (plan is not persisted)
        port = 0
        try:
            svc = self.api.get(_svc_path(namespace, name))
            ports = svc.get("spec", {}).get("ports", [])
            port = int(ports[0]["port"]) if ports else 0
        except KubeApiError:
            pass
        coord = self._to_coordinator(obj)
        coord.endpoint = f"{name}.{namespace}.svc:{port}"
        return coord

    def delete_coordinator(self, namespace: str, name: str) -> None:
        for path in (
            _deploy_path(namespace, name),
            _svc_path(namespace, name),
        ):
            try:
                self.api.delete(path, params={"propagationPolicy": "Background"})
            except KubeApiError as e:
                if e.status != 404:  # idempotent, like FakeCluster
                    raise

    # -- pod census (reference: JobPods pkg/cluster.go:117-136) ------------

    def job_pods(self, job: TrainingJob) -> Tuple[int, int, int]:
        pods = self.api.get(
            f"/api/v1/namespaces/{job.namespace}/pods",
            params={"labelSelector": f"edl-job={job.name}"},
        )
        total = running = pending = 0
        for pod in pods.get("items", []):
            phase = pod.get("status", {}).get("phase", "Pending")
            terminating = bool(pod["metadata"].get("deletionTimestamp"))
            total += 1
            if phase == "Running" and not terminating:
                running += 1
            elif phase == "Pending":
                pending += 1
        return total, running, pending

    # -- TrainingJob CRD source (reference: WatchTrainingJobs
    #    pkg/controller.go:79-108, poll-based) -----------------------------

    def list_training_jobs(self, namespace: str = "") -> List[TrainingJob]:
        return self.list_training_jobs_with_broken(namespace)[0]

    def training_job_list_path(self, namespace: str = "") -> str:
        return (
            _tj_path(namespace)
            if namespace
            else f"/apis/{TJ_GROUP}/{TJ_VERSION}/{TJ_PLURAL}"
        )

    def list_training_jobs_with_broken(
        self, namespace: str = ""
    ) -> Tuple[List[TrainingJob], List[Tuple[str, str]]]:
        """List CRs, also returning the (namespace, name) keys of items
        that exist but failed to parse. The watch source needs those:
        an unparseable CR (schema drift, a bad kubectl edit) must read
        as "still present, currently unreadable" — if it were simply
        omitted, the poll diff would report a deletion and the
        controller would tear down the live job over a parse error."""
        jobs, broken, _ = self.list_training_jobs_resumable(namespace)
        return jobs, broken

    def list_training_jobs_resumable(
        self, namespace: str = ""
    ) -> Tuple[List[TrainingJob], List[Tuple[str, str]], Optional[str]]:
        """As above, plus the list's resourceVersion — the resume point
        a watch starts from."""
        doc = self.api.get(self.training_job_list_path(namespace))
        out: List[TrainingJob] = []
        broken: List[Tuple[str, str]] = []
        for item in doc.get("items", []):
            meta = item.get("metadata", {})
            try:
                out.append(TrainingJob.from_dict(item))
            except Exception as e:
                broken.append(
                    (meta.get("namespace", "default"), meta.get("name", ""))
                )
                log.error(
                    "unparseable TrainingJob (keeping existing state)",
                    name=meta.get("name"),
                    error=str(e),
                )
        return out, broken, doc.get("metadata", {}).get("resourceVersion")

    def update_training_job_status(self, job: TrainingJob) -> None:
        """Publish observed status to the CRD status subresource
        (reference: updateCRDStatus pkg/updater/trainingJobUpdater.go:295)."""
        st = job.status
        self.api.merge_patch(
            _tj_path(job.namespace, job.name, "status"),
            {
                "status": {
                    "phase": st.phase.value,
                    "reason": st.reason,
                    "parallelism": st.parallelism,
                    "reshard_count": st.reshard_count,
                    "last_reshard_stall_s": st.last_reshard_stall_s,
                    "reshard_fallbacks": st.reshard_fallbacks,
                    "worker": {
                        "state": st.worker.state.value,
                        "replicas": st.worker.replicas,
                        "ready_replicas": st.worker.ready_replicas,
                        "succeeded": st.worker.succeeded,
                        "failed": st.worker.failed,
                    },
                    "master": {
                        "state": st.master.state.value,
                        "replicas": st.master.replicas,
                        "ready_replicas": st.master.ready_replicas,
                    },
                }
            },
        )


class KubeJobSource:
    """TrainingJob informer: a streaming ``watch=true`` connection with
    resourceVersion resume (reference: cache.NewInformer in
    pkg/controller.go:79-108), consumed tick-wise through ``poll()``.

    The first poll (and any poll after the watch breaks) does a FULL
    list diff — that is also the recovery path for a 410 Gone or an
    apiserver hiccup — then (re)starts a background watch thread that
    queues events. Healthy steady state costs zero LIST calls per tick:
    O(changes), not O(jobs), per 5 s.
    ``watch=False`` pins the pure poll-diff mode."""

    def __init__(
        self,
        cluster: KubeCluster,
        namespace: str = "",
        watch: bool = True,
        watch_timeout_s: float = 30.0,
    ):
        self.cluster = cluster
        self.namespace = namespace
        self.watch = watch
        self.watch_timeout_s = watch_timeout_s
        self._seen: Dict[Tuple[str, str], TrainingJob] = {}
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._rv: Optional[str] = None
        self._stop = False
        self._conn: list = []  # live watch response, for interrupting

    # -- watch plumbing ----------------------------------------------------

    def _watch_healthy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _watch_loop(self) -> None:
        path = self.cluster.training_job_list_path(self.namespace)
        # _stop is a monotonic bool close() flips to interrupt this loop
        # (worst case: one extra watch cycle); _conn/_rv are owned by
        # this thread, close() only pokes _conn to break a blocked read
        # edl: no-lint[lockset-race]
        while not self._stop:
            try:
                # edl: no-lint[lockset-race] _conn cleared by its owning thread; see loop-head note
                del self._conn[:]
                for ev in self.cluster.api.watch(
                    path, resource_version=self._rv,
                    timeout_s=self.watch_timeout_s,
                    conn_holder=self._conn,
                ):
                    if ev.get("type") in ("SYNC", "HEARTBEAT"):
                        if self._stop:
                            return
                        continue
                    if ev.get("type") == "BOOKMARK":
                        # progress marker, not a change: advance the
                        # resume point so a reconnect after a quiet
                        # period does not replay (or 410 on) history —
                        # never queue it as an object event
                        rv = (
                            ev.get("object", {})
                            .get("metadata", {})
                            .get("resourceVersion")
                        )
                        if rv:
                            with self._lock:
                                self._rv = rv
                        continue
                    if ev.get("type") == "ERROR":
                        # e.g. 410 Gone: the resume point expired —
                        # die; the next poll() relists and restarts us
                        raise KubeApiError(410, str(ev.get("object")))
                    with self._lock:
                        self._events.append(ev)
                        rv = (
                            ev.get("object", {})
                            .get("metadata", {})
                            .get("resourceVersion")
                        )
                        if rv:
                            self._rv = rv
                    if self._stop:
                        return
                # clean EOF: the server closed the watch window —
                # re-watch from the last seen resourceVersion
            except Exception as e:
                if self._stop:
                    return  # close() interrupted the read: clean exit
                log.warn(
                    "watch stream broke; falling back to list diff",
                    error=str(e),
                )
                return  # dead thread signals poll() to relist

    def close(self) -> None:
        self._stop = True
        for resp in self._conn:
            try:  # interrupt a read blocked on an idle stream
                resp.close()
            # edl: no-lint[silent-failure] interrupting a blocked watch read; a already-dead stream is the success case
            except Exception:
                pass

    # -- tick API ----------------------------------------------------------

    def poll(
        self,
        on_add: Callable[[TrainingJob], None],
        on_update: Callable[[TrainingJob], None],
        on_delete: Callable[[TrainingJob], None],
    ) -> None:
        if self.watch and self._watch_healthy():
            self._apply_events(on_add, on_update, on_delete)
            return
        self._relist(on_add, on_update, on_delete)
        if self.watch and not self._stop:
            with self._lock:
                self._events.clear()  # relist already reflected these
            self._thread = threading.Thread(
                target=self._watch_loop, name="edl-tj-watch", daemon=True
            )
            self._thread.start()

    def _relist(self, on_add, on_update, on_delete) -> None:
        jobs, broken, rv = self.cluster.list_training_jobs_resumable(
            self.namespace
        )
        self._rv = rv
        current = {(j.namespace, j.name): j for j in jobs}
        # An unparseable CR is present but unreadable: keep its last
        # good state so it neither fires a spurious delete (tearing
        # down the live job) nor a spurious update.
        for key in broken:
            if key in self._seen and key not in current:
                current[key] = self._seen[key]
        for key in sorted(set(current) - set(self._seen)):
            on_add(current[key])
        for key in sorted(set(current) & set(self._seen)):
            if current[key].spec != self._seen[key].spec:
                on_update(current[key])
        for key in sorted(set(self._seen) - set(current)):
            on_delete(self._seen[key])
        self._seen = current

    def _apply_events(self, on_add, on_update, on_delete) -> None:
        with self._lock:
            events, self._events = self._events, []
        for ev in events:
            obj = ev.get("object", {})
            meta = obj.get("metadata", {})
            key = (meta.get("namespace", "default"), meta.get("name", ""))
            if ev.get("type") == "DELETED":
                if key in self._seen:
                    on_delete(self._seen.pop(key))
                continue
            try:
                job = TrainingJob.from_dict(obj)
            except Exception as e:
                # same retention rule as the list path: unreadable is
                # not deleted; keep the last good state
                log.error(
                    "unparseable TrainingJob event (keeping state)",
                    name=meta.get("name"),
                    error=str(e),
                )
                continue
            prev = self._seen.get(key)
            self._seen[key] = job
            if prev is None:
                on_add(job)
            elif job.spec != prev.spec:
                on_update(job)
