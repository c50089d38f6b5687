"""TrainingJob — the declarative job spec (L0 API types).

TPU-native redesign of the reference's TrainingJob CRD/TPR
(reference: pkg/apis/paddlepaddle/v1/types.go:36-173,
 pkg/resource/training_job.go:109-238). Differences, by design:

- ``WorkerSpec`` (the trainer analog) asks for **TPU chips per worker**
  instead of GPU limits; an ``accelerator_type`` names the slice family
  (e.g. "v5e"). The elastic range stays ``min_replicas``/``max_replicas``
  (reference: min-instance/max-instance, types.go:86-87).
- ``PserverSpec`` is accepted for spec compatibility but maps to no
  runtime process: optimizer/parameter state is sharded in-mesh
  (FSDP/ZeRO over the ``jax.sharding.Mesh``). A non-zero pserver group
  is tolerated and reported in validation warnings.
- ``MasterSpec`` becomes the **coordinator**: the process that owns the
  membership registry, barrier, task queue and reshard signaling
  (replaces the reference's master + etcd sidecar,
  reference: pkg/jobparser.go:167-227).
- ``mesh`` describes the parallelism plan (dp/fsdp/tp/pp/sp/ep axis
  sizes) — new, first-class; the reference only has pserver DP.

The port of ``edl_tpu/api/job.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from edl_tpu_torch.api.resources import ResourceRequirements, ResourceSpec

try:
    import yaml  # type: ignore

    _HAVE_YAML = True
# edl: no-lint[silent-failure] optional-dependency probe; JSON manifests work without yaml
except Exception:  # pragma: no cover
    _HAVE_YAML = False

API_VERSION = "edl-tpu.org/v1"
KIND = "TrainingJob"

DEFAULT_PORT = 7164  # reference: pkg/jobparser.go:50-51
# default image for jobs that omit spec.image (reference default image,
# jobparser.go:59-60); docker/build.sh builds this tag
DEFAULT_IMAGE = "edl-tpu/worker:latest"
DEFAULT_PASSES = 1  # reference: pkg/jobparser.go:62-63
DEFAULT_ACCELERATOR = "v5e"


class JobPhase(str, enum.Enum):
    """Job lifecycle phase (reference: pkg/apis/paddlepaddle/v1/types.go:95-106,
    plus ``SCALING`` to surface in-place reshard — new in the TPU design)."""

    NONE = ""
    CREATING = "creating"
    RUNNING = "running"
    SCALING = "scaling"
    SUCCEEDED = "succeeded"
    FAILED = "failed"

    def terminal(self) -> bool:
        return self in (JobPhase.SUCCEEDED, JobPhase.FAILED)


class ResourceState(str, enum.Enum):
    """Per-child-resource state (reference: types.go:141-148)."""

    NONE = ""
    CREATING = "creating"
    READY = "ready"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


@dataclass
class VolumeSpec:
    """A named pod volume (reference: TrainingJobSpec.Volumes,
    pkg/apis/paddlepaddle/v1/types.go:54). ``source`` is the k8s volume
    source passed through verbatim (hostPath, persistentVolumeClaim,
    emptyDir, configMap, …) — typed enough to validate, open enough to
    carry any cluster's storage."""

    name: str
    source: Dict[str, Any] = field(default_factory=dict)


@dataclass
class VolumeMountSpec:
    """Where a declared volume lands in every job pod (reference:
    TrainingJobSpec.VolumeMounts, types.go:55-56 — mounted into master,
    pserver, and trainer pods alike; here: coordinator + workers)."""

    name: str
    mount_path: str
    read_only: bool = False


@dataclass
class MasterSpec:
    """Coordinator spec (reference: MasterSpec, types.go:67-72). The
    etcd-endpoint field becomes the coordinator address."""

    coordinator_endpoint: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


@dataclass
class PserverSpec:
    """Accepted for reference-spec compatibility (types.go:75-81); the TPU
    runtime shards parameters/optimizer state in-mesh instead."""

    min_replicas: int = 0
    max_replicas: int = 0
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


# Axes over which a batch is split (each shard sees different examples);
# consumed by parallel/mesh.py. Lives here (the jax-free API layer) so
# manifest validation and mesh construction share one definition — only
# these axes may be a MeshSpec growth axis.
BATCH_AXES: tuple = ("dp", "fsdp")


@dataclass
class MeshSpec:
    """Parallelism plan: per-axis sizes of the device mesh each worker set
    trains over. 0/absent axes are squeezed. New in the TPU design (the
    reference's only strategy is pserver DP, SURVEY §2.5)."""

    dp: int = 0  # data parallel (pure replication)
    fsdp: int = 0  # fully-sharded DP (ZeRO-3 analog)
    tp: int = 0  # tensor parallel
    pp: int = 0  # pipeline parallel
    sp: int = 0  # sequence/context parallel (ring attention)
    ep: int = 0  # expert parallel (MoE)
    # which axis absorbs elastic membership change (the others keep
    # their pinned sizes across rescales); "dp" for pure replication
    # growth, "fsdp" for the flagship ZeRO-3-growth config
    growth: str = "dp"

    def axis_sizes(self) -> Dict[str, int]:
        return {
            k: v
            for k, v in (
                ("dp", self.dp),
                ("fsdp", self.fsdp),
                ("tp", self.tp),
                ("pp", self.pp),
                ("sp", self.sp),
                ("ep", self.ep),
            )
            if v > 1
        }

    def to_mesh_string(self) -> str:
        """The EDL_MESH env value (MeshPlan.parse grammar): pinned axes
        as ``axis=K`` terms plus the bare growth axis."""
        terms = [
            f"{k}={v}" for k, v in self.axis_sizes().items() if k != self.growth
        ]
        return ",".join([self.growth] + terms)


@dataclass
class WorkerSpec:
    """Elastic worker group (the trainer analog, reference:
    TrainerSpec types.go:84-92). Each worker is one host process driving
    ``tpu_chips`` chips; the elastic range is in workers."""

    entrypoint: str = ""
    workspace: str = ""
    min_replicas: int = 1
    max_replicas: int = 1
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)

    @property
    def chips_per_worker(self) -> int:
        return self.resources.limits.tpu_chips or self.resources.requests.tpu_chips


@dataclass
class TrainingJobSpec:
    """reference: TrainingJobSpec types.go:44-64."""

    image: str = ""
    host_network: bool = False
    port: int = 0
    ports_num: int = 0
    fault_tolerant: bool = False
    passes: int = 0
    accelerator_type: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    # shared checkpoint store (a mounted volume path in pods) and the
    # periodic sharded-commit cadence in steps. Required for fsdp-growth
    # jobs: a crashed peer's primary shards only survive in the last
    # committed checkpoint. 0 = commit only at reshard/stop.
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    # on-disk dataset root (runtime/shards.py manifest layout), usually
    # under a volume mount — workers then train on real files through
    # the lease queue instead of synthetic batches
    data_dir: str = ""
    # extra worker environment (the runtime's EDL_* contract beyond
    # what the parser derives: EDL_MODEL, EDL_SYNC_EVERY, EDL_P2P,
    # EDL_EVAL_DIR, EDL_INT8_MXU, ... — worker_config.py is the full
    # list). Derived contract keys always win over these (validate()
    # warns on the collision); accepts a mapping or the k8s
    # [{name, value}] list form in YAML.
    env: Dict[str, str] = field(default_factory=dict)
    # pod volumes + mounts (reference: types.go:54-56) — how real jobs
    # see datasets and checkpoint stores
    volumes: List[VolumeSpec] = field(default_factory=list)
    volume_mounts: List[VolumeMountSpec] = field(default_factory=list)
    master: MasterSpec = field(default_factory=MasterSpec)
    pserver: PserverSpec = field(default_factory=PserverSpec)
    worker: WorkerSpec = field(default_factory=WorkerSpec)


@dataclass
class ResourceStatus:
    state: ResourceState = ResourceState.NONE
    replicas: int = 0
    ready_replicas: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class TrainingJobStatus:
    """reference: TrainingJobStatus types.go:151-173."""

    phase: JobPhase = JobPhase.NONE
    reason: str = ""
    master: ResourceStatus = field(default_factory=ResourceStatus)
    worker: ResourceStatus = field(default_factory=ResourceStatus)
    parallelism: int = 0  # current worker target (trainer Job .Spec.Parallelism analog)
    reshard_count: int = 0  # elastic reshard events so far (new: observability)
    last_reshard_stall_s: float = 0.0
    # reshards that fell back to host-RAM staging (the slow path whose
    # worst case doc/reshard_stall.md bounds) — a monitor alarm signal
    reshard_fallbacks: int = 0


def _env_value(v) -> str:
    """YAML scalar -> the EDL_* contract's string form. Booleans map to
    the contract's "1"/"0" — str(False) would be "False", which e.g.
    worker_config's ``!= "0"`` / ``== "1"`` checks silently misread
    (EDL_P2P: false would leave p2p ON)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    return str(v)


def _parse_env(raw) -> Dict[str, str]:
    """spec.env from YAML: a plain mapping, or the k8s container-style
    ``[{name, value}]`` list (what users paste from pod specs — but
    ONLY that shape: ``valueFrom`` etc. are hard errors, not silent
    empty strings). Scalars stringify (``EDL_INT8_MXU: 1`` -> "1",
    booleans -> "1"/"0")."""
    if not raw:
        return {}
    if isinstance(raw, list):
        out: Dict[str, str] = {}
        for e in raw:
            if (
                not isinstance(e, dict)
                or not e.get("name")
                or set(e) - {"name", "value"}
            ):
                raise ValueError(
                    "env list entries must be exactly {name, value} "
                    f"(k8s valueFrom etc. are not supported), got {e!r}"
                )
            out[str(e["name"])] = _env_value(e.get("value", ""))
        return out
    if isinstance(raw, dict):
        return {str(k): _env_value(v) for k, v in raw.items()}
    raise ValueError(
        f"spec.env must be a mapping or a [{{name, value}}] list, "
        f"got {type(raw).__name__}"
    )


def qualify(namespace: str, name: str) -> str:
    """Qualified job identity from (namespace, name) — the one rule
    behind ``TrainingJob.qualified_name``, shared by cluster backends
    that must address updaters without holding a TrainingJob (e.g.
    scale-listener notifications)."""
    if namespace in ("", "default"):
        return name
    return f"{namespace}/{name}"


@dataclass
class TrainingJob:
    """The job object: metadata + spec + status
    (reference: types.go:36-42)."""

    name: str
    namespace: str = "default"
    spec: TrainingJobSpec = field(default_factory=TrainingJobSpec)
    status: TrainingJobStatus = field(default_factory=TrainingJobStatus)
    labels: Dict[str, str] = field(default_factory=dict)

    @property
    def qualified_name(self) -> str:
        """Collision-free identity across namespaces. Bare name in the
        default namespace (so single-namespace callers and logs stay
        readable), ``namespace/name`` elsewhere — same-named jobs in
        different namespaces must not share controller/autoscaler
        state."""
        return qualify(self.namespace, self.name)

    # -- predicates (reference: pkg/resource/training_job.go:189-207) ------

    def elastic(self) -> bool:
        """True when the worker range is elastic (min < max)."""
        return self.spec.worker.min_replicas < self.spec.worker.max_replicas

    def need_tpu(self) -> bool:
        """TPU analog of NeedGPU (reference: training_job.go:205-207)."""
        return self.spec.worker.chips_per_worker > 0

    def chips_per_worker(self) -> int:
        return self.spec.worker.chips_per_worker

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingJob":
        """Build from a parsed YAML/JSON manifest mirroring the reference's
        examplejob.yaml shape (reference: example/fit_a_line/examplejob.yaml)."""
        meta = d.get("metadata", {})
        spec_d = d.get("spec", {})
        worker_d = spec_d.get("worker", spec_d.get("trainer", {})) or {}
        pserver_d = spec_d.get("pserver", {}) or {}
        master_d = spec_d.get("master", {}) or {}
        mesh_d = spec_d.get("mesh", {}) or {}

        def _minmax(g: dict, lo_default=0, hi_default=0):
            lo = g.get("min_replicas", g.get("min-instance", lo_default))
            hi = g.get("max_replicas", g.get("max-instance", hi_default))
            return int(lo), int(hi)

        wmin, wmax = _minmax(worker_d, 1, 0)
        pmin, pmax = _minmax(pserver_d)
        mesh_fields = {f for f in MeshSpec.__dataclass_fields__}
        bad_axes = set(mesh_d) - mesh_fields
        if bad_axes:
            raise ValueError(
                f"unknown mesh axes {sorted(bad_axes)}; valid: {sorted(mesh_fields)}"
            )
        try:
            growth = str(mesh_d.get("growth", "dp"))
            mesh = MeshSpec(
                growth=growth,
                **{k: int(v) for k, v in mesh_d.items() if k != "growth"},
            )
        except (TypeError, ValueError) as e:
            raise ValueError(f"invalid mesh spec {mesh_d!r}: {e}") from e
        if mesh.growth not in BATCH_AXES:
            # only batch axes can absorb elastic membership change (see
            # MeshPlan.parse); tp/pp/sp/ep growth would silently change
            # per-process batch rows under a fixed queue chunk
            raise ValueError(
                f"mesh growth axis must be one of {BATCH_AXES}, "
                f"got {mesh.growth!r}"
            )
        if mesh.axis_sizes().get(mesh.growth):
            raise ValueError(
                f"mesh axis {mesh.growth!r} is the growth axis; its size is "
                "set by the elastic worker count, not the manifest — remove "
                f"the pinned size or change 'growth'"
            )
        spec = TrainingJobSpec(
            image=spec_d.get("image", ""),
            host_network=bool(spec_d.get("host_network", False)),
            port=int(spec_d.get("port", 0)),
            ports_num=int(spec_d.get("ports_num", 0)),
            fault_tolerant=bool(spec_d.get("fault_tolerant", False)),
            passes=int(spec_d.get("passes", worker_d.get("passes", 0))),
            accelerator_type=spec_d.get("accelerator_type", ""),
            node_selector=dict(spec_d.get("node_selector", {})),
            mesh=mesh,
            checkpoint_dir=spec_d.get("checkpoint_dir", ""),
            checkpoint_every=int(spec_d.get("checkpoint_every", 0)),
            data_dir=spec_d.get("data_dir", ""),
            env=_parse_env(spec_d.get("env")),
            volumes=[
                VolumeSpec(
                    name=v.get("name", ""),
                    source={k: val for k, val in v.items() if k != "name"},
                )
                for v in spec_d.get("volumes", []) or []
            ],
            volume_mounts=[
                VolumeMountSpec(
                    name=m.get("name", ""),
                    mount_path=m.get("mount_path", m.get("mountPath", "")),
                    read_only=bool(m.get("read_only", m.get("readOnly", False))),
                )
                for m in (
                    spec_d.get("volume_mounts", spec_d.get("volumeMounts", []))
                    or []
                )
            ],
            master=MasterSpec(
                coordinator_endpoint=master_d.get(
                    "coordinator_endpoint", master_d.get("etcd-endpoint", "")
                ),
                resources=ResourceRequirements.parse(master_d.get("resources")),
            ),
            pserver=PserverSpec(
                min_replicas=pmin,
                max_replicas=pmax,
                resources=ResourceRequirements.parse(pserver_d.get("resources")),
            ),
            worker=WorkerSpec(
                entrypoint=worker_d.get("entrypoint", ""),
                workspace=worker_d.get("workspace", ""),
                min_replicas=wmin,
                max_replicas=wmax,
                resources=ResourceRequirements.parse(worker_d.get("resources")),
            ),
        )
        return cls(
            name=meta.get("name", d.get("name", "")),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels", {})),
            spec=spec,
        )

    def to_dict(self) -> dict:
        """Canonical manifest mapping; inverse of from_dict (legacy
        reference-era aliases are normalized away)."""
        s = self.spec
        worker: dict = {
            "min_replicas": s.worker.min_replicas,
            "max_replicas": s.worker.max_replicas,
        }
        if s.worker.entrypoint:
            worker["entrypoint"] = s.worker.entrypoint
        if s.worker.workspace:
            worker["workspace"] = s.worker.workspace
        if s.worker.resources.to_dict():
            worker["resources"] = s.worker.resources.to_dict()
        spec: dict = {"worker": worker}
        if s.image:
            spec["image"] = s.image
        if s.host_network:
            spec["host_network"] = True
        if s.port:
            spec["port"] = s.port
        if s.ports_num:
            spec["ports_num"] = s.ports_num
        if s.fault_tolerant:
            spec["fault_tolerant"] = True
        if s.passes:
            spec["passes"] = s.passes
        if s.accelerator_type:
            spec["accelerator_type"] = s.accelerator_type
        if s.node_selector:
            spec["node_selector"] = dict(s.node_selector)
        mesh = {k: v for k, v in s.mesh.axis_sizes().items()}
        if s.mesh.growth != "dp":
            mesh["growth"] = s.mesh.growth
        if mesh:
            spec["mesh"] = mesh
        if s.checkpoint_dir:
            spec["checkpoint_dir"] = s.checkpoint_dir
        if s.checkpoint_every:
            spec["checkpoint_every"] = s.checkpoint_every
        if s.data_dir:
            spec["data_dir"] = s.data_dir
        if s.env:
            spec["env"] = dict(s.env)
        if s.volumes:
            spec["volumes"] = [
                {"name": v.name, **v.source} for v in s.volumes
            ]
        if s.volume_mounts:
            spec["volume_mounts"] = [
                {
                    "name": m.name,
                    "mount_path": m.mount_path,
                    **({"read_only": True} if m.read_only else {}),
                }
                for m in s.volume_mounts
            ]
        master: dict = {}
        if s.master.coordinator_endpoint:
            master["coordinator_endpoint"] = s.master.coordinator_endpoint
        if s.master.resources.to_dict():
            master["resources"] = s.master.resources.to_dict()
        if master:
            spec["master"] = master
        if s.pserver.min_replicas or s.pserver.max_replicas:
            spec["pserver"] = {
                "min_replicas": s.pserver.min_replicas,
                "max_replicas": s.pserver.max_replicas,
            }
        meta: dict = {"name": self.name, "namespace": self.namespace}
        if self.labels:
            meta["labels"] = dict(self.labels)
        return {"metadata": meta, "spec": spec}

    @classmethod
    def from_yaml(cls, text: str) -> "TrainingJob":
        if not _HAVE_YAML:  # pragma: no cover
            raise RuntimeError("pyyaml unavailable")
        data = yaml.safe_load(text)
        if not isinstance(data, dict):
            raise ValueError(
                f"manifest must be a YAML mapping, got {type(data).__name__}"
            )
        return cls.from_dict(data)

    @classmethod
    def from_yaml_file(cls, path: str) -> "TrainingJob":
        with open(path) as f:
            return cls.from_yaml(f.read())


@dataclass
class Event:
    """Controller→autoscaler/updater event
    (reference: pkg/autoscaler.go:141-152)."""

    class Type(str, enum.Enum):
        ADD = "add"
        DEL = "del"
        UPDATE = "update"
        SCALE = "scale"

    type: "Event.Type"
    job: Optional[TrainingJob] = None


__all__ = [
    "API_VERSION",
    "KIND",
    "Event",
    "JobPhase",
    "MasterSpec",
    "MeshSpec",
    "PserverSpec",
    "ResourceRequirements",
    "ResourceState",
    "ResourceStatus",
    "ResourceSpec",
    "TrainingJob",
    "TrainingJobSpec",
    "TrainingJobStatus",
    "WorkerSpec",
]
