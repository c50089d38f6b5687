"""JobParser — defaulting, validation, and TrainingJob → child-resource plans.

L2 of the layer map. The reference parses a TrainingJob into a master
ReplicaSet + pserver ReplicaSet + trainer batch Job
(reference: pkg/jobparser.go:36-41,47-71; pkg/updater/jobparser.go:40-64).
The TPU design parses into two plans:

- ``CoordinatorPlan`` — one coordinator process (master analog; owns
  membership, barriers, the elastic data queue, reshard signaling).
- ``WorkerGroupPlan`` — the elastic worker set, parallelism starting at
  ``min_replicas`` (reference: ParseToTrainer sets Parallelism=min,
  jobparser.go:120-128).

There is no pserver plan: parameter/optimizer state lives in-mesh.

The port of ``edl_tpu/api/parser.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from edl_tpu_torch.api.job import (
    DEFAULT_ACCELERATOR,
    DEFAULT_IMAGE,
    DEFAULT_PASSES,
    DEFAULT_PORT,
    TrainingJob,
    VolumeMountSpec,
    VolumeSpec,
)


class ValidationError(ValueError):
    pass


@dataclass
class CoordinatorPlan:
    """Spec for the per-job coordinator process (replaces master RS +
    etcd sidecar, reference: pkg/jobparser.go:186-227)."""

    name: str
    namespace: str
    image: str
    port: int
    labels: Dict[str, str] = field(default_factory=dict)
    cpu_milli: int = 0
    mem_mega: int = 0
    volumes: List[VolumeSpec] = field(default_factory=list)
    volume_mounts: List[VolumeMountSpec] = field(default_factory=list)


@dataclass
class WorkerGroupPlan:
    """Spec for the elastic worker set (trainer batch Job analog,
    reference: pkg/jobparser.go:119-165)."""

    name: str
    namespace: str
    image: str
    entrypoint: str
    workspace: str
    parallelism: int
    min_replicas: int
    max_replicas: int
    chips_per_worker: int
    accelerator_type: str
    cpu_milli: int = 0
    mem_mega: int = 0
    fault_tolerant: bool = False
    passes: int = 1
    labels: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    restart_policy: str = "Never"  # reference: jobparser.go:160
    volumes: List[VolumeSpec] = field(default_factory=list)
    volume_mounts: List[VolumeMountSpec] = field(default_factory=list)


class JobParser:
    """Default parser (reference: DefaultJobParser, pkg/jobparser.go:43)."""

    def validate(self, job: TrainingJob) -> List[str]:
        """Fill defaults, enforce invariants; returns non-fatal warnings.

        Defaulting mirrors reference pkg/jobparser.go:47-65; the
        ``elastic ⇒ fault_tolerant`` rule mirrors jobparser.go:66-68.
        TPU additions: chips per worker must be a power of two (ICI
        slice legality) and an accelerator type is defaulted.
        """
        warnings: List[str] = []
        s = job.spec
        if not job.name:
            raise ValidationError("job name is required")
        if s.port == 0:
            s.port = DEFAULT_PORT
        if s.ports_num == 0:
            s.ports_num = 1
        if not s.image:
            s.image = DEFAULT_IMAGE
        if s.passes == 0:
            s.passes = DEFAULT_PASSES
        if not s.accelerator_type:
            s.accelerator_type = DEFAULT_ACCELERATOR
        w = s.worker
        if w.min_replicas <= 0:
            w.min_replicas = 1
        if w.max_replicas == 0:
            w.max_replicas = w.min_replicas
        if w.max_replicas < w.min_replicas:
            raise ValidationError(
                f"worker max_replicas ({w.max_replicas}) < min_replicas ({w.min_replicas})"
            )
        if job.elastic() and not s.fault_tolerant:
            # reference: pkg/jobparser.go:66-68
            raise ValidationError(
                "max_replicas must equal min_replicas when fault_tolerant is disabled"
            )
        chips = w.chips_per_worker
        if chips and chips & (chips - 1):
            raise ValidationError(
                f"tpu_chips per worker must be a power of two (got {chips})"
            )
        if s.pserver.min_replicas or s.pserver.max_replicas:
            warnings.append(
                "pserver group is ignored on TPU: parameter/optimizer state is "
                "sharded in-mesh (FSDP); remove spec.pserver"
            )
        if s.env:
            # keys the parser derives always win over spec.env — flag
            # the collision instead of silently dropping the user value
            shadowed = sorted(set(s.env) & set(self._derived_env(job)))
            if shadowed:
                warnings.append(
                    f"spec.env keys {shadowed} are derived by the parser "
                    "and will be overridden; set them through the spec "
                    "fields instead"
                )
        mesh_total = 1
        for v in s.mesh.axis_sizes().values():
            mesh_total *= v
        if chips and mesh_total > 1 and mesh_total % chips != 0 and chips % mesh_total:
            warnings.append(
                f"mesh plan ({mesh_total} devices) does not tile chips/worker ({chips})"
            )
        if job.elastic() and s.mesh.growth == "fsdp" and not s.checkpoint_dir:
            raise ValidationError(
                "elastic fsdp-growth jobs require spec.checkpoint_dir: state "
                "is sharded across workers, so rescale/recovery needs a "
                "shared checkpoint store"
            )
        # volumes/mounts (reference: types.go:54-56, plumbed into every
        # pod by the parsers)
        vol_names = [v.name for v in s.volumes]
        if len(vol_names) != len(set(vol_names)):
            raise ValidationError(f"duplicate volume names: {vol_names}")
        for v in s.volumes:
            if not v.name:
                raise ValidationError("volume without a name")
            if not v.source:
                raise ValidationError(f"volume {v.name!r} has no source")
        for m in s.volume_mounts:
            if m.name not in vol_names:
                raise ValidationError(
                    f"volume_mount {m.name!r} references no declared volume"
                )
            if not m.mount_path.startswith("/"):
                raise ValidationError(
                    f"volume_mount {m.name!r} mount_path must be absolute, "
                    f"got {m.mount_path!r}"
                )
        def _under_a_mount(path: str) -> bool:
            return any(
                path.startswith(m.mount_path.rstrip("/") + "/")
                or path == m.mount_path
                for m in s.volume_mounts
            )

        if s.checkpoint_dir and s.volumes and not _under_a_mount(s.checkpoint_dir):
            warnings.append(
                f"checkpoint_dir {s.checkpoint_dir!r} is not under any "
                "volume mount; workers may write to ephemeral pod storage"
            )
        if s.data_dir and s.volumes and not _under_a_mount(s.data_dir):
            warnings.append(
                f"data_dir {s.data_dir!r} is not under any volume mount; "
                "workers will find no dataset manifest at startup"
            )
        return warnings

    # -- plan builders -----------------------------------------------------

    def parse_to_coordinator(self, job: TrainingJob) -> CoordinatorPlan:
        """reference: ParseToMaster pkg/jobparser.go:186-227."""
        s = job.spec
        return CoordinatorPlan(
            name=f"{job.name}-coordinator",
            namespace=job.namespace,
            image=s.image,
            port=s.port,
            labels={"edl-job-coordinator": job.name},
            cpu_milli=s.master.resources.requests.cpu_milli,
            mem_mega=s.master.resources.requests.mem_mega,
            volumes=list(s.volumes),
            volume_mounts=list(s.volume_mounts),
        )

    def parse_to_workers(self, job: TrainingJob) -> WorkerGroupPlan:
        """reference: ParseToTrainer pkg/jobparser.go:119-165."""
        s = job.spec
        w = s.worker
        return WorkerGroupPlan(
            name=f"{job.name}-worker",
            namespace=job.namespace,
            image=s.image,
            entrypoint=w.entrypoint,
            workspace=w.workspace,
            parallelism=w.min_replicas,
            min_replicas=w.min_replicas,
            max_replicas=w.max_replicas,
            chips_per_worker=w.chips_per_worker,
            accelerator_type=s.accelerator_type,
            cpu_milli=w.resources.requests.cpu_milli,
            mem_mega=w.resources.requests.mem_mega,
            fault_tolerant=s.fault_tolerant,
            passes=s.passes,
            labels={"edl-job": job.name},
            env=self.pod_env(job),
            volumes=list(s.volumes),
            volume_mounts=list(s.volume_mounts),
        )

    def pod_env(self, job: TrainingJob) -> Dict[str, str]:
        """Env-var contract injected into every worker
        (reference: podEnv pkg/jobparser.go:263-311). TPU renames:
        EDL_* replaces PADDLE_INIT_*; the coordinator address replaces
        etcd discovery.

        ``spec.env`` rides underneath: the per-job runtime knobs the
        parser does NOT derive (EDL_MODEL, EDL_SYNC_EVERY, EDL_P2P*,
        EDL_EVAL_*, EDL_INT8_MXU, ...). Derived keys always win — a
        manifest overriding EDL_WORKERS_MIN would desync the
        autoscaler from the runtime (validate() warns on collisions).
        """
        return {**job.spec.env, **self._derived_env(job)}

    def _derived_env(self, job: TrainingJob) -> Dict[str, str]:
        """The contract keys the parser itself derives from the spec —
        the reserved set spec.env can never override."""
        s = job.spec
        return {
            "EDL_JOB_NAME": job.name,
            "EDL_NAMESPACE": job.namespace,
            "EDL_WORKERS": str(s.worker.min_replicas),
            "EDL_WORKERS_MIN": str(s.worker.min_replicas),
            "EDL_WORKERS_MAX": str(s.worker.max_replicas),
            "EDL_ENTRY": s.worker.entrypoint,
            "EDL_WORKSPACE": s.worker.workspace,
            "EDL_PORT": str(s.port),
            "EDL_CHIPS_PER_WORKER": str(s.worker.chips_per_worker),
            "EDL_ACCELERATOR": s.accelerator_type,
            "EDL_NUM_PASSES": str(s.passes),
            "EDL_FAULT_TOLERANT": "1" if s.fault_tolerant else "0",
            "EDL_MESH": s.mesh.to_mesh_string(),
            "EDL_CKPT_DIR": s.checkpoint_dir,
            "EDL_CKPT_EVERY": str(s.checkpoint_every),
            "EDL_DATA_DIR": s.data_dir,
            "EDL_COORDINATOR": s.master.coordinator_endpoint
            or f"{job.name}-coordinator:{s.port}",
        }
