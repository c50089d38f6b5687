"""Worker configuration — the EDL_* environment contract. A copy of
``edl_tpu/runtime/worker_config.py``: the same fields, defaults and env
names. The port's worker reads ``local_devices`` as the device rule of
:func:`edl_tpu_torch.parallel.mesh.process_device` (0 = the card, 1 =
the CPU) and raises for a mesh other than dp
(:mod:`edl_tpu_torch.runtime.worker_main`).

The contract itself is the TPU analog of the reference's PADDLE_INIT_*
env injection (pkg/jobparser.go:263-311), documented field by field
below.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

# --------------------------------------------------------------------------
# config


@dataclass
class WorkerConfig:
    job: str
    worker_id: str
    coord_host: str
    coord_port: int
    min_workers: int
    max_workers: int
    fault_tolerant: bool
    model: str = "linreg"
    # elastic mesh string (MeshPlan.parse): "dp" | "fsdp" | "fsdp,tp=2" …
    # — one growth axis absorbs membership change, fixed axes survive it
    mesh: str = "dp"
    local_devices: int = 0  # 0: the card; 1: the CPU; >1 raises (2b)
    per_device_batch: int = 32
    n_samples: int = 4096
    passes: int = 1
    lease_timeout_s: float = 16.0
    member_ttl_s: float = 10.0
    ckpt_dir: str = ""
    # periodic sharded-checkpoint cadence in steps (0 = only at
    # reshard/stop). REQUIRED for crash recovery on state no single
    # process can snapshot (fsdp): a SIGKILL'd peer takes its primary
    # shards with it, so survivors roll back to the last commit.
    ckpt_every: int = 0
    # how long the commit leader waits for every member's shard write
    # before abandoning the manifest (size with shard bytes / storage
    # bandwidth: multi-GB FSDP shards on shared storage need minutes)
    ckpt_commit_timeout_s: float = 300.0
    seed: int = 0
    vocab: int = 4096  # ctr/llama hash/token space (small for tests)
    emb: int = 0  # ctr embedding dim override (0 = model default)
    seq_len: int = 64  # llama sequence length
    # on-disk dataset (runtime/shards.py manifest dir, usually a mounted
    # volume). When set, leased tasks read REAL rows from shard files
    # instead of synthesizing them, and n_samples comes from the
    # manifest (reference: pre-baked RecordIO shards,
    # example/fit_a_line/Dockerfile:1-8).
    data_dir: str = ""
    rendezvous_timeout_s: float = 120.0
    step_sleep_s: float = 0.0  # throttle (tests: keeps jobs scalable mid-run)
    # servable export root: the commit leader writes a params-only,
    # dtype-cast artifact at every checkpoint commit and at stop
    # (reference save_inference_model, example/ctr/ctr/train.py:169-180)
    export_dir: str = ""
    export_dtype: str = "bfloat16"
    # delayed-sync DP: K local steps per dp group between cross-group
    # averages (trainer.LocalSyncStepper; the --async_mode analog,
    # reference example/ctr/ctr/train.py:75-79). 1 = fully synchronous.
    # Requires a dp-only mesh. Crash semantics: grouped state cannot be
    # snapshotted across a membership change, so a SIGKILL'd peer rolls
    # the job back to the last committed checkpoint (cadence:
    # ckpt_every) — graceful reshards/stops merge first and lose nothing.
    sync_every: int = 1
    # peer-to-peer state redistribution (shard_server.py): workers serve
    # their host-RAM snapshots over TCP; a reshard restores owner-
    # changing shards worker-to-worker across the drain window instead
    # of round-tripping through shared storage, and departing workers
    # linger (bounded) until the new world confirms restore. The data
    # plane for a migration to a DISJOINT worker set.
    p2p: bool = True
    p2p_linger_s: float = 20.0
    # held-out eval split (runtime/shards.py dataset dir): the commit
    # leader evaluates every published export against it and publishes
    # eval_metric in KV — the AUC-in-the-train-loop analog (reference:
    # example/ctr/ctr/train.py:161-167). Requires export_dir and a
    # workload that defines eval_fn.
    eval_dir: str = ""
    # eval resource bounds: the held-out split is CAPPED
    # (not the whole dir into leader RAM), and EDL_EVAL_DEVICE=cpu
    # moves the forward passes off the accelerator so eval never
    # contends with the training step loop for HBM.
    eval_max_rows: int = 4096
    eval_device: str = ""
    # llama/moe workloads: run the projection (and MoE expert) matmuls
    # on the MXU's double-rate int8 path (ops/int8_matmul.py — dynamic
    # absmax both operands, STE gradients; +12% flagship throughput,
    # loss tracks bf16 within noise, doc/design.md "Int8 MXU
    # training"). Exports and checkpoints are unaffected: weights at
    # rest stay dense.
    int8_mxu: bool = False
    # with int8_mxu: keep wgrad on the bf16 MXU path while fwd/dgrad
    # stay int8 (gradients are heavy-tailed; one outlier
    # crushes a whole contraction slice's absmax resolution, and the
    # weight-update noise compounds over runs far longer than the
    # measured loss-parity window). ~1/6 of the 2x rate win for an
    # update path whose error is bf16 rounding, not quantization.
    int8_wgrad_bf16: bool = False
    # telemetry (edl_tpu_torch/obs): EDL_METRICS_PORT >= 0 starts the HTTP
    # exporter (/metrics Prometheus text, /trace chrome-trace JSON,
    # /healthz) on that port (0 = ephemeral; the bound port is
    # published in coordinator KV at {job}/metrics_addr/{worker} so
    # the top verb can find it). -1 = no exporter.
    metrics_port: int = -1
    # cadence of metric-snapshot pushes into coordinator KV
    # ({job}/metrics/{worker}, with the event, span and clock windows)
    # that the coordinator's fleet /metrics, /events and /trace read
    # (runtime/coordinator_main.py --metrics-port, obs/fleet.py). 0 = no
    # pushes. Matches the reference collector's 10 s census period.
    metrics_push_s: float = 10.0
    # EDL_TSDB_DIR: record this worker's registry snapshot into an
    # on-disk metric history (obs/tsdb.py) on the push cadence — zero
    # new RPCs, the pusher already holds the snapshot. Served on the
    # exporter's /history and replayable with `edl watch DIR`. Setting
    # it also arms the memledger crosscheck on the same cadence
    # (edl_hbm_crosscheck_drift_bytes). "" = off.
    tsdb_dir: str = ""
    # TPU slice this host belongs to (multi-slice topology). -1 =
    # unknown: the mesh build falls back to the hardware's own
    # ``device.slice_index`` (real multislice TPU exposes it). When set
    # (launcher/controller placement, or GKE's MEGASCALE_SLICE_ID), the
    # worker publishes it in coordinator KV so EVERY peer can order the
    # global device list slice-major at reshard — dp/pp cross slices
    # over DCN, fsdp/sp/ep/tp stay inside one slice's ICI
    # (parallel/mesh.py MeshPlan.build slices=...).
    slice_id: int = -1

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "WorkerConfig":
        e = dict(env if env is not None else os.environ)
        host, port = (e.get("EDL_COORDINATOR") or "127.0.0.1:7164").rsplit(":", 1)
        return cls(
            job=e.get("EDL_JOB_NAME", "job"),
            worker_id=e.get("EDL_WORKER_ID")
            or e.get("HOSTNAME")
            or f"w{os.getpid()}",
            coord_host=host,
            coord_port=int(port),
            min_workers=int(e.get("EDL_WORKERS_MIN", e.get("EDL_WORKERS", "1"))),
            max_workers=int(e.get("EDL_WORKERS_MAX", e.get("EDL_WORKERS", "1"))),
            fault_tolerant=e.get("EDL_FAULT_TOLERANT", "0") == "1",
            model=e.get("EDL_MODEL", "linreg"),
            mesh=e.get("EDL_MESH", "dp"),
            local_devices=int(e.get("EDL_LOCAL_DEVICES", "0")),
            per_device_batch=int(e.get("EDL_PER_DEVICE_BATCH", "32")),
            n_samples=int(e.get("EDL_NUM_SAMPLES", "4096")),
            passes=int(e.get("EDL_NUM_PASSES", "1")),
            lease_timeout_s=float(e.get("EDL_LEASE_TIMEOUT_S", "16")),
            member_ttl_s=float(e.get("EDL_MEMBER_TTL_S", "10")),
            ckpt_dir=e.get("EDL_CKPT_DIR", ""),
            ckpt_every=int(e.get("EDL_CKPT_EVERY", "0")),
            ckpt_commit_timeout_s=float(
                e.get("EDL_CKPT_COMMIT_TIMEOUT_S", "300")
            ),
            seed=int(e.get("EDL_SEED", "0")),
            vocab=int(e.get("EDL_VOCAB", "4096")),
            emb=int(e.get("EDL_EMB", "0")),
            seq_len=int(e.get("EDL_SEQ_LEN", "64")),
            data_dir=e.get("EDL_DATA_DIR", ""),
            rendezvous_timeout_s=float(e.get("EDL_RENDEZVOUS_TIMEOUT_S", "120")),
            step_sleep_s=float(e.get("EDL_STEP_SLEEP_S", "0")),
            sync_every=int(e.get("EDL_SYNC_EVERY", "1")),
            export_dir=e.get("EDL_EXPORT_DIR", ""),
            export_dtype=e.get("EDL_EXPORT_DTYPE", "bfloat16"),
            p2p=e.get("EDL_P2P", "1") != "0",
            p2p_linger_s=float(e.get("EDL_P2P_LINGER_S", "20")),
            eval_dir=e.get("EDL_EVAL_DIR", ""),
            eval_max_rows=int(e.get("EDL_EVAL_MAX_ROWS", "4096")),
            eval_device=e.get("EDL_EVAL_DEVICE", ""),
            int8_mxu=e.get("EDL_INT8_MXU", "0") == "1",
            int8_wgrad_bf16=e.get("EDL_INT8_WGRAD_BF16", "0") == "1",
            metrics_port=int(e.get("EDL_METRICS_PORT", "-1")),
            metrics_push_s=float(e.get("EDL_METRICS_PUSH_S", "10")),
            tsdb_dir=e.get("EDL_TSDB_DIR", ""),
            # MEGASCALE_SLICE_ID is what GKE injects into multislice
            # TPU pods — honoring it makes the kube path slice-aware
            # with no manifest change
            slice_id=int(
                e.get("EDL_SLICE", e.get("MEGASCALE_SLICE_ID", "-1"))
            ),
        )
