"""ProcessJobLauncher — run an elastic job as real worker processes: the
port of ``edl_tpu/runtime/launcher.py``.

The local-machine realization of the reference's pod lifecycle: the
controller "creates pods" by spawning worker processes running
``python -m edl_tpu_torch.runtime.worker_main`` (reference: trainer
batch Job pods exec'ing docker/paddle_k8s), scales up by spawning more,
and scales down by SIGTERM-ing the highest-numbered workers (reference:
the k8s Job controller shrinking ``Parallelism``, pkg/autoscaler.go:361).
A per-job coordinator process (runtime/coordinator.py, the etcd/master
analog) provides membership, rendezvous KV and the data task queue.

Where the reference defaults to a virtual CPU device a worker, the
port's workers run on the card (``local_devices=0``: every worker
process drives ``cuda:0``, joined by gloo) unless the caller asks for
the CPU with ``local_devices=1``, as the tests do. The workers run the
peer-to-peer shard plane (``EDL_P2P``, on unless ``extra_env`` sets it
to 0), as the reference's do.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from edl_tpu_torch.runtime.coordinator import (CoordinatorClient,
                                               CoordinatorServer)
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("launcher")


@dataclass
class WorkerProc:
    worker_id: str
    proc: subprocess.Popen
    log_path: str


@dataclass
class ProcessJobLauncher:
    job: str = "job"
    model: str = "linreg"
    mesh: str = "dp"  # MeshPlan.parse grammar; the port runs "dp"
    min_workers: int = 1
    max_workers: int = 8
    n_samples: int = 2048
    passes: int = 1
    per_device_batch: int = 32
    local_devices: int = 0  # 0 = the card (cuda:0); 1 = the CPU
    work_dir: str = "."
    member_ttl_s: float = 3.0
    # must comfortably exceed a worker's first step (allocator and
    # kernel warm-up): a lease that times out mid-step is redelivered
    # and the job trains those rows twice (at-least-once)
    lease_timeout_s: float = 10.0
    fault_tolerant: bool = True
    ckpt_every: int = 0  # periodic sharded-commit cadence (steps)
    seed: int = 0
    seq_len: int = 32  # llama workload sequence length
    data_dir: str = ""  # on-disk dataset (runtime/shards.py layout)
    export: bool = False  # publish servable params exports (export_dir)
    step_sleep_s: float = 0.0
    sync_every: int = 1  # delayed-sync DP: K local steps between averages
    # virtual multi-slice topology: group every K consecutive workers
    # into one TPU slice (0 = single-slice / undeclared). Worker wNNN
    # gets EDL_SLICE = NNN // K, so a scale-up past one slice's hosts
    # lands the new workers on the next slice — the BASELINE north-star
    # shape (v5e-4 -> v5e-64 crosses slice boundaries). slice_map
    # overrides per worker id for irregular layouts (tests).
    workers_per_slice: int = 0
    slice_map: Dict[str, int] = field(default_factory=dict)
    # coordinator WAL auto-compaction threshold (bytes appended since
    # the last snapshot; 0 = server default 1 MiB). The WAL stays
    # O(state) regardless of job length.
    wal_compact_bytes: int = 0
    extra_env: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        # durable coordinator: the WAL lives in the job work dir, so a
        # killed coordinator can be restarted with exact accounting.
        # A launcher always starts a NEW job — drop any previous job's
        # log (a stale WAL would replay its queue_inited/phase KV and
        # the fresh job would "complete" without training).
        wal_path = os.path.join(self.work_dir, "coordinator.wal")
        if os.path.exists(wal_path):
            os.remove(wal_path)
        self.server = CoordinatorServer(
            member_ttl_s=self.member_ttl_s,
            wal_path=wal_path,
            wal_compact_bytes=self.wal_compact_bytes,
        )
        self.client: CoordinatorClient = self.server.client()
        self.workers: List[WorkerProc] = []
        self._next_id = 0

    # -- coordinator fault injection ----------------------------------------

    def kill_coordinator(self) -> None:
        """SIGKILL the coordinator process mid-job (the SPOF fault the
        reference tolerates via etcd durability)."""
        self.server.kill()

    def restart_coordinator(self) -> None:
        """Respawn the coordinator on the same port; it recovers from
        the WAL and the workers' reconnecting clients resume."""
        self.server.restart()

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.work_dir, "ckpt")

    @property
    def log_dir(self) -> str:
        return os.path.join(self.work_dir, "logs")

    @property
    def export_dir(self) -> str:
        return os.path.join(self.work_dir, "export")

    # -- pod lifecycle -------------------------------------------------------

    def _slice_of(self, worker_id: str) -> int:
        if worker_id in self.slice_map:
            return self.slice_map[worker_id]
        if self.workers_per_slice > 0:
            return int(worker_id.lstrip("w")) // self.workers_per_slice
        return -1

    def slice_workers(self, slice_id: int) -> List[WorkerProc]:
        """Live workers placed on one slice (fault injection: a slice
        outage kills all of them at once)."""
        return [
            w for w in self.live_workers() if self._slice_of(w.worker_id) == slice_id
        ]

    def kill_slice(self, slice_id: int) -> List[str]:
        """SIGKILL every live worker of a slice — the multi-slice fault
        the north-star scenario must survive (a whole v5e slice
        preempted at once). Tolerates workers exiting underfoot."""
        victims = []
        for w in self.slice_workers(slice_id):
            try:
                self.kill(w.worker_id)
                victims.append(w.worker_id)
            except KeyError:  # exited between listing and signal
                pass
        return victims

    def _env(self, worker_id: str) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(
            {
                "EDL_JOB_NAME": self.job,
                "EDL_WORKER_ID": worker_id,
                "EDL_COORDINATOR": f"127.0.0.1:{self.server.port}",
                "EDL_WORKERS": str(self.min_workers),
                "EDL_WORKERS_MIN": str(self.min_workers),
                "EDL_WORKERS_MAX": str(self.max_workers),
                "EDL_FAULT_TOLERANT": "1" if self.fault_tolerant else "0",
                "EDL_MODEL": self.model,
                "EDL_MESH": self.mesh,
                "EDL_CKPT_EVERY": str(self.ckpt_every),
                "EDL_SEQ_LEN": str(self.seq_len),
                "EDL_DATA_DIR": self.data_dir,
                "EDL_LOCAL_DEVICES": str(self.local_devices),
                "EDL_PER_DEVICE_BATCH": str(self.per_device_batch),
                "EDL_NUM_SAMPLES": str(self.n_samples),
                "EDL_NUM_PASSES": str(self.passes),
                "EDL_LEASE_TIMEOUT_S": str(self.lease_timeout_s),
                "EDL_MEMBER_TTL_S": str(self.member_ttl_s),
                "EDL_CKPT_DIR": self.ckpt_dir,
                "EDL_EXPORT_DIR": self.export_dir if self.export else "",
                "EDL_LOG_DIR": self.log_dir,
                "EDL_SEED": str(self.seed),
                "EDL_STEP_SLEEP_S": str(self.step_sleep_s),
                "EDL_SYNC_EVERY": str(self.sync_every),
                "EDL_SLICE": str(self._slice_of(worker_id)),
                "PYTHONPATH": os.pathsep.join(
                    [
                        os.path.dirname(
                            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                        )
                    ]
                    + os.environ.get("PYTHONPATH", "").split(os.pathsep)
                ).rstrip(os.pathsep),
            }
        )
        if self.local_devices == 1:
            # CPU workers share the host's cores: one torch thread each
            # (a worker's small ops spin many threads for nothing, up to
            # 40x slower on a shared host)
            env["OMP_NUM_THREADS"] = "1"
        env.update(self.extra_env)
        return env

    def spawn(self) -> WorkerProc:
        worker_id = f"w{self._next_id:03d}"
        self._next_id += 1
        log_path = os.path.join(self.log_dir, f"{worker_id}.log")
        f = open(log_path, "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.runtime.worker_main"],
            env=self._env(worker_id),
            stdout=f,
            stderr=subprocess.STDOUT,
        )
        f.close()  # child holds the fd
        wp = WorkerProc(worker_id, proc, log_path)
        self.workers.append(wp)
        log.info("spawned worker", worker=worker_id, pid=proc.pid)
        return wp

    def start(self, n_workers: Optional[int] = None) -> None:
        for _ in range(n_workers if n_workers is not None else self.min_workers):
            self.spawn()

    def live_workers(self) -> List[WorkerProc]:
        return [w for w in self.workers if w.proc.poll() is None]

    def scale_to(self, n: int) -> List[str]:
        """Reference semantics: retargeting Parallelism adds pods or
        removes the newest ones (graceful SIGTERM drain). Returns the
        worker ids that were sent SIGTERM (empty on scale-up)."""
        live = self.live_workers()
        terminated: List[str] = []
        if n > len(live):
            for _ in range(n - len(live)):
                self.spawn()
        else:
            for w in sorted(live, key=lambda w: w.worker_id)[n:]:
                log.info("terminating worker", worker=w.worker_id)
                w.proc.send_signal(signal.SIGTERM)
                terminated.append(w.worker_id)
        return terminated

    def kill(self, worker_id: str, sig: int = signal.SIGKILL) -> None:
        """Fault injection: hard-kill a worker (no graceful drain)."""
        for w in self.live_workers():
            if w.worker_id == worker_id:
                w.proc.send_signal(sig)
                return
        raise KeyError(worker_id)

    # -- observation ---------------------------------------------------------

    def kv(self, key: str) -> Optional[str]:
        return self.client.kv_get(f"{self.job}/{key}")

    def progress(self) -> int:
        return int(self.kv("progress") or "0")

    def wait_progress(self, at_least: int, timeout_s: float = 120.0) -> int:
        deadline = time.monotonic() + timeout_s
        while True:
            p = self.progress()
            if p >= at_least:
                return p
            if time.monotonic() > deadline:
                raise TimeoutError(f"progress {p} < {at_least}")
            if all(w.proc.poll() is not None for w in self.workers):
                raise RuntimeError(f"all workers exited at progress {p}")
            time.sleep(0.05)

    def wait(self, timeout_s: float = 300.0) -> Dict[str, int]:
        """Wait for every worker process to exit; {worker_id: returncode}."""
        deadline = time.monotonic() + timeout_s
        for w in self.workers:
            remain = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=remain)
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    f"worker {w.worker_id} still running; "
                    f"log tail: {self.log_tail(w.worker_id)}"
                )
        return {w.worker_id: w.proc.returncode for w in self.workers}

    def log_tail(self, worker_id: str, n_bytes: int = 2000) -> str:
        for w in self.workers:
            if w.worker_id == worker_id:
                with open(w.log_path, "rb") as f:
                    data = f.read()
                return data[-n_bytes:].decode(errors="replace")
        return ""

    def stop(self) -> None:
        """Kill every worker still running, then the coordinator; the
        epochs' store hosts see the coordinator gone and exit."""
        for w in self.live_workers():
            w.proc.kill()
        for w in self.workers:
            if w.proc.poll() is None:
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    log.warn("worker did not exit after SIGKILL",
                             worker=w.worker_id)
        self.client.close()
        self.server.stop()
        self._stop_store_hosts()

    def _stop_store_hosts(self) -> None:
        """SIGKILL the store hosts (runtime/dist_service.py) still up.
        The workers start them detached, so each names its pid in its
        log under :attr:`log_dir`; a dismissed host has already exited."""
        import glob
        import re

        for path in glob.glob(os.path.join(self.log_dir,
                                           "dist_service_*.log")):
            with open(path, errors="replace") as f:
                pids = re.findall(r"dist_service \w+ .*pid=(\d+)", f.read())
            for pid in map(int, pids):
                try:
                    # only a pid that is still a store host (never a
                    # reused one)
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"runtime.dist_service" not in f.read():
                            continue
                    os.kill(pid, signal.SIGKILL)
                except (FileNotFoundError, ProcessLookupError):
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
