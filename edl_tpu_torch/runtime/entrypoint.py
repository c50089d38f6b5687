"""Worker entrypoint — discovery, barrier, rank, failure gate. The port
of ``edl_tpu/runtime/entrypoint.py`` (the reference's pod runtime glue,
docker/paddle_k8s start_new_trainer:121-143 + docker/k8s_tools.py
fetch_pod_id:127-151): a starting worker

  1. reads the EDL_* env contract,
  2. connects to the job coordinator and registers with a fresh
     incarnation number,
  3. checks the failure gate (fault-tolerant jobs tolerate up to
     EDL_WORKERS failures; non-FT tolerate 0 —
     reference: check_failed_cnt docker/paddle_k8s:34-42),
  4. waits at the start barrier for min_replicas peers
     (reference: wait_pods_running barriers, paddle_k8s:128-130),
  5. takes its deterministic rank (index of its name in the sorted
     live-member list — reference: k8s_tools.py fetch_pod_id),
  6. joins the epoch's ``torch.distributed`` process group
     (:func:`init_distributed`, where the reference calls
     ``jax.distributed.initialize``), and
  7. hands control to the training program; exit codes are classified
     into a termination reason (reference: check_trainer_ret
     paddle_k8s:44-60).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("entrypoint")

# exit-code classification (reference: docker/paddle_k8s:44-60)
EXIT_REASONS = {
    0: "success",
    136: "floating point exception",
    139: "segmentation fault",
    134: "aborted",
}


class FailureGateError(RuntimeError):
    pass


@dataclass
class WorkerContext:
    job_name: str
    worker_id: str
    rank: int
    world_size: int
    incarnation: int
    coordinator: object
    membership_epoch: int


def classify_exit(code: int) -> str:
    return EXIT_REASONS.get(code, f"exit code {code}")


def check_failure_gate(coordinator, job_name: str, fault_tolerant: bool,
                       budget: int) -> None:
    """reference: check_failed_cnt docker/paddle_k8s:34-42 — FT jobs
    tolerate up to ``budget`` failures, non-FT tolerate 0. The failure
    count lives in coordinator KV (termination-log analog)."""
    raw = coordinator.kv_get(f"{job_name}/failed_count") or "0"
    failed = int(raw)
    limit = budget if fault_tolerant else 0
    if failed > limit:
        raise FailureGateError(
            f"job {job_name} exceeded failure budget: {failed} > {limit}"
        )


def record_failure(coordinator, job_name: str, reason: str) -> int:
    failed = int(coordinator.kv_get(f"{job_name}/failed_count") or "0") + 1
    coordinator.kv_put(f"{job_name}/failed_count", str(failed))
    coordinator.kv_put(f"{job_name}/last_failure", reason)
    return failed


def bootstrap(
    coordinator,
    env: Optional[Dict[str, str]] = None,
    barrier_timeout_s: float = 300.0,
    poll_s: float = 0.05,
) -> WorkerContext:
    """Steps 1-6. ``coordinator`` is any coordinator-interface object
    (runtime/coordinator.py); env defaults to os.environ."""
    env = dict(env if env is not None else os.environ)
    job = env.get("EDL_JOB_NAME", "job")
    worker_id = env.get("EDL_WORKER_ID") or env.get("HOSTNAME") or f"w{os.getpid()}"
    min_workers = int(env.get("EDL_WORKERS_MIN", env.get("EDL_WORKERS", "1")))
    fault_tolerant = env.get("EDL_FAULT_TOLERANT", "0") == "1"

    check_failure_gate(
        coordinator, job, fault_tolerant, budget=int(env.get("EDL_WORKERS", "1"))
    )

    # incarnation: monotonic per worker name, owned by the coordinator KV
    inc_key = f"{job}/incarnation/{worker_id}"
    incarnation = int(coordinator.kv_get(inc_key) or "0") + 1
    coordinator.kv_put(inc_key, str(incarnation))
    epoch = coordinator.register(worker_id, incarnation)

    # start barrier: wait for min_replicas live members
    # (reference: paddle_k8s:128-130 waits pservers+master Running)
    coordinator.barrier_arrive(f"{job}/start", worker_id)
    deadline = time.monotonic() + barrier_timeout_s
    while coordinator.barrier_count(f"{job}/start") < min_workers:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"start barrier: {coordinator.barrier_count(f'{job}/start')}"
                f"/{min_workers} workers after {barrier_timeout_s}s"
            )
        time.sleep(poll_s)

    members = coordinator.members()
    rank = next((m.rank for m in members if m.name == worker_id), -1)
    if rank < 0:
        raise RuntimeError(f"worker {worker_id} missing from membership")
    ctx = WorkerContext(
        job_name=job,
        worker_id=worker_id,
        rank=rank,
        world_size=len(members),
        incarnation=incarnation,
        coordinator=coordinator,
        membership_epoch=epoch,
    )
    log.info(
        "worker bootstrapped",
        job=job,
        worker=worker_id,
        rank=rank,
        world=ctx.world_size,
        incarnation=incarnation,
    )
    return ctx


BACKEND = "gloo"  # every device (NCCL for workers of other meshes: item 2h)


def collective_timeout_s(member_ttl_s: float) -> float:
    """The process group's connect and collective timeout, derived from
    the member TTL: a peer that dies before connecting is reaped from
    membership within a TTL, so waiting much longer than a few TTLs only
    holds the survivors (torch's default is 30 minutes). Floor 20 s:
    a healthy peer's first step (its allocator and kernels warming up)
    must not time a collective out."""
    return max(20.0, 6.0 * member_ttl_s)


def init_distributed(addr: str, world: int, rank: int,
                     timeout_s: float = 60.0) -> None:
    """Join this epoch's process group as a pure client of the EXTERNAL
    store host (runtime/dist_service.py) at ``addr`` ("host:port"), so
    rank-0 death cannot take the rendezvous with it. Backend
    :data:`BACKEND` for CPU and CUDA tensors alike. On a loopback
    endpoint every peer is on this host, so gloo binds loopback unless
    ``GLOO_SOCKET_IFNAME`` says otherwise."""
    import datetime

    import torch.distributed as dist

    host, port = addr.rsplit(":", 1)
    if host in ("127.0.0.1", "localhost"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world_size=world,
                          is_master=False, timeout=timeout)
    dist.init_process_group(BACKEND, store=store, rank=rank,
                            world_size=world, timeout=timeout)


def run_worker(
    ctx: WorkerContext,
    main: Callable[[WorkerContext], int],
) -> int:
    """Step 7: run the training program, classify the outcome, maintain
    the failure count (reference: check_trainer_ret paddle_k8s:44-60)."""
    try:
        code = int(main(ctx) or 0)
    except Exception as e:  # program crash
        record_failure(ctx.coordinator, ctx.job_name, f"exception: {e}")
        ctx.coordinator.leave(ctx.worker_id)
        ctx.coordinator.release_worker(ctx.worker_id)
        raise
    reason = classify_exit(code)
    if code != 0:
        record_failure(ctx.coordinator, ctx.job_name, reason)
        ctx.coordinator.release_worker(ctx.worker_id)
    ctx.coordinator.leave(ctx.worker_id)
    log.info("worker exited", worker=ctx.worker_id, code=code, reason=reason)
    return code
