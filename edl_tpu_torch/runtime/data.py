"""The elastic data queue — the port of ``edl_tpu/runtime/data.py``:
task-queue data dispatch that survives membership change (reference:
docker/paddle_k8s:26-32 runs the master with ``-chunk-per-task=1
-task-timout-dur=16s``; trainers pull tasks via ``cloud_reader``,
example/fit_a_line/train_ft.py:105-114). Data is cut into chunk tasks;
workers lease tasks; a lease that times out or whose worker leaves is
redelivered, so sample coverage is exactly-once-ish across membership
change. Passes (epochs) mirror the reference's ``passes`` spec field.

- :class:`ElasticDataQueue` — the thread-safe lease/ack queue.
- :class:`QueueBatcher` — fixed-size batches over leased tasks, acking
  a task only once every one of its samples has been handed out.
- :class:`StaticShardReader` — the non-elastic baseline: a fixed
  round-robin partition of chunks by rank.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from edl_tpu_torch.utils import faults

DEFAULT_LEASE_TIMEOUT_S = 16.0  # reference: -task-timout-dur=16s
MAX_TASK_FAILURES = 3  # reference master's task failure cap analog


@dataclass
class Task:
    """One chunk of work: a half-open range [start, end) of sample
    indices (the RecordIO-chunk analog)."""

    task_id: int
    start: int
    end: int
    epoch: int
    failures: int = 0


@dataclass
class _Lease:
    task: Task
    worker: str
    expires: float


class ElasticDataQueue:
    """Thread-safe lease/ack task queue over ``n_samples`` split into
    ``chunk_size`` tasks, replayed for ``passes`` epochs."""

    def __init__(
        self,
        n_samples: int,
        chunk_size: int,
        passes: int = 1,
        lease_timeout_s: float = DEFAULT_LEASE_TIMEOUT_S,
    ):
        if n_samples <= 0 or chunk_size <= 0:
            raise ValueError("n_samples and chunk_size must be positive")
        self.n_samples = n_samples
        self.chunk_size = chunk_size
        self.passes = passes
        self.lease_timeout_s = lease_timeout_s
        self._lock = threading.Lock()
        self._epoch = 0
        self._todo: List[Task] = []
        self._leases: Dict[int, _Lease] = {}
        self._done_count = 0
        self._dead: List[Task] = []  # tasks that exceeded MAX_TASK_FAILURES
        self._next_id = 0
        self._fill_epoch_locked(0)

    def _fill_epoch_locked(self, epoch: int) -> None:
        for start in range(0, self.n_samples, self.chunk_size):
            self._todo.append(
                Task(
                    task_id=self._next_id,
                    start=start,
                    end=min(start + self.chunk_size, self.n_samples),
                    epoch=epoch,
                )
            )
            self._next_id += 1

    @property
    def tasks_per_epoch(self) -> int:
        return -(-self.n_samples // self.chunk_size)

    # -- worker surface ----------------------------------------------------

    def get_task(self, worker: str) -> Optional[Task]:
        """Lease the next task (reference: cloud_reader's master fetch).
        None when the epoch's tasks are all leased/done — the caller
        retries or finishes."""
        # chaos site: a lost/late lease is redelivered by the timeout,
        # the redelivery invariant exp_chaos.py soaks
        faults.fault_point("data.lease")
        with self._lock:
            self._reap_expired_locked()
            if not self._todo and not self._leases:
                self._advance_epoch_locked()
            if not self._todo:
                return None
            task = self._todo.pop(0)
            self._leases[task.task_id] = _Lease(
                task=task, worker=worker, expires=time.monotonic() + self.lease_timeout_s
            )
            return task

    def ack(self, task_id: int) -> None:
        """Mark a leased task complete."""
        with self._lock:
            lease = self._leases.pop(task_id, None)
            if lease is not None:
                self._done_count += 1
                if not self._todo and not self._leases:
                    self._advance_epoch_locked()

    def nack(self, task_id: int) -> None:
        """Return a task to the queue (worker failed mid-chunk)."""
        with self._lock:
            lease = self._leases.pop(task_id, None)
            if lease is not None:
                self._requeue_locked(lease.task)

    def release_worker(self, worker: str) -> int:
        """Requeue every task leased by a departed worker (membership
        change; reference: master redelivers on trainer death). Returns
        the number requeued."""
        with self._lock:
            gone = [tid for tid, l in self._leases.items() if l.worker == worker]
            for tid in gone:
                self._requeue_locked(self._leases.pop(tid).task)
            return len(gone)

    # -- state -------------------------------------------------------------

    def done(self) -> bool:
        with self._lock:
            self._reap_expired_locked()
            return not self._todo and not self._leases and self._epoch >= self.passes - 1

    def progress(self) -> Dict[str, int]:
        with self._lock:
            return {
                "epoch": self._epoch,
                "todo": len(self._todo),
                "leased": len(self._leases),
                "done": self._done_count,
                "dead": len(self._dead),
            }

    # -- internals (lock held) ---------------------------------------------

    def _requeue_locked(self, task: Task) -> None:
        task.failures += 1
        if task.failures > MAX_TASK_FAILURES:
            self._dead.append(task)
        else:
            self._todo.append(task)

    def _reap_expired_locked(self) -> None:
        now = time.monotonic()
        expired = [tid for tid, l in self._leases.items() if l.expires <= now]
        for tid in expired:
            self._requeue_locked(self._leases.pop(tid).task)

    def _advance_epoch_locked(self) -> bool:
        if self._epoch < self.passes - 1:
            self._epoch += 1
            self._fill_epoch_locked(self._epoch)
            return True
        return False


class QueueBatcher:
    """Fixed-size batches from chunked tasks, with correct at-least-once
    accounting: a task is acked only when every one of its samples has
    been handed out, so batch size and chunk size need not align (the
    cloud_reader's buffered-read analog,
    reference: example/fit_a_line/train_ft.py:111-114).

    ``fetch(task) -> dict[str, np.ndarray]`` loads one chunk's arrays.
    """

    def __init__(self, queue: ElasticDataQueue, fetch, worker: str = "w0"):
        self.queue = queue
        self.fetch = fetch
        self.worker = worker
        self._buffer: List = []  # (task_id, arrays, offset)

    def _buffered(self) -> int:
        total = 0
        for _, arrays, offset in self._buffer:
            total += next(iter(arrays.values())).shape[0] - offset
        return total

    def next_batch(self, batch_size: int, rollover: bool = False):
        """Next batch dict, or None when the queue is drained. The final
        batch may be short (callers pad or drop). With ``rollover`` a
        short batch at a pass boundary is topped up from the next pass
        (leases advance epochs), so batches stay full-size until the
        true end of the queue — the streaming mode long-running trainers
        want."""
        import numpy as _np

        while self._buffered() < batch_size:
            task = self.queue.get_task(self.worker)
            if task is None:
                break
            self._buffer.append((task.task_id, self.fetch(task), 0))
        if not self._buffer:
            return None
        if rollover and self._buffered() < batch_size:
            head = self.next_batch(self._buffered())  # drain the tail...
            rest = self.next_batch(batch_size - next(
                iter(head.values())
            ).shape[0])  # ...then pull from the next pass
            if rest is None:
                return head
            return {
                k: _np.concatenate([head[k], rest[k]], axis=0) for k in head
            }
        need = batch_size
        pieces: List = []
        new_buffer = []
        for task_id, arrays, offset in self._buffer:
            n = next(iter(arrays.values())).shape[0]
            if need > 0:
                take = min(need, n - offset)
                pieces.append({k: v[offset : offset + take] for k, v in arrays.items()})
                offset += take
                need -= take
            if offset >= n:
                self.queue.ack(task_id)  # fully consumed
            else:
                new_buffer.append((task_id, arrays, offset))
        self._buffer = new_buffer
        return {
            k: _np.concatenate([p[k] for p in pieces], axis=0)
            for k in pieces[0]
        }


class StaticShardReader:
    """Classic non-elastic data sharding: chunk ``i`` belongs to worker
    ``i % n_workers`` (reference: example/fit_a_line/fluid/common.py:24-40
    ``cluster_reader`` shards files by ``idx % trainers == trainer_id``).
    No leases, no redelivery — membership is fixed for the life of the
    job, the DistributeTranspiler-era mode (W3). Complements
    :class:`ElasticDataQueue`, which is the elastic/fault-tolerant mode.
    """

    def __init__(
        self,
        n_samples: int,
        chunk_size: int,
        n_workers: int,
        worker_id: int,
    ):
        if not 0 <= worker_id < n_workers:
            raise ValueError(f"worker_id {worker_id} not in [0, {n_workers})")
        if n_samples <= 0 or chunk_size <= 0:
            raise ValueError("n_samples and chunk_size must be positive")
        self.n_samples = n_samples
        self.chunk_size = chunk_size
        self.n_workers = n_workers
        self.worker_id = worker_id

    def chunks(self) -> List[Task]:
        """This worker's chunk tasks, in deterministic order."""
        out: List[Task] = []
        n_chunks = -(-self.n_samples // self.chunk_size)
        for i in range(self.worker_id, n_chunks, self.n_workers):
            start = i * self.chunk_size
            out.append(
                Task(
                    task_id=i,
                    start=start,
                    end=min(start + self.chunk_size, self.n_samples),
                    epoch=0,
                )
            )
        return out

    def epoch_indices(self) -> List[int]:
        """Flat sample indices this worker owns, one epoch."""
        idx: List[int] = []
        for t in self.chunks():
            idx.extend(range(t.start, t.end))
        return idx
