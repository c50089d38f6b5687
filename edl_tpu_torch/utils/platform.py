"""The device pool — the port's counterpart of ``edl_tpu/utils/platform.py``.

The reference forces N virtual CPU devices into one process, and its
``ElasticTrainer`` is one SPMD program over them. The port's pool is N
processes, one a device slot, joined in one ``torch.distributed`` world:
:class:`ProcessPool` spawns them, rendezvouses them through a
``FileStore`` and runs the same function on every rank
(:meth:`ProcessPool.run`). A mesh is then a set of process groups over
the pool's first ranks (``parallel/mesh.py``).

- On the CPU (``device="cpu"``, the tests) every rank computes on the
  host under gloo.
- On the card every rank drives ``cuda:(rank % cards)``. The backend
  follows the topology (``parallel/collectives.choose_backend``): NCCL
  when each rank owns a card, gloo when the ranks share one; a CPU
  tensor always has gloo.
- The kernels are built in the parent before the ranks start
  (:func:`build_kernels`), so N ranks never race on one build directory.
- Every wait has a timeout. A rank that raises fails the whole call:
  the pool kills every process and the call raises with the rank's
  traceback. :meth:`ProcessPool.close` (and leaving the ``with`` block)
  kills what is still alive.

A function given to :meth:`ProcessPool.run` must be importable by name
(a top-level function of a module other than the parent's script, which
the ranks do not run); its arguments and result are pickled.
"""

from __future__ import annotations

import os
import queue as _queue
import shutil
import sys
import tempfile
import time
import traceback
import types
from typing import Any, Callable, List, Optional

from edl_tpu_torch.utils.logging import kv_logger

_IDLE_S = 3600.0  # a rank with no task for this long exits
log = kv_logger("platform")


def build_kernels() -> List[str]:
    """Build every CUDA source of the port once, in this process
    (``ops/_build.build_all``: one nvcc each, all at once)."""
    from edl_tpu_torch.ops import _build

    names = sorted(n[:-3] for n in os.listdir(_build.CSRC)
                   if n.endswith(".cu"))
    return _build.build_all(names)


def pool_device(rank: int, device: str):
    """The device of pool rank ``rank``: the CPU, or the card
    ``cuda:(rank % cards)``."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    from edl_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, device: str, backend: str,
               store_path: str, timeout_s: float, threads: int,
               tasks, results) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dev = pool_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException as e:
        log.error("pool rank failed to start", rank=rank, error=repr(e))
        results.put((rank, -1, False, traceback.format_exc()))
        return
    results.put((rank, -1, True, None))
    while True:
        try:
            item = tasks.get(timeout=_IDLE_S)
        except _queue.Empty:
            break
        if item is None:
            break
        seq, fn, args, kwargs = item
        try:
            out = fn(*args, **kwargs)
            results.put((rank, seq, True, out))
        except BaseException as e:
            # the parent raises PoolError with this traceback
            log.error("pool task failed", rank=rank, error=repr(e))
            results.put((rank, seq, False, traceback.format_exc()))
    try:
        dist.destroy_process_group()
    finally:
        if device != "cpu":
            torch.cuda.synchronize()


class PoolError(RuntimeError):
    """A pool rank failed (its traceback is the message)."""


class ProcessPool:
    """``world`` rank processes on ``device`` ("cpu" or "cuda") in one
    ``torch.distributed`` world.

    The backend is the topology's (:func:`~edl_tpu_torch.parallel.
    collectives.choose_backend`; ``backend`` and ``why``); an NCCL world
    also carries gloo for CPU tensors. ``timeout_s`` bounds the
    rendezvous, every collective (the process group's timeout) and
    every :meth:`run`. ``threads`` sets each rank's intra-op threads
    (default: the host's cores split between the ranks on the CPU;
    torch's default on the card)."""

    def __init__(self, world: int, device: str = "cuda",
                 timeout_s: float = 300.0, threads: Optional[int] = None):
        import torch.multiprocessing as mp

        from edl_tpu_torch.parallel.collectives import choose_backend

        self.world = int(world)
        self.device = device
        self.timeout_s = float(timeout_s)
        n_cards = 0
        if device != "cpu":
            import torch

            from edl_tpu_torch.utils.device import resolve_device

            resolve_device("cuda")
            n_cards = torch.cuda.device_count()
            build_kernels()
        backend, self.why = choose_backend(
            "cpu" if device == "cpu" else "cuda", n_cards, self.world)
        self.backend = backend
        if backend == "nccl":
            backend = "cpu:gloo,cuda:nccl"
        if threads is None and device == "cpu":
            threads = max(1, (os.cpu_count() or 1) // self.world)
        self._dir = tempfile.mkdtemp(prefix="edl_pool_")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, self.world, device, backend,
                os.path.join(self._dir, "store"), self.timeout_s,
                threads or 0, self._tasks[r], self._results))
            for r in range(self.world)]
        self._seq = 0
        self._closed = False
        # a rank runs importable functions only: it must not re-run the
        # parent's script (spawn would, and cannot for stdin or -c)
        main = sys.modules["__main__"]
        sys.modules["__main__"] = types.ModuleType("__main__")
        try:
            for p in self._procs:
                p.start()
        finally:
            sys.modules["__main__"] = main
        try:
            self._collect(-1)
        except BaseException:
            self.close()
            raise

    def _collect(self, seq: int) -> List[Any]:
        out: List[Any] = [None] * self.world
        got = 0
        deadline = time.monotonic() + self.timeout_s
        while got < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close()
                raise TimeoutError(
                    f"pool ranks did not answer within {self.timeout_s} s")
            try:
                rank, s, ok, val = self._results.get(timeout=min(left, 5.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    self.close()
                    raise PoolError(f"pool ranks {dead} died")
                continue
            if s != seq:
                continue  # an answer of a call that already failed
            if not ok:
                self.close()
                raise PoolError(f"pool rank {rank} failed:\n{val}")
            out[rank] = val
            got += 1
        return out

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the results in rank
        order."""
        if self._closed:
            raise PoolError("the pool is closed")
        self._seq += 1
        for q in self._tasks:
            q.put((self._seq, fn, args, kwargs))
        return self._collect(self._seq)

    def close(self) -> None:
        """Stop every rank: ask, wait a little, then kill."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 10.0
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "ProcessPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
