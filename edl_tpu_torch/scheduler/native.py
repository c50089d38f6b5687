"""The native planner — the port of ``edl_tpu/scheduler/native.py``:
ctypes over the repo's C++ planning core (``native/scheduler``), the
twin of the Python dry-run fixed point in ``scheduler/autoscaler.py``.
The Autoscaler uses it when available (``use_native=True``) and plans
in Python when it is not — the plans are interchangeable by
construction (``tests/test_torch_control.py`` holds both to the
reference's Python planner).

:func:`ensure_native_built` builds the library with the sources' own
Makefile into ``edl_tpu_torch/_build/scheduler``
(``utils/native_build.py``), as the coordinator's builds into
``edl_tpu_torch/_build/coordinator``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional

from edl_tpu_torch.cluster import topology
from edl_tpu_torch.cluster.resource import ClusterResource
from edl_tpu_torch.utils import native_build
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("sched.native")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native", "scheduler")
BUILD_DIR = os.path.join(_REPO, "edl_tpu_torch", "_build", "scheduler")
LIB_PATH = os.path.join(BUILD_DIR, "libedl_sched.so")
_SOURCES = ("sched.h", "sched.cc", "capi.cc", "Makefile")

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _fresh() -> bool:
    """The built library is newer than every source, so a stale library
    (old ABI) triggers a rebuild."""
    return native_build.fresh((LIB_PATH,), NATIVE_DIR, _SOURCES)


def ensure_native_built() -> bool:
    """Build the library on demand into :data:`BUILD_DIR`; False (and a
    warning) when the build fails."""
    return native_build.ensure_built((LIB_PATH,), NATIVE_DIR, BUILD_DIR,
                                     _SOURCES, _build_lock, "scheduler")


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not ensure_native_built():
        return None
    lib = ctypes.CDLL(LIB_PATH)
    I64P = ctypes.POINTER(ctypes.c_int64)
    I32P = ctypes.POINTER(ctypes.c_int32)
    lib.edl_sched_plan.restype = ctypes.c_int
    lib.edl_sched_plan.argtypes = (
        [ctypes.c_int64] + [I64P] * 6          # jobs: min/max/par/chip/cpu/mem
        + [I32P, I64P, I32P]                   # policy kind/cap/contiguous
        + [ctypes.c_int64] + [I64P] * 5        # hosts: cpu/mem/chip/block/index
        + [ctypes.c_int64] * 6                 # totals
        + [ctypes.c_double, I64P]
    )
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _policy_triple(policy) -> Optional[tuple]:
    """(kind, cap, contiguous) for a native-expressible policy, else
    None (a custom Python callable only the Python planner can run)."""
    if policy is topology.flexible:
        return (0, 0, 0)
    if policy is topology.pow2:
        return (1, 0, 0)
    if isinstance(policy, topology.SliceShapePolicy):
        return (1, policy.cap, 1 if policy.contiguous else 0)
    return None


def plan_native(
    jobs: List,  # List[JobState] (scheduler.autoscaler)
    r: ClusterResource,
    max_load_desired: float,
    policies: List,  # one resolved SlicePolicy per job
) -> Optional[Dict[str, int]]:
    """Plan deltas with the native core; None when unavailable or any
    job's policy is not native-expressible (caller falls back to the
    Python planner). ``r`` is not mutated."""
    lib = _load()
    if lib is None:
        return None
    triples = [_policy_triple(p) for p in policies]
    if any(t is None for t in triples):
        return None

    n = len(jobs)
    arr = lambda vals: (ctypes.c_int64 * len(vals))(*vals)
    arr32 = lambda vals: (ctypes.c_int32 * len(vals))(*vals)
    job_min = arr([j.config.spec.worker.min_replicas for j in jobs])
    job_max = arr([j.config.spec.worker.max_replicas for j in jobs])
    job_par = arr([j.group.parallelism if j.group else 0 for j in jobs])
    job_chip = arr([j.chips_per_worker() for j in jobs])
    job_cpu = arr([j.cpu_request_milli() for j in jobs])
    job_mem = arr([j.mem_request_mega() for j in jobs])
    job_kind = arr32([t[0] for t in triples])
    job_cap = arr([t[1] for t in triples])
    job_contig = arr32([t[2] for t in triples])

    host_names = sorted(r.hosts.cpu_idle_milli)
    host_cpu = arr([r.hosts.cpu_idle_milli[h] for h in host_names])
    host_mem = arr([r.hosts.mem_free_mega.get(h, 0) for h in host_names])
    host_chip = arr([r.hosts.chips_free.get(h, 0) for h in host_names])
    # block ids ascend in block-NAME order so the C++ std::map walk
    # matches Python's sorted(by_block) iteration
    block_ids = {
        b: i for i, b in enumerate(sorted(set(r.hosts.ici_block.values())))
    }
    host_block = arr(
        [block_ids.get(r.hosts.ici_block.get(h), -1) for h in host_names]
    )
    host_index = arr([r.hosts.ici_index.get(h, -1) for h in host_names])

    out = (ctypes.c_int64 * n)()
    rc = lib.edl_sched_plan(
        n, job_min, job_max, job_par, job_chip, job_cpu, job_mem,
        job_kind, job_cap, job_contig,
        len(host_names), host_cpu, host_mem, host_chip, host_block, host_index,
        r.chip_total, r.chip_limit,
        r.cpu_total_milli, r.cpu_request_milli,
        r.mem_total_mega, r.mem_request_mega,
        max_load_desired, out,
    )
    if rc != 0:
        log.warn("native planner returned error", rc=rc)
        return None
    return {jobs[i].config.qualified_name: int(out[i]) for i in range(n)}
