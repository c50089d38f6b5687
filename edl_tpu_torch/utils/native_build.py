"""Builds of the repo's jax-free C++ cores (``native/coordinator``,
``native/scheduler``) for the port: each with its sources' own Makefile
into a directory under ``edl_tpu_torch/_build`` (``make BUILD=...``), so
the port shares no build directory with the reference and writes
nothing into ``native/``. A file lock in the build directory serializes
concurrent builders across processes; the caller's lock, its threads.

The Makefile's own compiler and flags apply: ``CXX`` and ``CXXFLAGS``
from the environment are dropped for the build. A compiler named there
may link its own static libstdc++ into the library, and a library
loaded into a process that already holds the system libstdc++ (torch's)
then runs some of its C++ runtime calls in one copy and some in the
other: on the H100 machine, where ``CXX=/opt/gcc/bin/g++`` does that,
the in-process coordinator crashed in its first ``queue_init``.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import threading
from typing import Sequence

from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("native_build")


def fresh(artifacts: Sequence[str], native_dir: str,
          sources: Sequence[str]) -> bool:
    """Every artifact exists and is newer than every source (the
    Makefile too, so a flag change rebuilds)."""
    if not all(os.path.exists(a) for a in artifacts):
        return False
    built = min(os.path.getmtime(a) for a in artifacts)
    return all(os.path.getmtime(os.path.join(native_dir, s)) <= built
               for s in sources if os.path.exists(os.path.join(native_dir, s)))


def ensure_built(artifacts: Sequence[str], native_dir: str, build_dir: str,
                 sources: Sequence[str], lock: threading.Lock,
                 what: str) -> bool:
    """Make ``artifacts`` in ``build_dir`` unless they are fresh; False
    (and a warning) when the build fails."""
    if fresh(artifacts, native_dir, sources):
        return True
    os.makedirs(build_dir, exist_ok=True)
    with lock, open(os.path.join(build_dir, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if fresh(artifacts, native_dir, sources):
            return True
        env = {k: v for k, v in os.environ.items()
               if k not in ("CXX", "CXXFLAGS")}
        try:
            subprocess.run(
                ["make", "-C", native_dir, f"BUILD={build_dir}", *artifacts],
                check=True, capture_output=True, timeout=120, env=env,
            )
            return True
        except (OSError, subprocess.SubprocessError) as e:
            log.warn(f"native {what} build failed", error=str(e))
            return False
