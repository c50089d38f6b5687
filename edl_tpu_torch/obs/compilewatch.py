"""Runtime compile observability: the port's copy of
``edl_tpu/obs/compilewatch.py``.

In the reference every shared jit-program factory (the serving
engine's block/prefill memo, ``llama._generate_program``, the trainer
step factories) wraps its compiled callable here, and the first call of
each distinct program — where jax traces and compiles — is timed into
``edl_compile_seconds{program}`` and counted in
``edl_compiles_total{program}``.

PyTorch runs eagerly and has no jit programs, so the port wraps the
same factories' keys: the serving engine keeps a module-level LRU of
the reference's memo keys, ``llama.generate`` its program keys, and
each train-step factory instance one wrapper. The first call of each
pays what the port really pays the first time (cuBLAS handles and
workspaces, the kernel library's load, the caching allocator's first
segments), and the counts equal the reference's for the same request
stream.

After :func:`mark_warm` — called by harnesses once their warmup pass
has paid the expected first calls — any further first call
additionally emits an ``obs.recompile`` flight-recorder event
(severity ``warn``): a steady-state serving loop that meets a new
program is paying latency someone should see on the incident timeline.

Hot-path cost after the first call: one dict read per invocation.
Metrics go to the process default registry on purpose — compile
activity is process-level truth regardless of which private registry
an engine's serving metrics use.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from edl_tpu_torch.obs import metrics as obs_metrics

_lock = threading.Lock()
_warm = False


def mark_warm() -> None:
    """Declare warmup over: compiles from here on are RE-compiles and
    land on the flight-recorder timeline."""
    global _warm
    with _lock:
        _warm = True


def is_warm() -> bool:
    with _lock:
        return _warm


def reset() -> None:
    """Back to warmup (tests)."""
    global _warm
    with _lock:
        _warm = False


def wrap(fn: Callable, program: str) -> Callable:
    """Instrument one compiled program. Transparent to donation and
    tracing — the wrapper only forwards ``*args``."""

    state = {"done": False}
    state_lock = threading.Lock()

    def run(*args, **kw):
        if state["done"]:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        with state_lock:
            if state["done"]:  # lost the race: someone else timed it
                return out
            state["done"] = True
        r = obs_metrics.default_registry()
        r.histogram(
            "edl_compile_seconds",
            "first-call (trace + compile) time per distinct jit program",
            ("program",),
        ).observe(dt, program=program)
        r.counter(
            "edl_compiles_total",
            "distinct jit programs compiled, by factory",
            ("program",),
        ).inc(program=program)
        if is_warm():
            from edl_tpu_torch.obs import events as flight

            flight.emit(
                "obs.recompile", severity="warn",
                program=program, seconds=round(dt, 6),
            )
        return out

    run.__name__ = f"compilewatch[{program}]"
    run.__wrapped__ = fn
    return run
