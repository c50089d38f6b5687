"""Deterministic interleaving explorer (``edl schedcheck``'s engine).

The static rules in :mod:`edl_tpu_torch.analysis.rules` reason about source
text; this module *executes* concurrent code under a cooperative,
seeded scheduler so concurrency claims become machine-checkable:

* a **sync shim** replaces ``threading.Lock/RLock/Condition/Event/
  Thread``, ``queue.Queue`` and ``time.sleep`` (only inside
  :func:`shim_installed`) with wrappers that hand control to a single
  controller loop at every acquire/release/wait/notify/queue-op;
* only one task runs between handoffs, so every run is a *total order*
  of preemption points chosen by a seeded RNG — the choice list is the
  schedule, and replaying it reproduces the run bit-for-bit;
* :func:`explore` random-walks many schedules, steering each decision
  toward task choices untried at that prefix (a cheap sleep-set
  cousin) and deduping schedules that are Mazurkiewicz-equivalent
  (adjacent independent ops commuted into canonical order);
* every shim op feeds the vector-clock detector in
  :mod:`edl_tpu_torch.analysis.hb`, and :func:`instrument` rewrites an
  object's class so watched attribute reads/writes become preemption
  points *and* happens-before accesses — yield-*before*-access, so a
  racing peer can slip into the window being tested;
* failures (deadlock, uncaught exception, harness assertion) and races
  carry the choice list that produced them; :func:`minimize` greedily
  deletes choices while the failure still reproduces, yielding the
  minimal schedule printed by the CLI.

Nothing here is installed unless a harness asks for it: importing this
module captures the real primitives in ``_REAL`` and leaves
``threading`` untouched, and :func:`shim_installed` restores the exact
original objects on exit.

The port of ``edl_tpu/analysis/sched.py``, unchanged in behaviour (a
trace location under ``edl_tpu_torch/`` is printed from the package
root).

Invariant for code that runs under the shim: a *real* lock may be held
across a shim yield only if no other task can touch it (the scheduler
serializes tasks, so real locks never contend — but a real ``wait()``
on a real primitive would hang the controller, which reports it as a
``hang`` failure after a wall-clock grace period).
"""

from __future__ import annotations

import _thread as _thread_mod
import hashlib
import json
import logging as _logging
import os
import queue as _queue_mod
import random
import sys
import threading as _threading
import time as _time_mod
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from .hb import HBState, Race

__all__ = [
    "NullLock",
    "SchedAbort",
    "ScheduleResult",
    "ExploreResult",
    "Scheduler",
    "TrackedDict",
    "checkpoint",
    "explore",
    "instrument",
    "minimize",
    "replay",
    "run_one",
    "shim_installed",
]

# Real primitives, captured before any shim can be installed. The
# scheduler itself runs on these; the shim-off identity test asserts
# ``threading.Lock is _REAL["Lock"]`` after a shim session.
_REAL = {
    "Lock": _threading.Lock,
    "RLock": _threading.RLock,
    "Condition": _threading.Condition,
    "Event": _threading.Event,
    "Semaphore": _threading.Semaphore,
    "Thread": _threading.Thread,
    "Queue": _queue_mod.Queue,
    "sleep": _time_mod.sleep,
    "get_ident": _threading.get_ident,
}

_ACTIVE: Optional["Scheduler"] = None

_THIS_FILE = os.path.abspath(__file__)

# Ops that never conflict with each other on the same object — used by
# the Mazurkiewicz canonicalization to decide commutation.
_READ_OPS = frozenset({"read", "is_set", "qsize", "empty", "is_alive", "locked"})


class SchedAbort(BaseException):
    """Raised inside tasks to unwind them during scheduler teardown.

    BaseException on purpose: ``except Exception`` in code under test
    must not swallow it.
    """


class _Gate:
    """Auto-reset signal built directly on the interpreter's raw lock.

    The scheduler cannot use ``threading.Event`` for its own handoff:
    the real ``Event.__init__`` resolves ``Condition``/``Lock`` from
    the *patched* threading module globals at call time, so gates
    created mid-run would recurse into the shim. A raw ``_thread``
    lock held-when-unsignalled sidesteps the module namespace
    entirely. ``set`` on an already-signalled gate coalesces — the
    handoff protocol produces at most one signal per grant cycle.
    """

    __slots__ = ("_lk",)

    def __init__(self):
        self._lk = _thread_mod.allocate_lock()
        self._lk.acquire()

    def set(self) -> None:
        try:
            self._lk.release()
        except RuntimeError:
            pass  # already signalled

    def wait(self, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            self._lk.acquire()
            return True
        return self._lk.acquire(True, timeout)


def _caller_loc() -> str:
    """file:line of the nearest stack frame outside this module."""
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) == _THIS_FILE:
        f = f.f_back
    if f is None:
        return "?"
    path = f.f_code.co_filename.replace("\\", "/")
    if "/edl_tpu_torch/" in path:
        path = "edl_tpu_torch/" + path.split("/edl_tpu_torch/", 1)[1]
    else:
        path = path.rsplit("/", 1)[-1]
    return f"{path}:{f.f_lineno}"


@dataclass
class OpRecord:
    i: int
    task: str
    op: str
    obj: str
    loc: Optional[str] = None

    def to_record(self) -> dict:
        d = {"i": self.i, "task": self.task, "op": self.op, "obj": self.obj}
        if self.loc:
            d["loc"] = self.loc
        return d


class _Task:
    __slots__ = (
        "name", "gate", "exit_gate", "state", "resource", "timed",
        "wake_reason", "error",
    )

    def __init__(self, name: str):
        self.name = name
        self.gate = _Gate()
        self.exit_gate = _Gate()
        self.state = "new"  # new | runnable | blocked | done
        self.resource: Optional[str] = None
        self.timed = False
        self.wake_reason = "go"  # go | timeout | abort
        self.error: Optional[BaseException] = None


class Scheduler:
    """One schedule: a controller loop granting one task at a time.

    Tasks are real daemon threads, but only the granted one executes
    between handoffs, so scheduler state needs no locking of its own.
    """

    #: wall-clock grace before declaring a granted task hung on a real
    #: (non-shim) blocking call.
    HANG_GRACE_S = 10.0

    def __init__(
        self,
        seed: int = 0,
        max_ops: int = 4000,
        replay: Optional[List[str]] = None,
        guide: Optional[Dict[Tuple[str, ...], Set[str]]] = None,
        guide_depth: int = 48,
    ):
        self.seed = seed
        self.rng = random.Random(seed)
        self.max_ops = max_ops
        self.replay = list(replay) if replay is not None else None
        self.guide = guide
        self.guide_depth = guide_depth
        self.hb = HBState()
        self.tasks: Dict[str, _Task] = {}
        self.trace: List[OpRecord] = []
        self.choices: List[str] = []
        self.failure: Optional[Dict[str, Any]] = None
        self.aborting = False
        self.diverged = False
        self.hit_max_ops = False
        self._control = _Gate()
        self._by_ident: Dict[int, _Task] = {}
        self._counters: Dict[str, int] = {}

    # -- naming / identity ---------------------------------------------------

    def obj_name(self, prefix: str) -> str:
        """Deterministic per-scheduler resource name (creation order —
        never id(), which would break cross-run trace comparison)."""
        n = self._counters.get(prefix, 0)
        self._counters[prefix] = n + 1
        return f"{prefix}#{n}"

    def _current(self) -> Optional[_Task]:
        return self._by_ident.get(_REAL["get_ident"]())

    def in_task(self) -> bool:
        return self._current() is not None

    @property
    def races(self) -> List[Race]:
        return self.hb.races

    # -- failure bookkeeping -------------------------------------------------

    def record_failure(self, kind: str, detail: str, **extra: Any) -> None:
        if self.failure is None:
            self.failure = {
                "kind": kind,
                "detail": detail,
                "trace_len": len(self.trace),
                **extra,
            }

    # -- the handoff protocol ------------------------------------------------

    def _park(self, t: _Task) -> None:
        self._control.set()
        t.gate.wait()
        if t.wake_reason == "abort" or self.aborting:
            raise SchedAbort()

    def op(self, kind: str, obj: str, loc: Optional[str] = None) -> None:
        """A preemption point: park until granted, then record the op
        as executed. Code after the call runs atomically until the
        next op."""
        t = self._current()
        if t is None:
            return
        if self.aborting:
            raise SchedAbort()
        self._park(t)
        self.trace.append(OpRecord(len(self.trace), t.name, kind, obj, loc))

    def block(self, resource: str, timeout: Optional[float] = None) -> str:
        """Park as *blocked* on a resource; return "go" when woken by
        :meth:`wake` or "timeout" when the scheduler elected to fire
        the (abstract) timeout. Callers re-check their predicate
        Mesa-style."""
        t = self._current()
        if t is None:
            return "go"
        if self.aborting:
            raise SchedAbort()
        t.state = "blocked"
        t.resource = resource
        t.timed = timeout is not None
        self._park(t)
        reason = t.wake_reason
        t.resource = None
        t.timed = False
        self.trace.append(
            OpRecord(len(self.trace), t.name, "wake:" + reason, resource)
        )
        return reason

    def wake(self, resource: str) -> None:
        """Mark every task blocked on ``resource`` runnable (no yield)."""
        for t in self.tasks.values():
            if t.state == "blocked" and t.resource == resource:
                t.state = "runnable"
                t.wake_reason = "go"

    def access(self, var: str, write: bool, loc: Optional[str] = None) -> None:
        """A shared-variable access: yield *before* touching the value
        (so a peer can interleave into the window), then stamp it into
        the happens-before detector."""
        t = self._current()
        if t is None:
            return
        if loc is None:
            loc = _caller_loc()
        self.op("write" if write else "read", var, loc)
        self.hb.access(t.name, var, write, loc, op_index=len(self.trace) - 1)

    # -- task lifecycle ------------------------------------------------------

    def spawn(self, name: str, fn: Callable[[], Any]) -> _Task:
        t = _Task(name)
        t.state = "runnable"
        self.tasks[name] = t
        # raw thread start: _REAL["Thread"].__init__ resolves Event from
        # the patched threading globals, so it cannot be used mid-run
        _thread_mod.start_new_thread(self._bootstrap, (t, fn))
        return t

    def _bootstrap(self, t: _Task, fn: Callable[[], Any]) -> None:
        self._by_ident[_REAL["get_ident"]()] = t
        t.gate.wait()
        try:
            if t.wake_reason != "abort" and not self.aborting:
                fn()
        except SchedAbort:
            pass
        except BaseException as e:  # the crash IS the evidence
            t.error = e
            self.record_failure(
                "exception",
                f"{t.name} died: {e!r}",
                task=t.name,
                traceback=traceback.format_exc(limit=8),
            )
        finally:
            t.state = "done"
            self.wake("join:" + t.name)
            t.exit_gate.set()
            self._control.set()

    # -- controller ----------------------------------------------------------

    def run(self, fn: Callable[[], Any], main_name: str = "main") -> None:
        """Run ``fn`` as the root task and schedule until every task is
        done, a failure aborts the run, or the op budget is spent."""
        self.spawn(main_name, fn)
        while True:
            live = [t for t in self.tasks.values() if t.state != "done"]
            if not live:
                break
            if self.failure is not None:
                break
            enabled = [
                t for t in live
                if t.state == "runnable" or (t.state == "blocked" and t.timed)
            ]
            if not enabled:
                blocked = ", ".join(
                    f"{t.name} on {t.resource}" for t in sorted(
                        live, key=lambda x: x.name)
                )
                self.record_failure("deadlock", f"all live tasks blocked: {blocked}")
                break
            if len(self.trace) >= self.max_ops:
                self.hit_max_ops = True
                break
            t = self._choose(enabled)
            if t.state == "blocked":
                t.state = "runnable"
                t.wake_reason = "timeout"
            else:
                t.wake_reason = "go"
            t.gate.set()
            if not self._control.wait(timeout=self.HANG_GRACE_S):
                self.record_failure(
                    "hang",
                    f"task {t.name} did not reach a preemption point within "
                    f"{self.HANG_GRACE_S:.0f}s (blocking on a real, un-shimmed "
                    "primitive?)",
                )
                break
        self._abort_all()

    def _choose(self, enabled: List[_Task]) -> _Task:
        enabled = sorted(enabled, key=lambda t: t.name)
        names = [t.name for t in enabled]
        pick: Optional[str] = None
        if self.replay is not None and len(self.choices) < len(self.replay):
            want = self.replay[len(self.choices)]
            if want in names:
                pick = want
            else:
                self.diverged = True
        if pick is None and self.guide is not None and len(self.choices) < self.guide_depth:
            key = tuple(self.choices)
            tried = self.guide.setdefault(key, set())
            fresh = [n for n in names if n not in tried]
            pick = self.rng.choice(fresh or names)
            tried.add(pick)
        if pick is None:
            pick = self.rng.choice(names)
        self.choices.append(pick)
        return next(t for t in enabled if t.name == pick)

    def _abort_all(self) -> None:
        self.aborting = True
        for t in self.tasks.values():
            if t.state != "done":
                t.wake_reason = "abort"
                t.gate.set()
        for t in self.tasks.values():
            t.exit_gate.wait(timeout=5.0)


# ---------------------------------------------------------------------------
# The sync shim
# ---------------------------------------------------------------------------


def _sched() -> Optional[Scheduler]:
    return _ACTIVE


class ShimLock:
    """Drop-in ``threading.Lock`` (``reentrant=True`` → ``RLock``)
    whose acquire/release are scheduler preemption points and
    happens-before channel ops. Degrades to a no-op pass-through when
    no scheduler is active, so an object that leaks out of a schedule
    can't wedge later code."""

    def __init__(self, reentrant: bool = False):
        s = _sched()
        self._reentrant = reentrant
        self._name = s.obj_name("rlock" if reentrant else "lock") if s else "lock?"
        self._owner: Optional[str] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = _sched()
        if s is None or not s.in_task():
            return True
        t = s._current().name
        s.op("acquire", self._name)
        if self._reentrant and self._owner == t:
            self._depth += 1
            return True
        while self._owner is not None:
            if not blocking:
                return False
            to = None if timeout is None or timeout < 0 else timeout
            if s.block(self._name, timeout=to) == "timeout":
                return False
        self._owner = t
        self._depth = 1
        s.hb.acquire(t, self._name)
        return True

    def release(self) -> None:
        s = _sched()
        if s is None or not s.in_task():
            return
        t = s._current().name
        if self._owner != t:
            raise RuntimeError(
                f"release of {self._name} not owned by {t} (owner={self._owner})"
            )
        s.op("release", self._name)
        self._depth -= 1
        if self._depth == 0:
            s.hb.release(t, self._name)
            self._owner = None
            s.wake(self._name)

    def locked(self) -> bool:
        s = _sched()
        if s is not None and s.in_task():
            s.op("locked", self._name)
        return self._owner is not None

    def __enter__(self) -> "ShimLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


def _shim_lock() -> ShimLock:
    return ShimLock(reentrant=False)


def _shim_rlock() -> ShimLock:
    return ShimLock(reentrant=True)


class NullLock:
    """Mutation-corpus lock: keeps every call site (and its yield
    point) but provides neither mutual exclusion nor happens-before
    edges — it re-opens the exact window a since-fixed race lived in,
    so ``schedcheck`` can prove it would still catch the bug."""

    def __init__(self):
        s = _sched()
        self._name = s.obj_name("nulllock") if s else "nulllock?"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = _sched()
        if s is not None:
            s.op("acquire", self._name)
        return True

    def release(self) -> None:
        s = _sched()
        if s is not None:
            s.op("release", self._name)

    def locked(self) -> bool:
        return False

    def __enter__(self) -> "NullLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class ShimEvent:
    """Drop-in ``threading.Event``; ``set`` publishes the setter's
    clock, a successful ``wait`` imports it."""

    def __init__(self):
        s = _sched()
        self._name = s.obj_name("event") if s else "event?"
        self._flag = False

    def is_set(self) -> bool:
        s = _sched()
        if s is not None and s.in_task():
            s.op("is_set", self._name)
        return self._flag

    def set(self) -> None:
        s = _sched()
        if s is None or not s.in_task():
            self._flag = True
            return
        s.op("set", self._name)
        self._flag = True
        s.hb.release(s._current().name, self._name)
        s.wake(self._name)

    def clear(self) -> None:
        s = _sched()
        if s is not None and s.in_task():
            s.op("clear", self._name)
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        s = _sched()
        if s is None or not s.in_task():
            return self._flag
        s.op("wait", self._name)
        while not self._flag:
            if s.block(self._name, timeout=timeout) == "timeout":
                break
        if self._flag:
            s.hb.acquire(s._current().name, self._name)
        return self._flag


class ShimCondition:
    """Drop-in ``threading.Condition`` with Mesa semantics: ``wait``
    fully releases the lock, parks, and only a ``notify`` targeted at
    it lets it return True; waking re-acquires before returning. A
    waiter nobody notifies (and no timeout) deadlocks — which is the
    lost-wakeup detector."""

    def __init__(self, lock: Optional[ShimLock] = None):
        s = _sched()
        self._lock = lock if lock is not None else _shim_rlock()
        self._name = s.obj_name("cond") if s else "cond?"
        self._waiters: List[str] = []
        self._notified: Set[str] = set()

    def acquire(self, *a: Any, **k: Any) -> bool:
        return self._lock.acquire(*a, **k)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "ShimCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        s = _sched()
        if s is None or not s.in_task():
            return True
        t = s._current().name
        if self._lock._owner != t:
            raise RuntimeError("cannot wait on un-acquired lock")
        depth = self._lock._depth
        s.op("cond_wait", self._name)
        s.hb.release(t, self._lock._name)
        self._lock._owner = None
        self._lock._depth = 0
        s.wake(self._lock._name)
        self._waiters.append(t)
        notified = False
        while True:
            reason = s.block(self._name, timeout=timeout)
            if t in self._notified:
                self._notified.discard(t)
                notified = True
                break
            if reason == "timeout":
                break
        if t in self._waiters:
            self._waiters.remove(t)
        if notified:
            s.hb.acquire(t, self._name)
        # re-acquire at the saved depth
        s.op("acquire", self._lock._name)
        while self._lock._owner is not None:
            s.block(self._lock._name)
        self._lock._owner = t
        self._lock._depth = depth
        s.hb.acquire(t, self._lock._name)
        return notified

    def wait_for(self, predicate: Callable[[], Any],
                 timeout: Optional[float] = None) -> Any:
        result = predicate()
        while not result:
            if not self.wait(timeout=timeout):
                return predicate()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        s = _sched()
        if s is None or not s.in_task():
            return
        t = s._current().name
        if self._lock._owner != t:
            raise RuntimeError("cannot notify on un-acquired lock")
        s.op("notify", self._name)
        s.hb.release(t, self._name)
        for w in self._waiters[:n]:
            self._notified.add(w)
        s.wake(self._name)

    def notify_all(self) -> None:
        self.notify(n=len(self._waiters) or 1)


class ShimQueue:
    """Drop-in ``queue.Queue``: each item is its own happens-before
    channel (put publishes, get imports), so producer work is ordered
    before the consumer that received that exact item — and nothing
    else."""

    def __init__(self, maxsize: int = 0):
        s = _sched()
        self._name = s.obj_name("queue") if s else "queue?"
        self._maxsize = maxsize
        self._items: List[Tuple[str, Any]] = []
        self._seq = 0

    def qsize(self) -> int:
        s = _sched()
        if s is not None and s.in_task():
            s.op("qsize", self._name)
        return len(self._items)

    def empty(self) -> bool:
        s = _sched()
        if s is not None and s.in_task():
            s.op("empty", self._name)
        return not self._items

    def full(self) -> bool:
        return self._maxsize > 0 and len(self._items) >= self._maxsize

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        s = _sched()
        if s is None or not s.in_task():
            self._items.append(("?", item))
            return
        t = s._current().name
        s.op("put", self._name)
        while self._maxsize > 0 and len(self._items) >= self._maxsize:
            if not block:
                raise _queue_mod.Full
            if s.block(self._name + ":put", timeout=timeout) == "timeout":
                raise _queue_mod.Full
        chan = f"{self._name}:item{self._seq}"
        self._seq += 1
        s.hb.release(t, chan)
        self._items.append((chan, item))
        s.wake(self._name + ":get")

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        s = _sched()
        if s is None or not s.in_task():
            if not self._items:
                raise _queue_mod.Empty
            return self._items.pop(0)[1]
        t = s._current().name
        s.op("get", self._name)
        while not self._items:
            if not block:
                raise _queue_mod.Empty
            if s.block(self._name + ":get", timeout=timeout) == "timeout":
                raise _queue_mod.Empty
        chan, item = self._items.pop(0)
        s.hb.acquire(t, chan)
        s.wake(self._name + ":put")
        return item

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def task_done(self) -> None:
        pass

    def join(self) -> None:
        pass


class ShimThread:
    """Drop-in ``threading.Thread`` mapping start/join to scheduler
    fork/join. Subclass-with-``run()`` style is supported; ``is_alive``
    is a preemption point so health-polling loops make progress."""

    def __init__(self, group: Any = None, target: Optional[Callable] = None,
                 name: Optional[str] = None, args: Tuple = (),
                 kwargs: Optional[dict] = None, *, daemon: Optional[bool] = None):
        s = _sched()
        if s is None:
            raise RuntimeError("ShimThread created with no active scheduler")
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self._name = s.obj_name(name or "thread")
        self.daemon = bool(daemon) if daemon is not None else True
        self._task: Optional[_Task] = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def ident(self) -> Optional[int]:
        return None if self._task is None else id(self._task)

    def run(self) -> None:
        if self._target is not None:
            self._target(*self._args, **self._kwargs)

    def start(self) -> None:
        s = _sched()
        if s is None:
            raise RuntimeError("ShimThread.start with no active scheduler")
        if self._task is not None:
            raise RuntimeError("threads can only be started once")
        parent = s._current().name if s.in_task() else "main"
        s.op("thread_start", self._name)
        s.hb.fork(parent, self._name)
        self._task = s.spawn(self._name, self.run)

    def is_alive(self) -> bool:
        s = _sched()
        if s is not None and s.in_task():
            s.op("is_alive", self._name)
        return self._task is not None and self._task.state != "done"

    def join(self, timeout: Optional[float] = None) -> None:
        s = _sched()
        if s is None or not s.in_task():
            return
        if self._task is None:
            raise RuntimeError("cannot join thread before it is started")
        t = s._current().name
        s.op("join", self._name)
        while self._task.state != "done":
            if s.block("join:" + self._name, timeout=timeout) == "timeout":
                return
        s.hb.join(t, self._name)


def _shim_sleep(secs: float) -> None:
    s = _sched()
    if s is not None and s.in_task():
        s.op("sleep", "time")
    # no real sleeping: scheduler time is abstract


# ---------------------------------------------------------------------------
# Attribute instrumentation
# ---------------------------------------------------------------------------


def instrument(obj: Any, fields: List[str], name: Optional[str] = None) -> Any:
    """Swap ``obj``'s class for a dynamic subclass whose watched
    attribute reads/writes yield to the scheduler *before* the access
    and feed the happens-before detector. Returns ``obj``."""
    base = type(obj)
    s = _sched()
    label = name or (s.obj_name(base.__name__) if s else base.__name__)
    watched = frozenset(fields)

    def __getattribute__(self: Any, attr: str) -> Any:
        if attr in watched:
            sch = _ACTIVE
            if sch is not None and sch.in_task():
                sch.access(f"{label}.{attr}", write=False, loc=_caller_loc())
        return base.__getattribute__(self, attr)

    def __setattr__(self: Any, attr: str, value: Any) -> None:
        if attr in watched:
            sch = _ACTIVE
            if sch is not None and sch.in_task():
                sch.access(f"{label}.{attr}", write=True, loc=_caller_loc())
        base.__setattr__(self, attr, value)

    sub = type(
        "Instrumented" + base.__name__,
        (base,),
        {"__getattribute__": __getattribute__, "__setattr__": __setattr__},
    )
    obj.__class__ = sub
    return obj


class TrackedDict(dict):
    """Dict whose operations are container-granularity shared accesses
    (mutations = writes, lookups/iteration = reads) on one variable —
    for shared registries like ``Controller.updaters``."""

    def __init__(self, label: str, *a: Any, **k: Any):
        super().__init__(*a, **k)
        self._label = label

    def _acc(self, write: bool) -> None:
        sch = _ACTIVE
        if sch is not None and sch.in_task():
            sch.access(self._label, write=write, loc=_caller_loc())

    def __getitem__(self, k: Any) -> Any:
        self._acc(False)
        return dict.__getitem__(self, k)

    def get(self, k: Any, default: Any = None) -> Any:
        self._acc(False)
        return dict.get(self, k, default)

    def __contains__(self, k: Any) -> bool:
        self._acc(False)
        return dict.__contains__(self, k)

    def __len__(self) -> int:
        self._acc(False)
        return dict.__len__(self)

    def __iter__(self):
        self._acc(False)
        return dict.__iter__(self)

    def keys(self):
        self._acc(False)
        return dict.keys(self)

    def values(self):
        self._acc(False)
        return dict.values(self)

    def items(self):
        self._acc(False)
        return dict.items(self)

    def __setitem__(self, k: Any, v: Any) -> None:
        self._acc(True)
        dict.__setitem__(self, k, v)

    def __delitem__(self, k: Any) -> None:
        self._acc(True)
        dict.__delitem__(self, k)

    def pop(self, k: Any, *default: Any) -> Any:
        self._acc(True)
        return dict.pop(self, k, *default)

    def update(self, *a: Any, **k: Any) -> None:
        self._acc(True)
        dict.update(self, *a, **k)

    def clear(self) -> None:
        self._acc(True)
        dict.clear(self)


def checkpoint(label: str = "checkpoint") -> None:
    """Explicit preemption point for harness code (e.g. inside a stub
    generator that otherwise performs no shim ops)."""
    s = _sched()
    if s is not None and s.in_task():
        s.op("yield", label)


# ---------------------------------------------------------------------------
# Shim installation
# ---------------------------------------------------------------------------


@contextmanager
def shim_installed(sched: Scheduler):
    """Patch ``threading``/``queue``/``time`` module attributes to the
    shim for the duration; restore the exact original objects after.
    Target modules all use ``import threading; threading.X(...)``
    (verified — no ``from threading import`` in edl_tpu_torch), so module-
    attribute patching reaches every construction site."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a scheduler is already active in this process")
    _ACTIVE = sched
    log_threads = _logging.logThreads
    _threading.Lock = _shim_lock
    _threading.RLock = _shim_rlock
    _threading.Condition = ShimCondition
    _threading.Event = ShimEvent
    _threading.Thread = ShimThread
    _queue_mod.Queue = ShimQueue
    _time_mod.sleep = _shim_sleep
    # logging must not call current_thread() from a scheduler task: the
    # _DummyThread it would create builds an Event from the patched
    # globals, turning a log line into a surprise preemption point
    _logging.logThreads = False
    try:
        yield sched
    finally:
        _threading.Lock = _REAL["Lock"]
        _threading.RLock = _REAL["RLock"]
        _threading.Condition = _REAL["Condition"]
        _threading.Event = _REAL["Event"]
        _threading.Thread = _REAL["Thread"]
        _queue_mod.Queue = _REAL["Queue"]
        _time_mod.sleep = _REAL["sleep"]
        _logging.logThreads = log_threads
        _ACTIVE = None


# ---------------------------------------------------------------------------
# Exploration
# ---------------------------------------------------------------------------


@dataclass
class ScheduleResult:
    seed: int
    choices: List[str]
    trace: List[OpRecord]
    races: List[Race]
    failure: Optional[Dict[str, Any]]
    diverged: bool = False
    hit_max_ops: bool = False

    @property
    def race_keys(self) -> Set[str]:
        return {r.key for r in self.races}


def run_one(
    harness: Callable[[], Any],
    seed: int,
    replay_choices: Optional[List[str]] = None,
    max_ops: int = 4000,
    guide: Optional[Dict[Tuple[str, ...], Set[str]]] = None,
) -> ScheduleResult:
    """Execute one schedule of ``harness`` under the shim."""
    sched = Scheduler(seed=seed, max_ops=max_ops, replay=replay_choices, guide=guide)
    with shim_installed(sched):
        sched.run(harness)
    return ScheduleResult(
        seed=seed,
        choices=sched.choices,
        trace=sched.trace,
        races=list(sched.races),
        failure=sched.failure,
        diverged=sched.diverged,
        hit_max_ops=sched.hit_max_ops,
    )


def replay(
    harness: Callable[[], Any],
    choices: List[str],
    seed: int,
    max_ops: int = 4000,
) -> ScheduleResult:
    return run_one(harness, seed, replay_choices=choices, max_ops=max_ops)


def _independent(a: Tuple[str, str, str], b: Tuple[str, str, str]) -> bool:
    if a[2] != b[2]:
        return True
    return a[1] in _READ_OPS and b[1] in _READ_OPS


def canonical_hash(trace: List[OpRecord]) -> str:
    """Mazurkiewicz canonical form: bubble adjacent independent ops of
    different tasks into sorted order, then hash — schedules that only
    commute independent ops collapse to one equivalence class."""
    seq = [(r.task, r.op, r.obj) for r in trace]
    for _ in range(len(seq)):
        changed = False
        for i in range(len(seq) - 1):
            a, b = seq[i], seq[i + 1]
            if a[0] != b[0] and _independent(a, b) and b < a:
                seq[i], seq[i + 1] = b, a
                changed = True
        if not changed:
            break
    return hashlib.sha1(repr(seq).encode()).hexdigest()[:16]


def minimize(
    harness: Callable[[], Any],
    choices: List[str],
    seed: int,
    predicate: Callable[[ScheduleResult], bool],
    max_ops: int = 4000,
    budget: int = 160,
) -> List[str]:
    """Greedy one-delta schedule minimization: drop one choice at a
    time, keep the deletion if the predicate (same failure / same race)
    still holds on replay. Bounded by ``budget`` replays."""
    best = list(choices)
    spent = 0
    for _ in range(3):
        i = 0
        shrunk = False
        while i < len(best) and spent < budget:
            cand = best[:i] + best[i + 1:]
            spent += 1
            res = run_one(harness, seed, replay_choices=cand, max_ops=max_ops)
            if predicate(res):
                best = cand
                shrunk = True
            else:
                i += 1
        if not shrunk or spent >= budget:
            break
    return best


@dataclass
class ExploreResult:
    name: str
    schedules: int
    distinct_traces: int
    equivalent_pruned: int
    races: List[Dict[str, Any]] = field(default_factory=list)
    failure: Optional[Dict[str, Any]] = None
    elapsed_s: float = 0.0
    ops_total: int = 0

    @property
    def evidence(self) -> bool:
        return bool(self.races) or self.failure is not None

    def to_record(self) -> dict:
        return {
            "harness": self.name,
            "schedules": self.schedules,
            "distinct_traces": self.distinct_traces,
            "equivalent_pruned": self.equivalent_pruned,
            "races": self.races,
            "failure": self.failure,
            "elapsed_s": round(self.elapsed_s, 3),
            "ops_total": self.ops_total,
        }


def explore(
    harness: Callable[[], Any],
    name: str,
    schedules: int = 24,
    seed: int = 0,
    max_ops: int = 4000,
    stop_on_evidence: bool = False,
    trace_dir: Optional[str] = None,
    minimize_evidence: bool = True,
) -> ExploreResult:
    """Random-walk ``schedules`` interleavings of ``harness`` (child
    seed ``seed*10007+k``), sharing an untried-first guide across
    schedules, deduping Mazurkiewicz-equivalent traces, and minimizing
    the schedule behind each piece of evidence."""
    t0 = _time_mod.monotonic()
    guide: Dict[Tuple[str, ...], Set[str]] = {}
    seen_hashes: Set[str] = set()
    pruned = 0
    ops_total = 0
    race_info: Dict[str, Dict[str, Any]] = {}
    failure: Optional[Dict[str, Any]] = None
    ran = 0

    for k in range(schedules):
        child_seed = seed * 10007 + k
        res = run_one(harness, child_seed, max_ops=max_ops, guide=guide)
        ran += 1
        ops_total += len(res.trace)
        h = canonical_hash(res.trace)
        if h in seen_hashes:
            pruned += 1
        else:
            seen_hashes.add(h)
        for r in res.races:
            if r.key not in race_info:
                race_info[r.key] = {
                    **r.to_record(),
                    "seed": child_seed,
                    "schedule": k,
                    "choices": list(res.choices),
                }
        if failure is None and res.failure is not None:
            failure = {
                **res.failure,
                "seed": child_seed,
                "schedule": k,
                "choices": list(res.choices),
            }
        if stop_on_evidence and (race_info or failure is not None):
            break

    if minimize_evidence:
        for key, info in race_info.items():
            forced = minimize(
                harness, info["choices"], info["seed"],
                lambda r, _k=key: _k in r.race_keys, max_ops=max_ops,
            )
            info["forced_prefix"] = forced
            # replaying the forced prefix reproduces the race (the full
            # original choice list always does; minimize only accepted
            # deletions that kept the predicate true) — the op window
            # between the two accesses is the printable minimal schedule
            rep = run_one(harness, info["seed"], replay_choices=forced,
                          max_ops=max_ops)
            hit = next((r for r in rep.races if r.key == key), None)
            if hit is not None:
                hi = max(hit.a.op_index, hit.b.op_index)
                lo = min(hit.a.op_index, hit.b.op_index)
                window = rep.trace[max(lo, hi - 29): hi + 1]
                info["minimal_schedule"] = [t.to_record() for t in window]
            else:
                info["minimal_schedule"] = []
            info.pop("choices", None)
        if failure is not None:
            kind = failure["kind"]
            forced = minimize(
                harness, failure["choices"], failure["seed"],
                lambda r, _k=kind: r.failure is not None and r.failure["kind"] == _k,
                max_ops=max_ops,
            )
            failure["forced_prefix"] = forced
            rep = run_one(harness, failure["seed"], replay_choices=forced,
                          max_ops=max_ops)
            failure["minimal_schedule"] = [
                t.to_record() for t in rep.trace[-20:]
            ]
            failure.pop("choices", None)

    out = ExploreResult(
        name=name,
        schedules=ran,
        distinct_traces=len(seen_hashes),
        equivalent_pruned=pruned,
        races=sorted(race_info.values(), key=lambda d: d["var"]),
        failure=failure,
        elapsed_s=_time_mod.monotonic() - t0,
        ops_total=ops_total,
    )
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{name}.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"type": "summary", **out.to_record()}) + "\n")
            for info in out.races:
                f.write(json.dumps({"type": "race", **info}) + "\n")
            if failure is not None:
                f.write(json.dumps({"type": "failure", **failure}) + "\n")
    return out
