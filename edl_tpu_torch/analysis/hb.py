"""Vector-clock happens-before race detection — the dynamic twin of
the ``lockset-race`` static rule.

The lockset rule answers "is there a single lock that protects this
attribute everywhere?" — a *convention* check that cannot tell a
latent race from a deliberately lock-free hand-off. This module
answers the stronger question for one concrete execution: **were two
conflicting accesses actually unordered by any synchronization?**
Following FastTrack's happens-before formulation (but with full
vector clocks — the fleets here are under ten tasks, so the epoch
optimization buys nothing and full clocks keep the code obvious):

* every task carries a vector clock, incremented at each of its own
  synchronization operations;
* every synchronization *channel* (lock, condition, event, queue
  item, thread fork/join) carries the clock of its last releaser;
  acquiring/observing the channel joins that clock into the acquirer;
* every shared-variable access is stamped with the accessing task's
  clock; two conflicting accesses (same variable, at least one write)
  race iff neither's clock is ≤ the other's at the owning component.

A race reported here is real *for the synchronization the execution
actually performed* — no lockset heuristics, no ``*_locked`` naming
conventions. The scheduler (:mod:`edl_tpu_torch.analysis.sched`) drives the
channel/access callbacks; this module is pure bookkeeping and has no
threading of its own, so it is unit-testable without the shim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["Access", "HBState", "Race", "VClock"]


class VClock:
    """A vector clock: task name -> local event counter."""

    __slots__ = ("c",)

    def __init__(self, c: Optional[Dict[str, int]] = None):
        self.c: Dict[str, int] = dict(c) if c else {}

    def copy(self) -> "VClock":
        return VClock(self.c)

    def tick(self, task: str) -> None:
        self.c[task] = self.c.get(task, 0) + 1

    def join(self, other: "VClock") -> None:
        for k, v in other.c.items():
            if v > self.c.get(k, 0):
                self.c[k] = v

    def get(self, task: str) -> int:
        return self.c.get(task, 0)

    def __repr__(self) -> str:  # debugging / trace dumps
        inner = ",".join(f"{k}:{v}" for k, v in sorted(self.c.items()))
        return "{" + inner + "}"


@dataclass(frozen=True)
class Access:
    """One recorded shared-variable access, stamped with the accessing
    task's clock at access time."""

    task: str
    write: bool
    loc: str  # "file.py:123" of the access site in code under test
    clock: VClock
    op_index: int  # position in the scheduler trace (repro pointer)

    def happens_before(self, clock: VClock) -> bool:
        """True iff this access is ordered before a point whose clock
        is ``clock`` — the standard component test: A hb B iff
        A.clock[A.task] <= B.clock[A.task]."""
        return self.clock.get(self.task) <= clock.get(self.task)

    @property
    def op(self) -> str:
        return "write" if self.write else "read"


@dataclass(frozen=True)
class Race:
    """Two conflicting, happens-before-unordered accesses to one
    shared variable."""

    var: str
    a: Access  # earlier in the trace
    b: Access

    @property
    def key(self) -> str:
        """Stable identity for dedup across schedules: the variable and
        the two code sites, orientation-insensitive."""
        sites = sorted([f"{self.a.op}@{self.a.loc}", f"{self.b.op}@{self.b.loc}"])
        return f"{self.var}|{sites[0]}|{sites[1]}"

    @property
    def message(self) -> str:
        return (
            f"race on {self.var}: {self.a.op} at {self.a.loc} "
            f"({self.a.task}) is unordered with {self.b.op} at "
            f"{self.b.loc} ({self.b.task})"
        )

    def to_record(self) -> dict:
        return {
            "var": self.var,
            "a": {"task": self.a.task, "op": self.a.op, "loc": self.a.loc,
                  "op_index": self.a.op_index},
            "b": {"task": self.b.task, "op": self.b.op, "loc": self.b.loc,
                  "op_index": self.b.op_index},
            "message": self.message,
        }


class _VarState:
    """Per-variable access history: the last write plus the last read
    of each task since that write (the minimal frontier the race check
    needs — an older read is ordered before the newer read of the same
    task, so racing with the older implies racing with the newer or
    with the write that cleared it)."""

    __slots__ = ("last_write", "reads")

    def __init__(self):
        self.last_write: Optional[Access] = None
        self.reads: Dict[str, Access] = {}


class HBState:
    """The detector: task clocks, channel clocks, per-variable access
    frontiers, and the list of discovered races."""

    def __init__(self):
        self.clocks: Dict[str, VClock] = {}
        self.channels: Dict[str, VClock] = {}
        self.vars: Dict[str, _VarState] = {}
        self.races: List[Race] = []
        self._race_keys: set = set()

    # -- task lifecycle ------------------------------------------------------

    def ensure_task(self, task: str) -> VClock:
        vc = self.clocks.get(task)
        if vc is None:
            vc = VClock({task: 1})
            self.clocks[task] = vc
        return vc

    def fork(self, parent: str, child: str) -> None:
        """Thread start: the child begins after everything the parent
        has done so far."""
        pv = self.ensure_task(parent)
        cv = self.ensure_task(child)
        cv.join(pv)
        cv.tick(child)
        pv.tick(parent)

    def join(self, parent: str, child: str) -> None:
        """Successful thread join: the parent continues after
        everything the child ever did."""
        self.ensure_task(parent).join(self.ensure_task(child))
        self.ensure_task(parent).tick(parent)

    # -- synchronization channels -------------------------------------------

    def release(self, task: str, channel: str) -> None:
        """Publish the task's clock on a channel: lock release, event
        set, condition notify, queue put."""
        vc = self.ensure_task(task)
        ch = self.channels.setdefault(channel, VClock())
        ch.join(vc)
        vc.tick(task)

    def acquire(self, task: str, channel: str) -> None:
        """Import a channel's clock: lock acquire, successful event
        wait, notified condition wait, queue get."""
        ch = self.channels.get(channel)
        if ch is not None:
            self.ensure_task(task).join(ch)
        self.ensure_task(task).tick(task)

    # -- shared accesses -----------------------------------------------------

    def access(
        self, task: str, var: str, write: bool, loc: str, op_index: int = -1
    ) -> Optional[Race]:
        """Record one access; returns a Race if it conflicts with an
        unordered prior access (first time this (var, site-pair) is
        seen), else None."""
        vc = self.ensure_task(task)
        acc = Access(task, write, loc, vc.copy(), op_index)
        st = self.vars.setdefault(var, _VarState())

        race: Optional[Race] = None
        w = st.last_write
        if w is not None and w.task != task and not w.happens_before(vc):
            race = self._report(var, w, acc)
        if write:
            for r in st.reads.values():
                if r.task != task and not r.happens_before(vc):
                    race = self._report(var, r, acc) or race
            st.last_write = acc
            st.reads.clear()
        else:
            st.reads[task] = acc
        return race

    def _report(self, var: str, a: Access, b: Access) -> Optional[Race]:
        r = Race(var, a, b)
        if r.key in self._race_keys:
            return None
        self._race_keys.add(r.key)
        self.races.append(r)
        return r
