"""ChipLeaseBroker — the cluster's chip inventory as first-class leases:
the port of ``edl_tpu/elasticity/broker.py`` (the same state machine,
flight events, gauges and fault site).

Every chip the elasticity plane can move belongs to exactly one of two
places at any instant: the broker's free pool, or a live lease held by
a side of the system (``train:*`` or ``serve:*`` holders). A lease
walks a one-way state machine:

    GRANTED ──recall()──▶ RECALLING ──free()──▶ FREED

``recall`` is the broker asking the holder to give the chips back (the
holder then shrinks — a trainer reshard or a replica drain — and calls
``free``); it is idempotent while RECALLING so a retried recall RPC is
safe. ``free`` returns the chips to the pool. A holder that dies
mid-conversation is settled by :meth:`ChipLeaseBroker.holder_crashed`:
whatever it held (GRANTED or stuck RECALLING) returns to the pool,
because the recall ack will never come.

Epochs are globally monotonic — every grant bumps the broker epoch and
stamps the lease with it, so any two leases are ordered and a stale
grant can never be mistaken for a current one (the lease analog of the
reshard epoch in ``runtime/elastic.py``).

Concurrency: one ``_lock`` guards the table, the free count, and the
epoch. State is mutated under the lock; flight events and gauge
updates are published after release (no I/O under the table lock).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils import faults
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("lease")

GRANTED = "GRANTED"
RECALLING = "RECALLING"
FREED = "FREED"


class LeaseError(RuntimeError):
    """Illegal lease transition or an unsatisfiable grant."""


@dataclass
class Lease:
    """One chip allocation. ``holder`` is ``side:name`` (``train:job0``,
    ``serve:r3``); the side prefix keys the per-side gauge."""

    lease_id: str
    holder: str
    chips: int
    epoch: int
    state: str = GRANTED
    granted_t: float = 0.0
    recalled_t: Optional[float] = None
    freed_t: Optional[float] = None

    @property
    def side(self) -> str:
        return self.holder.split(":", 1)[0]


class ChipLeaseBroker:
    """Grant/recall/free chip leases against a fixed ``total_chips``
    inventory. Conservation is the core invariant: at every quiescent
    point, chips under live (non-FREED) leases plus the free pool equal
    the inventory — :meth:`check_conservation` asserts it, and the
    controller's callers check it after every tick."""

    def __init__(
        self,
        total_chips: int,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        clock=time.monotonic,
    ):
        if total_chips <= 0:
            raise ValueError(f"total_chips must be >= 1, got {total_chips}")
        self.total_chips = total_chips
        self.clock = clock
        self._lock = threading.Lock()
        self._leases: Dict[str, Lease] = {}
        self._free = total_chips
        self._epoch = 0
        self._sides: set = set()  # sides ever seen: zero their gauges
        reg = registry or obs_metrics.default_registry()
        self._g_chips = reg.gauge(
            "edl_lease_chips",
            "chips under live (GRANTED/RECALLING) leases, by holder side",
            ("side",),
        )
        self._g_free = reg.gauge(
            "edl_lease_chips_free", "chips in the broker pool, unleased"
        )
        self._g_leases = reg.gauge(
            "edl_leases", "lease count by state", ("state",)
        )
        self._g_epoch = reg.gauge(
            "edl_lease_epoch", "broker lease epoch (bumps on every grant)"
        )
        with self._lock:
            doc = self._gauges_locked()
        self._publish(doc)

    # -- queries -------------------------------------------------------------

    @property
    def free_chips(self) -> int:
        with self._lock:
            return self._free

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def get(self, lease_id: str) -> Optional[Lease]:
        with self._lock:
            lease = self._leases.get(lease_id)
            return replace(lease) if lease is not None else None

    def snapshot(self) -> List[Lease]:
        """Copies — callers can't mutate broker state through them."""
        with self._lock:
            return [replace(l) for l in self._leases.values()]

    def live(self, holder: Optional[str] = None) -> List[Lease]:
        """Non-FREED leases, optionally for one holder."""
        with self._lock:
            return [
                replace(l)
                for l in self._leases.values()
                if l.state != FREED
                and (holder is None or l.holder == holder)
            ]

    def check_conservation(self) -> bool:
        """granted + free == total — the invariant every transition
        must preserve."""
        with self._lock:
            leased = sum(
                l.chips for l in self._leases.values() if l.state != FREED
            )
            return leased + self._free == self.total_chips

    # -- transitions ---------------------------------------------------------

    def grant(self, holder: str, chips: int) -> Lease:
        """Lease ``chips`` to ``holder``. Raises :class:`LeaseError`
        when the pool can't cover it — a double grant of the same chips
        is structurally impossible because the pool is debited under
        the lock before the lease exists."""
        if chips <= 0:
            raise ValueError(f"grant chips must be >= 1, got {chips}")
        with self._lock:
            if chips > self._free:
                raise LeaseError(
                    f"grant({holder}, {chips}): only {self._free}/"
                    f"{self.total_chips} chips free"
                )
            self._free -= chips
            self._epoch += 1
            lease = Lease(
                lease_id=f"L{self._epoch:04d}",
                holder=holder,
                chips=chips,
                epoch=self._epoch,
                granted_t=self.clock(),
            )
            self._leases[lease.lease_id] = lease
            self._sides.add(lease.side)
            doc = self._gauges_locked()
        self._publish(doc)
        flight.emit(
            "lease.grant",
            site="lease.grant",
            worker=holder,
            reshard_epoch=lease.epoch,
            lease=lease.lease_id,
            chips=chips,
            free=doc["free"],
        )
        log.info("grant", lease=lease.lease_id, holder=holder, chips=chips,
                 epoch=lease.epoch, free=doc["free"])
        return replace(lease)

    def recall(self, lease_id: str) -> Lease:
        """GRANTED → RECALLING: ask the holder for the chips back.
        Idempotent while RECALLING (a retried recall is a no-op)."""
        # chaos site: an injected raise here models the recall RPC
        # failing before any state moved — the lease is untouched, so
        # the caller's retry is safe (the controller's retry emits
        # ``lease.recover``)
        faults.fault_point("lease.recall")
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise LeaseError(f"recall: unknown lease {lease_id}")
            if lease.state == FREED:
                raise LeaseError(f"recall: lease {lease_id} already FREED")
            already = lease.state == RECALLING
            if not already:
                lease.state = RECALLING
                lease.recalled_t = self.clock()
            doc = self._gauges_locked()
            out = replace(lease)
        if already:
            return out  # idempotent retry: no second event
        self._publish(doc)
        flight.emit(
            "lease.recall",
            site="lease.recall",
            worker=out.holder,
            reshard_epoch=out.epoch,
            lease=out.lease_id,
            chips=out.chips,
        )
        log.info("recall", lease=out.lease_id, holder=out.holder,
                 chips=out.chips)
        return out

    def free(self, lease_id: str) -> int:
        """RECALLING → FREED: the holder has shrunk; chips return to
        the pool. Returns the chips freed (0 on an idempotent repeat).
        A GRANTED lease must be recalled first — the two-step keeps the
        holder's shrink inside the RECALLING window where the broker
        won't re-grant those chips."""
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise LeaseError(f"free: unknown lease {lease_id}")
            if lease.state == FREED:
                return 0
            if lease.state != RECALLING:
                raise LeaseError(
                    f"free: lease {lease_id} is {lease.state}, "
                    "not RECALLING (recall first)"
                )
            lease.state = FREED
            lease.freed_t = self.clock()
            self._free += lease.chips
            doc = self._gauges_locked()
            out = replace(lease)
        self._publish(doc)
        flight.emit(
            "lease.freed",
            site="lease.freed",
            worker=out.holder,
            reshard_epoch=out.epoch,
            lease=out.lease_id,
            chips=out.chips,
            free=doc["free"],
        )
        log.info("freed", lease=out.lease_id, holder=out.holder,
                 chips=out.chips, free=doc["free"])
        return out.chips

    def holder_crashed(self, holder: str) -> List[Lease]:
        """Settle a dead holder: every lease it held — GRANTED or stuck
        mid-RECALLING (the ack will never come) — returns to the pool
        in one transition."""
        with self._lock:
            now = self.clock()
            dead = []
            for lease in self._leases.values():
                if lease.holder == holder and lease.state != FREED:
                    lease.state = FREED
                    lease.freed_t = now
                    self._free += lease.chips
                    dead.append(replace(lease))
            doc = self._gauges_locked()
        if not dead:
            return []
        self._publish(doc)
        for lease in dead:
            flight.emit(
                "lease.freed",
                severity="warn",
                site="lease.freed",
                worker=holder,
                reshard_epoch=lease.epoch,
                lease=lease.lease_id,
                chips=lease.chips,
                crashed=True,
                free=doc["free"],
            )
        log.warn("holder_crashed", holder=holder, leases=len(dead),
                 chips=sum(l.chips for l in dead))
        return dead

    # -- observability -------------------------------------------------------

    def _gauges_locked(self) -> Dict:
        by_side = {side: 0 for side in self._sides}
        by_state = {GRANTED: 0, RECALLING: 0, FREED: 0}
        for lease in self._leases.values():
            by_state[lease.state] += 1
            if lease.state != FREED:
                by_side[lease.side] = by_side.get(lease.side, 0) + lease.chips
        return {
            "free": self._free,
            "epoch": self._epoch,
            "by_side": by_side,
            "by_state": by_state,
        }

    def _publish(self, doc: Dict) -> None:
        self._g_free.set(doc["free"])
        self._g_epoch.set(doc["epoch"])
        for side, chips in doc["by_side"].items():
            self._g_chips.set(chips, side=side)
        for state, n in doc["by_state"].items():
            self._g_leases.set(n, state=state)
