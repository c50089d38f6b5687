"""LeaseTable — the chip-lease state machine behind the coordinator.

The pure-Python twin of the native coordinator's chip-lease core
(native/coordinator/coordinator.cc): one shared pool, leases fenced by
a globally monotonic epoch, every mutation pushed through a persist
hook so a restarted broker resumes with exact accounting. Used two
ways:

* embedded by :class:`~edl_tpu_torch.runtime.coordinator.PyCoordinator`
  (persisting the doc into its KV under ``lease/table``) so the
  toolchain-free fallback speaks the same lease API as the native
  server;
* directly by the ``dist-lease-broker`` schedcheck harness, which
  drives the RECOVERING window's confirm-vs-expire race under the
  deterministic scheduler.

Return values mirror the wire protocol, not exceptions: ``confirm``
answers ``"ok" | "stale_epoch" | "freed" | "unknown"`` exactly like
``LCONFIRM`` answers ``OK | FENCED <reason>``, so the client adapter
treats the native and Python backends identically.

Crash discipline: state mutates in memory, then the doc is persisted,
then the caller sees the reply. The ``lease.persist`` fault site sits
between persist and reply — the lost-reply window — so an injected
raise leaves a durably persisted grant whose caller never heard back;
the client-supplied idempotency token makes the retry return the same
lease instead of double-granting the chips.

The port of ``edl_tpu/runtime/lease_table.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from edl_tpu_torch.utils import faults

# state codes match the native ChipLease struct
GRANTED = 0
RECALLING = 1
FREED = 2


@dataclass
class LeaseRow:
    """One lease as the coordinator sees it (int id, int state — the
    broker-side :class:`~edl_tpu_torch.elasticity.broker.Lease` is the
    human-facing view)."""

    id: int
    holder: str
    chips: int
    epoch: int
    state: int = GRANTED
    token: str = ""
    confirmed: bool = False


class LeaseTable:
    """Grant/recall/free/confirm over one shared pool, with epoch
    fencing and a RECOVERING re-confirmation window after restore."""

    def __init__(
        self,
        persist: Optional[Callable[[dict], None]] = None,
        recover_window_s: float = 5.0,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        self._leases: Dict[int, LeaseRow] = {}
        self._pool = 0
        self._free = 0
        self._epoch = 0  # globally monotonic; never reset
        self._next_id = 1
        self._recovering = False
        self._recover_started = 0.0
        self.recover_window_s = recover_window_s
        self._persist = persist
        self._clock = clock

    # -- persistence ---------------------------------------------------------

    def _doc_locked(self) -> dict:
        # FREED rows are history, not state: only live leases persist
        # (same policy as the native WAL snapshot's SLL lines)
        return {
            "pool": self._pool,
            "epoch": self._epoch,
            "next_id": self._next_id,
            "leases": [
                {
                    "id": l.id,
                    "holder": l.holder,
                    "chips": l.chips,
                    "epoch": l.epoch,
                    "state": l.state,
                    "token": l.token,
                }
                for l in self._leases.values()
                if l.state != FREED
            ],
        }

    def _persist_locked(self) -> None:
        if self._persist is not None:
            self._persist(self._doc_locked())
        # chaos site: the injected raise lands after the doc is durably
        # persisted but before the caller sees a reply — the lost-reply
        # window the idempotency token must absorb (conservation is
        # asserted across a restore from exactly this point)
        faults.fault_point("lease.persist")

    def restore(self, doc: dict) -> None:
        """Broker restart: rebuild from the last persisted doc. Live
        leases come back unconfirmed (confirms are session-local, like
        member TTLs) and the table enters RECOVERING: holders must
        re-confirm within the window or :meth:`expire` force-releases
        them. Free is recomputed from first principles so conservation
        holds no matter where in a mutation the old process died."""
        with self._lock:
            self._pool = int(doc.get("pool", 0))
            self._epoch = max(self._epoch, int(doc.get("epoch", 0)))
            self._next_id = max(self._next_id, int(doc.get("next_id", 1)))
            self._leases = {}
            live = 0
            for d in doc.get("leases", ()):
                row = LeaseRow(
                    id=int(d["id"]),
                    holder=d["holder"],
                    chips=int(d["chips"]),
                    epoch=int(d["epoch"]),
                    state=int(d.get("state", GRANTED)),
                    token=d.get("token", ""),
                    confirmed=False,
                )
                self._leases[row.id] = row
                if row.state != FREED:
                    live += row.chips
            self._free = self._pool - live
            if any(l.state != FREED for l in self._leases.values()):
                self._recovering = True
                self._recover_started = self._clock()

    # -- queries -------------------------------------------------------------

    @property
    def recovering(self) -> bool:
        with self._lock:
            return self._recovering

    def snap(self) -> dict:
        """Same shape as the parsed ``LSNAP`` reply."""
        with self._lock:
            return {
                "pool": self._pool,
                "free": self._free,
                "epoch": self._epoch,
                "recovering": self._recovering,
                "leases": [
                    {
                        "id": l.id,
                        "holder": l.holder,
                        "chips": l.chips,
                        "epoch": l.epoch,
                        "state": l.state,
                        "confirmed": l.confirmed,
                    }
                    for l in self._leases.values()
                ],
            }

    def check_conservation(self) -> bool:
        """live chips + free == pool — the invariant every transition
        preserves (and recovery restores)."""
        with self._lock:
            live = sum(
                l.chips for l in self._leases.values() if l.state != FREED
            )
            return live + self._free == self._pool

    # -- transitions ---------------------------------------------------------

    def init(self, total_chips: int) -> bool:
        """Pool init; idempotent on the same total, refused (False)
        while any lease is live. Epoch/next-id survive a re-init so
        fencing stays globally monotonic."""
        with self._lock:
            if self._pool == total_chips and self._pool > 0:
                return True
            if any(l.state != FREED for l in self._leases.values()):
                return False
            self._pool = total_chips
            self._free = total_chips
            self._leases = {}
            self._persist_locked()
            return True

    def grant(self, holder: str, chips: int, token: str = "") -> dict:
        """``{"ok": True, id, epoch, chips}`` or ``{"ok": False,
        reason: "nochips"|"nopool", free}``. Idempotent on ``token``
        among live leases: a retried grant (lost reply) returns the
        original lease unchanged — no chips move, no epoch bump."""
        with self._lock:
            if self._pool <= 0:
                return {"ok": False, "reason": "nopool", "free": 0}
            if token:
                for l in self._leases.values():
                    if l.state != FREED and l.token == token:
                        l.confirmed = True
                        self._maybe_recovered_locked()
                        return {
                            "ok": True, "id": l.id, "epoch": l.epoch,
                            "chips": l.chips,
                        }
            if chips <= 0 or chips > self._free:
                return {"ok": False, "reason": "nochips", "free": self._free}
            self._epoch += 1
            row = LeaseRow(
                id=self._next_id,
                holder=holder,
                chips=chips,
                epoch=self._epoch,
                token=token,
                confirmed=True,  # the live grantee just talked to us
            )
            self._next_id += 1
            self._leases[row.id] = row
            self._free -= chips
            self._persist_locked()
            return {
                "ok": True, "id": row.id, "epoch": row.epoch,
                "chips": row.chips,
            }

    def recall(self, lease_id: int) -> str:
        """GRANTED → RECALLING. ``"ok"`` (idempotent while RECALLING),
        ``"unknown"`` or ``"freed"``."""
        with self._lock:
            row = self._leases.get(lease_id)
            if row is None:
                return "unknown"
            if row.state == FREED:
                return "freed"
            if row.state == GRANTED:
                row.state = RECALLING
                self._persist_locked()
            return "ok"

    def free(self, lease_id: int) -> int:
        """Settle a lease: chips back to the pool. Returns the chips
        freed, ``-1`` unknown, ``-2`` already freed."""
        with self._lock:
            row = self._leases.get(lease_id)
            if row is None:
                return -1
            if row.state == FREED:
                return -2
            self._settle_locked(row)
            self._persist_locked()
            self._maybe_recovered_locked()
            return row.chips

    def confirm(self, lease_id: int, epoch: int) -> str:
        """The fencing check: ``"ok"``, or why the holder is fenced
        (``"stale_epoch"`` / ``"freed"`` / ``"unknown"``). Confirms are
        session-local — not persisted — like member TTLs."""
        with self._lock:
            row = self._leases.get(lease_id)
            if row is None:
                return "unknown"
            if row.state == FREED:
                return "freed"
            if self._stale_locked(row, epoch):
                return "stale_epoch"
            row.confirmed = True
            self._maybe_recovered_locked()
            return "ok"

    def crashed(self, holder: str) -> int:
        """Settle every live lease of a dead holder; returns chips
        returned to the pool."""
        with self._lock:
            chips = 0
            for row in self._leases.values():
                if row.state != FREED and row.holder == holder:
                    chips += row.chips
                    self._settle_locked(row)
            if chips:
                self._persist_locked()
                self._maybe_recovered_locked()
            return chips

    def expire(self) -> Tuple[int, int]:
        """Recovery reaper: once the window has passed, force-release
        every live lease that has not re-confirmed. Returns
        ``(force_released, still_recovering)``."""
        with self._lock:
            if not self._recovering:
                return (0, 0)
            if all(
                l.confirmed for l in self._leases.values() if l.state != FREED
            ):
                self._recovering = False
                return (0, 0)
            if self._clock() < self._recover_started + self.recover_window_s:
                return (0, 1)
            released = 0
            for row in self._leases.values():
                if row.state != FREED and not row.confirmed:
                    self._settle_locked(row)
                    released += 1
            self._recovering = False
            if released:
                self._persist_locked()
            return (released, 0)

    # -- locked helpers ------------------------------------------------------

    def _settle_locked(self, row: LeaseRow) -> None:
        if row.state == FREED:
            return  # settling is idempotent
        row.state = FREED
        self._free += row.chips

    def _stale_locked(self, row: LeaseRow, epoch: int) -> bool:
        """The epoch fence. The ``mut-dist-lease-broker`` schedcheck
        harness strips exactly this predicate to prove the fence is
        load-bearing."""
        return epoch != row.epoch

    def _maybe_recovered_locked(self) -> None:
        if self._recovering and all(
            l.confirmed for l in self._leases.values() if l.state != FREED
        ):
            self._recovering = False  # everyone re-confirmed: recovery over
