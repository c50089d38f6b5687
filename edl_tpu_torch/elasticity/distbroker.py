"""DistributedChipBroker — the chip market behind the coordinator: the
port of ``edl_tpu/elasticity/distbroker.py``, over the lease ops of
:class:`~edl_tpu_torch.runtime.coordinator.CoordinatorClient` and the
repo's native coordinator.

The client adapter that makes a coordinator-fronted lease pool look
exactly like the in-process :class:`~edl_tpu_torch.elasticity.broker.ChipLeaseBroker`:
``grant``/``recall``/``free``/``holder_crashed``/``check_conservation``/
``free_chips``/``epoch`` with the same :class:`Lease` objects, the same
flight events, and the same gauges — so ``ElasticityController``,
``ElasticTrainer.apply_chip_grant``, and the serving fleet's warm-start
path run unchanged whether the broker lives in this process or behind
``edl-coordinator`` on another host.

What the distributed version adds on top of the in-process contract:

* **Crash-safe persistence** — every transition is WAL-logged by the
  coordinator, so a SIGKILLed broker restarts with exact accounting
  and the adapter's :meth:`resync` re-confirms this process's leases
  through the RECOVERING window.
* **Epoch fencing** — :meth:`confirm` carries the lease epoch; a stale
  holder (force-released during recovery, or beaten by a newer grant)
  gets ``FENCED`` back, ``edl_lease_fenced_total{reason}`` ticks, and
  a ``lease.fence`` event lands on the timeline.
* **Reconnect/backoff** — RPCs ride :class:`CoordinatorClient`'s
  reconnect window (decorrelated-jitter backoff), so a broker restart
  inside a handover is a stall, not a failure.

Fault sites on the real paths: ``lease.rpc`` ahead of every round
trip, ``lease.confirm`` in the fencing handshake, plus the in-process
broker's ``lease.recall`` for chaos parity.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Dict, List, Optional

from edl_tpu_torch.elasticity.broker import (
    FREED,
    GRANTED,
    RECALLING,
    Lease,
    LeaseError,
)
from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils import faults
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("distlease")

# coordinator wire states (lease_table.GRANTED/...) -> broker states
_STATE = {0: GRANTED, 1: RECALLING, 2: FREED}


class DistributedChipBroker:
    """ChipLeaseBroker-compatible adapter over a coordinator's lease
    plane: a ``CoordinatorClient`` to an ``edl-coordinator`` server
    (``runtime/coordinator.CoordinatorServer``)."""

    def __init__(
        self,
        coord,
        total_chips: int,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        clock=time.monotonic,
    ):
        if total_chips <= 0:
            raise ValueError(f"total_chips must be >= 1, got {total_chips}")
        self.coord = coord
        self.total_chips = total_chips
        self.clock = clock
        self._lock = threading.Lock()
        # local mirror: the leases THIS process granted/settled (other
        # processes' leases are visible through lease_snap, not here)
        self._leases: Dict[str, Lease] = {}
        self._sides: set = set()
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
        self._c_fenced = reg.counter(
            "edl_lease_fenced_total",
            "lease confirms rejected by the epoch fence",
            ("reason",),
        )
        self._c_recovered = reg.counter(
            "edl_lease_recoveries_total",
            "broker-restart recoveries completed (RECOVERING -> steady)",
        )
        ok = self._rpc(lambda: coord.lease_init(total_chips))
        if ok is None:
            raise LeaseError(
                "coordinator does not speak the lease protocol "
                "(old server binary — use the in-process broker)"
            )
        if not ok:
            raise LeaseError(
                f"lease pool busy: live leases exist under a total other "
                f"than {total_chips}"
            )
        self._publish_snap()

    # -- plumbing ------------------------------------------------------------

    def _rpc(self, fn):
        # chaos site: an armed drop raises ConnectionError here,
        # exercising the same retry contract as a real partition
        # between this holder and the broker
        faults.fault_point("lease.rpc")
        return fn()

    def _snap(self) -> Dict:
        snap = self._rpc(self.coord.lease_snap)
        if snap is None:
            raise LeaseError("coordinator does not speak the lease protocol")
        return snap

    def _publish_snap(self) -> Dict:
        """Gauges come from the coordinator's snapshot — the shared
        pool's truth — not the local mirror, so N adapter processes
        all report the same conserved totals."""
        snap = self._snap()
        by_side: Dict[str, int] = {side: 0 for side in self._sides}
        by_state = {GRANTED: 0, RECALLING: 0, FREED: 0}
        for l in snap["leases"]:
            state = _STATE[l["state"]]
            by_state[state] += 1
            if state != FREED:
                side = l["holder"].split(":", 1)[0]
                by_side[side] = by_side.get(side, 0) + l["chips"]
        self._g_free.set(snap["free"])
        self._g_epoch.set(snap["epoch"])
        for side, chips in by_side.items():
            self._g_chips.set(chips, side=side)
        for state, n in by_state.items():
            self._g_leases.set(n, state=state)
        return snap

    @staticmethod
    def _sid(int_id: int) -> str:
        return f"L{int_id:04d}"

    @staticmethod
    def _iid(lease_id: str) -> int:
        return int(str(lease_id).lstrip("L"))

    def _mirror_locked(self, lease_id: str) -> Optional[Lease]:
        return self._leases.get(lease_id)

    # -- queries (ChipLeaseBroker parity) ------------------------------------

    @property
    def free_chips(self) -> int:
        return self._snap()["free"]

    @property
    def epoch(self) -> int:
        return self._snap()["epoch"]

    @property
    def recovering(self) -> bool:
        return self._snap()["recovering"]

    def get(self, lease_id: str) -> Optional[Lease]:
        with self._lock:
            lease = self._leases.get(lease_id)
            return replace(lease) if lease is not None else None

    def snapshot(self) -> List[Lease]:
        """The WHOLE pool's leases (every holder process), as broker
        Lease copies built from the coordinator snapshot."""
        out = []
        for l in self._snap()["leases"]:
            out.append(
                Lease(
                    lease_id=self._sid(l["id"]),
                    holder=l["holder"],
                    chips=l["chips"],
                    epoch=l["epoch"],
                    state=_STATE[l["state"]],
                )
            )
        return out

    def live(self, holder: Optional[str] = None) -> List[Lease]:
        return [
            l for l in self.snapshot()
            if l.state != FREED and (holder is None or l.holder == holder)
        ]

    def check_conservation(self) -> bool:
        """live chips + free == pool, judged at the coordinator — the
        shared-pool truth across every holder process."""
        snap = self._snap()
        live = sum(
            l["chips"] for l in snap["leases"] if _STATE[l["state"]] != FREED
        )
        return live + snap["free"] == snap["pool"]

    # -- transitions ---------------------------------------------------------

    def grant(self, holder: str, chips: int) -> Lease:
        """Lease ``chips`` to ``holder`` from the shared pool. The
        client token makes a retried grant (reply lost to a broker
        crash) return the original lease instead of double-granting."""
        if chips <= 0:
            raise ValueError(f"grant chips must be >= 1, got {chips}")
        res = self._rpc(lambda: self.coord.lease_grant(holder, chips))
        if res is None:
            raise LeaseError("coordinator does not speak the lease protocol")
        if not res["ok"]:
            raise LeaseError(
                f"grant({holder}, {chips}): {res['reason']} "
                f"({res['free']}/{self.total_chips} chips free)"
            )
        lease = Lease(
            lease_id=self._sid(res["id"]),
            holder=holder,
            chips=res["chips"],
            epoch=res["epoch"],
            granted_t=self.clock(),
        )
        with self._lock:
            self._leases[lease.lease_id] = lease
            self._sides.add(lease.side)
        snap = self._publish_snap()
        flight.emit(
            "lease.grant",
            site="lease.grant",
            worker=holder,
            reshard_epoch=lease.epoch,
            lease=lease.lease_id,
            chips=lease.chips,
            free=snap["free"],
        )
        log.info("grant", lease=lease.lease_id, holder=holder,
                 chips=lease.chips, epoch=lease.epoch, free=snap["free"])
        return replace(lease)

    def recall(self, lease_id: str) -> Lease:
        """GRANTED → RECALLING at the coordinator. Idempotent while
        RECALLING, same as the in-process broker."""
        # chaos parity with ChipLeaseBroker.recall: the same site the
        # controller's _recall_with_retry recovers from
        faults.fault_point("lease.recall")
        rc = self._rpc(lambda: self.coord.lease_recall(self._iid(lease_id)))
        if rc is None:
            raise LeaseError("coordinator does not speak the lease protocol")
        if rc == "unknown":
            raise LeaseError(f"recall: unknown lease {lease_id}")
        if rc == "freed":
            raise LeaseError(f"recall: lease {lease_id} already FREED")
        with self._lock:
            lease = self._leases.get(lease_id)
            already = lease is not None and lease.state == RECALLING
            if lease is not None and lease.state == GRANTED:
                lease.state = RECALLING
                lease.recalled_t = self.clock()
            out = replace(lease) if lease is not None else None
        if out is None:
            # recalling a lease another process granted: mirror it from
            # the pool snapshot so the caller still gets a Lease back
            out = next(
                (l for l in self.snapshot() if l.lease_id == lease_id), None
            )
            if out is None:  # pragma: no cover - racing a concurrent free
                raise LeaseError(f"recall: unknown lease {lease_id}")
            already = False
        if already:
            return out  # idempotent retry: no second event
        self._publish_snap()
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
        """Settle at the coordinator: chips return to the shared pool.
        Returns chips freed (0 on an idempotent repeat)."""
        chips = self._rpc(lambda: self.coord.lease_free(self._iid(lease_id)))
        if chips is None:
            raise LeaseError("coordinator does not speak the lease protocol")
        if chips == -1:
            raise LeaseError(f"free: unknown lease {lease_id}")
        if chips == -2:
            return 0
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is not None and lease.state != FREED:
                lease.state = FREED
                lease.freed_t = self.clock()
            out = replace(lease) if lease is not None else None
        snap = self._publish_snap()
        flight.emit(
            "lease.freed",
            site="lease.freed",
            worker=out.holder if out else "remote",
            reshard_epoch=out.epoch if out else snap["epoch"],
            lease=lease_id,
            chips=chips,
            free=snap["free"],
        )
        log.info("freed", lease=lease_id, chips=chips, free=snap["free"])
        return chips

    def holder_crashed(self, holder: str) -> List[Lease]:
        """Settle a dead holder's leases pool-wide (LCRASH). The dead
        list comes from the coordinator's snapshot, not the local
        mirror — the corpse may have been another process entirely."""
        doomed = self.live(holder)
        chips = self._rpc(lambda: self.coord.lease_crashed(holder))
        if chips is None:
            raise LeaseError("coordinator does not speak the lease protocol")
        with self._lock:
            now = self.clock()
            dead = []
            for lease in doomed:
                lease.state = FREED
                lease.freed_t = now
                dead.append(lease)
                mirrored = self._leases.get(lease.lease_id)
                if mirrored is not None and mirrored.state != FREED:
                    mirrored.state = FREED
                    mirrored.freed_t = now
        if not chips:
            return dead
        snap = self._publish_snap()
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
                free=snap["free"],
            )
        log.warn("holder_crashed", holder=holder, chips=chips)
        return dead

    # -- fencing + recovery --------------------------------------------------

    def adopt(self, lease_id: str, holder: str, chips: int, epoch: int) -> Lease:
        """Mirror a lease this holder believes it already holds — the
        holder-restart path: re-attach from the holder's own persisted
        state, then :meth:`confirm` asks the broker whether it still
        agrees. A holder whose memory is stale (force-released during
        recovery, then re-granted) gets fenced right there instead of
        silently computing on chips it no longer owns."""
        lease = Lease(
            lease_id=lease_id,
            holder=holder,
            chips=chips,
            epoch=epoch,
            granted_t=self.clock(),
        )
        with self._lock:
            self._leases[lease.lease_id] = lease
            self._sides.add(lease.side)
        return replace(lease)

    def confirm(self, lease_id: str) -> bool:
        """Present this holder's lease epoch to the fence. True when
        the broker still recognises the lease at that epoch; False
        when fenced — the holder must release and re-grant, it may NOT
        keep using the chips."""
        with self._lock:
            lease = self._leases.get(lease_id)
        if lease is None:
            raise LeaseError(f"confirm: unknown lease {lease_id}")
        # chaos site: the confirm leg of the handshake, distinct from
        # lease.rpc so a partition BETWEEN confirm and grant is armable
        faults.fault_point("lease.confirm")
        rc = self._rpc(
            lambda: self.coord.lease_confirm(self._iid(lease_id), lease.epoch)
        )
        if rc is None or rc == "ok":
            return True  # old server: nothing to confirm against
        self._c_fenced.inc(reason=rc)
        flight.emit(
            "lease.fence",
            severity="warn",
            site="lease.confirm",
            worker=lease.holder,
            reshard_epoch=lease.epoch,
            lease=lease_id,
            reason=rc,
        )
        log.warn("fenced", lease=lease_id, holder=lease.holder, reason=rc)
        with self._lock:
            mirrored = self._leases.get(lease_id)
            if mirrored is not None and mirrored.state != FREED:
                # the coordinator no longer honors this lease — the
                # local mirror must not keep counting its chips
                mirrored.state = FREED
                mirrored.freed_t = self.clock()
        return False

    def resync(self) -> Dict:
        """Re-attach after a broker restart: re-confirm every live
        lease this process holds, then run the recovery reaper. Emits
        ``lease.recover`` (closing the postmortem fault chain) when the
        broker leaves RECOVERING."""
        before = self._snap()
        with self._lock:
            mine = [
                replace(l) for l in self._leases.values() if l.state != FREED
            ]
        fenced = [
            lease.lease_id for lease in mine if not self.confirm(lease.lease_id)
        ]
        expire = self._rpc(self.coord.lease_expire) or (0, 0)
        snap = self._publish_snap()
        if before["recovering"] and not snap["recovering"]:
            self._c_recovered.inc()
            flight.emit(
                "lease.recover",
                site="lease.rpc",
                worker="broker",
                reshard_epoch=snap["epoch"],
                rids=[],
                confirmed=len(mine) - len(fenced),
                fenced=len(fenced),
                force_released=expire[0],
            )
            log.info("recovered", confirmed=len(mine) - len(fenced),
                     fenced=len(fenced), force_released=expire[0])
        return {
            "fenced": fenced,
            "force_released": expire[0],
            "recovering": bool(snap["recovering"]),
        }
