"""ElasticityController — the train⇄serve handover policy loop: the
port of ``edl_tpu/elasticity/controller.py``.

Watches the serving side's load/SLO signals and decides, once per
tick, whether chips should move:

* serving is drowning (load above ``load_high`` or the TTFT SLO
  breached) and the trainer can spare a replica's worth of chips above
  its floor → ``to_serve``: recall the train lease, shrink the trainer
  in place (the ``runtime/elastic.py`` reshard path), free, re-grant
  the remainder to the trainer and a replica's slice to serving, spawn
  the replica (warm via the p2p weight push when wired);
* serving is idle (load below ``load_low``) and above its replica
  floor → ``to_train``: drain-before-evict a replica, free its lease,
  recall+regrow the train lease, grow-reshard the trainer.

Decisions run through the autoscaler's shared
:class:`~edl_tpu_torch.scheduler.autoscaler.ScaleGate` — the same damped
decide→gate→act→record pipeline the serving ``FleetScaler`` uses — so
a marginal diurnal signal can't thrash handovers; an SLO breach
bypasses the cooldown.

The controller is deliberately device-free and fleet-free: it drives
the real sides through :class:`TrainPort`/:class:`ServePort` adapters
(plain callables), so the policy is testable with fakes, and a live
subprocess fleet (``serving/fleet.ServingFleet.scale_up`` /
``scale_down``) plugs into :class:`ServePort` as it is.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from edl_tpu_torch.elasticity.broker import ChipLeaseBroker, Lease
from edl_tpu_torch.obs import disttrace
from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.scheduler.autoscaler import ScaleGate
from edl_tpu_torch.utils import faults, tracing
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("elasticity")


@dataclass
class TrainPort:
    """What the controller needs from the trainer: how many chips it
    holds, and a way to retarget that total (which drives the in-place
    reshard — ``ElasticTrainer.apply_chip_grant``)."""

    chips: Callable[[], int]
    apply_chips: Callable[[int], None]
    min_chips: int = 1


@dataclass
class ServePort:
    """What the controller needs from the serving fleet. ``load`` is
    queue depth + inflight per READY replica (the FleetScaler signal);
    ``add_replica`` spawns one replica (warm, when the fleet spec says
    so) and blocks until READY, returning the ramp seconds;
    ``remove_replica`` drains-before-evicts one."""

    replicas: Callable[[], int]
    load: Callable[[], float]
    slo_breached: Callable[[], bool]
    add_replica: Callable[[], float]
    remove_replica: Callable[[], None]
    min_replicas: int = 1


@dataclass
class Handover:
    """Ledger row for one completed handover."""

    n: int
    direction: str
    wall_s: float
    epoch: int
    ramp_s: Optional[float] = None
    recall_retries: int = 0


class ElasticityController:
    """One policy loop instance: a broker, the two side ports, and the
    damped gate. Call :meth:`bootstrap` once (leases whatever the
    sides already hold), then :meth:`tick` per control period."""

    def __init__(
        self,
        broker: ChipLeaseBroker,
        train: TrainPort,
        serve: ServePort,
        *,
        chips_per_replica: int = 1,
        load_high: float = 4.0,
        load_low: float = 0.5,
        cooldown_s: float = 30.0,
        recall_retries: int = 3,
        clock=time.monotonic,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        if chips_per_replica < 1:
            raise ValueError(
                f"chips_per_replica must be >= 1, got {chips_per_replica}"
            )
        if load_low >= load_high:
            raise ValueError(
                f"load_low {load_low} must be < load_high {load_high}"
            )
        self.broker = broker
        self.train = train
        self.serve = serve
        self.chips_per_replica = chips_per_replica
        self.load_high = load_high
        self.load_low = load_low
        self.recall_retries = recall_retries
        self.clock = clock
        self.gate = ScaleGate(
            "elasticity", cooldown_s, clock=clock, bypass=serve.slo_breached
        )
        self.ledger: List[Handover] = []
        self._train_lease: Optional[Lease] = None
        self._serve_leases: List[Lease] = []
        self._n = 0
        self._pending_retries = 0
        reg = registry or obs_metrics.default_registry()
        self._c_handover = reg.counter(
            "edl_lease_handovers_total",
            "completed train<->serve chip handovers",
            ("direction",),
        )

    # -- setup ---------------------------------------------------------------

    def bootstrap(self) -> None:
        """Lease the inventory the sides already hold, so day one of
        the loop starts from a conserved ledger."""
        n = self.train.chips()
        if n:
            self._train_lease = self.broker.grant("train:job", n)
        for i in range(self.serve.replicas()):
            self._serve_leases.append(
                self.broker.grant(f"serve:r{i}", self.chips_per_replica)
            )

    # -- policy --------------------------------------------------------------

    def decide(self) -> Optional[str]:
        """Pure decision: "to_serve", "to_train", or None. No side
        effects, no cooldown (that's :meth:`tick`)."""
        load = self.serve.load()
        breach = self.serve.slo_breached()
        train_chips = self._train_lease.chips if self._train_lease else 0
        if (
            (load > self.load_high or breach)
            and train_chips - self.chips_per_replica >= self.train.min_chips
        ):
            return "to_serve"
        if (
            load < self.load_low
            and not breach
            and len(self._serve_leases) > self.serve.min_replicas
        ):
            return "to_train"
        return None

    def tick(self) -> Optional[str]:
        """One damped decision through the shared gate. Returns the
        handover direction applied, or None."""
        return self.gate.apply(self.decide, self._handover)

    # -- mechanics -----------------------------------------------------------

    def _recall_with_retry(self, lease_id: str) -> Lease:
        """Recall, surviving a transiently failing recall RPC (the
        ``lease.recall`` chaos site). A successful retry emits
        ``lease.recover``, which closes the fault chain on the flight
        timeline; ``rids`` is empty
        because a lease recall carries no serving requests — losing
        the RPC loses nothing a client sees."""
        last: Optional[BaseException] = None
        for attempt in range(self.recall_retries + 1):
            try:
                lease = self.broker.recall(lease_id)
            except (faults.InjectedFault, ConnectionError, OSError) as e:
                last = e
                log.warn("recall failed", lease=lease_id,
                         attempt=attempt, err=str(e))
                continue
            if attempt:
                flight.emit(
                    "lease.recover",
                    site="lease.recall",
                    worker=lease.holder,
                    reshard_epoch=lease.epoch,
                    lease=lease.lease_id,
                    rids=[],
                    retried=attempt,
                )
                self._pending_retries += attempt
            return lease
        raise LeaseRecallFailed(
            f"recall {lease_id} failed after "
            f"{self.recall_retries + 1} attempts"
        ) from last

    def _handover(self, direction: str) -> None:
        self._n += 1
        n = self._n
        t0 = self.clock()
        self._pending_retries = 0
        # every span/event of one handover shares a derived trace id,
        # same convention as ("reshard", ep) in runtime/elastic.py
        with disttrace.root("handover", n):
            with tracing.span("elasticity.handover", direction=direction,
                              n=n):
                flight.emit(
                    "handover.begin",
                    site="handover.begin",
                    reshard_epoch=self.broker.epoch,
                    direction=direction,
                    n=n,
                )
                if direction == "to_serve":
                    ramp = self._train_to_serve()
                else:
                    ramp = self._serve_to_train()
                wall = self.clock() - t0
                flight.emit(
                    "handover.end",
                    site="handover.end",
                    reshard_epoch=self.broker.epoch,
                    direction=direction,
                    n=n,
                    wall_s=wall,
                )
        self._c_handover.inc(direction=direction)
        self.ledger.append(
            Handover(
                n=n,
                direction=direction,
                wall_s=wall,
                epoch=self.broker.epoch,
                ramp_s=ramp,
                recall_retries=self._pending_retries,
            )
        )
        log.info("handover", n=n, direction=direction,
                 wall_s=round(wall, 3), epoch=self.broker.epoch)

    def _train_to_serve(self) -> Optional[float]:
        """Recall train chips → shrink-reshard → free → re-grant the
        smaller train lease + one serving slice → spawn the replica."""
        old = self._train_lease
        assert old is not None  # decide() guarantees it
        self._recall_with_retry(old.lease_id)
        remain = old.chips - self.chips_per_replica
        self.train.apply_chips(remain)  # shrink happens inside RECALLING
        self.broker.free(old.lease_id)
        self._train_lease = (
            self.broker.grant("train:job", remain) if remain else None
        )
        lease = self.broker.grant(
            f"serve:r{len(self._serve_leases)}", self.chips_per_replica
        )
        self._serve_leases.append(lease)
        return self.serve.add_replica()

    def _serve_to_train(self) -> Optional[float]:
        """Drain-before-evict one replica → free its lease → regrow the
        train lease → grow-reshard."""
        victim = self._serve_leases.pop()
        self._recall_with_retry(victim.lease_id)
        self.serve.remove_replica()  # drain + evict inside RECALLING
        self.broker.free(victim.lease_id)
        old = self._train_lease
        grow = (old.chips if old else 0) + self.chips_per_replica
        if old is not None:
            self._recall_with_retry(old.lease_id)
            self.broker.free(old.lease_id)
        self._train_lease = self.broker.grant("train:job", grow)
        self.train.apply_chips(grow)
        return None


class LeaseRecallFailed(RuntimeError):
    """Recall retries exhausted — the handover did not start."""
