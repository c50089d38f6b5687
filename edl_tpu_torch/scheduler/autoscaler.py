"""Scale-decision damping — the port's copy of ``HysteresisGate`` and
``ScaleGate`` from ``edl_tpu/scheduler/autoscaler.py``, unchanged in
behaviour. The serving fleet's :class:`~edl_tpu_torch.serving.fleet.FleetScaler`
runs its decisions through them. The rest of that module (the cluster
autoscaler over the job API and the cluster model) is the control
plane and is not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional


class HysteresisGate:
    """Per-key rescale damping — the cooldown machinery shared by the
    cluster autoscaler's job-retarget loop and the serving fleet's
    replica scaler (serving/fleet.py).

    Both loops have the same failure mode: a marginal signal flips the
    decision every tick and each flip is expensive (a reshard stall for
    training, a replica drain+spawn for serving). The gate admits an
    action for ``key`` only when at least ``cooldown_s`` has elapsed
    since that key's last :meth:`record`; ``cooldown_s == 0`` admits
    everything (the undamped reference behavior). Callers may bypass
    the gate when an urgency signal says churn is the lesser evil
    (pending pods for training, an SLO breach for serving)."""

    def __init__(self, cooldown_s: float, clock=time.monotonic):
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._last: Dict[str, float] = {}

    def ready(self, key: str = "") -> bool:
        if self.cooldown_s <= 0:
            return True
        return (
            self.clock() - self._last.get(key, -1e18) >= self.cooldown_s
        )

    def record(self, key: str = "") -> None:
        self._last[key] = self.clock()


class ScaleGate:
    """The one damped scale-decision pipeline every elastic consumer
    shares: ``decide → (cooldown or bypass) → act → record``.

    Before this class the pattern lived copy-pasted in the serving
    fleet's :class:`~edl_tpu_torch.serving.fleet.FleetScaler` and inline in
    the elasticity controller's handover loop — each re-implementing
    the same four lines around a :class:`HysteresisGate` and each free
    to drift (forget the record, invert the bypass). ``apply`` owns the
    sequencing; callers supply only the pure ``decide`` (returns an
    action label or None) and the side-effecting ``act``.

    ``bypass`` is the urgency escape hatch: when it returns True the
    cooldown is ignored (pending pods for training, an SLO breach for
    serving — churn is the lesser evil once users are hurting)."""

    def __init__(
        self,
        key: str,
        cooldown_s: float,
        clock=time.monotonic,
        bypass: Optional[Callable[[], bool]] = None,
    ):
        self.key = key
        self.gate = HysteresisGate(cooldown_s, clock=clock)
        self.bypass = bypass

    def apply(
        self,
        decide: Callable[[], Optional[str]],
        act: Callable[[str], None],
    ) -> Optional[str]:
        """One damped decision. Returns the action applied, or None
        (nothing to do, or held by the cooldown)."""
        action = decide()
        if action is None:
            return None
        if not self.gate.ready(self.key) and not (
            self.bypass is not None and self.bypass()
        ):
            return None
        act(action)
        self.gate.record(self.key)
        return action
