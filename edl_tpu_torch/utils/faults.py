"""Deterministic fault injection — a seeded, process-wide registry of
named fault points: the port's copy of ``edl_tpu/utils/faults.py``,
with the same plan grammar and site names, so a fault plan written for
the reference arms the port unchanged.

Code declares named sites on its real failure paths
(``fault_point("serve.dispatch")`` inside the engine's dispatch, not a
mock), and a PLAN arms triggers at those sites so a harness can drive
failures deterministically and assert the recovery invariants.

Plan grammar (env ``EDL_FAULTS`` or :func:`arm`)::

    site:action@key=val[,key=val...][;site2:...]

    EDL_FAULTS="serve.dispatch:raise@n=3;serve.drain:raise@n=5"

Actions
    ``raise``  raise :class:`InjectedFault` (a RuntimeError) at the site
    ``drop``   raise :class:`InjectedConnectionError` (a
               ConnectionError) — "the connection broke here", so
               reconnect/backoff paths run for real
    ``delay``  sleep ``s`` seconds (default 0.05) — stall, not fail

Triggers (exactly one per spec)
    ``n=K``      fire on the Kth call to the site (1-based), once
    ``every=K``  fire on every Kth call
    ``p=F``      fire with probability F per call, from a PRNG seeded
                 with ``(seed, site)`` — deterministic given the seed
                 and the per-site call sequence, independent of
                 interleaving across sites
    ``max=M``    (modifier) cap total firings of this spec at M

The port's sites: ``serve.dispatch`` (after a decode / verify block is
queued), ``serve.drain`` (a popped block, before its tokens are read),
``serve.prefill`` (an admission prefill, before its first token is
read) and ``ckpt.commit`` (a dense checkpoint save).

``EDL_FAULTS`` may instead name a JSON file (path to an existing file,
or ``@path``): ``{"seed": 0, "faults": [{"site": "serve.dispatch",
"action": "raise", "n": 3}, ...]}``. ``EDL_FAULTS_SEED`` seeds the
inline-grammar form.

Every injection increments ``edl_faults_injected_total{site}`` in the
process obs registry and lands on the flight recorder as
``fault.injected``, so a chaos run can PROVE its faults fired (a plan
that never triggers is a green run that tested nothing).

Unarmed cost is one module-attribute read and a falsy check per
``fault_point`` call — sites sit on per-block paths, never per-token.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union

__all__ = [
    "InjectedFault",
    "InjectedConnectionError",
    "FaultSpec",
    "arm",
    "disarm",
    "armed",
    "fault_point",
    "counts",
    "parse_plan",
]

ACTIVE = False  # module-level fast flag: the unarmed no-op check

_ACTIONS = ("raise", "drop", "delay")

_lock = threading.RLock()
_armed_by_site: Dict[str, List["_ArmedFault"]] = {}


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` action. ``site`` names the fault
    point, so recovery tests can assert WHERE the failure landed."""

    def __init__(self, site: str, nth: int):
        super().__init__(f"injected fault at {site} (call #{nth})")
        self.site = site
        self.nth = nth


class InjectedConnectionError(ConnectionError):
    """Raised by an armed ``drop`` action — a ConnectionError, so the
    real reconnect/backoff handling at the site runs, not a test mock."""

    def __init__(self, site: str, nth: int):
        super().__init__(f"injected connection drop at {site} (call #{nth})")
        self.site = site
        self.nth = nth


@dataclass(frozen=True)
class FaultSpec:
    """One parsed plan entry: a site, an action, and exactly one
    trigger (``n`` | ``every`` | ``p``) plus modifiers."""

    site: str
    action: str
    n: int = 0
    every: int = 0
    p: float = 0.0
    delay_s: float = 0.05
    max: int = 0  # 0 = unbounded

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(
                f"{self.site}: unknown action {self.action!r} "
                f"(one of {_ACTIONS})"
            )
        triggers = sum((self.n > 0, self.every > 0, self.p > 0))
        if triggers != 1:
            raise ValueError(
                f"{self.site}: need exactly one trigger of n=/every=/p=, "
                f"got {triggers}"
            )
        if not 0 <= self.p <= 1:
            raise ValueError(f"{self.site}: p must be in [0, 1], got {self.p}")


class _ArmedFault:
    """Runtime state of one armed spec: its call counter and per-site
    seeded PRNG. Counting happens under the module lock; the action
    itself (sleep/raise) runs outside it."""

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec = spec
        self.calls = 0
        self.fired = 0
        # (seed, site) keyed: deterministic per site regardless of how
        # calls to OTHER sites interleave
        self.rng = random.Random(f"{seed}/{spec.site}/{spec.action}")

    def should_fire(self) -> bool:
        self.calls += 1
        s = self.spec
        if s.max and self.fired >= s.max:
            return False
        if s.n:
            hit = self.calls == s.n
        elif s.every:
            hit = self.calls % s.every == 0
        else:
            hit = self.rng.random() < s.p
        if hit:
            self.fired += 1
        return hit


def parse_plan(plan: str) -> List[FaultSpec]:
    """Parse the ``site:action@params;...`` grammar into specs."""
    specs: List[FaultSpec] = []
    for part in plan.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, params = part.partition("@")
        site, sep, action = head.partition(":")
        if not sep or not site or not action:
            raise ValueError(
                f"bad fault spec {part!r}: want site:action@k=v[,k=v]"
            )
        kw: Dict[str, Union[int, float]] = {}
        for kv in params.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"bad fault param {kv!r} in {part!r}")
            k = k.strip()
            if k in ("n", "every", "max"):
                kw[k] = int(v)
            elif k == "p":
                kw[k] = float(v)
            elif k == "s":
                kw["delay_s"] = float(v)
            else:
                raise ValueError(f"unknown fault param {k!r} in {part!r}")
        specs.append(FaultSpec(site=site.strip(), action=action.strip(), **kw))
    if not specs:
        raise ValueError(f"empty fault plan {plan!r}")
    return specs


def _specs_from_json(doc: dict) -> tuple:
    faults = doc.get("faults")
    if not isinstance(faults, list) or not faults:
        raise ValueError('fault plan JSON needs a non-empty "faults" list')
    specs = []
    for f in faults:
        f = dict(f)
        if "s" in f:
            f["delay_s"] = f.pop("s")
        specs.append(FaultSpec(**f))
    return specs, int(doc.get("seed", 0))


def arm(
    plan: Union[str, dict, Iterable[FaultSpec]], seed: int = 0
) -> List[FaultSpec]:
    """Replace the armed plan. ``plan`` is the string grammar, a JSON
    doc (``{"seed", "faults": [...]}`` — its seed wins), or FaultSpecs.
    Arming resets all call counters, so runs are reproducible."""
    global ACTIVE
    if isinstance(plan, str):
        specs = parse_plan(plan)
    elif isinstance(plan, dict):
        specs, seed = _specs_from_json(plan)
    else:
        specs = list(plan)
    with _lock:
        _armed_by_site.clear()
        for spec in specs:
            _armed_by_site.setdefault(spec.site, []).append(
                _ArmedFault(spec, seed)
            )
        ACTIVE = bool(_armed_by_site)
    return specs


def disarm() -> None:
    global ACTIVE
    with _lock:
        _armed_by_site.clear()
        ACTIVE = False


def armed() -> bool:
    return ACTIVE


def counts() -> Dict[str, int]:
    """{site: total injections} for the CURRENT plan (the process-wide
    ``edl_faults_injected_total`` counter survives re-arms; this view
    resets with each :func:`arm`)."""
    with _lock:
        return {
            site: sum(a.fired for a in armed_list)
            for site, armed_list in _armed_by_site.items()
        }


def _count_injection(site: str, nth: int, action: str) -> None:
    # resolved per injection so a registry swap in tests takes effect;
    # injections are rare by construction, so the lookup cost is noise
    from edl_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.default_registry().counter(
        "edl_faults_injected_total", "injected faults by site", ("site",)
    ).inc(site=site)
    # flight recorder: the injection lands on the SAME timeline as its
    # consequences, so `edl postmortem` can verify every fault is
    # followed by a recorded recovery (fault -> recover -> re-prefill
    # -> finish, the chaos lane's chain contract)
    from edl_tpu_torch.obs import events

    events.emit(
        "fault.injected", severity="warn", site=site, nth=nth, action=action
    )


def fault_point(site: str) -> None:
    """Declare + check one named fault site. No-op (one attribute read)
    unless a plan armed this site; armed, it applies the first firing
    spec's action. Call it ON the real failure path — the point is that
    recovery code downstream runs against genuine control flow."""
    if not ACTIVE:
        return
    fire: Optional[_ArmedFault] = None
    with _lock:
        for a in _armed_by_site.get(site, ()):
            if a.should_fire():
                fire = a
                break
    if fire is None:
        return
    spec = fire.spec
    _count_injection(site, fire.calls, spec.action)
    if spec.action == "delay":
        time.sleep(spec.delay_s)
    elif spec.action == "drop":
        raise InjectedConnectionError(site, fire.calls)
    else:
        raise InjectedFault(site, fire.calls)


def _maybe_arm_from_env() -> None:
    raw = os.environ.get("EDL_FAULTS", "").strip()
    if not raw:
        return
    path = raw[1:] if raw.startswith("@") else raw
    if os.path.exists(path):
        with open(path) as f:
            arm(json.load(f))
    else:
        arm(raw, seed=int(os.environ.get("EDL_FAULTS_SEED", "0")))


_maybe_arm_from_env()
