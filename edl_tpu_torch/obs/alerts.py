"""Alerting over metric history — threshold, multi-window burn-rate,
and anomaly rules evaluated against a :class:`~edl_tpu_torch.obs.tsdb.TSDB`:
the port's copy of ``edl_tpu/obs/alerts.py`` (stdlib-only, no torch
import).

Three rule families, one engine:

* **threshold** — an aggregate (``avg/min/max/last``) of any scalar
  series over a trailing window compared against a constant, with an
  optional ``for_s`` debounce (condition must hold continuously).
* **burn_rate** — the SRE-workbook multi-window multi-burn-rate shape
  over an *ok-ratio* gauge (``edl_slo_ttft_ok_ratio``,
  ``edl_slo_goodput_fraction``): error fraction ``1 - ratio`` averaged
  over a SHORT and a LONG trailing window, both expressed as multiples
  of the error budget ``1 - objective``. The alert fires only when
  BOTH windows burn faster than ``factor`` — the long window keeps a
  blip from paging, the short window makes the page resolve promptly
  once the burn stops. Convention: a fast pair (5m/1h, factor 14.4)
  pages; a slow pair (1h/6h, factor 6) warns.
* **anomaly** — a watchdog for series with no crisp objective (queue
  wait p99, reshard stall, push-failure rate): EWMA mean over the
  trailing window plus a MAD band; the newest sample fires when its
  robust z-score ``|x - ewma| / (1.4826 * MAD + floor)`` exceeds
  ``z``. ``mode`` picks the observed value: the raw sample
  (``value``), the per-step counter increase (``increase``, reset
  clamped), or a histogram percentile (``hist_p99``/``hist_p50``).

Every window in a rules doc is scaled by ``time_scale`` so the SAME
rules file runs against production cadences and the CI lane's
seconds-long replays. Alert transitions are observable three ways:
``alert.fire`` / ``alert.resolve`` flight-recorder events (site
``alert.<rule>``, so ``postmortem --sites alert.`` chains them),
the ``edl_alerts_active{severity}`` / ``edl_alerts_fired_total{rule}``
series, and :meth:`AlertEngine.to_block` (the reference's ``monitor
--json`` block).
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional

from edl_tpu_torch.utils.logging import kv_logger

from . import events as obs_events
from . import metrics as obs_metrics

log = kv_logger("obs")

__all__ = [
    "AlertEngine",
    "AnomalyRule",
    "BurnRateRule",
    "DEFAULT_RULES",
    "ThresholdRule",
    "engine_from_doc",
    "load_rules_doc",
    "parse_rules",
]

# rule severity -> flight-recorder severity (a page is an error on
# the incident timeline; a warn is a warn)
_EVENT_SEVERITY = {"page": "error", "warn": "warn", "info": "info"}

# The shipped default rules file, as a pure literal (the reference's,
# byte for byte: its static check verifies every referenced series
# against the registered metric catalog). `watch` with no
# --rules evaluates exactly this doc.
DEFAULT_RULES = {
    "time_scale": 1.0,
    "rules": [
        {
            "type": "burn_rate",
            "name": "slo_ttft_fast_burn",
            "series": "edl_slo_ttft_ok_ratio",
            "labels": {"slo_class": "interactive"},
            "objective": 0.99,
            "short_s": 300.0,
            "long_s": 3600.0,
            "factor": 14.4,
            "severity": "page",
        },
        {
            "type": "burn_rate",
            "name": "slo_ttft_slow_burn",
            "series": "edl_slo_ttft_ok_ratio",
            "labels": {"slo_class": "interactive"},
            "objective": 0.99,
            "short_s": 3600.0,
            "long_s": 21600.0,
            "factor": 6.0,
            "severity": "warn",
        },
        {
            "type": "burn_rate",
            "name": "goodput_fast_burn",
            "series": "edl_slo_goodput_fraction",
            "labels": {},
            "objective": 0.95,
            "short_s": 300.0,
            "long_s": 3600.0,
            "factor": 14.4,
            "severity": "page",
        },
        {
            "type": "threshold",
            "name": "hbm_crosscheck_drift",
            "series": "edl_hbm_crosscheck_drift_bytes",
            "labels": {},
            "op": ">",
            "value": 16777216.0,
            "window_s": 120.0,
            "agg": "max",
            "severity": "warn",
        },
        {
            "type": "anomaly",
            "name": "queue_wait_anomaly",
            "series": "edl_serving_queue_wait_seconds",
            "labels": {},
            "mode": "hist_p99",
            "window_s": 600.0,
            "z": 8.0,
            "severity": "warn",
        },
        {
            "type": "anomaly",
            "name": "reshard_stall_anomaly",
            "series": "edl_reshard_stall_seconds",
            "labels": {},
            "mode": "hist_p99",
            "window_s": 3600.0,
            "z": 8.0,
            "severity": "warn",
        },
        {
            "type": "anomaly",
            "name": "push_failure_anomaly",
            "series": "edl_metrics_push_failures_total",
            "labels": {},
            "mode": "increase",
            "window_s": 600.0,
            "z": 8.0,
            "severity": "warn",
        },
        {
            # a spike of stale-epoch fences means holders are acting on
            # leases the broker no longer honors — split-brain in the
            # chip inventory; one or two after a broker restart is the
            # recovery window working, a burst is an incident
            "type": "anomaly",
            "name": "lease_fence_anomaly",
            "series": "edl_lease_fenced_total",
            "labels": {"reason": "stale_epoch"},
            "mode": "increase",
            "window_s": 600.0,
            "z": 8.0,
            "severity": "warn",
        },
    ],
}


class Rule:
    """One named condition over history. ``firing(db, now)`` returns
    a detail dict while the condition holds, None otherwise (including
    "not enough data yet" — an alert must never fire on an empty
    window). The engine layers the fire/resolve state machine and the
    ``for_s`` debounce on top."""

    def __init__(self, name: str, severity: str = "warn",
                 for_s: float = 0.0):
        if severity not in _EVENT_SEVERITY:
            raise ValueError(
                f"rule {name!r}: severity must be one of "
                f"{tuple(_EVENT_SEVERITY)}, got {severity!r}"
            )
        self.name = name
        self.severity = severity
        self.for_s = float(for_s)

    def scale(self, time_scale: float) -> None:
        self.for_s *= time_scale

    def firing(self, db: Any, now: float) -> Optional[Dict[str, float]]:
        raise NotImplementedError


_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class ThresholdRule(Rule):
    def __init__(self, name: str, series: str,
                 labels: Optional[Dict[str, str]] = None, *,
                 op: str = ">", value: float = 0.0,
                 window_s: float = 60.0, agg: str = "avg",
                 severity: str = "warn", for_s: float = 0.0):
        super().__init__(name, severity, for_s)
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: unknown op {op!r}")
        if agg not in ("avg", "min", "max", "last"):
            raise ValueError(f"rule {name!r}: unknown agg {agg!r}")
        self.series = series
        self.labels = dict(labels or {})
        self.op = op
        self.value = float(value)
        self.window_s = float(window_s)
        self.agg = agg

    def scale(self, time_scale: float) -> None:
        super().scale(time_scale)
        self.window_s *= time_scale

    def firing(self, db, now):
        # step=None: ONE aggregate over the whole trailing window (a
        # stepped query would put the window-edge sample in a bucket
        # of its own)
        buckets = db.series(
            self.series, self.labels, now - self.window_s, now,
        )
        if not buckets:
            return None
        observed = buckets[-1][self.agg]
        if _OPS[self.op](observed, self.value):
            return {"value": observed, "threshold": self.value,
                    "window_s": self.window_s}
        return None


class BurnRateRule(Rule):
    def __init__(self, name: str, series: str,
                 labels: Optional[Dict[str, str]] = None, *,
                 objective: float = 0.99, short_s: float = 300.0,
                 long_s: float = 3600.0, factor: float = 14.4,
                 severity: str = "page", for_s: float = 0.0):
        super().__init__(name, severity, for_s)
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"rule {name!r}: objective must be in (0, 1), "
                f"got {objective}"
            )
        if short_s >= long_s:
            raise ValueError(
                f"rule {name!r}: short window {short_s} must be < "
                f"long window {long_s}"
            )
        self.series = series
        self.labels = dict(labels or {})
        self.objective = float(objective)
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.factor = float(factor)

    def scale(self, time_scale: float) -> None:
        super().scale(time_scale)
        self.short_s *= time_scale
        self.long_s *= time_scale

    def _burn(self, db, t0: float, t1: float) -> Optional[float]:
        # step=None: one aggregate over the whole window
        buckets = db.series(self.series, self.labels, t0, t1)
        if not buckets:
            return None
        err = 1.0 - min(1.0, max(0.0, buckets[0]["avg"]))
        return err / max(1e-9, 1.0 - self.objective)

    def firing(self, db, now):
        b_short = self._burn(db, now - self.short_s, now)
        b_long = self._burn(db, now - self.long_s, now)
        if b_short is None or b_long is None:
            return None
        if b_short > self.factor and b_long > self.factor:
            return {"burn_short": b_short, "burn_long": b_long,
                    "threshold": self.factor,
                    "window_s": self.long_s, "value": b_short}
        return None


class AnomalyRule(Rule):
    """EWMA + MAD watchdog: robust to the odd outlier in the history
    (median absolute deviation, not stddev) and to slow drift (the
    EWMA tracks it). The band floor (``0.1% of |ewma|`` + epsilon)
    keeps a perfectly flat series from paging on float jitter."""

    _MODES = ("value", "increase", "hist_p99", "hist_p50")

    def __init__(self, name: str, series: str,
                 labels: Optional[Dict[str, str]] = None, *,
                 mode: str = "value", window_s: float = 600.0,
                 z: float = 8.0, min_points: int = 12,
                 alpha: float = 0.3, severity: str = "warn",
                 for_s: float = 0.0):
        super().__init__(name, severity, for_s)
        if mode not in self._MODES:
            raise ValueError(
                f"rule {name!r}: mode must be one of {self._MODES}, "
                f"got {mode!r}"
            )
        self.series = series
        self.labels = dict(labels or {})
        self.mode = mode
        self.window_s = float(window_s)
        self.z = float(z)
        self.min_points = int(min_points)
        self.alpha = float(alpha)

    def scale(self, time_scale: float) -> None:
        super().scale(time_scale)
        self.window_s *= time_scale

    def _values(self, db, now: float) -> List[float]:
        t0 = now - self.window_s
        if self.mode in ("hist_p99", "hist_p50"):
            q = 0.99 if self.mode == "hist_p99" else 0.50
            out = []
            for _, h in db.hist_points(self.series, self.labels, t0, now):
                edges = list(h.get("buckets") or []) + [math.inf]
                pairs, cum = [], 0.0  # per-bucket -> cumulative `le`
                for e, c in zip(edges, h["counts"]):
                    cum += c
                    pairs.append((
                        {"le": "+Inf" if not math.isfinite(e) else repr(e)},
                        cum,
                    ))
                out.append(obs_metrics.percentile_from_buckets(pairs, q))
            return out
        pts = db.points(self.series, self.labels, t0, now)
        vs = [v for _, v in pts]
        if self.mode == "increase":
            return [cur - prev if cur >= prev else cur
                    for prev, cur in zip(vs, vs[1:])]
        return vs

    def firing(self, db, now):
        vs = [v for v in self._values(db, now) if math.isfinite(v)]
        if len(vs) < max(3, self.min_points):
            return None
        history, current = vs[:-1], vs[-1]
        ewma = history[0]
        resids = []
        for v in history[1:]:
            resids.append(v - ewma)
            ewma = self.alpha * v + (1.0 - self.alpha) * ewma
        med = sorted(resids)[len(resids) // 2] if resids else 0.0
        mad = (sorted(abs(r - med) for r in resids)[len(resids) // 2]
               if resids else 0.0)
        band = 1.4826 * mad + 1e-9 + 1e-3 * abs(ewma)
        rz = abs(current - ewma) / band
        if rz > self.z:
            return {"value": current, "ewma": ewma, "robust_z": rz,
                    "threshold": self.z, "window_s": self.window_s}
        return None


_RULE_TYPES = {
    "threshold": ThresholdRule,
    "burn_rate": BurnRateRule,
    "anomaly": AnomalyRule,
}


def parse_rules(doc: Dict[str, Any]) -> List[Rule]:
    """Build rule objects from a rules doc (the JSON file / the
    DEFAULT_RULES literal). Unknown rule types and duplicate names are
    errors — a typo'd rule silently never firing is the worst failure
    mode an alerting layer can have."""
    out: List[Rule] = []
    seen = set()
    for spec in doc.get("rules", []):
        spec = dict(spec)
        rtype = spec.pop("type", None)
        cls = _RULE_TYPES.get(rtype)
        if cls is None:
            raise ValueError(
                f"unknown rule type {rtype!r} (want one of "
                f"{tuple(_RULE_TYPES)})"
            )
        name = spec.pop("name", None)
        if not name:
            raise ValueError("every rule needs a name")
        if name in seen:
            raise ValueError(f"duplicate rule name {name!r}")
        seen.add(name)
        series = spec.pop("series", None)
        if not series:
            raise ValueError(f"rule {name!r} names no series")
        labels = spec.pop("labels", None)
        out.append(cls(name, series, labels, **spec))
    return out


def load_rules_doc(path: Optional[str] = None) -> Dict[str, Any]:
    """The rules doc ``watch`` and the coordinator evaluate: the JSON
    file at ``path``, or a deep copy of :data:`DEFAULT_RULES`."""
    if path is None:
        return json.loads(json.dumps(DEFAULT_RULES))
    with open(path) as f:
        return json.load(f)


def engine_from_doc(
    doc: Dict[str, Any],
    *,
    time_scale: Optional[float] = None,
    registry: Optional[obs_metrics.MetricsRegistry] = None,
    recorder: Any = None,
) -> "AlertEngine":
    rules = parse_rules(doc)
    scale = float(doc.get("time_scale", 1.0)
                  if time_scale is None else time_scale)
    return AlertEngine(rules, time_scale=scale, registry=registry,
                       recorder=recorder)


class AlertEngine:
    """The fire/resolve state machine over a rule set. One engine per
    watcher (a ``watch`` process, the coordinator supervision loop);
    evaluation is driven by the caller's clock
    so a recorded directory replays deterministically."""

    def __init__(self, rules: List[Rule], *, time_scale: float = 1.0,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 recorder: Any = None):
        if time_scale <= 0:
            raise ValueError(f"time_scale must be > 0, got {time_scale}")
        self.rules = list(rules)
        for r in self.rules:
            r.scale(float(time_scale))
        self.time_scale = float(time_scale)
        self._registry = registry
        self._recorder = recorder
        self._active: Dict[str, Dict[str, Any]] = {}
        self._pending_since: Dict[str, float] = {}
        self._fired_total = 0
        self._last_transition: Optional[Dict[str, Any]] = None

    # -- state -------------------------------------------------------

    def active(self) -> List[Dict[str, Any]]:
        return [dict(a) for _, a in sorted(self._active.items())]

    def pages(self) -> int:
        return sum(1 for a in self._active.values()
                   if a["severity"] == "page")

    def to_block(self) -> Dict[str, Any]:
        """The ``alerts`` block a monitor's ``--json`` carries per
        sample: what is firing now plus the most recent transition."""
        return {
            "active": self.active(),
            "fired_total": self._fired_total,
            "last_transition": (dict(self._last_transition)
                                if self._last_transition else None),
        }

    # -- evaluation --------------------------------------------------

    def evaluate(self, db: Any, now: float) -> List[Dict[str, Any]]:
        """One pass over every rule at time ``now``; returns the
        transitions (fire/resolve) this pass produced. A rule whose
        evaluation raises is skipped for the pass — one broken rule
        must not blind the rest of the watchdog."""
        transitions: List[Dict[str, Any]] = []
        for rule in self.rules:
            try:
                detail = rule.firing(db, now)
            except Exception as e:  # noqa: BLE001 - rule boundary
                # one bad rule must not take down the watch loop: it
                # reports not-firing this pass, and the failure is logged
                log.warn("alert rule evaluation failed", rule=rule.name,
                         error=str(e))
                detail = None
            if detail is not None:
                since = self._pending_since.setdefault(rule.name, now)
                if rule.name not in self._active and (
                        now - since >= rule.for_s):
                    transitions.append(self._fire(rule, detail, now))
                elif rule.name in self._active:
                    self._active[rule.name].update(
                        {k: v for k, v in detail.items()
                         if isinstance(v, (int, float))})
            else:
                self._pending_since.pop(rule.name, None)
                if rule.name in self._active:
                    transitions.append(self._resolve(rule, now))
        self._publish_gauges()
        return transitions

    def _fire(self, rule: Rule, detail: Dict[str, float],
              now: float) -> Dict[str, Any]:
        rec = {
            "transition": "fire",
            "rule": rule.name,
            "severity": rule.severity,
            "t": now,
            **{k: v for k, v in detail.items()
               if isinstance(v, (int, float))},
        }
        self._active[rule.name] = {
            "rule": rule.name, "severity": rule.severity, "since": now,
            **{k: v for k, v in detail.items()
               if isinstance(v, (int, float))},
        }
        self._fired_total += 1
        self._last_transition = rec
        if self._registry is not None:
            self._registry.counter(
                "edl_alerts_fired_total",
                "alert fire transitions by rule name",
                ("rule",),
            ).inc(rule=rule.name)
        self._emit("alert.fire", _EVENT_SEVERITY[rule.severity],
                   rule, detail)
        return rec

    def _resolve(self, rule: Rule, now: float) -> Dict[str, Any]:
        prior = self._active.pop(rule.name)
        rec = {
            "transition": "resolve",
            "rule": rule.name,
            "severity": rule.severity,
            "t": now,
            "active_s": now - prior.get("since", now),
        }
        self._last_transition = rec
        self._emit("alert.resolve", "info", rule,
                   {"active_s": rec["active_s"]})
        return rec

    def _emit(self, kind: str, severity: str, rule: Rule,
              detail: Dict[str, float]) -> None:
        attrs = {k: v for k, v in detail.items()
                 if isinstance(v, (int, float))}
        emit = (self._recorder.emit if self._recorder is not None
                else obs_events.emit)
        emit(kind, severity=severity, site=f"alert.{rule.name}",
             rule=rule.name, alert_severity=rule.severity, **attrs)

    def _publish_gauges(self) -> None:
        if self._registry is None:
            return
        g = self._registry.gauge(
            "edl_alerts_active",
            "alerts currently firing by severity (page/warn/info)",
            ("severity",),
        )
        counts = {"page": 0, "warn": 0, "info": 0}
        for a in self._active.values():
            counts[a["severity"]] += 1
        for sev, n in counts.items():
            g.set(float(n), severity=sev)
