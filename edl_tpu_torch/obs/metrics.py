"""Metrics core — thread-safe registry of counters, gauges, and
fixed-bucket histograms with Prometheus text exposition: the port's
copy of ``edl_tpu/obs/metrics.py``. Names, help strings and the
rendered text are the reference's byte for byte, so dashboards and
scrapers carry over.

Design constraints, in order:

* **torch-free, stdlib-only** — the CLI imports this before any device
  work; a scrape must never touch the device.
* **cheap on the hot path** — one lock acquire + a dict hit + (for
  histograms) a bisect per observation. The step loop and the serving
  drain call these per iteration.

Histograms are fixed-bucket (Prometheus-style cumulative ``le``
edges), and p50/p95/p99 are linear interpolation inside the owning
bucket — the same estimate a PromQL ``histogram_quantile`` would give.
``MetricsRegistry.snapshot()`` is a JSON-able dict: what the metric
history (``obs/tsdb.py``) stores. The reference's ``merge_snapshot``
(the fleet's KV aggregation) waits for the rest of ``obs/fleet``.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Prometheus' default latency ladder extended to reshard-stall scale
# (the BASELINE north-star is "<30 s per reshard" — the 30/60 edges
# exist so a stall regression lands in a bucket, not in +Inf).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _fnum(v: float) -> str:
    """Prometheus sample-value formatting: integral floats print as
    ints (``3`` not ``3.0``), everything else as repr."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Family:
    """One named metric family: a kind, a label schema, and a dict of
    per-label-value samples. Base for Counter/Gauge/Histogram."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            # eager unlabeled sample: the series renders a concrete
            # value from registration on (a scraper sees the catalog
            # even before the first observation)
            self._samples[()] = self._new_sample()

    def _new_sample(self):
        raise NotImplementedError

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        # hot path: no intermediate set allocations — a gauge set /
        # counter inc runs once per engine step
        if not labels:
            if self.labelnames:
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}"
                )
            return ()
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        try:
            return tuple(str(labels[n]) for n in self.labelnames)
        except KeyError:
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            ) from None

    def _sample_locked(self, labels: Dict[str, str]):
        key = self._key(labels)
        s = self._samples.get(key)
        if s is None:
            s = self._samples.setdefault(key, self._new_sample())
        return s

    def samples(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._samples.items())


class Counter(_Family):
    """Monotonic counter (name it ``*_total``)."""

    kind = "counter"

    def _new_sample(self) -> List[float]:
        return [0.0]

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (got {n})")
        with self._lock:
            self._sample_locked(labels)[0] += n

    def value(self, **labels: str) -> float:
        with self._lock:
            s = self._samples.get(self._key(labels))
            return s[0] if s else 0.0

    def render(self, out: List[str]) -> None:
        for key, s in self.samples():
            out.append(
                f"{self.name}{_label_str(self.labelnames, key)} {_fnum(s[0])}"
            )


class Gauge(_Family):
    """Set-to-current-value metric (queue depth, active slots, loss)."""

    kind = "gauge"

    def _new_sample(self) -> List[float]:
        return [0.0]

    def set(self, v: float, **labels: str) -> None:
        with self._lock:
            self._sample_locked(labels)[0] = float(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._sample_locked(labels)[0] += n

    def value(self, **labels: str) -> float:
        with self._lock:
            s = self._samples.get(self._key(labels))
            return s[0] if s else 0.0

    def render(self, out: List[str]) -> None:
        for key, s in self.samples():
            out.append(
                f"{self.name}{_label_str(self.labelnames, key)} {_fnum(s[0])}"
            )


class _HistSample:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0.0] * (n_buckets + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0.0


class Histogram(_Family):
    """Fixed-bucket histogram with cumulative Prometheus exposition and
    interpolated percentiles.

    ``observe(v, n=...)`` supports weighted observations: the serving
    engine drains a fused horizon block's tokens with ONE clock read,
    so inter-token latency lands as one observation of the per-token
    mean with weight n — the histogram stays exact in count and sum.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(not math.isfinite(x) for x in b):
            raise ValueError(f"{name}: buckets must be finite and non-empty")
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _new_sample(self) -> _HistSample:
        return _HistSample(len(self.buckets))

    def observe(self, v: float, n: float = 1.0, **labels: str) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            s = self._sample_locked(labels)
            s.counts[i] += n
            s.sum += v * n
            s.count += n

    def percentile(self, q: float, **labels: str) -> float:
        """Interpolated quantile estimate (same rule as PromQL
        ``histogram_quantile``): linear within the owning bucket, the
        +Inf bucket clamps to the largest finite edge. 0.0 when empty."""
        with self._lock:
            s = self._samples.get(self._key(labels))
            if s is None or s.count <= 0:
                return 0.0
            counts = list(s.counts)
            total = s.count
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= target and c > 0:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (target - prev) / c
                return lo + frac * (hi - lo)
        return self.buckets[-1]

    def stats(self, **labels: str) -> Dict[str, float]:
        with self._lock:
            s = self._samples.get(self._key(labels))
            if s is None:
                return {"count": 0.0, "sum": 0.0}
            return {"count": s.count, "sum": s.sum}

    def render(self, out: List[str]) -> None:
        for key, s in self.samples():
            cum = 0.0
            for edge, c in zip(self.buckets, s.counts):
                cum += c
                lv = _label_str(
                    self.labelnames + ("le",), key + (str(edge),)
                )
                out.append(f"{self.name}_bucket{lv} {_fnum(cum)}")
            lv = _label_str(self.labelnames + ("le",), key + ("+Inf",))
            out.append(f"{self.name}_bucket{lv} {_fnum(s.count)}")
            ls = _label_str(self.labelnames, key)
            out.append(f"{self.name}_sum{ls} {_fnum(s.sum)}")
            out.append(f"{self.name}_count{ls} {_fnum(s.count)}")


class MetricsRegistry:
    """Thread-safe named-family registry.

    ``counter``/``gauge``/``histogram`` are get-or-create: the same
    (name, kind, labelnames) returns the existing family, so every
    instrumentation site can declare its series locally and module
    import order never matters. A name re-registered with a different
    kind or label schema raises — silent schema drift would corrupt
    the fleet merge.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "Dict[str, _Family]" = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, requested "
                        f"{cls.kind}{tuple(labelnames)}"
                    )
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def families(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    # -- exposition ---------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            fam.render(out)
        return "\n".join(out) + "\n"

    # -- snapshot (the format the metric history stores) ------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able full dump of every family: what the metric history
        (obs/tsdb.py) appends."""
        fams = []
        for fam in self.families():
            rec: Dict[str, Any] = {
                "name": fam.name,
                "kind": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
            }
            if isinstance(fam, Histogram):
                rec["buckets"] = list(fam.buckets)
                rec["samples"] = [
                    {
                        "labels": list(key),
                        "counts": list(s.counts),
                        "sum": s.sum,
                        "count": s.count,
                    }
                    for key, s in fam.samples()
                ]
            else:
                rec["samples"] = [
                    {"labels": list(key), "value": s[0]}
                    for key, s in fam.samples()
                ]
            fams.append(rec)
        return {"v": 1, "families": fams}


# ---------------------------------------------------------------------------
# the process-wide default registry + the core series catalog


_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    return _default


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (tests); returns the new one."""
    global _default
    with _default_lock:
        _default = MetricsRegistry()
    return _default


def ensure_core_series(reg: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Pre-register the core catalog so a scrape of ANY edl process
    shows the full schema — training, serving, reshard, and checkpoint
    series render (zero-valued until observed) even on a process that
    only ever serves. Keep this list in sync with
    doc/observability.md."""
    r = reg or default_registry()
    # training
    r.counter("edl_train_steps_total", "optimizer steps completed")
    r.counter("edl_train_examples_total", "training rows consumed")
    r.histogram("edl_train_step_seconds", "full step wall time (data + dispatch + sync)")
    r.histogram("edl_train_data_wait_seconds", "host wait for the next batch (data stall)")
    r.histogram("edl_train_host_block_seconds", "host blocked on device results (sync stall)")
    r.histogram("edl_train_dispatch_seconds", "train-step program dispatch (enqueue) time")
    r.gauge("edl_train_examples_per_sec", "training throughput over the last report window")
    r.gauge("edl_train_loss", "most recent training loss")
    # serving
    r.counter("edl_serving_requests_total", "request lifecycle events", ("event",))
    r.counter("edl_serving_tokens_total", "generated tokens")
    r.counter("edl_serving_dispatch_total", "device program dispatches", ("kind",))
    r.histogram("edl_serving_ttft_seconds", "time to first token (submit -> first token)")
    r.histogram("edl_serving_itl_seconds", "inter-token latency (per generated token)")
    r.histogram(
        "edl_serving_tpot_seconds",
        "user-perceived time per output token: (finish - first token) "
        "/ (tokens - 1), once per finished request",
    )
    # the latency decomposition (queue wait + prefill ~= TTFT; block =
    # the decode granule) — see doc/observability.md "SLO & goodput"
    r.histogram("edl_serving_queue_wait_seconds", "queue wait (submit -> scheduler pop)")
    r.histogram("edl_serving_prefill_seconds", "prefill phase (scheduler pop -> first token)")
    r.histogram("edl_serving_block_seconds", "fused decode block wall time (dispatch -> drain)")
    r.counter(
        "edl_serving_outcomes_total",
        "terminal request outcomes by tenant and SLO class",
        ("outcome", "tenant", "slo_class"),
    )
    # SLO burn gauges (obs/slo.py update_gauges; loadgen refreshes
    # them live during a load run)
    r.gauge(
        "edl_slo_ttft_ok_ratio",
        "fraction of served requests meeting their class TTFT SLO",
        ("slo_class",),
    )
    r.gauge(
        "edl_slo_itl_ok_ratio",
        "fraction of served requests meeting their class per-token SLO",
        ("slo_class",),
    )
    r.gauge("edl_slo_goodput_rps", "requests/s finishing within their class SLOs")
    r.gauge(
        "edl_slo_goodput_fraction",
        "good requests / all requests (shed and timeouts count against)",
    )
    r.gauge("edl_serving_queue_depth", "requests waiting for a KV slot")
    r.gauge("edl_serving_active_slots", "occupied KV slots")
    r.gauge("edl_serving_slot_occupancy", "mean active/max slots over decode steps")
    r.counter(
        "edl_serving_recoveries_total",
        "engine crash-recovery passes (device state rebuilt, live "
        "slots re-prefilled from prompt + generated)",
    )
    # robustness (doc/robustness.md)
    r.counter("edl_faults_injected_total", "injected faults by site", ("site",))
    r.counter("edl_metrics_push_failures_total", "metrics snapshot pushes that raised")
    r.gauge(
        "edl_worker_heartbeat_degraded",
        "1 while the heartbeat loop cannot reach the coordinator",
    )
    # chip-lease elasticity (elasticity/broker.py + distbroker.py)
    r.counter(
        "edl_lease_fenced_total",
        "lease confirms rejected by the epoch fence",
        ("reason",),
    )
    r.counter(
        "edl_lease_recoveries_total",
        "broker-restart recoveries completed (RECOVERING -> steady)",
    )
    # elastic / reshard (the BASELINE north-star metric, scrapeable)
    r.counter("edl_reshard_total", "elastic reshards", ("path",))
    r.histogram("edl_reshard_stall_seconds", "traffic-stopping reshard window")
    r.histogram("edl_reshard_recompile_seconds", "first-step compile on the new mesh")
    # checkpoint
    r.histogram("edl_checkpoint_save_seconds", "checkpoint write time", ("kind",))
    r.histogram("edl_checkpoint_restore_seconds", "checkpoint read/restore time", ("kind",))
    r.counter("edl_checkpoint_bytes_total", "checkpoint bytes moved", ("op",))
    # hardware efficiency (obs/costmodel.py, obs/memledger.py,
    # obs/compilewatch.py — doc/observability.md "Hardware efficiency")
    r.gauge(
        "edl_mfu",
        "achieved model FLOPs/s over peak FLOPs by phase (obs/costmodel.py)",
        ("phase",),
    )
    r.gauge(
        "edl_bw_util_ratio",
        "achieved HBM bytes/s over peak bandwidth by phase",
        ("phase",),
    )
    r.counter(
        "edl_costmodel_flops_total",
        "analytic model FLOPs completed by phase",
        ("phase",),
    )
    r.counter(
        "edl_costmodel_hbm_bytes_total",
        "analytic HBM bytes moved by phase",
        ("phase",),
    )
    r.gauge(
        "edl_hbm_bytes",
        "bytes of registered long-lived device allocations by "
        "category (obs/memledger.py)",
        ("category",),
    )
    r.gauge(
        "edl_kv_occupancy_ratio",
        "used KV-cache tokens over capacity across registered engines",
    )
    r.histogram(
        "edl_compile_seconds",
        "first-call (trace + compile) time per distinct jit program",
        ("program",),
    )
    r.counter(
        "edl_compiles_total",
        "distinct jit programs compiled, by factory",
        ("program",),
    )
    # tracing bridge (obs/fleet.py bridge_tracer)
    r.histogram("edl_span_seconds", "tracer span durations by name", ("name",))
    r.counter("edl_trace_spans_dropped_total", "spans evicted from the tracer ring buffer")
    # flight recorder (obs/events.py)
    r.counter("edl_events_total", "flight-recorder events by kind", ("kind",))
    r.counter(
        "edl_events_dropped_total",
        "flight-recorder events evicted from the bounded ring",
    )
    # history & alerting (obs/tsdb.py, obs/alerts.py —
    # doc/observability.md "History, alerting & burn rates")
    r.gauge(
        "edl_alerts_active",
        "alerts currently firing by severity (page/warn/info)",
        ("severity",),
    )
    r.counter(
        "edl_alerts_fired_total",
        "alert fire transitions by rule name",
        ("rule",),
    )
    r.gauge(
        "edl_hbm_crosscheck_drift_bytes",
        "ledger-vs-live-arrays drift from memledger.crosscheck(), "
        "refreshed on the metrics-push/tsdb-append cadence",
    )
    return r


# ---------------------------------------------------------------------------
# Prometheus text parsing (the `edl top` / test-side consumer)


def _unescape_label(v: str) -> str:
    """Invert :func:`_escape_label` in ONE left-to-right pass. The old
    chained ``.replace`` corrupted values where a literal backslash
    preceded an ``n`` or a quote: ``\\`` + ``n`` renders as ``\\\\n``,
    and replacing ``\\n`` first turns the escaped backslash's second
    character into a newline."""
    if "\\" not in v:
        return v
    out: List[str] = []
    i, n = 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def parse_prometheus_text(
    text: str,
) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Parse exposition text into {metric_name: [(labels, value), ...]}.
    Histogram component series keep their ``_bucket``/``_sum``/
    ``_count`` suffixes — the consumer reassembles quantiles via
    :func:`percentile_from_buckets`."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{l1="v1",...} value  |  name value
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_raw, _, val = rest.rpartition("}")
            labels: Dict[str, str] = {}
            # split on commas not inside quotes, honoring backslash
            # escapes (a \" inside a value must not close the quote)
            buf, inq, esc, parts = "", False, False, []
            for ch in labels_raw:
                if esc:
                    buf += ch
                    esc = False
                    continue
                if inq and ch == "\\":
                    buf += ch
                    esc = True
                    continue
                if ch == '"':
                    inq = not inq
                if ch == "," and not inq:
                    parts.append(buf)
                    buf = ""
                else:
                    buf += ch
            if buf:
                parts.append(buf)
            for p in parts:
                if "=" not in p:
                    continue
                k, v = p.split("=", 1)
                # exactly ONE surrounding quote pair — str.strip('"')
                # would eat a trailing quote that belongs to a \" escape
                v = v.strip()
                if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                    v = v[1:-1]
                labels[k.strip()] = _unescape_label(v)
            try:
                fval = float(val.strip().split()[0])
            except (ValueError, IndexError):
                continue
            out.setdefault(name.strip(), []).append((labels, fval))
        else:
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                fval = float(parts[1])
            except ValueError:
                continue
            out.setdefault(parts[0], []).append(({}, fval))
    return out


def percentile_from_buckets(
    pairs: Iterable[Tuple[Dict[str, str], float]], q: float
) -> float:
    """Quantile from parsed ``*_bucket`` samples (summed across any
    non-``le`` labels, i.e. fleet-wide when workers are labels). Same
    interpolation rule as :meth:`Histogram.percentile`."""
    by_edge: Dict[float, float] = {}
    for labels, v in pairs:
        le = labels.get("le")
        if le is None:
            continue
        edge = math.inf if le == "+Inf" else float(le)
        by_edge[edge] = by_edge.get(edge, 0.0) + v
    if not by_edge:
        return 0.0
    edges = sorted(by_edge)
    total = by_edge[edges[-1]] if edges and edges[-1] == math.inf else (
        max(by_edge.values()) if by_edge else 0.0
    )
    if total <= 0:
        return 0.0
    target = q * total
    prev_cum, prev_edge = 0.0, 0.0
    finite = [e for e in edges if math.isfinite(e)]
    for e in edges:
        cum = by_edge[e]
        if cum >= target and cum > prev_cum:
            if not math.isfinite(e):
                return finite[-1] if finite else 0.0
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_edge + frac * (e - prev_edge)
        prev_cum, prev_edge = cum, (e if math.isfinite(e) else prev_edge)
    return finite[-1] if finite else 0.0
