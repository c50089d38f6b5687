"""Metrics core — thread-safe registry of counters, gauges, and
fixed-bucket histograms.

The PyTorch port's copy of ``edl_tpu/obs/metrics.py``, cut to what
``serving.metrics.ServingMetrics`` needs: the Prometheus exposition,
snapshot/merge and the core catalog stay in the reference until the
obs layer is ported.

Design constraints, in order:

* **torch-free, stdlib-only** — the CLI imports this before any device
  work; a scrape must never touch the device.
* **cheap on the hot path** — one lock acquire + a dict hit + (for
  histograms) a bisect per observation. The serving drain calls these
  per iteration.

Histograms are fixed-bucket (Prometheus-style ``le`` edges), and
p50/p95/p99 are linear interpolation inside the owning bucket — the
same estimate a PromQL ``histogram_quantile`` would give.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Sequence, Tuple

# Prometheus' default latency ladder extended to reshard-stall scale
# (the BASELINE north-star is "<30 s per reshard" — the 30/60 edges
# exist so a stall regression lands in a bucket, not in +Inf).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


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


class _HistSample:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0.0] * (n_buckets + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0.0


class Histogram(_Family):
    """Fixed-bucket histogram with interpolated percentiles.

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


# ---------------------------------------------------------------------------
# the process-wide default registry


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
