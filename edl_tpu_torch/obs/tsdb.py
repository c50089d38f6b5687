"""On-disk metric history — the time dimension of the observability
stack (stdlib-only, no torch import).

Every other surface in ``obs/`` is a *snapshot*: ``/metrics`` renders
the registry now, ``edl top`` paints the last scrape, ``edl profile``
reads one roofline position. Burn-rate alerting ("SLO attainment has
been below objective for 2 of the last 5 minutes") needs a durable
series, so this module stores periodic registry snapshots on disk and
answers windowed queries over them.

Layout (one directory per process/fleet):

* ``raw-NNNNNN.jsonl`` — full-resolution tier. Each line is one
  appended registry snapshot, verbatim: ``{"t": <wall>, "snap":
  <MetricsRegistry.snapshot()>}``. Segments roll at ``segment_bytes``.
* ``agg10-NNNNNN.jsonl`` / ``agg60-NNNNNN.jsonl`` — downsample tiers
  (10 s and 1 m buckets by default). Each line is one closed bucket:
  per scalar series the window's ``sum/cnt/min/max/last``, per
  histogram series the *last cumulative sample* in the window (for a
  cumulative histogram the window-edge value is the exact aggregate —
  rates and percentile bounds survive downsampling losslessly).

Retention deletes the oldest RAW segment first (its history survives
in the tiers), then the oldest 10 s segment, then 1 m — so the store
degrades in resolution, never in coverage, until ``max_bytes`` holds.

Counter semantics: processes restart, so any cumulative series can
reset to zero mid-window. :meth:`TSDB.increase` and
:meth:`TSDB.hist_delta` clamp every negative step to the post-reset
value instead of letting a windowed delta go negative — the classic
``rate()`` bug this module's tests pin.

The PyTorch port's copy of ``edl_tpu/obs/tsdb.py``, unchanged in
behaviour. The exporter serves it on ``/history``; ``loadgen
--tsdb-dir`` records into it.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TSDB",
    "flatten_snapshot",
    "parse_series_key",
    "series_key",
    "snapshot_from_prometheus_text",
]

_SEG_RE = re.compile(r"^(raw|agg(\d+))-(\d{6})\.jsonl$")


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Canonical series identity: ``name{k=v,...}`` with sorted label
    keys — the same (name, labels) always maps to the same key, so
    downsampled aggregates line up with raw points."""
    items = sorted((labels or {}).items())
    inner = ",".join(f"{k}={v}" for k, v in items)
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def flatten_snapshot(
    snap: Dict[str, Any],
) -> Tuple[Dict[str, float], Dict[str, Dict[str, Any]]]:
    """Split one registry snapshot into ``{key: value}`` scalars
    (counters + gauges) and ``{key: {counts, sum, count, buckets}}``
    histogram samples."""
    scalars: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for fam in snap.get("families", []):
        names = fam.get("labelnames") or []
        for s in fam.get("samples", []):
            labels = {
                k: str(v) for k, v in zip(names, s.get("labels", []))
            }
            key = series_key(fam["name"], labels)
            if fam.get("kind") == "histogram":
                hists[key] = {
                    "counts": [float(c) for c in s["counts"]],
                    "sum": float(s["sum"]),
                    "count": float(s["count"]),
                    "buckets": [float(b) for b in fam.get("buckets") or []],
                }
            else:
                scalars[key] = float(s["value"])
    return scalars, hists


def snapshot_from_prometheus_text(text: str) -> Dict[str, Any]:
    """Adapt a scraped ``/metrics`` page into the snapshot doc
    :meth:`TSDB.append` stores, so ``edl watch`` can record a live
    endpoint it can only see through text exposition. Every parsed
    series lands as a gauge-kind sample (histogram buckets arrive as
    their exploded ``_bucket{le=}`` / ``_sum`` / ``_count`` series,
    which is exactly what windowed rate queries need anyway)."""
    from .metrics import parse_prometheus_text

    fams = []
    for name, pairs in sorted(parse_prometheus_text(text).items()):
        labelnames = sorted({k for labels, _ in pairs for k in labels})
        fams.append({
            "name": name,
            "kind": "gauge",
            "labelnames": labelnames,
            "samples": [
                {
                    "labels": [labels.get(k, "") for k in labelnames],
                    "value": v,
                }
                for labels, v in pairs
            ],
        })
    return {"v": 1, "families": fams}


def _merge_scalar(agg: Optional[Dict[str, float]], v: float,
                  ) -> Dict[str, float]:
    if agg is None:
        return {"sum": v, "cnt": 1.0, "min": v, "max": v, "last": v}
    agg["sum"] += v
    agg["cnt"] += 1.0
    agg["min"] = min(agg["min"], v)
    agg["max"] = max(agg["max"], v)
    agg["last"] = v
    return agg


def _merge_agg(a: Optional[Dict[str, float]], b: Dict[str, float],
               ) -> Dict[str, float]:
    """Fold two closed-window aggregates (``b`` later than ``a``)."""
    if a is None:
        return dict(b)
    return {
        "sum": a["sum"] + b["sum"],
        "cnt": a["cnt"] + b["cnt"],
        "min": min(a["min"], b["min"]),
        "max": max(a["max"], b["max"]),
        "last": b["last"],
    }


class _Tier:
    """One open downsample tier: accumulates the current bucket in
    memory and flushes it as ONE line when time moves past its edge."""

    def __init__(self, width_s: float):
        self.width_s = float(width_s)
        self.bidx: Optional[int] = None  # open bucket index
        self.t_last: float = 0.0  # latest sample time in the bucket
        self.scalars: Dict[str, Dict[str, float]] = {}
        self.hists: Dict[str, Dict[str, Any]] = {}

    def record_name(self) -> str:
        return f"agg{int(self.width_s)}"

    def add(self, t: float, scalars, hists) -> Optional[Dict[str, Any]]:
        """Accumulate one snapshot; returns the CLOSED bucket record
        when ``t`` crosses into a new bucket, else None."""
        bidx = int(math.floor(t / self.width_s))
        closed = None
        if self.bidx is not None and bidx != self.bidx:
            closed = self.to_record()
            self.scalars, self.hists = {}, {}
        self.bidx = bidx
        self.t_last = t
        for key, v in scalars.items():
            self.scalars[key] = _merge_scalar(self.scalars.get(key), v)
        for key, h in hists.items():
            self.hists[key] = dict(h)  # cumulative: last wins
        return closed

    def to_record(self) -> Optional[Dict[str, Any]]:
        if self.bidx is None or not (self.scalars or self.hists):
            return None
        return {
            "t0": self.bidx * self.width_s,
            "t1": (self.bidx + 1) * self.width_s,
            # the latest sample actually inside the bucket: readers
            # stamp fills here, never at a t1 the writer hasn't
            # reached (an open bucket's edge is in the future)
            "tl": self.t_last,
            "w": self.width_s,
            "series": self.scalars,
            "hist": self.hists,
        }


class TSDB:
    """Append + query over one history directory. Safe for one writer
    process (appends are lock-serialized); any number of readers can
    open the same directory independently."""

    def __init__(
        self,
        path: str,
        *,
        segment_bytes: int = 1 << 20,
        max_bytes: int = 16 << 20,
        tiers: Tuple[float, ...] = (10.0, 60.0),
    ):
        if segment_bytes <= 0 or max_bytes <= 0:
            raise ValueError("segment_bytes/max_bytes must be > 0")
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._tiers = [_Tier(w) for w in sorted(tiers)]
        os.makedirs(path, exist_ok=True)
        # resume numbering after existing segments so a reopened dir
        # keeps appending instead of clobbering history
        self._seq: Dict[str, int] = {}
        for fname, _, _ in self._segments():
            m = _SEG_RE.match(fname)
            kind, num = m.group(1), int(m.group(3))
            self._seq[kind] = max(self._seq.get(kind, 0), num + 1)

    # -- write side --------------------------------------------------

    def append(self, snap: Any, t: Optional[float] = None) -> None:
        """Store one registry snapshot (dict or ``snapshot_json()``
        string) at wall time ``t``. Rolls/downsamples/retains as a
        side effect; never raises into the caller's telemetry loop for
        malformed snapshots — those raise ValueError loudly instead
        (an appender with a broken snapshot is a bug, not weather)."""
        if isinstance(snap, (str, bytes)):
            snap = json.loads(snap)
        if not isinstance(snap, dict) or "families" not in snap:
            raise ValueError("not a registry snapshot (no families)")
        t = float(time.time() if t is None else t)
        scalars, hists = flatten_snapshot(snap)
        line = json.dumps(
            {"t": t, "snap": snap}, separators=(",", ":")
        ) + "\n"
        with self._lock:
            self._write("raw", line)
            for tier in self._tiers:
                closed = tier.add(t, scalars, hists)
                if closed is not None:
                    self._write(
                        tier.record_name(),
                        json.dumps(closed, separators=(",", ":")) + "\n",
                    )
            self._retain()

    def flush(self) -> None:
        """Flush every open downsample bucket (stop/final-push path) —
        after this, readers of the directory see the full history the
        writer saw."""
        with self._lock:
            for tier in self._tiers:
                rec = tier.to_record()
                if rec is not None:
                    self._write(
                        tier.record_name(),
                        json.dumps(rec, separators=(",", ":")) + "\n",
                    )
                tier.bidx, tier.scalars, tier.hists = None, {}, {}
            self._retain()

    def _write(self, kind: str, line: str) -> None:
        seq = self._seq.get(kind, 0)
        fpath = os.path.join(self.path, f"{kind}-{seq:06d}.jsonl")
        with open(fpath, "a") as f:
            f.write(line)
        if os.path.getsize(fpath) >= self.segment_bytes:
            self._seq[kind] = seq + 1

    def _segments(self) -> List[Tuple[str, str, int]]:
        """(fname, kind, size) for every segment, sorted by (kind
        resolution, seq) — raw first, then finer tiers."""
        out = []
        try:
            names = sorted(os.listdir(self.path))
        except OSError:
            return []
        for fname in names:
            m = _SEG_RE.match(fname)
            if m:
                fpath = os.path.join(self.path, fname)
                try:
                    out.append((fname, m.group(1), os.path.getsize(fpath)))
                except OSError:
                    continue
        return out

    def total_bytes(self) -> int:
        return sum(size for _, _, size in self._segments())

    def _retain(self) -> None:
        """Enforce ``max_bytes``: drop the oldest segment of the
        FINEST kind that still has more than one segment (the active
        tail is never deleted) — resolution degrades, coverage stays."""
        while self.total_bytes() > self.max_bytes:
            segs = self._segments()
            by_kind: Dict[str, List[str]] = {}
            for fname, kind, _ in segs:
                by_kind.setdefault(kind, []).append(fname)
            order = ["raw"] + [t.record_name() for t in self._tiers]
            victim = None
            for kind in order:
                files = sorted(by_kind.get(kind, []))
                if len(files) > 1:
                    victim = files[0]
                    break
            if victim is None:
                break  # single active segment per kind — nothing safe to drop
            os.remove(os.path.join(self.path, victim))

    # -- read side ---------------------------------------------------

    def _iter_raw(
        self, t0: float, t1: float
    ) -> Iterable[Tuple[float, Dict[str, float], Dict[str, Any]]]:
        for fname, kind, _ in self._segments():
            if kind != "raw":
                continue
            with open(os.path.join(self.path, fname)) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # truncated tail of a crashed writer
                    t = float(rec.get("t", math.nan))
                    if t0 <= t <= t1:
                        yield (t, *flatten_snapshot(rec.get("snap", {})))

    def _iter_tier(
        self, width_s: float, t0: float, t1: float
    ) -> Iterable[Dict[str, Any]]:
        kind = f"agg{int(width_s)}"
        for fname, k, _ in self._segments():
            if k != kind:
                continue
            with open(os.path.join(self.path, fname)) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("t1", 0) > t0 and rec.get("t0", 0) < t1:
                        yield rec
        # the writer's open bucket is part of the history its own
        # process queries (alert engines run in the appender)
        for tier in self._tiers:
            if tier.width_s == width_s:
                rec = tier.to_record()
                if rec and rec["t1"] > t0 and rec["t0"] < t1:
                    yield rec

    def raw_times(
        self, t0: float = -math.inf, t1: float = math.inf
    ) -> List[float]:
        """Every raw append timestamp in range, sorted — the replay
        axis ``edl watch`` walks over a recorded directory."""
        return sorted(t for t, _, _ in self._iter_raw(t0, t1))

    def series_names(self) -> List[str]:
        names = set()
        for _, scalars, hists in self._iter_raw(-math.inf, math.inf):
            names.update(scalars)
            names.update(hists)
        for tier in self._tiers:
            for rec in self._iter_tier(tier.width_s, -math.inf, math.inf):
                names.update(rec.get("series", {}))
                names.update(rec.get("hist", {}))
        return sorted(names)

    def points(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        t0: float = -math.inf,
        t1: float = math.inf,
    ) -> List[Tuple[float, float]]:
        """Scalar samples ``[(t, v)]``: raw resolution where raw
        segments survive, tier ``last``-per-bucket (stamped at the
        bucket edge) where retention already folded raw away."""
        key = series_key(name, labels)
        pts = [
            (t, scalars[key])
            for t, scalars, _ in self._iter_raw(t0, t1)
            if key in scalars
        ]
        covered_from = min((t for t, _ in pts), default=math.inf)
        for tier in self._tiers:  # finest tier fills the gap first
            fill = [
                (ts, rec["series"][key]["last"])
                for rec in self._iter_tier(tier.width_s, t0, t1)
                if key in rec.get("series", {})
                # stamp at the bucket's true last-sample time (older
                # records predate "tl": their t1 was always reached)
                for ts in (min(rec["t1"], rec.get("tl", rec["t1"])),)
                if ts <= covered_from and t0 <= ts <= t1
            ]
            if fill:
                pts.extend(fill)
                covered_from = min(covered_from,
                                   min(t for t, _ in fill))
        return sorted(set(pts))

    def hist_points(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        t0: float = -math.inf,
        t1: float = math.inf,
    ) -> List[Tuple[float, Dict[str, Any]]]:
        """Cumulative histogram samples ``[(t, {counts,sum,count,
        buckets})]`` with the same raw-then-tier fallback as
        :meth:`points`."""
        key = series_key(name, labels)
        pts = [
            (t, hists[key])
            for t, _, hists in self._iter_raw(t0, t1)
            if key in hists
        ]
        covered_from = min((t for t, _ in pts), default=math.inf)
        for tier in self._tiers:
            fill = [
                (ts, rec["hist"][key])
                for rec in self._iter_tier(tier.width_s, t0, t1)
                if key in rec.get("hist", {})
                for ts in (min(rec["t1"], rec.get("tl", rec["t1"])),)
                if ts <= covered_from and t0 <= ts <= t1
            ]
            if fill:
                pts.extend(fill)
                covered_from = min(covered_from,
                                   min(t for t, _ in fill))
        return sorted(pts, key=lambda p: p[0])

    def series(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        t0: float = -math.inf,
        t1: float = math.inf,
        step: Optional[float] = None,
    ) -> List[Dict[str, float]]:
        """Windowed aggregate query — the alert engine's read path.
        Buckets ``[t0 + k*step, t0 + (k+1)*step)`` each carry
        ``t/sum/count/min/max/last/avg`` over the points inside.
        ``step=None`` (or a non-finite range) returns one bucket over
        the whole range. Buckets with no points are omitted."""
        pts = self.points(name, labels, t0, t1)
        if not pts:
            return []
        if step is None or not math.isfinite(t0):
            start, step_w = pts[0][0], math.inf
        else:
            start, step_w = t0, float(step)
        buckets: Dict[int, Dict[str, float]] = {}
        for t, v in pts:
            k = 0 if not math.isfinite(step_w) else int((t - start) // step_w)
            buckets[k] = _merge_scalar(buckets.get(k), v)
        out = []
        for k in sorted(buckets):
            agg = buckets[k]
            agg["t"] = start if not math.isfinite(step_w) else start + k * step_w
            agg["avg"] = agg["sum"] / agg["cnt"]
            out.append(agg)
        return out

    def increase(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        t0: float = -math.inf,
        t1: float = math.inf,
    ) -> float:
        """Counter increase over the window with RESET CLAMPING: a
        sample below its predecessor means the process restarted, so
        that step contributes the post-reset value (counting from
        zero), never a negative delta."""
        pts = self.points(name, labels, t0, t1)
        inc = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            inc += cur - prev if cur >= prev else cur
        return inc

    def hist_delta(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        t0: float = -math.inf,
        t1: float = math.inf,
    ) -> Optional[Dict[str, Any]]:
        """Windowed delta of a cumulative histogram: per-bucket count
        increases between the window's edge samples, clamped at a
        counter reset (total count went down → the later sample IS the
        delta, the pre-reset history is gone). Returns ``{pairs, sum,
        count, buckets}`` where ``pairs`` is the
        ``[({"le": edge}, cumulative)]`` list
        :func:`~edl_tpu_torch.obs.metrics.percentile_from_buckets` takes, or
        None with fewer than 2 samples in range."""
        pts = self.hist_points(name, labels, t0, t1)
        if len(pts) < 2:
            return None
        lo, hi = pts[0][1], pts[-1][1]
        buckets = hi.get("buckets") or lo.get("buckets") or []
        if hi["count"] < lo["count"] or len(lo["counts"]) != len(hi["counts"]):
            d_counts = list(hi["counts"])  # reset: later sample counts from 0
            d_sum, d_count = hi["sum"], hi["count"]
        else:
            d_counts = [
                max(0.0, h - l) for h, l in zip(hi["counts"], lo["counts"])
            ]
            d_sum = max(0.0, hi["sum"] - lo["sum"])
            d_count = max(0.0, hi["count"] - lo["count"])
        # registry counts are per-bucket; Prometheus `le` pairs are
        # cumulative — running-sum before handing to the quantile math
        pairs, cum = [], 0.0
        for e, c in zip(list(buckets) + [math.inf], d_counts):
            cum += c
            pairs.append(
                ({"le": "+Inf" if not math.isfinite(e) else repr(e)}, cum)
            )
        return {
            "pairs": pairs,
            "sum": d_sum,
            "count": d_count,
            "buckets": list(buckets),
        }

    # -- http --------------------------------------------------------

    def render_history(self, qs: Dict[str, List[str]]) -> str:
        """The ``/history`` endpoint body (exporter.py routes here).
        No ``name`` → the series directory; with ``name`` → points or
        ``step``-bucketed aggregates. Any unrecognized query param is
        a label matcher, so ``/history?name=edl_slo_ttft_ok_ratio&
        slo_class=interactive&step=60`` reads exactly like the query
        API."""
        def one(param: str) -> Optional[str]:
            vals = qs.get(param)
            return vals[0] if vals else None

        name = one("name")
        if not name:
            return json.dumps(
                {"series": self.series_names(),
                 "total_bytes": self.total_bytes()},
                separators=(",", ":"),
            )
        t0 = float(one("t0") or -math.inf)
        t1 = float(one("t1") or math.inf)
        step = one("step")
        labels = {
            k: vs[0] for k, vs in qs.items()
            if k not in ("name", "t0", "t1", "step") and vs
        }
        if step is not None:
            body: Any = self.series(name, labels, t0, t1, float(step))
        else:
            body = [[t, v] for t, v in self.points(name, labels, t0, t1)]
        return json.dumps(
            {"name": name, "labels": labels, "points": body},
            separators=(",", ":"),
        )
