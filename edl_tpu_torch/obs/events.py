"""Flight recorder — a bounded ring of typed, correlated events: the
port's copy of ``edl_tpu/obs/events.py``, with the same event kinds,
correlation keys and dump format, so postmortem tooling reads either.

Metrics aggregate away causality and tracer spans are durations with no
request identity; neither explains ONE incident after the fact. Every
autonomous decision — admit, preempt, reshard, retry, recover — lands
here as one typed event ``{seq, t_wall, kind, severity, corr, attrs}``
with a monotonically increasing sequence number, so "what happened to
request r17" or "what followed fault #3" is a filter, not a log grep.

Correlation keys are first-class (``rid`` for serving requests,
``step`` for checkpoints, ``reshard_epoch`` for elastic rescales,
``site`` for injected faults, ``worker`` for fleet identity).

Design constraints, in order:

* **cheap, always-on** — one lock acquire + a deque append per event;
  sites sit on per-block / per-request / per-reshard paths, never
  per-token. The ring is bounded (drop-OLDEST, keeping the events
  closest to the incident; ``EDL_EVENTS_MAX``, default 8192) and
  evictions are counted (``dropped`` + ``edl_events_dropped_total``)
  so a truncated window is never mistaken for a complete one.
* **torch-free, stdlib-only** — the CLI and exporters import this.
* **a black box** — :func:`crash_dump` writes the ring as JSONL under
  ``$EDL_BLACKBOX_DIR`` (no-op when unset, never raises): recovery
  paths call it BEFORE rebuilding state, so the dump holds the events
  leading up to the incident.

Every emit also increments ``edl_events_total{kind}`` in the process
registry. Warn/error KV-log lines mirror in as ``log.warn`` /
``log.error`` events via the ``utils/logging.py`` sink (installed at
import), so stray error logs land on the same timeline as the
decisions around them.

Usage::

    from edl_tpu_torch.obs import events
    events.emit("serve.admit", rid="r3", slot=2, prompt_len=17)
    events.default_recorder().dump("/tmp/flight.jsonl")
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

from edl_tpu_torch.obs import disttrace
from edl_tpu_torch.utils import logging as edl_logging

__all__ = [
    "Event",
    "FlightRecorder",
    "default_recorder",
    "reset_default_recorder",
    "emit",
    "crash_dump",
    "load_jsonl",
    "CORRELATION_KEYS",
]

# the first-class correlation schema: every key a timeline can be
# grouped by (postmortem filters on these, everything else is attrs)
CORRELATION_KEYS = ("rid", "step", "reshard_epoch", "site", "worker")

SEVERITIES = ("info", "warn", "error")


@dataclass
class Event:
    """One recorded decision/incident. ``t_wall`` is epoch seconds
    (human + cross-process ordering), ``t_mono`` is process
    ``perf_counter`` (merges onto the tracer's span timeline)."""

    seq: int
    t_wall: float
    t_mono: float
    kind: str
    severity: str = "info"
    corr: Dict[str, Any] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "t_wall": self.t_wall,
            "t_mono": self.t_mono,
            "kind": self.kind,
            "severity": self.severity,
            "corr": dict(self.corr),
            "attrs": dict(self.attrs),
        }


class FlightRecorder:
    """Thread-safe bounded ring of :class:`Event`.

    Appends are O(1); past ``max_events`` the OLDEST event is evicted
    and counted in ``dropped`` (the events nearest the incident are
    the ones worth keeping). ``counts()`` keeps monotonic per-kind
    totals that SURVIVE ring eviction — accounting never silently
    shrinks with the window.
    """

    def __init__(self, max_events: int = 8192, clock=time.time):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self.clock = clock
        self._lock = threading.Lock()
        self._events: Deque[Event] = deque()
        self._seq = 0
        self.dropped = 0
        self._counts: Dict[str, int] = {}
        self._context: Dict[str, Any] = {}

    # -- recording ----------------------------------------------------------

    def set_context(self, **corr: Any) -> None:
        """Default correlation merged into every subsequent event —
        e.g. a worker process stamps ``worker=<id>`` once at bring-up
        so its whole timeline is fleet-attributable."""
        with self._lock:
            for k, v in corr.items():
                if v is None:
                    self._context.pop(k, None)
                else:
                    self._context[k] = v

    def emit(
        self,
        kind: str,
        severity: str = "info",
        *,
        rid: Optional[str] = None,
        step: Optional[int] = None,
        reshard_epoch: Optional[int] = None,
        site: Optional[str] = None,
        worker: Optional[str] = None,
        **attrs: Any,
    ) -> Event:
        """Record one event. Correlation keys are keyword-only and
        land in ``corr``; everything else is free-form ``attrs``."""
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")
        t_wall = self.clock()
        t_mono = time.perf_counter()
        explicit = {
            "rid": rid, "step": step, "reshard_epoch": reshard_epoch,
            "site": site, "worker": worker,
        }
        # active distributed-trace context (obs/disttrace): events on a
        # traced path carry the enclosing span's trace/span ids, which
        # is how /events?rid= and /trace agree on one correlation key.
        # One contextvar read when no trace is active.
        tctx = disttrace.ctx_corr()
        with self._lock:
            corr = dict(self._context)
            if tctx:
                corr.update(tctx)
            corr.update((k, v) for k, v in explicit.items() if v is not None)
            self._seq += 1
            ev = Event(self._seq, t_wall, t_mono, kind, severity, corr, attrs)
            if len(self._events) >= self.max_events:
                self._events.popleft()
                self.dropped += 1
                dropped_now = True
            else:
                dropped_now = False
            self._events.append(ev)
            self._counts[kind] = self._counts.get(kind, 0) + 1
        _obs_count(kind, dropped_now)
        return ev

    # -- views --------------------------------------------------------------

    def events(
        self,
        kind: Optional[str] = None,
        rid: Optional[str] = None,
        severity: Optional[str] = None,
    ) -> List[Event]:
        with self._lock:
            out = list(self._events)
        return [
            e for e in out
            if (kind is None or e.kind == kind)
            and (rid is None or e.corr.get("rid") == rid)
            and (severity is None or e.severity == severity)
        ]

    def records(
        self,
        kind: Optional[str] = None,
        rid: Optional[str] = None,
        severity: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """The JSON-able dict view — what the exporter's ``/events``
        serves, the fleet push publishes, and postmortem consumes."""
        return [e.to_record() for e in self.events(kind, rid, severity)]

    def counts(self) -> Dict[str, int]:
        """Monotonic per-kind totals (survive ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._counts.clear()

    # -- serialization ------------------------------------------------------

    def _meta_record(self, retained: int) -> Dict[str, Any]:
        # callers (to_jsonl/window_json) snapshot events BEFORE this,
        # so the lock is free to take here
        with self._lock:
            dropped = self.dropped
        return {
            "meta": {
                "dropped": dropped,
                "max_events": self.max_events,
                "retained": retained,
                "pid": os.getpid(),
            }
        }

    def to_jsonl(self, last_n: Optional[int] = None) -> str:
        """JSONL dump: one meta line (ring accounting — a reader must
        see truncation) followed by one line per event, oldest first."""
        evs = self.events()
        if last_n is not None:
            evs = evs[-last_n:]
        lines = [json.dumps(self._meta_record(len(evs)), default=str)]
        lines.extend(
            json.dumps(e.to_record(), default=str, separators=(",", ":"))
            for e in evs
        )
        return "\n".join(lines) + "\n"

    def recent_jsonl(self, last_n: int = 256) -> str:
        """The newest ``last_n`` events as JSONL (dumps/debugging)."""
        return self.to_jsonl(last_n=last_n)

    def window_json(self, last_n: int = 256) -> str:
        """The fleet push window as ONE line — coordinator KV is a
        line protocol (``PUT k v\\n``), so the pushed value must not
        contain newlines. :func:`load_jsonl` accepts this doc form
        alongside plain JSONL."""
        evs = self.events()[-last_n:]
        return json.dumps(
            {
                **self._meta_record(len(evs)),
                "events": [e.to_record() for e in evs],
            },
            default=str,
            separators=(",", ":"),
        )

    def dump(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    # -- Perfetto merge -----------------------------------------------------

    def to_chrome_events(self, tracer=None) -> List[Dict[str, Any]]:
        """Catapult instant events ("i"), aligned to the TRACER's
        timebase so they interleave with its duration spans in
        Perfetto/chrome://tracing."""
        if tracer is None:
            from edl_tpu_torch.utils import tracing

            tracer = tracing.tracer()
        t0 = tracer.t0
        return [
            {
                "name": e.kind,
                "ph": "i",
                "s": "p",  # process-scoped instant marker
                "ts": (e.t_mono - t0) * 1e6,
                "pid": os.getpid(),
                "tid": 0,
                "args": {"severity": e.severity, **e.corr, **e.attrs},
            }
            for e in self.events()
        ]

    def to_chrome_doc(
        self, tracer=None, since_seq: int = 0, last_n=None
    ) -> Dict[str, Any]:
        """The tracer's chrome-trace document with this recorder's
        events merged in as instant events — one Perfetto load shows
        spans AND the decisions between them. Served by the exporter's
        ``/trace``. ``since_seq``/``last_n`` bound the SPAN window
        (tracer-side paging; instant markers are comparatively few and
        ride along whole)."""
        if tracer is None:
            from edl_tpu_torch.utils import tracing

            tracer = tracing.tracer()
        doc = tracer.to_chrome_doc(since_seq=since_seq, last_n=last_n)
        doc["traceEvents"].extend(self.to_chrome_events(tracer))
        with self._lock:
            doc["eventsDropped"] = self.dropped
        return doc


def _obs_count(kind: str, dropped: bool) -> None:
    # resolved per emit so a registry swap in tests takes effect; the
    # get-or-create is one lock + dict hit (obs/metrics.py)
    from edl_tpu_torch.obs import metrics as obs_metrics

    reg = obs_metrics.default_registry()
    reg.counter(
        "edl_events_total", "flight-recorder events by kind", ("kind",)
    ).inc(kind=kind)
    if dropped:
        reg.counter(
            "edl_events_dropped_total",
            "flight-recorder events evicted from the bounded ring",
        ).inc()


# ---------------------------------------------------------------------------
# process-wide default recorder


def _ring_size() -> int:
    try:
        return max(1, int(os.environ.get("EDL_EVENTS_MAX", "8192")))
    except ValueError:
        return 8192


_default = FlightRecorder(max_events=_ring_size())
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder:
    return _default


def reset_default_recorder(max_events: Optional[int] = None) -> FlightRecorder:
    """Swap in a fresh default recorder (tests); returns the new one."""
    global _default
    with _default_lock:
        _default = FlightRecorder(max_events=max_events or _ring_size())
    return _default


def emit(kind: str, severity: str = "info", **kw: Any) -> Event:
    """Record into the process-wide default recorder."""
    return _default.emit(kind, severity, **kw)


# ---------------------------------------------------------------------------
# the black box: crash dumps


_dump_seq = 0


def crash_dump(tag: str, err: Optional[BaseException] = None) -> Optional[str]:
    """Dump the default recorder's ring to ``$EDL_BLACKBOX_DIR`` —
    called by recovery paths (serving ``_recover``, the elastic
    trainer's unhandled-exception path) BEFORE they rebuild state, so
    the file holds the timeline leading up to the incident. No-op
    (returns None) when the env var is unset; NEVER raises — the black
    box must not take the recovering process down with it."""
    global _dump_seq
    d = os.environ.get("EDL_BLACKBOX_DIR", "").strip()
    if not d:
        return None
    try:
        rec = default_recorder()
        if err is not None:
            # kind follows site.verb so the postmortem's chain matcher
            # can group it
            rec.emit(
                "blackbox.crash", severity="error",
                error=f"{type(err).__name__}: {err}", tag=tag,
            )
        with _default_lock:
            _dump_seq += 1
            n = _dump_seq
        path = os.path.join(d, f"blackbox-{tag}-{os.getpid()}-{n}.jsonl")
        return rec.dump(path)
    # edl: no-lint[silent-failure] the black box is best-effort BY CONTRACT: it runs inside recovery paths and must never take them down
    except Exception:  # pragma: no cover - the black box is best-effort
        return None


# ---------------------------------------------------------------------------
# loading dumps back


def load_jsonl(source: str) -> List[Dict[str, Any]]:
    """Parse a flight-recorder JSONL dump (a path or the raw text)
    into event records, skipping meta lines and tolerating truncated
    trailing lines (a crash dump may be cut short). Raises ValueError
    when nothing parseable is found."""
    if "\n" not in source and os.path.exists(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    out: List[Dict[str, Any]] = []
    meta: Optional[Dict[str, Any]] = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail of a crash dump
        if not isinstance(rec, dict):
            continue
        if isinstance(rec.get("events"), list):
            # the single-line window-doc form (window_json)
            meta = rec.get("meta", meta)
            for e in rec["events"]:
                if isinstance(e, dict) and "kind" in e:
                    e.setdefault("corr", {})
                    e.setdefault("attrs", {})
                    out.append(e)
            continue
        if "meta" in rec and "kind" not in rec:
            meta = rec["meta"]
            continue
        if "kind" in rec:
            rec.setdefault("corr", {})
            rec.setdefault("attrs", {})
            out.append(rec)
    if not out and meta is None:
        raise ValueError("no flight-recorder events in input")
    if meta is not None and out:
        # surface ring truncation to the analyzer without a side channel
        out[0].setdefault("attrs", {})
        out[0]["attrs"].setdefault("_ring_dropped", meta.get("dropped", 0))
    return out


# ---------------------------------------------------------------------------
# log bridge: warn/error KV-log lines mirror onto the event timeline
# (the one-line hook lives in utils/logging.py; installing the sink
# here means the bridge is on exactly when a recorder exists)


def _log_event(level: str, logger: str, msg: str, kv: Dict[str, Any]) -> None:
    try:
        corr = {k: kv[k] for k in CORRELATION_KEYS if k in kv}
        attrs = {k: v for k, v in kv.items() if k not in CORRELATION_KEYS}
        _default.emit(
            f"log.{level}",
            severity=level if level in SEVERITIES else "warn",
            logger=logger,
            msg=msg,
            **corr,
            **attrs,
        )
    # edl: no-lint[silent-failure] the log->event sink itself: logging a sink failure would recurse into the sink
    except Exception:  # pragma: no cover - telemetry must never raise
        pass


edl_logging.set_event_sink(_log_event)
