"""Tracing — span recording and a torch.profiler helper: the port's
copy of ``edl_tpu/utils/tracing.py``.

The elastic runtime and the serving engine emit timed spans (engine
dispatch / drain / prefill / recover, checkpoint I/O) into a
process-wide tracer that can be dumped as chrome://tracing / Perfetto
JSON. :func:`torch_profile` additionally wraps a block in
``torch.profiler`` and writes its chrome trace (device kernels included
on a card).

Usage:
    from edl_tpu_torch.utils import tracing
    with tracing.span("reshard", job="ctr", to=8):
        ...
    tracing.dump("/tmp/trace.json")
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("tracing")


@dataclass
class Span:
    name: str
    start_s: float  # perf_counter-based, process-relative
    dur_s: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    thread: int = 0
    seq: int = 0  # per-tracer monotonic id (survives ring eviction)


# distributed-trace context hooks (installed by edl_tpu_torch.obs.disttrace
# at import): ``enter()`` runs at span open and returns (state, attrs)
# — the attrs carry the span's trace/span/parent ids when a trace is
# active — and ``exit(state)`` restores the enclosing context. Kept as
# injected callables so this low-level module stays free of obs
# imports and the hook costs one None-check when tracing alone.
_ctx_enter = None
_ctx_exit = None


def set_span_context_hooks(enter, exit) -> None:
    global _ctx_enter, _ctx_exit
    _ctx_enter, _ctx_exit = enter, exit


class Tracer:
    """Thread-safe in-memory span recorder.

    The buffer is a bounded RING: past ``max_spans`` the OLDEST span
    is evicted and ``dropped`` counts evictions — an always-on tracer
    must keep the spans closest to the incident, and the old
    drop-newest policy silently threw away exactly those (a reshard
    storm after a long soak recorded nothing). The eviction count
    surfaces in :meth:`summary` (the ``_tracer`` entry) and in the
    chrome-trace metadata, so a truncated trace is never mistaken for
    a complete one. ``add_listener`` subscribes observers (the obs
    bridge turns spans into scrapeable histograms) — listeners run
    outside the lock and must be cheap/non-throwing."""

    def __init__(self, max_spans: int = 100_000):
        self._lock = threading.Lock()
        self._spans: Deque[Span] = deque(maxlen=max_spans)
        # adjacent reads: t0_wall anchors start_s (perf_counter-
        # relative) on the wall clock, which is what lets span windows
        # from different processes merge onto one axis (obs/disttrace)
        self._t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.t0 = self._t0  # public timebase (flight-recorder merge)
        self._seq = 0  # monotonic span id; never reset (paging cursor)
        self.max_spans = max_spans
        self.enabled = True
        self.dropped = 0  # spans evicted after the ring filled
        self._listeners: List[Callable[[Span], None]] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        state = ctx_attrs = None
        if _ctx_enter is not None:
            # the span body runs inside its OWN child trace context:
            # nested spans parent here, and flight events emitted
            # within carry these ids (how /trace and /events agree)
            state, ctx_attrs = _ctx_enter()
        start = time.perf_counter()
        try:
            yield
        finally:
            if _ctx_exit is not None:
                _ctx_exit(state)
            if ctx_attrs:
                attrs = {**attrs, **ctx_attrs}
            self.record(name, start, time.perf_counter() - start, attrs)

    def record(self, name: str, start_s: float, dur_s: float,
               attrs: Optional[Dict[str, Any]] = None) -> None:
        """``start_s`` is absolute time.perf_counter(); stored relative to
        tracer start so chrome-trace timestamps line up across threads."""
        if not self.enabled:
            return
        span = Span(name, start_s - self._t0, dur_s, dict(attrs or {}),
                    threading.get_ident())
        with self._lock:
            self._seq += 1
            span.seq = self._seq
            if len(self._spans) >= self.max_spans:
                # ring semantics: evict the OLDEST, keep the new span
                if self.dropped == 0:
                    log.warn(
                        "span ring full; evicting oldest spans",
                        max_spans=self.max_spans,
                    )
                self.dropped += 1
            self._spans.append(span)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(span)
            except Exception as e:  # telemetry must never take us down
                log.warn("span listener failed", error=str(e))

    def add_listener(self, fn: Callable[[Span], None]) -> None:
        """Subscribe ``fn(span)`` to every recorded span (called
        outside the tracer lock, after the span is stored)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        return [s for s in out if name is None or s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name {count, total_s, max_s} rollup, plus a
        ``_tracer`` meta entry carrying the ring-buffer accounting
        (retained span count + evictions) so a truncated window is
        visible to every summary consumer."""
        spans, dropped = self._snapshot()
        out: Dict[str, Dict[str, float]] = {}
        for s in spans:
            agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.dur_s
            agg["max_s"] = max(agg["max_s"], s.dur_s)
        out["_tracer"] = {"spans": len(spans), "dropped": dropped}
        return out

    def to_chrome_trace(self) -> List[Dict[str, Any]]:
        """Catapult "X" (complete) events, microsecond units — loadable in
        chrome://tracing and Perfetto."""
        return [
            {
                "name": s.name,
                "ph": "X",
                "ts": s.start_s * 1e6,
                "dur": s.dur_s * 1e6,
                "pid": os.getpid(),
                "tid": s.thread % 2**31,
                "args": s.attrs,
            }
            for s in self.spans()
        ]

    def _snapshot(self):
        """(spans, dropped) under one lock acquire: readers must see a
        consistent pair (an unguarded ``self.dropped`` read races the
        writer)."""
        with self._lock:
            return list(self._spans), self.dropped

    def to_chrome_doc(
        self, since_seq: int = 0, last_n: Optional[int] = None
    ) -> Dict[str, Any]:
        """Full chrome-trace JSON document: the events plus a metadata
        ("M") event and top-level ``dropped``, so a viewer AND a raw
        reader both see ring-buffer truncation. Served by the obs
        exporter's ``/trace`` and written by :meth:`dump`.

        ``since_seq``/``last_n`` bound the window (the ``/events``
        paging mirror): only spans with ``seq > since_seq`` ship,
        newest ``last_n`` kept. The metadata event carries ``max_seq``
        so an incremental puller knows its next cursor — a fleet
        cadence tick fetches the delta, not the whole ring."""
        spans, dropped = self._snapshot()
        if since_seq:
            spans = [s for s in spans if s.seq > since_seq]
        if last_n is not None:
            spans = spans[-max(int(last_n), 0):]
        events = [
            {
                "name": s.name,
                "ph": "X",
                "ts": s.start_s * 1e6,
                "dur": s.dur_s * 1e6,
                "pid": os.getpid(),
                "tid": s.thread % 2**31,
                "seq": s.seq,
                "args": s.attrs,
            }
            for s in spans
        ]
        events.append(
            {
                "name": "edl_tracer",
                "ph": "M",
                "pid": os.getpid(),
                "tid": 0,
                "args": {
                    "dropped": dropped,
                    "max_spans": self.max_spans,
                    "spans": len(events),
                    "max_seq": max((s.seq for s in spans), default=since_seq),
                },
            }
        )
        return {"traceEvents": events, "dropped": dropped}

    def dump(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        doc = self.to_chrome_doc()
        with open(path, "w") as f:
            json.dump(doc, f)
        log.info(
            "trace written",
            path=path,
            spans=max(len(doc["traceEvents"]) - 1, 0),
            dropped=doc["dropped"],
        )


_global = Tracer()


def tracer() -> Tracer:
    return _global


def span(name: str, **attrs: Any):
    return _global.span(name, **attrs)


def dump(path: str) -> None:
    _global.dump(path)


def summary() -> Dict[str, Dict[str, float]]:
    return _global.summary()


@contextlib.contextmanager
def torch_profile(path: str, cuda: Optional[bool] = None) -> Iterator[Any]:
    """``torch.profiler`` over the block; its chrome trace is written to
    ``path`` when the block ends. ``cuda`` adds the device activity
    (default: when a card is present). Yields the profiler, so the
    caller can also read ``key_averages()``. torch always ships its
    profiler, so a failure to start or export raises."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() if cuda is None else cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    log.info("torch profile written", path=path)
