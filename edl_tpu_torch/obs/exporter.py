"""Telemetry HTTP exporter — the port's copy of
``edl_tpu/obs/exporter.py``: a stdlib ``http.server`` endpoint serving

* ``/metrics``  — Prometheus text exposition (format 0.0.4) of a
  :class:`~edl_tpu_torch.obs.metrics.MetricsRegistry` (or of a callable that
  rebuilds one per scrape — the coordinator's fleet aggregation mode);
* ``/trace``    — the process tracer's chrome://tracing JSON (load in
  Perfetto / chrome://tracing) with the flight recorder's events
  merged in as instant markers, and the ring-buffer ``dropped`` count
  in the metadata; ``?since=<seq>`` / ``?n=`` bound the span window
  (the ``/events`` paging mirror — an incremental puller reads
  ``max_seq`` from the metadata event and fetches only the delta on
  the next cadence tick). A ``trace_source`` callable replaces the
  local document entirely — the coordinator serves the offset-
  corrected FLEET merge here (obs/disttrace.py);
* ``/events``   — the flight recorder's event log as JSONL, filterable
  by ``?rid=``, ``?kind=``, ``?severity=`` and bounded by ``?n=``
  (obs/events.py; the coordinator serves the worker-labeled fleet
  union here via its events source);
* ``/history``  — windowed queries over the process's on-disk metric
  history (obs/tsdb.py) when a ``history`` store is attached:
  ``?name=&t0=&t1=&step=`` plus any label matchers; no ``name`` lists
  the recorded series; without a store, 404 "no history store
  attached";
* ``/healthz``  — liveness JSON (status, uptime, pid).

Pull-based on purpose (the Prometheus model): the process never blocks
on a slow consumer, and a scraper outage costs nothing. The server is
a daemon-threaded ``ThreadingHTTPServer`` bound by default to
loopback; ``port=0`` binds an ephemeral port (tests, `--metrics-port
0`). Scrapes read shared registries under their own family locks — a
scrape never takes a lock the step loop holds across a dispatch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Union
from urllib.parse import parse_qs, urlsplit

from edl_tpu_torch.obs.metrics import MetricsRegistry, ensure_core_series
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("obs")

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Own one telemetry endpoint.

    ``source`` is a registry, or a zero-arg callable returning one
    (re-evaluated per scrape; the fleet aggregator rebuilds a merged
    registry from coordinator KV each time). ``tracer`` defaults to
    the process-wide tracer so ``/trace`` always works.
    ``events_source`` is a zero-arg callable returning event RECORDS
    (dicts) for ``/events`` — defaults to the process flight
    recorder; the coordinator passes its fleet-union collector.
    ``trace_source`` is a zero-arg callable returning a chrome-trace
    document for ``/trace`` — defaults to the local tracer+recorder
    merge; the coordinator passes the fleet trace merge.
    ``history`` is a :class:`~edl_tpu_torch.obs.tsdb.TSDB` (or a string
    path to a history directory) served on ``/history``; absent, the
    endpoint 404s and is omitted from ``/healthz``.
    """

    def __init__(
        self,
        source: Union[MetricsRegistry, Callable[[], MetricsRegistry], None] = None,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        tracer=None,
        events_source: Optional[Callable[[], List[dict]]] = None,
        trace_source: Optional[Callable[[], dict]] = None,
        history=None,
    ):
        if isinstance(history, str):
            from edl_tpu_torch.obs.tsdb import TSDB

            history = TSDB(history)
        self.history = history
        if source is None:
            from edl_tpu_torch.obs.metrics import default_registry

            source = default_registry()
        self._collect: Callable[[], MetricsRegistry] = (
            source if callable(source) else (lambda: source)
        )
        if isinstance(source, MetricsRegistry):
            ensure_core_series(source)
        if tracer is None:
            from edl_tpu_torch.utils import tracing

            tracer = tracing.tracer()
        self.tracer = tracer
        if events_source is None:
            from edl_tpu_torch.obs import events as _events

            events_source = lambda: _events.default_recorder().records()  # noqa: E731
        self._events = events_source
        self._trace_source = trace_source
        self._host = host
        self._want_port = port
        self._t0 = time.monotonic()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("exporter not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "MetricsExporter":
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "edl-obs/1"

            def do_GET(self):  # noqa: N802 (http.server API)
                parts = urlsplit(self.path)
                path = parts.path
                try:
                    if path == "/metrics":
                        body = exporter.render_metrics().encode()
                        ctype = CONTENT_TYPE_METRICS
                    elif path == "/trace":
                        body = json.dumps(
                            exporter.render_trace(parse_qs(parts.query))
                        ).encode()
                        ctype = "application/json"
                    elif path == "/events":
                        body = exporter.render_events(
                            parse_qs(parts.query)
                        ).encode()
                        ctype = "application/x-ndjson"
                    elif path == "/history":
                        if exporter.history is None:
                            self.send_error(
                                404, "no history store attached"
                            )
                            return
                        body = exporter.history.render_history(
                            parse_qs(parts.query)
                        ).encode()
                        ctype = "application/json"
                    elif path in ("/", "/healthz"):
                        endpoints = ["/metrics", "/trace", "/events"]
                        if exporter.history is not None:
                            endpoints.append("/history")
                        endpoints.append("/healthz")
                        body = json.dumps(
                            {
                                "status": "ok",
                                "uptime_s": round(
                                    time.monotonic() - exporter._t0, 3
                                ),
                                "pid": os.getpid(),
                                "endpoints": endpoints,
                            }
                        ).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:  # collection failure, not transport
                    body = f"collection failed: {e}\n".encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # silence per-scrape stderr
                pass

        srv = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        srv.daemon_threads = True
        self._server = srv
        self._thread = threading.Thread(
            target=srv.serve_forever, name="edl-metrics-exporter", daemon=True
        )
        self._thread.start()
        log.info("metrics exporter up", url=self.url)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start() if self._server is None else self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- collection ---------------------------------------------------------

    def render_metrics(self) -> str:
        return self._collect().render()

    def render_trace(self, qs: Optional[dict] = None) -> dict:
        """Chrome-trace doc: tracer spans + flight-recorder events
        merged as instant markers (one Perfetto load shows both), or
        the injected ``trace_source`` document (the coordinator's
        offset-corrected fleet merge). ``?since=<seq>``/``?n=`` bound
        the local span window — mirror of ``/events`` paging — so a
        cadence puller doesn't reship the whole ring each tick."""
        if self._trace_source is not None:
            return self._trace_source()
        qs = qs or {}
        first = lambda k: (qs.get(k) or [None])[0]  # noqa: E731
        since = last_n = None
        try:
            if first("since") is not None:
                since = int(first("since"))
            if first("n") is not None:
                last_n = int(first("n"))
        except ValueError:
            pass  # malformed paging params: serve the full window
        from edl_tpu_torch.obs import events as _events

        return _events.default_recorder().to_chrome_doc(
            self.tracer, since_seq=since or 0, last_n=last_n
        )

    def render_events(self, qs: Optional[dict] = None) -> str:
        """JSONL of the events source, filtered by ``rid``/``kind``/
        ``severity`` query params and bounded by ``n`` (newest kept)."""
        qs = qs or {}
        first = lambda k: (qs.get(k) or [None])[0]  # noqa: E731
        rid, kind, sev = first("rid"), first("kind"), first("severity")
        recs = self._events()
        if rid is not None:
            recs = [r for r in recs if (r.get("corr") or {}).get("rid") == rid]
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        if sev is not None:
            recs = [r for r in recs if r.get("severity") == sev]
        n = first("n")
        if n is not None:
            try:
                recs = recs[-max(0, int(n)):]
            except ValueError:
                pass
        return "\n".join(
            json.dumps(r, default=str, separators=(",", ":")) for r in recs
        ) + ("\n" if recs else "")


def start_exporter(
    source=None, *, port: int = 0, host: str = "127.0.0.1", tracer=None,
    events_source=None, trace_source=None, history=None,
) -> MetricsExporter:
    """Convenience: construct + start (``port=0`` = ephemeral)."""
    return MetricsExporter(
        source, port=port, host=host, tracer=tracer,
        events_source=events_source, trace_source=trace_source,
        history=history,
    ).start()


def scrape(url: str, path: str = "/metrics", timeout_s: float = 5.0) -> str:
    """GET one endpoint path and return the body text — the client
    side of the ``top``, ``trace`` and ``postmortem`` verbs. ``url`` may
    be a bare ``host:port``."""
    from urllib.request import urlopen

    if not url.startswith("http"):
        url = f"http://{url}"
    with urlopen(url.rstrip("/") + path, timeout=timeout_s) as r:
        return r.read().decode()
