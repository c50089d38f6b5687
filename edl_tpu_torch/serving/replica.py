"""Replica server — one serving engine behind a small HTTP surface.

Each fleet replica is this server in its own process: the continuous-
batching engine stepped by a background loop thread, fronted by

* ``POST /generate`` — submit one request and STREAM its tokens back
  as JSONL (one line per newly drained batch, a terminal line carrying
  the outcome, close-delimited). Streaming is what makes router
  failover token-identical: the router always holds ``prompt +
  received`` as host truth, so a replica that dies mid-stream costs
  only the tokens of the block in flight — which the replacement
  replica regenerates exactly (greedy decode, identically seeded
  weights).
* ``POST /drain`` — graceful half-close (engine ``half_close()``):
  admission stops, in-flight streams finish, then the residual queued
  requests return in the response body for the supervisor to requeue
  elsewhere. The drain-before-evict and rolling-weight-swap paths both
  ride this.
* ``GET /healthz`` — liveness JSON in the obs exporter's shape plus
  the replica's routing signals (state, queue depth, active slots,
  generation) — the supervisor's prober and the router's queue-depth
  placement both read it.
* ``GET /metrics`` / ``GET /events`` — the process registry and flight
  recorder, same wire format as :mod:`edl_tpu_torch.obs.exporter`, so fleet
  tooling (``edl top``, postmortem event merges) needs no new scrape
  path.

The HTTP layer is stdlib ``ThreadingHTTPServer``; every engine touch
goes through one lock (the engine itself is single-threaded by
design — the loop thread steps it, handler threads only submit and
read snapshots under the lock).

The PyTorch port's copy of ``edl_tpu/serving/replica.py`` over the
port's engine, with one repair. In the reference the engine loop
re-takes its lock at once (the lock is not fair), so a busy engine
starves ``/healthz``, submits, drains and the token streams, and every
stream polls the engine every 2 ms; on the H100, under load, the
supervisor's 3 s health probes timed out and the fleet failed requests.
Here ``/healthz`` reads the engine's counters without the lock, the
loop hands the lock to waiting handlers between two steps, and a stream
waits for the engine's next step instead of polling.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.serving.scheduler import AdmissionError, Request
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("replica")

__all__ = ["ReplicaServer"]


class ReplicaServer:
    """Serve one engine over HTTP. ``start()`` binds the port (0 =
    ephemeral; read it back from :attr:`port`) and launches the engine
    loop thread; ``stop()`` shuts both down."""

    def __init__(
        self,
        engine: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        generation: int = 0,
        poll_s: float = 0.002,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        recorder: Optional[flight.FlightRecorder] = None,
    ):
        self.engine = engine
        self.generation = int(generation)
        self._host = host
        self._want_port = int(port)
        self._poll_s = poll_s
        self._registry = registry or obs_metrics.default_registry()
        self._recorder = recorder or flight.default_recorder()
        self._elock = threading.Lock()
        # handler threads waiting for _elock (the loop yields to them)
        self._waiters = 0
        self._wcond = threading.Condition()
        # engine steps taken; streams wait on it for new tokens
        self._steps = 0
        self._stepped = threading.Condition()
        self._stop_evt = threading.Event()
        self._draining = False
        self._t0 = time.monotonic()
        self._srv: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> int:
        assert self._srv is not None, "not started"
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "ReplicaServer":
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # close-delimited streaming: HTTP/1.0 semantics keep the
            # /generate body framing trivial (EOF = stream over)
            protocol_version = "HTTP/1.0"

            def do_GET(self):  # noqa: N802 (http.server API)
                outer._get(self)

            def do_POST(self):  # noqa: N802 (http.server API)
                outer._post(self)

            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

        srv = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        srv.daemon_threads = True
        self._srv = srv
        t_http = threading.Thread(
            target=srv.serve_forever, name="replica-http", daemon=True
        )
        t_loop = threading.Thread(
            target=self._loop, name="replica-engine", daemon=True
        )
        self._threads = [t_http, t_loop]
        t_http.start()
        t_loop.start()
        log.info("replica serving", url=self.url, pid=os.getpid(),
                 generation=self.generation)
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "ReplicaServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- engine loop --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            with self._elock:
                work = self.engine.has_work
                if work:
                    self.engine.step()
            if not work:
                # idle: park briefly instead of spinning on the lock
                self._stop_evt.wait(self._poll_s)
                continue
            with self._stepped:
                self._steps += 1
                self._stepped.notify_all()
            if self._waiters:
                # handlers queued for the lock during the step: let them
                # in before the next one (bounded, so a stream of them
                # cannot stall the engine)
                with self._wcond:
                    self._wcond.wait_for(lambda: not self._waiters,
                                         timeout=50 * self._poll_s)

    @contextlib.contextmanager
    def _engine_lock(self):
        """The engine lock for handler threads: counted while they wait,
        so the loop hands it over between two steps."""
        with self._wcond:
            self._waiters += 1
        try:
            self._elock.acquire()
        finally:
            with self._wcond:
                self._waiters -= 1
                self._wcond.notify_all()
        try:
            yield
        finally:
            self._elock.release()

    # -- request handling ---------------------------------------------------

    def _get(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0].rstrip("/") or "/"
        if path in ("/", "/healthz"):
            # read without the engine lock: liveness must not wait for
            # a busy engine (each count is one atomic read)
            body = {
                "status": "draining" if self._draining else "ok",
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "pid": os.getpid(),
                "generation": self.generation,
                "queue_depth": self.engine.queue.depth,
                "active_slots": self.engine.active_slots,
                "results": len(self.engine.results),
            }
            self._json(h, 200, body)
        elif path == "/metrics":
            text = self._registry.render()
            self._raw(h, 200, text.encode(), "text/plain; version=0.0.4")
        elif path == "/events":
            text = "\n".join(
                json.dumps(r) for r in self._recorder.records()
            )
            self._raw(h, 200, text.encode(), "application/jsonl")
        else:
            self._json(h, 404, {"error": f"unknown path {path}"})

    def _post(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?", 1)[0].rstrip("/")
        try:
            n = int(h.headers.get("Content-Length", 0))
            doc = json.loads(h.rfile.read(n).decode()) if n else {}
        except (ValueError, OSError) as e:
            self._json(h, 400, {"error": f"bad body: {e}",
                                "reason": "bad_request"})
            return
        if path == "/generate":
            self._generate(h, doc)
        elif path == "/drain":
            self._drain(h)
        else:
            self._json(h, 404, {"error": f"unknown path {path}"})

    def _generate(self, h: BaseHTTPRequestHandler, doc: Dict) -> None:
        rid = str(doc.get("rid", ""))
        try:
            prompt = [int(t) for t in doc["prompt"]]
            max_new = int(doc.get("max_new", 16))
        except (KeyError, TypeError, ValueError) as e:
            self._json(h, 400, {"error": f"bad request: {e}",
                                "reason": "bad_request"})
            return
        with self._engine_lock():
            if self._draining:
                self._json(h, 503, {"error": "replica draining",
                                    "reason": "draining"})
                return
            try:
                self.engine.submit(
                    rid, prompt, max_new,
                    eos_id=doc.get("eos_id"),
                    deadline_s=doc.get("deadline_s"),
                    tenant=doc.get("tenant"),
                    slo_class=doc.get("slo_class"),
                )
            except AdmissionError as e:
                self._json(h, 409 if e.reason == "bad_request" else 429,
                           {"error": str(e), "reason": e.reason})
                return
        # stream: headers first, then one JSONL line per newly drained
        # batch; the terminal line carries the outcome. No
        # Content-Length — HTTP/1.0 close-delimited.
        h.send_response(200)
        h.send_header("Content-Type", "application/jsonl")
        h.end_headers()
        sent = 0
        try:
            while True:
                with self._stepped:
                    seen = self._steps
                with self._engine_lock():
                    res = self.engine.results.get(rid)
                    if res is not None:
                        toks = list(res.tokens)
                        outcome: Optional[str] = res.outcome
                    else:
                        toks = self._slot_tokens_locked(rid)
                        outcome = None
                new = toks[sent:]
                if new:
                    h.wfile.write(
                        (json.dumps({"tokens": new}) + "\n").encode()
                    )
                    h.wfile.flush()
                    sent = len(toks)
                if outcome is not None:
                    h.wfile.write(
                        (json.dumps({"outcome": outcome,
                                     "tokens_total": sent}) + "\n").encode()
                    )
                    h.wfile.flush()
                    return
                # the next engine step (or a drain's requeue, which
                # the timeout covers) brings the next tokens
                with self._stepped:
                    self._stepped.wait_for(lambda: self._steps != seen,
                                           timeout=50 * self._poll_s)
        except (BrokenPipeError, ConnectionError, OSError) as e:
            # the ROUTER went away (its own failover or restart); the
            # engine still finishes the request — nothing to unwind
            log.warn("generate stream client lost", rid=rid, err=str(e))

    def _slot_tokens_locked(self, rid: str) -> List[int]:
        for sl in self.engine._slots:
            if sl is not None and sl.rid == rid:
                return list(sl.generated)
        return []

    def _drain(self, h: BaseHTTPRequestHandler) -> None:
        with self._engine_lock():
            self._draining = True
            self.engine.half_close()
        # the loop thread keeps stepping; wait for in-flight slots to
        # reach their terminal outcome, then hand back the residuals
        while True:
            with self._engine_lock():
                idle = (
                    self.engine.active_slots == 0
                    and not self.engine._inflight
                )
            if idle:
                break
            time.sleep(self._poll_s)
        with self._engine_lock():
            served = len(self.engine.results)
            residual = self.engine.take_residual()
            # a residual request usually still has its router's
            # /generate stream attached (queued, zero tokens sent):
            # post a synthetic "requeued" terminal so that stream ends
            # cleanly and the ROUTER re-routes the request whole —
            # resubmitting it here too would run it twice
            for r in residual:
                self.engine.results[r.rid] = _Requeued(r.rid)
        self._json(h, 200, {
            "residual": [_req_doc(r) for r in residual],
            "served": served,
        })

    # -- response helpers ---------------------------------------------------

    def _raw(
        self, h: BaseHTTPRequestHandler, code: int, body: bytes, ctype: str
    ) -> None:
        try:
            h.send_response(code)
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except (BrokenPipeError, ConnectionError) as e:
            log.warn("client went away mid-response", err=str(e))

    def _json(self, h: BaseHTTPRequestHandler, code: int, doc: Dict) -> None:
        self._raw(h, code, json.dumps(doc).encode(), "application/json")


class _Requeued:
    """Synthetic terminal result for a drain-displaced request (shape-
    compatible with the engine's RequestResult where the stream loop
    reads it, without importing the torch-bearing engine module)."""

    __slots__ = ("rid", "tokens", "outcome")

    def __init__(self, rid: str):
        self.rid = rid
        self.tokens: List[int] = []
        self.outcome = "requeued"


def _req_doc(r: Request) -> Dict[str, Any]:
    """Residual request as wire JSON (everything the router needs to
    resubmit it elsewhere, deadline converted back to a relative
    budget)."""
    doc: Dict[str, Any] = {
        "rid": r.rid, "prompt": list(r.prompt), "max_new": r.max_new,
    }
    if r.eos_id is not None:
        doc["eos_id"] = r.eos_id
    if r.deadline_s is not None:
        doc["deadline_s"] = r.deadline_s
    if r.tenant is not None:
        doc["tenant"] = r.tenant
    if r.slo_class is not None:
        doc["slo_class"] = r.slo_class
    return doc
