"""Fault-tolerant serving router — the fleet's front door.

One engine replica dying mid-request used to be a full outage; this
module makes it a failover. The router fronts N replica processes
(spawned and health-checked by :mod:`edl_tpu_torch.serving.fleet`), admits
requests, and routes each one with **session affinity** (a sticky
session id keeps hitting the replica that holds its KV reuse),
**prefix affinity** (rendezvous hashing over the prompt's head blocks,
so shared system prompts land where their prefix-cache blocks already
live), and **least-queue-depth** placement as the load tiebreak.

Failover is the engine's crash-recovery argument lifted one level up:
the host truth for a request is ``prompt + generated`` (the router
accumulates every streamed token), replicas are seeded identically and
decode greedily, so resubmitting ``prompt + received`` with the
remaining budget to any healthy replica reproduces exactly the tokens
the dead replica would have produced — failover output is
token-identical to the fault-free run. Failovers are bounded per
request (``max_failovers``), retries take jittered exponential backoff
that never sleeps a request past its deadline (when the backoff would
eat a meaningful slice of the remaining budget the retry is hedged —
dispatched immediately), and a failed replica is excluded from the
request's candidate set so the same rid is never resubmitted to an
engine that may already hold it (the zero-duplicate invariant: one
terminal result per rid, fleet-wide).

torch-free on purpose, like the scheduler: the routing/table layer is
pure stdlib so tests (and ``edl schedcheck``'s interleaving explorer)
drive it without a device in sight. The shared :class:`ReplicaTable`
is the fleet's single source of truth — health prober, router threads,
and the scale-down evictor all mutate it under ``_lock`` (the
``*_locked`` helpers assume the caller holds it; the schedcheck
harness ``router-table`` proves the discipline and its mutation
rediscovers the race when the lock is dropped).

The PyTorch port's copy of ``edl_tpu/serving/router.py``, with one
repair: a replica's "draining" admission refusal (it began draining
between the route and the forward, so it never admitted the request)
re-routes the request whole, as a drain-displaced one; the reference
ends it ``rejected:draining``, which fails a rolling swap under
traffic.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional

from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.serving.scheduler import Request
from edl_tpu_torch.utils import faults
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("router")

__all__ = [
    "STARTING", "READY", "SUSPECT", "DRAINING", "DEAD",
    "Replica", "ReplicaRef", "ReplicaTable",
    "RouteResult", "RouteRejected", "Router", "HttpTransport",
    "http_json",
]

# replica health states (the prober/evictor state machine):
#   STARTING -> READY -> (SUSPECT <-> READY) -> DEAD      (crash path)
#   READY -> DRAINING -> DEAD                             (evict path)
# Only READY replicas take new routes; SUSPECT keeps its in-flight
# streams (they may still finish) but admits nothing new.
STARTING = "starting"
READY = "ready"
SUSPECT = "suspect"
DRAINING = "draining"
DEAD = "dead"

_ROUTABLE = (READY,)


@dataclass
class Replica:
    """Mutable table entry for one replica. ``generation`` bumps on a
    rolling weight swap so observers can tell old weights from new."""

    id: str
    url: str
    state: str = STARTING
    generation: int = 0
    queue_depth: int = 0
    inflight: int = 0
    fails: int = 0  # consecutive health-probe failures


@dataclass(frozen=True)
class ReplicaRef:
    """Immutable routing handle handed out by :meth:`ReplicaTable.acquire`
    — safe to use outside the table lock."""

    id: str
    url: str
    generation: int = 0


class RouteRejected(Exception):
    """A replica refused the request at admission (terminal — the
    request is invalid or over budget everywhere, not a transport
    failure, so the router must NOT fail it over)."""

    def __init__(self, reason: str, msg: str = ""):
        super().__init__(msg or reason)
        self.reason = reason


class ReplicaTable:
    """Lock-guarded shared replica registry + health state machine.

    Everything the fleet knows about its replicas lives here: the
    health prober writes probe verdicts, router threads acquire/release
    routing slots, the supervisor adds/drains/evicts entries. Public
    methods take ``_lock``; ``*_locked`` helpers assume the caller
    holds it. Per-replica gauges (``edl_fleet_replica_up`` /
    ``_queue_depth`` / ``_inflight``) publish every transition so
    ``edl top``'s FLEET strip sees the fleet live."""

    def __init__(
        self,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        suspect_after: int = 1,
        dead_after: int = 3,
        affinity_slack: int = 2,
    ):
        if dead_after < suspect_after:
            raise ValueError(
                f"dead_after {dead_after} < suspect_after {suspect_after}"
            )
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._sessions: Dict[str, str] = {}
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        # prefix-affine choice wins only while its load is within this
        # many requests of the least-loaded replica — affinity must
        # never turn into a hotspot
        self.affinity_slack = affinity_slack
        reg = registry or obs_metrics.default_registry()
        self._g_up = reg.gauge(
            "edl_fleet_replica_up",
            "1 while the replica is READY to take new routes",
            ("replica",),
        )
        self._g_depth = reg.gauge(
            "edl_fleet_replica_queue_depth",
            "queued requests on the replica engine (last health probe)",
            ("replica",),
        )
        self._g_inflight = reg.gauge(
            "edl_fleet_replica_inflight",
            "requests the router currently has streaming on the replica",
            ("replica",),
        )

    # -- membership ---------------------------------------------------------

    def add(self, id: str, url: str, generation: int = 0) -> None:
        with self._lock:
            if id in self._replicas:
                raise ValueError(f"replica {id!r} already registered")
            self._replicas[id] = Replica(
                id=id, url=url, generation=generation
            )
            self._publish_locked(self._replicas[id])

    def remove(self, id: str) -> None:
        with self._lock:
            rep = self._replicas.pop(id, None)
            if rep is not None:
                rep.state = DEAD
                self._publish_locked(rep)
            self._sessions = {
                s: r for s, r in self._sessions.items() if r != id
            }

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def get(self, id: str) -> Optional[Replica]:
        """Snapshot copy of one entry (detached from the table)."""
        with self._lock:
            rep = self._replicas.get(id)
            if rep is None:
                return None
            return Replica(**vars(rep))

    def snapshot(self) -> List[Replica]:
        with self._lock:
            return [Replica(**vars(r)) for r in self._replicas.values()]

    def ready_count(self) -> int:
        with self._lock:
            return sum(
                1 for r in self._replicas.values() if r.state == READY
            )

    # -- state machine ------------------------------------------------------

    def set_state(self, id: str, state: str) -> Optional[str]:
        """Force a state (supervisor transitions: DRAINING, DEAD).
        Returns the previous state, or None when unknown."""
        with self._lock:
            rep = self._replicas.get(id)
            if rep is None:
                return None
            prev, rep.state = rep.state, state
            if state == READY:
                rep.fails = 0
            self._publish_locked(rep)
            return prev

    def mark_probe(
        self, id: str, ok: bool, queue_depth: Optional[int] = None
    ) -> Optional[str]:
        """Fold one health-probe verdict into the state machine and
        return the resulting state. Consecutive failures walk READY →
        SUSPECT (at ``suspect_after``) → DEAD (at ``dead_after``); one
        good probe resets the streak and resurrects SUSPECT/STARTING.
        DRAINING and DEAD are sticky — probes never resurrect a replica
        the supervisor is evicting or has declared gone."""
        with self._lock:
            rep = self._replicas.get(id)
            if rep is None:
                return None
            if rep.state in (DRAINING, DEAD):
                return rep.state
            if ok:
                rep.fails = 0
                rep.state = READY
                if queue_depth is not None:
                    rep.queue_depth = int(queue_depth)
            else:
                rep.fails += 1
                if rep.fails >= self.dead_after:
                    rep.state = DEAD
                elif rep.fails >= self.suspect_after:
                    rep.state = SUSPECT
            self._publish_locked(rep)
            return rep.state

    def _publish_locked(self, rep: Replica) -> None:
        self._g_up.set(1.0 if rep.state == READY else 0.0, replica=rep.id)
        self._g_depth.set(float(rep.queue_depth), replica=rep.id)
        self._g_inflight.set(float(rep.inflight), replica=rep.id)

    # -- routing ------------------------------------------------------------

    def acquire(
        self,
        *,
        session: Optional[str] = None,
        prefix_key: Optional[str] = None,
        exclude: Iterable[str] = (),
    ) -> Optional[ReplicaRef]:
        """Pick a READY replica and count the route against it, in one
        atomic step. Preference order: the session's pinned replica →
        the prefix-affine choice (rendezvous hash, while within
        ``affinity_slack`` of the least load) → least queue depth +
        inflight. Returns None when no READY replica remains outside
        ``exclude``. Pair with :meth:`release`."""
        ex = frozenset(exclude)
        with self._lock:
            rep = self._pick_locked(session, prefix_key, ex)
            if rep is None:
                return None
            rep.inflight += 1
            if session is not None:
                self._sessions[session] = rep.id
            self._publish_locked(rep)
            return ReplicaRef(
                id=rep.id, url=rep.url, generation=rep.generation
            )

    def unpin(self, session: str, replica_id: str) -> None:
        """Drop a session→replica pin if it still points at
        ``replica_id`` (failover: the sticky replica is gone)."""
        with self._lock:
            if self._sessions.get(session) == replica_id:
                del self._sessions[session]

    def release(self, id: str) -> None:
        """Return the routing slot taken by :meth:`acquire` (call on
        every forward outcome, success or failure)."""
        with self._lock:
            rep = self._replicas.get(id)
            if rep is None:
                return
            rep.inflight = max(0, rep.inflight - 1)
            self._publish_locked(rep)

    def _pick_locked(
        self,
        session: Optional[str],
        prefix_key: Optional[str],
        exclude: FrozenSet[str],
    ) -> Optional[Replica]:
        ready = [
            r for r in self._replicas.values()
            if r.state in _ROUTABLE and r.id not in exclude
        ]
        if not ready:
            return None
        if session is not None:
            pinned = self._sessions.get(session)
            if pinned is not None:
                for r in ready:
                    if r.id == pinned:
                        return r
        ready.sort(key=lambda r: (r.queue_depth + r.inflight, r.id))
        least = ready[0]
        if prefix_key is not None and len(ready) > 1:
            affine = max(
                ready, key=lambda r: _rendezvous_score(prefix_key, r.id)
            )
            floor = least.queue_depth + least.inflight
            if affine.queue_depth + affine.inflight <= (
                floor + self.affinity_slack
            ):
                return affine
        return least


def _rendezvous_score(key: str, replica_id: str) -> int:
    """Deterministic rendezvous (highest-random-weight) score: the
    prefix→replica mapping survives membership changes with minimal
    reshuffling, so a scale event doesn't cold-start every prefix."""
    h = hashlib.md5(f"{key}|{replica_id}".encode()).digest()
    return int.from_bytes(h[:8], "big")


# ---------------------------------------------------------------------------
# the router


@dataclass
class RouteResult:
    """Terminal per-request outcome as the ROUTER saw it. ``tokens``
    is the full accumulated stream (across failovers); ``outcome``
    mirrors the engine's done|eos|timeout|failed plus the transport's
    own failure modes."""

    rid: str
    tokens: List[int]
    outcome: str
    replica: Optional[str] = None
    failovers: int = 0


# transport contract: forward `payload` to `ref`, invoke `on_tokens`
# for every streamed token batch, return the terminal outcome string.
# Raises ConnectionError when the replica died / the stream broke
# (retryable → failover) and RouteRejected on replica-side admission
# refusal (terminal).
Transport = Callable[[ReplicaRef, dict, Callable[[List[int]], None]], str]


class Router:
    """Admits requests and drives each to exactly one terminal result
    across the fleet, failing over when a replica dies mid-flight.

    ``transport`` is injectable (tests drive the failover logic with
    scripted fakes); the default is :class:`HttpTransport` against the
    replica server's streaming ``POST /generate``."""

    def __init__(
        self,
        table: ReplicaTable,
        transport: Optional[Transport] = None,
        *,
        max_failovers: int = 2,
        max_requeues: int = 8,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        hedge_frac: float = 0.2,
        affinity_prefix: int = 16,
        pick_wait_s: float = 5.0,
        seed: int = 0,
        clock=time.monotonic,
        sleep=time.sleep,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        if max_failovers < 0:
            raise ValueError(f"max_failovers must be >= 0, got {max_failovers}")
        self.table = table
        self.transport: Transport = transport or HttpTransport()
        self.max_failovers = max_failovers
        # "requeued" terminals (drain displacement) re-route without
        # burning failover budget — the request never started; this
        # bounds pathological drain storms, not ordinary failures
        self.max_requeues = max_requeues
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # hedged retry: when the jittered backoff would consume more
        # than this fraction of the request's remaining deadline, skip
        # the sleep and dispatch the retry immediately
        self.hedge_frac = hedge_frac
        self.affinity_prefix = affinity_prefix
        # how long a request may wait for SOME replica to become READY
        # (e.g. mid rolling swap) before the router gives up on it
        self.pick_wait_s = pick_wait_s
        self.clock = clock
        self.sleep = sleep
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._inflight_rids: set = set()
        self._if_lock = threading.Lock()
        reg = registry or obs_metrics.default_registry()
        self._c_requests = reg.counter(
            "edl_fleet_requests_total",
            "terminal router outcomes", ("outcome",),
        )
        self._c_failovers = reg.counter(
            "edl_fleet_failovers_total",
            "mid-flight replica handovers (bounded per request)",
        )
        self._c_forwards = reg.counter(
            "edl_fleet_forwards_total",
            "request forwards by replica", ("replica",),
        )
        self._c_requeues = reg.counter(
            "edl_fleet_requeues_total",
            "drain-displaced requests re-routed whole",
        )

    # -- public -------------------------------------------------------------

    def generate(
        self, req: Request, session: Optional[str] = None
    ) -> RouteResult:
        """Route one request to a terminal result. Blocking; safe to
        call from many threads at once (the fleet CLI and the chaos
        harness drive it from a thread pool)."""
        with self._if_lock:
            self._inflight_rids.add(req.rid)
        try:
            return self._route(req, session)
        finally:
            with self._if_lock:
                self._inflight_rids.discard(req.rid)

    def owns(self, rid: str) -> bool:
        """True while a ``generate`` call for ``rid`` is active. The
        router's own failover/requeue loop owns the rerun of every
        request it is still attached to — drain-residual resubmission
        (ServingFleet) must skip those rids or the request would run
        twice (the zero-duplicate invariant)."""
        with self._if_lock:
            return rid in self._inflight_rids

    def _route(
        self, req: Request, session: Optional[str]
    ) -> RouteResult:
        got: List[int] = []
        failed_on: List[str] = []
        attempt = 0
        requeues = 0
        deadline = req.deadline_at() if req.submit_s else (
            self.clock() + req.deadline_s if req.deadline_s else None
        )
        prefix_key = ",".join(
            str(t) for t in req.prompt[: self.affinity_prefix]
        )
        while True:
            ref = self._acquire_with_wait(
                session, prefix_key, failed_on, deadline
            )
            if ref is None:
                outcome = "timeout" if self._past(deadline) else "failed"
                log.warn(
                    "no routable replica", rid=req.rid, outcome=outcome,
                    excluded=len(failed_on),
                )
                return self._finish(req.rid, got, outcome, None, attempt)
            try:
                # chaos site: the forward path — an armed drop here is
                # "the wire to the replica broke", exercising the same
                # failover the SIGKILL lane exercises from outside
                faults.fault_point("router.forward")
                payload = {
                    "rid": req.rid,
                    "prompt": list(req.prompt) + got,
                    "max_new": req.max_new - len(got),
                    "eos_id": req.eos_id,
                    "deadline_s": (
                        max(deadline - self.clock(), 1e-3)
                        if deadline is not None else None
                    ),
                    "tenant": req.tenant,
                    "slo_class": req.slo_class,
                }
                self._c_forwards.inc(replica=ref.id)
                try:
                    outcome = self.transport(ref, payload, got.extend)
                except RouteRejected as e:
                    if e.reason != "draining":
                        raise
                    # the replica began draining between the acquire and
                    # this forward and never admitted the request: it is
                    # displaced, not bad — re-route it whole (the
                    # reference returns "rejected:draining" here)
                    outcome = "requeued"
                if outcome == "requeued":
                    # the replica half-closed with this request still
                    # queued: its stream ended before a single token,
                    # so re-route it whole (no failover budget burned —
                    # nothing failed, the replica is draining)
                    requeues += 1
                    failed_on.append(ref.id)
                    self._c_requeues.inc()
                    flight.emit(
                        "router.requeue", rid=req.rid, worker=ref.id,
                        requeues=requeues,
                    )
                    if requeues > self.max_requeues:
                        log.error("requeue budget exhausted",
                                  rid=req.rid, requeues=requeues)
                        return self._finish(
                            req.rid, got, "failed", ref.id, attempt
                        )
                    continue
                return self._finish(req.rid, got, outcome, ref.id, attempt)
            except RouteRejected as e:
                # replica-side admission refusal is terminal by
                # contract — the request is bad everywhere, not lost
                log.warn("rejected", rid=req.rid, reason=e.reason,
                         replica=ref.id)
                return self._finish(
                    req.rid, got, f"rejected:{e.reason}", ref.id, attempt
                )
            except (ConnectionError, OSError) as e:
                attempt += 1
                failed_on.append(ref.id)
                self.table.mark_probe(ref.id, ok=False)
                self._c_failovers.inc()
                flight.emit(
                    "replica.failover", severity="warn", rid=req.rid,
                    site="router.forward", worker=ref.id,
                    got=len(got), attempt=attempt, err=type(e).__name__,
                )
                # the postmortem chain anchor: fault → THIS recovery →
                # the surviving replica's re-prefill → finish
                flight.emit(
                    "router.recover", severity="warn", rid=req.rid,
                    site="router.forward", rids=[req.rid],
                    from_replica=ref.id, attempt=attempt,
                )
                if session is not None:
                    self.table.unpin(session, ref.id)
                if attempt > self.max_failovers:
                    log.error(
                        "failover budget exhausted", rid=req.rid,
                        attempts=attempt, err=str(e),
                    )
                    return self._finish(
                        req.rid, got, "failed", ref.id, attempt
                    )
                wait = self._backoff_s(attempt, deadline)
                if wait is None:
                    return self._finish(
                        req.rid, got, "timeout", ref.id, attempt
                    )
                if wait > 0:
                    self.sleep(wait)
            finally:
                self.table.release(ref.id)

    # -- internals ----------------------------------------------------------

    def _past(self, deadline: Optional[float]) -> bool:
        return deadline is not None and self.clock() > deadline

    def _acquire_with_wait(
        self,
        session: Optional[str],
        prefix_key: str,
        exclude: List[str],
        deadline: Optional[float],
    ) -> Optional[ReplicaRef]:
        t0 = self.clock()
        while True:
            ref = self.table.acquire(
                session=session, prefix_key=prefix_key, exclude=exclude
            )
            if ref is not None:
                return ref
            if exclude:
                # every excluded replica failed this request already;
                # widening back to them risks a duplicate rid on an
                # engine that may still hold it — give up instead
                return None
            now = self.clock()
            if now - t0 >= self.pick_wait_s or self._past(deadline):
                return None
            self.sleep(min(0.02, self.pick_wait_s / 10))

    def _backoff_s(
        self, attempt: int, deadline: Optional[float]
    ) -> Optional[float]:
        """Jittered exponential backoff bounded by the deadline: None
        means the deadline already passed (stop retrying), 0.0 means
        hedge — retry immediately because sleeping would burn too much
        of the remaining budget."""
        with self._rng_lock:
            jitter = 0.5 + self._rng.random()
        wait = min(
            self.backoff_base_s * (2 ** (attempt - 1)), self.backoff_cap_s
        ) * jitter
        if deadline is None:
            return wait
        remaining = deadline - self.clock()
        if remaining <= 0:
            return None
        if wait > self.hedge_frac * remaining:
            return 0.0
        return wait

    def _finish(
        self,
        rid: str,
        tokens: List[int],
        outcome: str,
        replica: Optional[str],
        failovers: int,
    ) -> RouteResult:
        self._c_requests.inc(outcome=outcome.split(":", 1)[0])
        return RouteResult(
            rid=rid, tokens=list(tokens), outcome=outcome,
            replica=replica, failovers=failovers,
        )


# ---------------------------------------------------------------------------
# HTTP transport (the real wire; tests inject fakes instead)


def http_json(
    url: str, path: str, timeout_s: float = 5.0, body: Optional[dict] = None
) -> dict:
    """One JSON request against a replica endpoint (GET, or POST when
    ``body`` is given). Raises ConnectionError on transport failure."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url.rstrip("/") + path, data=data,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise ConnectionError(f"{url}{path}: {e}") from e


class HttpTransport:
    """Streaming client for the replica server's ``POST /generate``:
    one JSONL line per drained token batch, a terminal line carrying
    the outcome, close-delimited. A connection that dies before the
    terminal line raises ConnectionError — the router's failover
    trigger."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s

    def __call__(
        self,
        ref: ReplicaRef,
        payload: dict,
        on_tokens: Callable[[List[int]], None],
    ) -> str:
        import http.client
        from urllib.parse import urlparse

        u = urlparse(ref.url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port, timeout=self.timeout_s
        )
        try:
            try:
                conn.request(
                    "POST", "/generate", body=json.dumps(payload),
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                raise ConnectionError(f"{ref.url}/generate: {e}") from e
            if resp.status != 200:
                doc = _best_effort_json(resp)
                raise RouteRejected(
                    doc.get("reason", f"http_{resp.status}"),
                    doc.get("error", f"replica returned {resp.status}"),
                )
            outcome: Optional[str] = None
            while True:
                try:
                    line = resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    raise ConnectionError(
                        f"{ref.url}/generate stream broke: {e}"
                    ) from e
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                if doc.get("tokens"):
                    on_tokens([int(t) for t in doc["tokens"]])
                if "outcome" in doc:
                    outcome = str(doc["outcome"])
                    break
            if outcome is None:
                # replica died mid-stream: no terminal line arrived
                raise ConnectionError(
                    f"{ref.url}/generate closed without an outcome"
                )
            return outcome
        finally:
            conn.close()


def _best_effort_json(resp) -> dict:
    try:
        return json.loads(resp.read().decode())
    # edl: no-lint[silent-failure] a non-JSON error body degrades to the status-code reason; nothing to recover
    except Exception:
        return {}
