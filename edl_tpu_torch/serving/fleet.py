"""Elastic serving fleet — replica supervisor, drain-before-evict,
rolling weight swaps, and SLO-driven replica scaling.

The paper's membership-tolerant control plane, applied to serving:
N replica processes (each a :mod:`edl_tpu_torch.serving.replica` server
around its own engine) supervised here, fronted by the fault-tolerant
:class:`~edl_tpu_torch.serving.router.Router`. The supervisor owns replica
LIFECYCLE, the shared :class:`~edl_tpu_torch.serving.router.ReplicaTable`
owns replica STATE, and the router owns per-request routing — three
parties, one lock-guarded table.

* **Spawn/monitor** — replicas are subprocesses (``python -m
  edl_tpu_torch fleet --replica``) that write their ephemeral port to a file; the
  supervisor resolves it, probes ``/healthz`` until READY, then a
  prober thread folds periodic probe verdicts into the table's health
  state machine (READY → SUSPECT → DEAD on consecutive failures; a
  dead replica is respawned and the fleet heals). The spawn and probe
  paths carry the ``replica.spawn`` / ``replica.health`` fault sites —
  chaos plans break them for real.
* **Drain-before-evict** — scale-down half-closes the victim
  (``POST /drain`` → engine ``half_close()``), lets in-flight streams
  finish, takes the residual queued requests back, and only then kills
  the process. Residuals requeue through the router, so scale-down
  loses nothing.
* **Rolling weight swap** — one replica at a time: drain → evict →
  spawn at the next weight generation → wait READY → next. The fleet
  never drops below N−1 READY replicas (``min_ready_observed`` proves
  it), and mid-stream requests on the victim either finish on it
  during the drain or fail over.
* **Scaling** — :class:`FleetScaler` turns queue depth per replica and
  the TTFT SLO signal into scale up/down decisions, damped by the same
  :class:`~edl_tpu_torch.scheduler.autoscaler.HysteresisGate` the cluster
  autoscaler uses (an SLO breach bypasses the cooldown, like pending
  pods do for training).

Everything here is injectable for tests: ``spawn_fn``/``probe_fn``/
``drain_fn`` replace subprocesses and HTTP with fakes, so the
orchestration logic runs in tier-1 without booting an engine.

The PyTorch port's copy of ``edl_tpu/serving/fleet.py``. A replica is
``python -m edl_tpu_torch fleet --replica`` on ``ReplicaSpec.device``
(the card unless the spec says ``cpu``). The p2p warm start
(``--warm-from p2p``, the reference's ``elasticity/weightpush.py``) is
not ported yet: the replica verb refuses it. One repair against the
reference: :class:`ServingFleet` skips a swap or scale-down residual
whose request a ``generate`` call is still attached to or has already
finished (the reference checks only the router's own attachment, so a
request the router re-routed and finished while the victim was evicted
ran a second time).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.scheduler.autoscaler import ScaleGate
from edl_tpu_torch.serving.router import (
    DEAD,
    DRAINING,
    READY,
    SUSPECT,
    ReplicaTable,
    RouteResult,
    Router,
    http_json,
)
from edl_tpu_torch.serving.scheduler import Request
from edl_tpu_torch.utils import faults
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("fleet")

__all__ = [
    "ReplicaSpec", "ReplicaHandle", "ReplicaSupervisor",
    "FleetScaler", "ServingFleet",
]


@dataclass
class ReplicaSpec:
    """How to launch one replica subprocess. ``workdir`` holds the
    per-replica port files and log files; the command is the CLI's own
    internal replica mode so the supervised process is exactly the
    shipped serving stack, not a test double."""

    workdir: str
    vocab: int = 256
    slots: int = 4
    max_len: int = 96
    horizon: int = 4
    max_new_cap: int = 0
    block_size: int = 0
    seed: int = 1
    export_dir: Optional[str] = None
    # the replica's device: the card unless a caller asks for the CPU
    # (the tests); a replica that cannot reach it exits, never falls back
    device: str = "cuda"
    # p2p warm-start (the reference's elasticity/weightpush.py; not
    # ported yet, the replica verb refuses it): replicas pull live
    # weights from a shard server at ``warm_addr`` instead of
    # cold-loading the export / seed-initializing
    warm_from: Optional[str] = None
    warm_addr: Optional[str] = None
    extra: List[str] = field(default_factory=list)

    def command(
        self, replica_id: str, port_file: str, generation: int
    ) -> List[str]:
        cmd = [
            sys.executable, "-m", "edl_tpu_torch", "fleet",
            "--replica", "--replica-id", replica_id,
            "--port-file", port_file,
            "--generation", str(generation),
            "--slots", str(self.slots),
            "--max-len", str(self.max_len),
            "--horizon", str(self.horizon),
            "--seed", str(self.seed),
            "--device", self.device,
        ]
        if self.max_new_cap:
            cmd += ["--max-new-cap", str(self.max_new_cap)]
        if self.block_size:
            cmd += ["--block-size", str(self.block_size)]
        if self.export_dir:
            cmd += ["--export-dir", self.export_dir]
        else:
            cmd += ["--dryrun", "--vocab", str(self.vocab)]
        if self.warm_from:
            cmd += ["--warm-from", self.warm_from]
            if self.warm_addr:
                cmd += ["--warm-addr", self.warm_addr]
        return cmd + list(self.extra)


@dataclass
class ReplicaHandle:
    """Supervisor-private process bookkeeping for one replica (the
    router never sees this — it routes off the table)."""

    id: str
    generation: int = 0
    url: str = ""
    proc: Optional[subprocess.Popen] = None
    port_file: str = ""
    log_path: str = ""


class ReplicaSupervisor:
    """Spawns, health-checks, drains, evicts, and swaps replicas.

    ``events_sink(replica_id, records)`` receives a replica's flight-
    recorder dump scraped just before a deliberate evict — the chaos
    harness merges these into one timeline so ``edl postmortem`` can
    verify no request was lost across any handover."""

    def __init__(
        self,
        table: ReplicaTable,
        spec: Optional[ReplicaSpec] = None,
        *,
        spawn_fn: Optional[Callable[[str, int], ReplicaHandle]] = None,
        probe_fn: Optional[Callable[[str], Dict[str, Any]]] = None,
        drain_fn: Optional[Callable[[str], Dict[str, Any]]] = None,
        ready_timeout_s: float = 90.0,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 3.0,
        drain_timeout_s: float = 120.0,
        spawn_retries: int = 1,
        auto_respawn: bool = True,
        events_sink: Optional[Callable[[str, List[dict]], None]] = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        if spec is None and spawn_fn is None:
            raise ValueError("need a ReplicaSpec or a spawn_fn")
        self.table = table
        self.spec = spec
        self._spawn_fn = spawn_fn or self._spawn_subprocess
        self._probe_fn = probe_fn or self._probe_http
        self._drain_fn = drain_fn or self._drain_http
        self.ready_timeout_s = ready_timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.spawn_retries = spawn_retries
        self.auto_respawn = auto_respawn
        self.events_sink = events_sink
        self.clock = clock
        self.sleep = sleep
        self._handles: Dict[str, ReplicaHandle] = {}
        self._hlock = threading.Lock()
        self._seq = 0
        self._target = 0  # replicas the fleet should keep alive
        self._stop_evt = threading.Event()
        self._prober: Optional[threading.Thread] = None
        #: lowest READY count seen while a rolling swap was in progress
        self.min_ready_observed: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, n: int) -> List[str]:
        """Bring up ``n`` replicas, wait until every one is READY, then
        start the health prober. Returns the replica ids."""
        ids = [self.spawn() for _ in range(n)]
        for rid in ids:
            self.wait_ready(rid)
        with self._hlock:
            self._target = n
        self._prober = threading.Thread(
            target=self._probe_loop, name="fleet-prober", daemon=True
        )
        self._prober.start()
        return ids

    def stop(self) -> None:
        self._stop_evt.set()
        if self._prober is not None:
            self._prober.join(timeout=5)
        with self._hlock:
            handles = list(self._handles.values())
            self._handles.clear()
        for h in handles:
            self._kill(h)

    def handle(self, replica_id: str) -> Optional[ReplicaHandle]:
        with self._hlock:
            return self._handles.get(replica_id)

    @property
    def target(self) -> int:
        with self._hlock:
            return self._target

    # -- spawn / ready ------------------------------------------------------

    def spawn(self, generation: int = 0) -> str:
        """Launch one replica (retrying ``spawn_retries`` times) and
        register its handle. The replica is NOT yet in the routing
        table — :meth:`wait_ready` adds it once it answers health."""
        with self._hlock:
            rid = f"r{self._seq}"
            self._seq += 1
        last: Optional[Exception] = None
        for attempt in range(self.spawn_retries + 1):
            try:
                # chaos site: process launch — an armed fault here is
                # "the scheduler refused / the binary is gone"
                faults.fault_point("replica.spawn")
                h = self._spawn_fn(rid, generation)
                break
            except (ConnectionError, OSError, RuntimeError) as e:
                last = e
                log.warn("replica spawn failed", replica=rid,
                         attempt=attempt, err=str(e))
        else:
            raise RuntimeError(
                f"replica {rid} failed to spawn after "
                f"{self.spawn_retries + 1} attempts"
            ) from last
        with self._hlock:
            self._handles[rid] = h
        flight.emit("replica.spawn", worker=rid, generation=generation,
                    pid=h.proc.pid if h.proc else None)
        if attempt:
            # a retry recovered the launch — close the postmortem
            # chain for any injected replica.spawn fault
            flight.emit("replica.recover", worker=rid,
                        site="replica.spawn", rids=[], retried=attempt)
        return rid

    def wait_ready(self, replica_id: str) -> None:
        """Resolve the replica's URL (port file) and probe until the
        first healthy answer, then publish it READY in the table."""
        h = self.handle(replica_id)
        assert h is not None, f"unknown replica {replica_id}"
        t0 = self.clock()
        while not h.url:
            if h.port_file and os.path.exists(h.port_file):
                try:
                    doc = json.loads(open(h.port_file).read())
                    h.url = f"http://127.0.0.1:{int(doc['port'])}"
                    break
                except (ValueError, KeyError, OSError):
                    pass  # partially written; retried below until timeout
            if h.proc is not None and h.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {replica_id} exited rc={h.proc.returncode} "
                    f"before binding (log: {h.log_path})"
                )
            if self.clock() - t0 > self.ready_timeout_s:
                raise TimeoutError(
                    f"replica {replica_id} never wrote {h.port_file}"
                )
            self.sleep(0.05)
        while True:
            try:
                doc = self._probe_fn(h.url)
                if doc.get("status") in ("ok", "draining"):
                    break
            except (ConnectionError, OSError):
                pass  # not accepting yet; retried below until timeout
            if self.clock() - t0 > self.ready_timeout_s:
                raise TimeoutError(
                    f"replica {replica_id} at {h.url} never became healthy"
                )
            self.sleep(0.05)
        # edl: no-lint[lockset-race] ReplicaTable guards itself; bound once in __init__
        self.table.add(replica_id, h.url, generation=h.generation)
        self.table.set_state(replica_id, READY)
        flight.emit("replica.ready", worker=replica_id, url=h.url,
                    generation=h.generation,
                    wait_s=round(self.clock() - t0, 3))

    def _spawn_subprocess(
        self, replica_id: str, generation: int
    ) -> ReplicaHandle:
        assert self.spec is not None
        os.makedirs(self.spec.workdir, exist_ok=True)
        port_file = os.path.join(
            self.spec.workdir, f"{replica_id}.port.json"
        )
        if os.path.exists(port_file):
            os.unlink(port_file)
        log_path = os.path.join(self.spec.workdir, f"{replica_id}.log")
        cmd = self.spec.command(replica_id, port_file, generation)
        # the repo may be run in-place (not pip-installed): make sure
        # the child resolves edl_tpu_torch even though its cwd is the workdir
        import edl_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(edl_tpu_torch.__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                cmd, stdout=logf, stderr=subprocess.STDOUT,
                cwd=self.spec.workdir, env=env,
            )
        finally:
            logf.close()
        return ReplicaHandle(
            id=replica_id, generation=generation, proc=proc,
            port_file=port_file, log_path=log_path,
        )

    # -- health -------------------------------------------------------------

    def _probe_http(self, url: str) -> Dict[str, Any]:
        return http_json(url, "/healthz", timeout_s=self.probe_timeout_s)

    def probe_once(self, replica_id: str) -> Optional[str]:
        """One probe → state machine. Returns the replica's resulting
        table state (None when it isn't tabled)."""
        h = self.handle(replica_id)
        rep = self.table.get(replica_id)
        if h is None or rep is None or not h.url:
            return None
        if rep.state == DRAINING:
            return rep.state
        if rep.state == DEAD:
            # the ROUTER's own mark_probe(ok=False) calls (one per
            # failed forward) can walk a replica to DEAD between prober
            # sweeps, and DEAD is sticky — without this reap the zombie
            # entry would sit in the table forever and the fleet would
            # never heal back to target
            flight.emit("replica.dead", severity="error",
                        worker=replica_id, fails=self.table.dead_after)
            self._handle_death(replica_id)
            return DEAD
        prev = rep.state
        try:
            # chaos site: the health probe wire — armed flaps make the
            # prober SUSPECT a live replica, exercising the resurrect
            # path without hurting any request
            faults.fault_point("replica.health")
            doc = self._probe_fn(h.url)
            ok = doc.get("status") in ("ok", "draining")
            depth = doc.get("queue_depth")
        except (ConnectionError, OSError, faults.InjectedFault) as e:
            ok, depth = False, None
            log.warn("health probe failed", replica=replica_id, err=str(e))
        state = self.table.mark_probe(replica_id, ok, queue_depth=depth)
        if ok and prev == SUSPECT and state == READY:
            # the flap cleared: the replica was never gone
            flight.emit("replica.recover", worker=replica_id,
                        site="replica.health", rids=[])
        if state == DEAD:
            flight.emit("replica.dead", severity="error",
                        worker=replica_id, fails=self.table.dead_after)
            self._handle_death(replica_id)
            return DEAD
        return state

    def _probe_loop(self) -> None:
        while not self._stop_evt.wait(self.probe_interval_s):
            for rid in self.table.ids():
                if self._stop_evt.is_set():
                    return
                self.probe_once(rid)

    def _handle_death(self, replica_id: str) -> None:
        """A replica stopped answering: reap it and heal the fleet back
        to the target size (the router already fails its in-flight
        requests over; nothing is waiting on this process)."""
        with self._hlock:
            h = self._handles.pop(replica_id, None)
        self.table.remove(replica_id)
        if h is not None:
            self._kill(h)
        if not self.auto_respawn or self._stop_evt.is_set():
            return
        alive = len(self.table.ids())
        with self._hlock:
            target = self._target
        if alive >= target:
            return
        try:
            new_id = self.spawn(
                generation=h.generation if h is not None else 0
            )
            self.wait_ready(new_id)
            flight.emit("replica.recover", worker=new_id,
                        site="replica.health", rids=[],
                        replaced=replica_id)
        except (RuntimeError, TimeoutError, ConnectionError, OSError) as e:
            log.error("respawn after death failed",
                      replica=replica_id, err=str(e))

    # -- drain / evict / scale ---------------------------------------------

    def _drain_http(self, url: str) -> Dict[str, Any]:
        return http_json(url, "/drain", timeout_s=self.drain_timeout_s,
                         body={})

    def drain_replica(self, replica_id: str) -> List[Dict[str, Any]]:
        """Half-close one replica and collect its residual queued
        requests (wire docs, ready for router resubmission). The
        replica stays alive — in-flight streams have already finished
        when this returns."""
        h = self.handle(replica_id)
        if h is None:
            return []
        self.table.set_state(replica_id, DRAINING)
        flight.emit("replica.drain", worker=replica_id,
                    generation=h.generation)
        try:
            doc = self._drain_fn(h.url)
        except (ConnectionError, OSError) as e:
            # the victim died while draining — its queued residuals are
            # gone WITH their engine, but none had streamed a token;
            # the router's retry path owns any in-flight rids
            log.error("drain failed (victim died?)",
                      replica=replica_id, err=str(e))
            return []
        residual = list(doc.get("residual", []))
        log.info("replica drained", replica=replica_id,
                 residual=len(residual), served=doc.get("served"))
        return residual

    def evict_replica(self, replica_id: str) -> None:
        """Kill a drained replica and drop it from the table. Scrapes
        its flight-recorder events into ``events_sink`` first, so the
        postmortem timeline keeps the victim's half of every story."""
        h = self.handle(replica_id)
        if h is not None and self.events_sink is not None and h.url:
            try:
                self.events_sink(
                    replica_id,
                    sorted(flight.load_jsonl(_scrape_text(h.url, "/events")),
                           key=lambda e: (e.get("t_wall", 0.0),
                                          e.get("seq", 0))),
                )
            except (ConnectionError, OSError, ValueError) as e:
                log.warn("event scrape before evict failed",
                         replica=replica_id, err=str(e))
        flight.emit("replica.evict", worker=replica_id,
                    generation=h.generation if h else None)
        with self._hlock:
            self._handles.pop(replica_id, None)
        self.table.remove(replica_id)
        if h is not None:
            self._kill(h)

    def scale_up(self, generation: int = 0) -> str:
        rid = self.spawn(generation=generation)
        self.wait_ready(rid)
        with self._hlock:
            self._target += 1
        return rid

    def scale_down(
        self, victim: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Drain-before-evict: pick the least-loaded READY replica (or
        ``victim``), half-close it, finish in-flight, take residuals,
        THEN kill. Returns the residual request docs — the caller
        (:meth:`ServingFleet.scale_down`) requeues them through the
        router so scale-down loses zero requests."""
        if victim is None:
            ready = [
                r for r in self.table.snapshot() if r.state == READY
            ]
            if not ready:
                return []
            ready.sort(key=lambda r: (r.queue_depth + r.inflight, r.id))
            victim = ready[0].id
        residual = self.drain_replica(victim)
        self.evict_replica(victim)
        with self._hlock:
            self._target = max(0, self._target - 1)
        return residual

    def rolling_swap(self, new_generation: Optional[int] = None) -> int:
        """Swap every replica to ``new_generation`` (default: max
        current + 1), one at a time: drain → evict → spawn new → wait
        READY. The fleet never has more than one replica out at a time,
        so the up count (READY + SUSPECT) never drops below N−1
        (tracked in ``min_ready_observed``). Returns the generation
        swapped to."""
        victims = [r.id for r in self.table.snapshot()]
        if new_generation is None:
            with self._hlock:
                new_generation = 1 + max(
                    (h.generation for h in self._handles.values()),
                    default=0,
                )
        self.min_ready_observed = self._up_count()
        residual_total = 0
        for vid in victims:
            if self.table.get(vid) is None:
                continue  # died and was reaped mid-swap
            residual = self.drain_replica(vid)
            self._note_ready_floor()
            self.evict_replica(vid)
            if residual:
                # queued-but-unstarted work must not wait for the swap
                residual_total += len(residual)
                self._residual_cb(residual)
            new_id = self.spawn(generation=new_generation)
            self.wait_ready(new_id)
            self._note_ready_floor()
        log.info("rolling swap complete", generation=new_generation,
                 swapped=len(victims), residual=residual_total,
                 min_ready=self.min_ready_observed)
        return new_generation

    # hook ServingFleet installs so swap residuals requeue through the
    # router; standalone supervisors just log them
    def _residual_cb(self, residual: List[Dict[str, Any]]) -> None:
        log.warn("swap residuals with no requeue hook",
                 n=len(residual))

    def _up_count(self) -> int:
        # READY + SUSPECT: a suspect replica still holds its streams (a
        # probe flap is a verdict, not an eviction), so the swap floor
        # proves how many replicas the SWAP itself has taken out — at
        # most one — independent of concurrent wire faults flapping
        # probes on the others
        return sum(
            1 for r in self.table.snapshot()
            if r.state in (READY, SUSPECT)
        )

    def _note_ready_floor(self) -> None:
        n = self._up_count()
        if self.min_ready_observed is None or n < self.min_ready_observed:
            self.min_ready_observed = n

    def _kill(self, h: ReplicaHandle) -> None:
        if h.proc is None:
            return
        if h.proc.poll() is None:
            h.proc.terminate()
            try:
                h.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=5)


def _scrape_text(url: str, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(
        url.rstrip("/") + path, timeout=5.0
    ) as resp:
        return resp.read().decode()


# ---------------------------------------------------------------------------
# fleet-level scaling (queue depth + TTFT SLO through the shared gate)


class FleetScaler:
    """Replica-count controller: queue depth per READY replica and the
    TTFT SLO drive scale up/down, damped through the autoscaler's
    shared :class:`ScaleGate` so a marginal load signal can't thrash
    drain/spawn cycles. An SLO breach bypasses the cooldown — churn is
    the lesser evil once users are missing deadlines (the serving
    analog of the training loop's pending-pods bypass)."""

    def __init__(
        self,
        table: ReplicaTable,
        *,
        min_replicas: int = 1,
        max_replicas: int = 8,
        depth_high: float = 4.0,
        depth_low: float = 0.5,
        ttft_slo_s: Optional[float] = None,
        ttft_p95_s: Optional[Callable[[], float]] = None,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"bad replica bounds [{min_replicas}, {max_replicas}]"
            )
        if depth_low >= depth_high:
            raise ValueError(
                f"depth_low {depth_low} must be < depth_high {depth_high}"
            )
        self.table = table
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.depth_high = depth_high
        self.depth_low = depth_low
        self.ttft_slo_s = ttft_slo_s
        self.ttft_p95_s = ttft_p95_s
        self._scale_gate = ScaleGate(
            "fleet", cooldown_s, clock=clock, bypass=self._slo_breached
        )
        # the underlying HysteresisGate, kept addressable so tests and
        # the CLI can poke cooldown state directly
        self.gate = self._scale_gate.gate

    def _slo_breached(self) -> bool:
        if self.ttft_slo_s is None or self.ttft_p95_s is None:
            return False
        return self.ttft_p95_s() > self.ttft_slo_s

    def decide(self) -> Optional[str]:
        """Pure decision: "up", "down", or None — no side effects, no
        cooldown (that's :meth:`tick`)."""
        ready = [r for r in self.table.snapshot() if r.state == READY]
        n = len(ready)
        if n == 0:
            return "up" if self.max_replicas >= 1 else None
        load = sum(r.queue_depth + r.inflight for r in ready) / n
        breach = self._slo_breached()
        if (load > self.depth_high or breach) and n < self.max_replicas:
            return "up"
        if load < self.depth_low and n > self.min_replicas and not breach:
            return "down"
        return None

    def tick(self, fleet: "ServingFleet") -> Optional[str]:
        """One damped decision, applied through the fleet. Returns the
        action taken (None = held). The decide→gate→act→record
        sequencing lives in the shared :class:`ScaleGate` — the same
        pipeline the elasticity controller's handover loop runs."""
        return self._scale_gate.apply(
            self.decide,
            lambda action: (
                fleet.scale_up() if action == "up" else fleet.scale_down()
            ),
        )


# ---------------------------------------------------------------------------
# the composed fleet


class ServingFleet:
    """Table + supervisor + router, wired: the front door the CLI and
    the chaos harness drive. ``generate`` is thread-safe; residuals
    from scale-down/swap requeue through the router automatically."""

    def __init__(
        self,
        supervisor: ReplicaSupervisor,
        router: Router,
    ):
        self.supervisor = supervisor
        self.router = router
        self.table = supervisor.table
        self.results: Dict[str, RouteResult] = {}
        # rids a generate() call holds, from before the router takes
        # them until their result is recorded
        self._attached: set = set()
        self._rlock = threading.Lock()
        supervisor._residual_cb = self._requeue_docs

    def start(self, n: int) -> List[str]:
        return self.supervisor.start(n)

    def stop(self) -> None:
        self.supervisor.stop()

    def generate(
        self, req: Request, session: Optional[str] = None
    ) -> RouteResult:
        with self._rlock:
            self._attached.add(req.rid)
        try:
            res = self.router.generate(req, session=session)
        except BaseException:
            with self._rlock:
                self._attached.discard(req.rid)
            raise
        with self._rlock:
            if req.rid in self.results:
                # the zero-duplicate invariant tripped — surface it
                # loudly instead of silently overwriting
                log.error("duplicate terminal result", rid=req.rid)
            self.results[req.rid] = res
            self._attached.discard(req.rid)
        return res

    def scale_up(self) -> str:
        return self.supervisor.scale_up()

    def scale_down(self, victim: Optional[str] = None) -> List[RouteResult]:
        """Drain-before-evict scale-down; the victim's residual queued
        requests rerun through the router before this returns."""
        residual = self.supervisor.scale_down(victim)
        return self._requeue_docs(residual)

    def rolling_swap(self, new_generation: Optional[int] = None) -> int:
        return self.supervisor.rolling_swap(new_generation)

    def _requeue_docs(
        self, residual: List[Dict[str, Any]]
    ) -> List[RouteResult]:
        out: List[RouteResult] = []
        for doc in residual:
            rid = str(doc["rid"])
            with self._rlock:
                held = rid in self._attached or rid in self.results
            if held or self.router.owns(rid):
                # a generate() call is attached to this rid (its own
                # requeue loop reruns it) or already finished it;
                # resubmitting here would execute the request twice
                continue
            req = Request(
                rid=str(doc["rid"]),
                prompt=[int(t) for t in doc["prompt"]],
                max_new=int(doc["max_new"]),
                eos_id=doc.get("eos_id"),
                deadline_s=doc.get("deadline_s"),
                tenant=doc.get("tenant"),
                slo_class=doc.get("slo_class"),
            )
            out.append(self.generate(req))
        return out
