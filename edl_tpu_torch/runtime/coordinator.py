"""Coordinator bindings — the port of ``edl_tpu/runtime/coordinator.py``:
the client and the server process of the repo's jax-free C++
coordinator (``native/coordinator``), the job's membership, rendezvous
KV and data task queue (reference: pkg/jobparser.go:167-227,
docker/paddle_k8s:26-32).

- :class:`CoordinatorClient` — TCP client of the line protocol, with the
  reference's reconnect window, RPC counters, ``coord.rpc`` fault site
  and client spans on traced paths, and the chip-lease ops
  (``lease_init``, ``lease_grant``, ``lease_recall``, ``lease_free``,
  ``lease_confirm``, ``lease_crashed``, ``lease_expire``,
  ``lease_snap``) that ``elasticity/distbroker.py`` drives.
- :class:`CoordinatorServer` — spawns and owns an ``edl-coordinator``
  process (durable with a WAL; ``lease_recover_s`` sets the window a
  restarted lease pool waits for its holders to re-confirm).
- :func:`ensure_native_built` — builds the server with the sources'
  own Makefile into ``edl_tpu_torch/_build/coordinator`` (``make
  BUILD=...``), so the port shares no build directory with the
  reference and writes nothing into ``native/``.

There is no Python fallback: the server raises when the build fails,
as the reference's does. The in-process coordinators
(``NativeCoordinator``, ``PyCoordinator`` and its ``LeaseTable``) wait
for ROADMAP Queue A item 9c. ``runtime/coordinator_main.py`` runs the
server as a process, with the fleet's telemetry endpoint beside it.
"""

from __future__ import annotations

import fcntl
import os
import random
import socket
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.obs import disttrace
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.runtime.data import Task
from edl_tpu_torch.utils import faults, tracing
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("coordinator")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native", "coordinator")
BUILD_DIR = os.path.join(_REPO, "edl_tpu_torch", "_build", "coordinator")
BIN_PATH = os.path.join(BUILD_DIR, "edl-coordinator")
_SOURCES = ("coordinator.h", "coordinator.cc", "capi.cc", "server_main.cc",
            "Makefile")

_build_lock = threading.Lock()


def _rpc_counters():
    """RPC-volume telemetry of the coordination plane, resolved per call
    so a registry swap in tests takes effect."""
    r = obs_metrics.default_registry()
    return (
        r.counter(
            "edl_coordinator_rpc_total",
            "coordinator client round trips", ("op",),
        ),
        r.counter(
            "edl_coordinator_reconnects_total",
            "coordinator client reconnect attempts",
        ),
    )


def _emit_rpc_error(op: str, err: Exception) -> None:
    """Flight-recorder entry for a failed coordinator round trip."""
    from edl_tpu_torch.obs import events

    events.emit(
        "coord.rpc_error", severity="warn", op=op,
        error=f"{type(err).__name__}: {err}",
    )


def _fresh() -> bool:
    """The built server is newer than every source (the Makefile too)."""
    if not os.path.exists(BIN_PATH):
        return False
    built = os.path.getmtime(BIN_PATH)
    return all(os.path.getmtime(os.path.join(NATIVE_DIR, s)) <= built
               for s in _SOURCES if os.path.exists(os.path.join(NATIVE_DIR, s)))


def ensure_native_built() -> bool:
    """Build the server on demand into :data:`BUILD_DIR`; False (and a
    warning) when the build fails. A file lock serializes concurrent
    builds across processes."""
    if _fresh():
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _build_lock, open(os.path.join(BUILD_DIR, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if _fresh():
            return True
        try:
            subprocess.run(
                ["make", "-C", NATIVE_DIR, f"BUILD={BUILD_DIR}",
                 f"{BUILD_DIR}/edl-coordinator"],
                check=True, capture_output=True, timeout=120,
            )
            return True
        except (OSError, subprocess.SubprocessError) as e:
            log.warn("native coordinator build failed", error=str(e))
            return False


@dataclass
class Member:
    name: str
    incarnation: int
    rank: int


def _parse_members(s: str) -> List[Member]:
    out = []
    if s:
        for part in s.split(","):
            name, inc, rank = part.rsplit(":", 2)
            out.append(Member(name, int(inc), int(rank)))
    return out


def _parse_lease_snap(s: str) -> Dict:
    """Parse ``pool free epoch recovering [id|holder|chips|epoch|state|
    confirmed,...]`` (the LSNAP payload; "|" because holders contain
    ":") into the same dict shape LeaseTable.snap() returns."""
    parts = s.split(" ", 4)
    out = {
        "pool": int(parts[0]),
        "free": int(parts[1]),
        "epoch": int(parts[2]),
        "recovering": bool(int(parts[3])),
        "leases": [],
    }
    if len(parts) > 4 and parts[4]:
        for ent in parts[4].split(","):
            lid, holder, chips, ep, st, conf = ent.split("|")
            out["leases"].append(
                {
                    "id": int(lid),
                    "holder": holder,
                    "chips": int(chips),
                    "epoch": int(ep),
                    "state": int(st),
                    "confirmed": bool(int(conf)),
                }
            )
    return out


class CoordinatorClient:
    """TCP client for the edl-coordinator line protocol.

    Survives coordinator restarts: a broken connection is re-dialed with
    decorrelated-jitter backoff for up to ``reconnect_window_s`` and the
    command re-issued (the WAL makes the restarted server resume with
    the same state; PUT/DEL/REG/BARRIER are idempotent, a retried LEASE
    at worst leases another task while the first lease times out, and a
    retried ACK/NACK whose first attempt was applied returns False)."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 10.0,
        reconnect_window_s: float = 30.0,
    ):
        self._host = host
        self._port = port
        self._timeout_s = timeout_s
        self._reconnect_window_s = reconnect_window_s
        self._lock = threading.Lock()
        self._sock = None
        self._file = None
        self._connect_locked()

    def _connect_locked(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout_s
        )
        self._file = self._sock.makefile("rwb")

    def _close_locked(self) -> None:
        try:
            if self._file is not None:
                self._file.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = self._file = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _roundtrip_locked(self, line: str) -> str:
        if self._sock is None:
            self._connect_locked()
        self._file.write(line.encode() + b"\n")
        self._file.flush()
        resp = self._file.readline()
        if not resp:
            raise ConnectionError("coordinator closed connection")
        return resp.decode().rstrip("\n")

    def _call(self, line: str) -> str:
        rpcs, reconnects = _rpc_counters()
        op = line.split(" ", 1)[0]
        with self._lock:
            deadline = time.monotonic() + self._reconnect_window_s
            backoff = 0.05
            while True:
                try:
                    faults.fault_point("coord.rpc")
                    if disttrace.current() is not None:
                        with tracing.span("coord.rpc", op=op):
                            out = self._roundtrip_locked(line)
                    else:
                        out = self._roundtrip_locked(line)
                    rpcs.inc(op=op)
                    return out
                except (ConnectionError, OSError, socket.timeout) as e:
                    self._close_locked()
                    reconnects.inc()
                    _emit_rpc_error(op, e)
                    if time.monotonic() >= deadline:
                        raise ConnectionError(
                            f"coordinator unreachable after "
                            f"{self._reconnect_window_s:.0f}s: {e}"
                        ) from e
                    time.sleep(backoff)
                    backoff = min(2.0, random.uniform(0.05, backoff * 3))

    def ping(self) -> bool:
        return self._call("PING") == "PONG"

    def time(self) -> Optional[float]:
        """The coordinator's wall clock (epoch seconds); None against a
        server without the TIME op."""
        r = self._call("TIME")
        if not r.startswith("TIME "):
            return None
        return int(r.split()[1]) / 1e6

    def kv_put(self, k: str, v: str) -> None:
        self._call(f"PUT {k} {v}")

    def kv_get(self, k: str) -> Optional[str]:
        r = self._call(f"GET {k}")
        return r[4:] if r.startswith("VAL ") else None

    def kv_del(self, k: str) -> None:
        self._call(f"DEL {k}")

    def register(self, worker: str, incarnation: int) -> int:
        return int(self._call(f"REG {worker} {incarnation}").split()[1])

    def heartbeat(self, worker: str) -> bool:
        return self._call(f"HB {worker}") == "OK"

    def leave(self, worker: str) -> int:
        return int(self._call(f"LEAVE {worker}").split()[1])

    def expire(self) -> int:
        return int(self._call("EXPIRE").split()[1])

    def epoch(self) -> int:
        return int(self._call("EPOCH").split()[1])

    def members(self) -> List[Member]:
        r = self._call("MEMBERS")
        return _parse_members(r[8:].strip())

    def barrier_arrive(self, name: str, worker: str) -> int:
        return int(self._call(f"BARRIER {name} {worker}").split()[1])

    def barrier_count(self, name: str) -> int:
        return int(self._call(f"BCOUNT {name}").split()[1])

    def queue_init(
        self,
        n_samples: int,
        chunk: int,
        passes: int = 1,
        lease_timeout_s: float = 16.0,
        max_failures: int = 3,
    ) -> None:
        self._call(f"QINIT {n_samples} {chunk} {passes} {lease_timeout_s}")

    def lease(self, worker: str) -> Optional[Task]:
        r = self._call(f"LEASE {worker}")
        if not r.startswith("TASK "):
            return None
        _, tid, start, end, epoch = r.split()
        return Task(
            task_id=int(tid), start=int(start), end=int(end), epoch=int(epoch)
        )

    def ack(self, task_id: int) -> bool:
        return self._call(f"ACK {task_id}") == "OK"

    def nack(self, task_id: int) -> bool:
        return self._call(f"NACK {task_id}") == "OK"

    def release_worker(self, worker: str) -> int:
        return int(self._call(f"RELEASE {worker}").split()[1])

    def queue_done(self) -> bool:
        return self._call("QDONE") == "DONE 1"

    def queue_stats(self) -> Dict[str, int]:
        parts = self._call("QSTATS").split()[1:]
        keys = ("todo", "leased", "done", "dead", "epoch")
        return dict(zip(keys, map(int, parts)))

    def wal_compact(self) -> None:
        self._call("COMPACT")

    def wal_stats(self) -> Dict[str, int]:
        parts = self._call("WALSTATS").split()[1:]
        return {"appended_bytes": int(parts[0]), "compactions": int(parts[1])}

    # chip leases. Same graceful degradation as time(): an old server
    # binary without the lease ops answers "ERR unknown command" and
    # every method returns None, so callers can fall back to the
    # in-process broker instead of failing bring-up. Holders and
    # tokens must be space-free (":" is fine — "train:job0").

    def lease_init(self, total_chips: int) -> Optional[bool]:
        r = self._call(f"LINIT {total_chips}")
        if r.startswith("OK"):
            return True
        if r == "ERR busy":
            return False
        return None

    def lease_grant(
        self, holder: str, chips: int, token: str = ""
    ) -> Optional[Dict]:
        # the token makes a retried grant (reconnect window re-issuing
        # after a lost reply) return the original lease, not a second
        # one — the WAL-replayed server still knows the token
        token = token or uuid.uuid4().hex
        r = self._call(f"LGRANT {holder} {chips} {token}")
        if r.startswith("LEASE "):
            _, lid, ep, ch = r.split()
            return {
                "ok": True, "id": int(lid), "epoch": int(ep),
                "chips": int(ch), "token": token,
            }
        if r.startswith("ERR nochips"):
            return {"ok": False, "reason": "nochips", "free": int(r.split()[2])}
        if r == "ERR nopool":
            return {"ok": False, "reason": "nopool", "free": 0}
        return None

    def lease_recall(self, lease_id: int) -> Optional[str]:
        r = self._call(f"LRECALL {lease_id}")
        if r == "OK":
            return "ok"
        if r.startswith("ERR unknown c"):  # old server: no lease ops
            return None
        if r.startswith("ERR "):
            return r.split()[1]  # "unknown" | "freed"
        return None

    def lease_free(self, lease_id: int) -> Optional[int]:
        r = self._call(f"LFREE {lease_id}")
        if r.startswith("OK "):
            return int(r.split()[1])
        if r == "ERR unknown":
            return -1
        if r == "ERR freed":
            return -2
        return None

    def lease_confirm(self, lease_id: int, epoch: int) -> Optional[str]:
        r = self._call(f"LCONFIRM {lease_id} {epoch}")
        if r.startswith("OK"):
            return "ok"
        if r.startswith("FENCED "):
            return r.split()[1]  # "stale_epoch" | "freed" | "unknown"
        return None

    def lease_crashed(self, holder: str) -> Optional[int]:
        r = self._call(f"LCRASH {holder}")
        return int(r.split()[1]) if r.startswith("OK ") else None

    def lease_expire(self) -> Optional[Tuple[int, int]]:
        r = self._call("LEXPIRE")
        if not r.startswith("OK "):
            return None
        _, released, recovering = r.split()
        return (int(released), int(recovering))

    def lease_snap(self) -> Optional[Dict]:
        r = self._call("LSNAP")
        if not r.startswith("LEASES "):
            return None
        return _parse_lease_snap(r[7:])


class CoordinatorServer:
    """Spawn and own an edl-coordinator process (the per-job coordinator
    pod). With ``wal_path`` the server is durable: :meth:`restart` (or a
    crash and a respawn) resumes from the write-ahead log with exact
    KV/membership/queue accounting."""

    def __init__(
        self,
        port: int = 0,
        member_ttl_s: float = 10.0,
        wal_path: str = "",
        wal_compact_bytes: int = 0,  # 0 = server default (1 MiB)
        lease_recover_s: float = -1.0,  # <0 = server default (5 s)
    ):
        if not ensure_native_built():
            raise RuntimeError("native coordinator unavailable")
        if port == 0:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
        self.port = port
        self.member_ttl_s = member_ttl_s
        self.wal_path = wal_path
        self.wal_compact_bytes = wal_compact_bytes
        self.lease_recover_s = lease_recover_s
        self._spawn()

    def _spawn(self) -> None:
        cmd = [BIN_PATH, "--port", str(self.port),
               "--member-ttl", str(self.member_ttl_s)]
        if self.wal_path:
            cmd += ["--wal", self.wal_path]
        if self.wal_compact_bytes > 0:
            cmd += ["--wal-compact-bytes", str(self.wal_compact_bytes)]
        if self.lease_recover_s >= 0:
            # the chip-lease recovery window: how long a restarted pool
            # waits for holders to re-confirm before force-releasing
            cmd += ["--lease-recover", str(self.lease_recover_s)]
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        line = self._proc.stdout.readline().decode()
        if "listening" not in line:
            raise RuntimeError(f"coordinator failed to start: {line!r}")

    def client(self) -> CoordinatorClient:
        return CoordinatorClient("127.0.0.1", self.port)

    def kill(self) -> None:
        """Fault injection: SIGKILL the coordinator process."""
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(timeout=5)

    def restart(self) -> None:
        """Respawn on the same port, recovering from the WAL."""
        self.kill()
        self._spawn()

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=5)
        self._proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
