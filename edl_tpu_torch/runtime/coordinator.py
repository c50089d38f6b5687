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
- :class:`NativeCoordinator` — the same C++ core in process, through
  ctypes over ``libedl_coord.so``.
- :class:`PyCoordinator` — the pure-Python fallback with the same
  interface, its chip leases in a :class:`~edl_tpu_torch.runtime.
  lease_table.LeaseTable` and its task queue an
  :class:`~edl_tpu_torch.runtime.data.ElasticDataQueue`.
- :func:`make_coordinator` — the best in-process coordinator: native,
  else Python.
- :func:`ensure_native_built` — builds the library and the server with
  the sources' own Makefile into ``edl_tpu_torch/_build/coordinator``
  (``make BUILD=...``), so the port shares no build directory with the
  reference and writes nothing into ``native/``.

The server raises when the build fails, as the reference's does;
``make_coordinator`` then returns a ``PyCoordinator``.
``runtime/coordinator_main.py`` runs the server as a process, with the
fleet's telemetry endpoint beside it.
"""

from __future__ import annotations

import ctypes
import json
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
from edl_tpu_torch.runtime.data import ElasticDataQueue, Task
from edl_tpu_torch.runtime.lease_table import LeaseTable
from edl_tpu_torch.utils import faults, native_build, tracing
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("coordinator")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native", "coordinator")
BUILD_DIR = os.path.join(_REPO, "edl_tpu_torch", "_build", "coordinator")
BIN_PATH = os.path.join(BUILD_DIR, "edl-coordinator")
LIB_PATH = os.path.join(BUILD_DIR, "libedl_coord.so")
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
    """The built library and server are both newer than every source."""
    return native_build.fresh((LIB_PATH, BIN_PATH), NATIVE_DIR, _SOURCES)


def ensure_native_built() -> bool:
    """Build the library and the server on demand into
    :data:`BUILD_DIR`; False (and a warning) when the build fails."""
    return native_build.ensure_built((LIB_PATH, BIN_PATH), NATIVE_DIR,
                                     BUILD_DIR, _SOURCES, _build_lock,
                                     "coordinator")


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


class NativeCoordinator:
    """ctypes wrapper over the C++ core (in-process mode)."""

    def __init__(self, member_ttl_s: float = 10.0, wal_path: str = ""):
        if not ensure_native_built():
            raise RuntimeError("native coordinator unavailable")
        lib = ctypes.CDLL(LIB_PATH)
        lib.edl_coord_new.restype = ctypes.c_void_p
        lib.edl_coord_new.argtypes = [ctypes.c_double]
        lib.edl_coord_new_wal.restype = ctypes.c_void_p
        lib.edl_coord_new_wal.argtypes = [ctypes.c_double, ctypes.c_char_p]
        lib.edl_coord_free.argtypes = [ctypes.c_void_p]
        lib.edl_kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.edl_kv_get.restype = ctypes.c_longlong
        lib.edl_kv_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_longlong,
        ]
        lib.edl_kv_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_member_register.restype = ctypes.c_longlong
        lib.edl_member_register.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_longlong,
        ]
        lib.edl_member_heartbeat.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_member_leave.restype = ctypes.c_longlong
        lib.edl_member_leave.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_member_expire.restype = ctypes.c_longlong
        lib.edl_member_expire.argtypes = [ctypes.c_void_p]
        lib.edl_epoch.restype = ctypes.c_longlong
        lib.edl_epoch.argtypes = [ctypes.c_void_p]
        lib.edl_members.restype = ctypes.c_longlong
        lib.edl_members.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_longlong,
        ]
        lib.edl_barrier_arrive.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.edl_barrier_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_queue_init.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_int,
        ]
        lib.edl_queue_lease.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_longlong * 4,
        ]
        lib.edl_queue_ack.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.edl_queue_nack.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.edl_queue_release_worker.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_queue_done.argtypes = [ctypes.c_void_p]
        lib.edl_queue_stats.argtypes = [ctypes.c_void_p, ctypes.c_longlong * 5]
        lib.edl_lease_init.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.edl_lease_grant.restype = ctypes.c_longlong
        lib.edl_lease_grant.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_longlong,
            ctypes.c_char_p,
            ctypes.c_longlong * 2,
        ]
        lib.edl_lease_recall.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.edl_lease_free.restype = ctypes.c_longlong
        lib.edl_lease_free.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.edl_lease_confirm.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
        ]
        lib.edl_lease_crashed.restype = ctypes.c_longlong
        lib.edl_lease_crashed.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.edl_lease_expire.argtypes = [ctypes.c_void_p, ctypes.c_longlong * 2]
        lib.edl_lease_set_recover_window.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double,
        ]
        lib.edl_lease_snap.restype = ctypes.c_longlong
        lib.edl_lease_snap.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_longlong,
        ]
        lib.edl_wal_compact.argtypes = [ctypes.c_void_p]
        lib.edl_wal_set_compact_bytes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        lib.edl_wal_stats.argtypes = [ctypes.c_void_p, ctypes.c_longlong * 2]
        self._lib = lib
        # wal_path makes the coordinator durable: mutations append to a
        # write-ahead log; a new instance on the same path replays it
        if wal_path:
            # preflight the path so an unwritable WAL raises here
            # instead of running silently non-durable
            with open(wal_path, "a"):
                pass
            self._h = lib.edl_coord_new_wal(member_ttl_s, wal_path.encode())
        else:
            self._h = lib.edl_coord_new(member_ttl_s)

    def close(self):
        if self._h:
            self._lib.edl_coord_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        # edl: no-lint[silent-failure] __del__ during interpreter shutdown: nothing to report to, must never raise
        except Exception:
            pass

    # KV
    def kv_put(self, k: str, v: str) -> None:
        self._lib.edl_kv_put(self._h, k.encode(), v.encode())

    def kv_get(self, k: str) -> Optional[str]:
        buf = ctypes.create_string_buffer(65536)
        n = self._lib.edl_kv_get(self._h, k.encode(), buf, len(buf))
        return None if n < 0 else buf.value.decode()

    def kv_del(self, k: str) -> None:
        self._lib.edl_kv_del(self._h, k.encode())

    # membership
    def register(self, worker: str, incarnation: int) -> int:
        return self._lib.edl_member_register(self._h, worker.encode(), incarnation)

    def heartbeat(self, worker: str) -> bool:
        return bool(self._lib.edl_member_heartbeat(self._h, worker.encode()))

    def leave(self, worker: str) -> int:
        return self._lib.edl_member_leave(self._h, worker.encode())

    def expire(self) -> int:
        return self._lib.edl_member_expire(self._h)

    def epoch(self) -> int:
        return self._lib.edl_epoch(self._h)

    def members(self) -> List[Member]:
        buf = ctypes.create_string_buffer(65536)
        self._lib.edl_members(self._h, buf, len(buf))
        return _parse_members(buf.value.decode())

    def time(self) -> float:
        """In-process: the reference clock IS this process's clock."""
        return time.time()

    # barriers
    def barrier_arrive(self, name: str, worker: str) -> int:
        return self._lib.edl_barrier_arrive(self._h, name.encode(), worker.encode())

    def barrier_count(self, name: str) -> int:
        return self._lib.edl_barrier_count(self._h, name.encode())

    # queue
    def queue_init(
        self,
        n_samples: int,
        chunk: int,
        passes: int = 1,
        lease_timeout_s: float = 16.0,
        max_failures: int = 3,
    ) -> None:
        self._lib.edl_queue_init(
            self._h, n_samples, chunk, passes, lease_timeout_s, max_failures
        )

    def lease(self, worker: str) -> Optional[Task]:
        out = (ctypes.c_longlong * 4)()
        if not self._lib.edl_queue_lease(self._h, worker.encode(), out):
            return None
        return Task(task_id=out[0], start=out[1], end=out[2], epoch=out[3])

    def ack(self, task_id: int) -> bool:
        return bool(self._lib.edl_queue_ack(self._h, task_id))

    def nack(self, task_id: int) -> bool:
        return bool(self._lib.edl_queue_nack(self._h, task_id))

    def release_worker(self, worker: str) -> int:
        return self._lib.edl_queue_release_worker(self._h, worker.encode())

    def queue_done(self) -> bool:
        return bool(self._lib.edl_queue_done(self._h))

    def queue_stats(self) -> Dict[str, int]:
        out = (ctypes.c_longlong * 5)()
        self._lib.edl_queue_stats(self._h, out)
        return {
            "todo": out[0],
            "leased": out[1],
            "done": out[2],
            "dead": out[3],
            "epoch": out[4],
        }

    # chip leases (the distributed ChipLeaseBroker backend; WAL-logged,
    # so a SIGKILLed broker resumes with exact lease accounting)
    def lease_init(self, total_chips: int) -> bool:
        return bool(self._lib.edl_lease_init(self._h, total_chips))

    def lease_grant(self, holder: str, chips: int, token: str = "") -> Dict:
        token = token or uuid.uuid4().hex
        out = (ctypes.c_longlong * 2)()
        lid = self._lib.edl_lease_grant(
            self._h, holder.encode(), chips, token.encode(), out
        )
        if lid == -2:
            return {"ok": False, "reason": "nopool", "free": 0}
        if lid == -1:
            return {"ok": False, "reason": "nochips", "free": out[1]}
        return {"ok": True, "id": lid, "epoch": out[0], "chips": out[1]}

    def lease_recall(self, lease_id: int) -> str:
        rc = self._lib.edl_lease_recall(self._h, lease_id)
        return {0: "ok", -1: "unknown", -2: "freed"}[rc]

    def lease_free(self, lease_id: int) -> int:
        return self._lib.edl_lease_free(self._h, lease_id)

    def lease_confirm(self, lease_id: int, epoch: int) -> str:
        rc = self._lib.edl_lease_confirm(self._h, lease_id, epoch)
        return {0: "ok", 1: "stale_epoch", 2: "freed", 3: "unknown"}[rc]

    def lease_crashed(self, holder: str) -> int:
        return self._lib.edl_lease_crashed(self._h, holder.encode())

    def lease_expire(self) -> Tuple[int, int]:
        out = (ctypes.c_longlong * 2)()
        self._lib.edl_lease_expire(self._h, out)
        return (out[0], out[1])

    def lease_set_recover_window(self, seconds: float) -> None:
        self._lib.edl_lease_set_recover_window(self._h, seconds)

    def lease_snap(self) -> Dict:
        buf = ctypes.create_string_buffer(262144)
        self._lib.edl_lease_snap(self._h, buf, len(buf))
        return _parse_lease_snap(buf.value.decode())

    # WAL compaction (snapshot+truncate: replay cost O(state), not
    # O(history) — the compacted-etcd-durability analog)
    def wal_compact(self) -> None:
        self._lib.edl_wal_compact(self._h)

    def set_wal_compact_bytes(self, n: int) -> None:
        self._lib.edl_wal_set_compact_bytes(self._h, n)

    def wal_stats(self) -> Dict[str, int]:
        out = (ctypes.c_longlong * 2)()
        self._lib.edl_wal_stats(self._h, out)
        return {"appended_bytes": out[0], "compactions": out[1]}


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


class PyCoordinator:
    """Pure-Python fallback with the same interface (no toolchain needed)."""

    def __init__(self, member_ttl_s: float = 10.0):
        self._ttl = member_ttl_s
        self._lock = threading.Lock()
        self._kv: Dict[str, str] = {}
        self._members: Dict[str, Tuple[int, float]] = {}
        self._epoch = 0
        self._barriers: Dict[str, set] = {}
        self._queue: Optional[ElasticDataQueue] = None
        # chip leases: the shared state machine, persisting its doc
        # into this KV (the memory-only analog of the native WAL)
        self._lease_table = LeaseTable(persist=self._lease_persist)

    def kv_put(self, k, v):
        with self._lock:
            self._kv[k] = v

    def kv_get(self, k):
        with self._lock:
            return self._kv.get(k)

    def kv_del(self, k):
        with self._lock:
            self._kv.pop(k, None)

    def register(self, worker, incarnation):
        with self._lock:
            cur = self._members.get(worker)
            if cur and cur[0] > incarnation:
                return self._epoch  # zombie with stale incarnation
            if cur is None or cur[0] != incarnation:
                self._epoch += 1
            self._members[worker] = (incarnation, time.monotonic() + self._ttl)
            return self._epoch

    def heartbeat(self, worker):
        with self._lock:
            if worker not in self._members:
                return False
            inc, _ = self._members[worker]
            self._members[worker] = (inc, time.monotonic() + self._ttl)
            return True

    def leave(self, worker):
        with self._lock:
            if self._members.pop(worker, None) is not None:
                self._epoch += 1
            return self._epoch

    def expire(self):
        with self._lock:
            now = time.monotonic()
            dead = [w for w, (_, exp) in self._members.items() if exp <= now]
            for w in dead:
                del self._members[w]
            if dead:
                self._epoch += 1
            return self._epoch

    def epoch(self):
        with self._lock:
            return self._epoch

    def members(self):
        with self._lock:
            return [
                Member(name, inc, rank)
                for rank, (name, (inc, _)) in enumerate(
                    sorted(self._members.items())
                )
            ]

    def time(self):
        """Duck-typed clock-sync parity: in-process fallback, so the
        reference clock is the local one."""
        return time.time()

    def barrier_arrive(self, name, worker):
        with self._lock:
            self._barriers.setdefault(name, set()).add(worker)
            return len(self._barriers[name])

    def barrier_count(self, name):
        with self._lock:
            return len(self._barriers.get(name, ()))

    def queue_init(self, n_samples, chunk, passes=1, lease_timeout_s=16.0,
                   max_failures=3):
        self._queue = ElasticDataQueue(
            n_samples, chunk, passes=passes, lease_timeout_s=lease_timeout_s
        )

    def lease(self, worker):
        return self._queue.get_task(worker) if self._queue else None

    def ack(self, task_id):
        self._queue.ack(task_id)
        return True

    def nack(self, task_id):
        self._queue.nack(task_id)
        return True

    def release_worker(self, worker):
        return self._queue.release_worker(worker) if self._queue else 0

    def queue_done(self):
        return self._queue.done() if self._queue else False

    def queue_stats(self):
        return self._queue.progress() if self._queue else {}

    # chip leases: delegate to the shared LeaseTable (same return
    # values as the native bindings, so the client adapter can't tell
    # the backends apart)
    def _lease_persist(self, doc):
        self.kv_put("lease/table", json.dumps(doc, sort_keys=True))

    def lease_restore(self):
        """Simulate a broker restart: rebuild the lease table from the
        persisted KV doc. Live leases come back unconfirmed and the
        table enters RECOVERING — the WAL-replay analog for the
        memory-only fallback (tests crash the table, then restore)."""
        doc = self.kv_get("lease/table")
        window = self._lease_table.recover_window_s
        self._lease_table = LeaseTable(
            persist=self._lease_persist, recover_window_s=window
        )
        if doc:
            self._lease_table.restore(json.loads(doc))

    def lease_init(self, total_chips):
        return self._lease_table.init(total_chips)

    def lease_grant(self, holder, chips, token=""):
        return self._lease_table.grant(holder, chips, token or uuid.uuid4().hex)

    def lease_recall(self, lease_id):
        return self._lease_table.recall(lease_id)

    def lease_free(self, lease_id):
        return self._lease_table.free(lease_id)

    def lease_confirm(self, lease_id, epoch):
        return self._lease_table.confirm(lease_id, epoch)

    def lease_crashed(self, holder):
        return self._lease_table.crashed(holder)

    def lease_expire(self):
        return self._lease_table.expire()

    def lease_set_recover_window(self, seconds):
        self._lease_table.recover_window_s = seconds

    def lease_snap(self):
        return self._lease_table.snap()

    # WAL interface parity (duck-typed with NativeCoordinator): the
    # Python fallback is memory-only, so these are honest no-ops
    def wal_compact(self):
        pass

    def set_wal_compact_bytes(self, n):
        pass

    def wal_stats(self):
        return {"appended_bytes": 0, "compactions": 0}


def make_coordinator(member_ttl_s: float = 10.0):
    """Best available in-process coordinator: native, else Python."""
    try:
        return NativeCoordinator(member_ttl_s)
    except RuntimeError:
        return PyCoordinator(member_ttl_s)
