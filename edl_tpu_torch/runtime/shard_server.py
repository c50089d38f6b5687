"""Peer-to-peer shard transfer — RAM-to-RAM state redistribution: the
port of ``edl_tpu/runtime/shard_server.py``, wire-compatible with it in
both directions.

The drain window of an elastic reshard has old and new worlds coexisting
as live processes; the state that must change owners already sits in the
old workers' host-RAM snapshots (checkpoint.LocalSnapshot). Moving it
worker-to-worker over TCP skips the shared-storage round trip.

Each worker runs one :class:`ShardServer` thread serving its CURRENT
snapshot (the owner swaps its snapshot attribute at every reshard or
commit). Restorers probe peers with :func:`fetch_index` and feed
:class:`RemotePieces` handles into the checkpoint piece index
(``checkpoint._PieceIndex``), so remote pieces join the same
coverage-checked assembly as RAM and disk pieces.

The transfer path:

- **batched + pipelined**: ``FETCHN`` requests K pieces in one verb and
  streams K length-prefixed payloads back to back;
- **parallel**: :meth:`RemotePieces.get_many` stripes a batch across a
  pool of connections (``EDL_P2P_CONNS``, default 4), each fetched by
  its own thread, and the checkpoint prefetch drains peers concurrently;
- **zero-copy**: the server ``sendall``s a memoryview of the piece, the
  client ``readinto``s a preallocated array.

Line protocol (length-prefixed binary payloads):

    AUTH <token>\\n         -> OK\\n              (required iff the server
                                                 was given a token check)
    INDEX\\n                -> <len>\\n<json: {"step": S, "entries": {entry: dtype}}>
    FETCH <entry>\\n        -> <len>\\n<raw C-order bytes>   (-1\\n if unknown)
    FETCHN <n>\\n<e1>\\n...  -> n frames of <len>\\n<raw>      (-1\\n if unknown)

Entry keys are ``checkpoint._piece_key`` strings (leaf@offsets@shape).
A bfloat16 piece is held as its uint16 view and advertised as
``"bfloat16"``, the name the reference's ml_dtypes arrays carry: the
bytes on the wire are the same, and a client allocates uint16 for it.
The server binds the ``EDL_HOST_ADDR`` interface when set, and a
per-job token from coordinator KV gates access to the weights.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from edl_tpu_torch.runtime.checkpoint import (LocalSnapshot, _parse_piece_key,
                                              _piece_key, storage_dtype)
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("shardsrv")

_IO_TIMEOUT_S = 30.0
_MAX_BATCH = 4096  # FETCHN sanity cap (protocol abuse guard)


def _default_conns() -> int:
    try:
        return max(1, int(os.environ.get("EDL_P2P_CONNS", "4")))
    except ValueError:
        return 4


def _read_line(f) -> str:
    return f.readline().decode().rstrip("\n")


def _read_into(f, view: memoryview) -> None:
    """Fill the whole view via readinto (BufferedReader reads large
    remainders straight into the destination — no staging copies)."""
    filled, n = 0, len(view)
    while filled < n:
        k = f.readinto(view[filled:])
        if not k:
            raise OSError("short read")
        filled += k


def _read_exact(f, n: int) -> bytearray:
    """Read exactly n bytes into a fresh buffer via readinto — one
    allocation, no intermediate bytes objects."""
    buf = bytearray(n)
    _read_into(f, memoryview(buf))
    return buf


def _wire_dtype(snap: LocalSnapshot, key: str, arr: np.ndarray) -> str:
    """The dtype name a piece is advertised under: ``"bfloat16"`` for
    the uint16 view of a bf16 leaf, else the array's own."""
    if arr.dtype == np.uint16 and snap.dtypes.get(key) == "bfloat16":
        return "bfloat16"
    return str(arr.dtype)


class ShardServer:
    """Serve this process's host-RAM snapshot pieces to peers.

    ``get_snapshot`` returns the snapshot to serve (or None before the
    first one exists); it is called per request, so the owner just keeps
    its ``_ram_snapshot`` attribute fresh and the server follows.
    ``check_token`` (optional) gates every connection: the first verb
    must then be a valid ``AUTH``. ``host`` defaults to the
    ``EDL_HOST_ADDR`` interface when set, else loopback — never every
    interface unless explicitly asked (``host="0.0.0.0"``)."""

    def __init__(
        self,
        get_snapshot: Callable[[], Optional[LocalSnapshot]],
        check_token: Optional[Callable[[str], bool]] = None,
        host: Optional[str] = None,
    ):
        self._get = get_snapshot
        self._check = check_token
        bind = host or os.environ.get("EDL_HOST_ADDR") or "127.0.0.1"
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._srv.bind((bind, 0))
        except OSError:
            # EDL_HOST_ADDR may be a name that is not a local interface
            # (NAT / service VIP): fall back to all interfaces so peers
            # can still reach us at the published address
            self._srv.bind(("0.0.0.0", 0))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._active = 0  # open peer connections (drain-linger signal)
        self._active_lock = threading.Lock()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    @property
    def active(self) -> int:
        with self._active_lock:
            return self._active

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:  # pragma: no cover - thread loop
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _send_piece(self, conn, f, arr) -> None:
        """One <len>\\n<raw> frame; payload bytes go straight from the
        snapshot array to the socket (no tobytes staging copy)."""
        if arr is None:
            f.write(b"-1\n")
            return
        a = np.ascontiguousarray(arr)  # no-op for snapshot pieces
        f.write(str(a.nbytes).encode() + b"\n")
        f.flush()
        conn.sendall(memoryview(a).cast("B", (a.nbytes,)))

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(_IO_TIMEOUT_S)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        f = conn.makefile("rwb")
        with self._active_lock:
            self._active += 1
        authed = self._check is None
        try:
            while True:
                line = _read_line(f)
                if not line:
                    return
                if line.startswith("AUTH "):
                    if self._check is None or self._check(line[5:]):
                        authed = True
                        f.write(b"OK\n")
                        f.flush()
                        continue
                    return  # bad token: close without serving anything
                if not authed:
                    return  # first verb must be AUTH when gated
                snap = self._get()
                if line == "INDEX":
                    if snap is None:
                        payload = b'{"step": -1, "entries": {}}'
                    else:
                        entries = {
                            _piece_key(key, off, tuple(arr.shape)):
                                _wire_dtype(snap, key, arr)
                            for key, plist in snap.pieces.items()
                            for off, arr in plist
                        }
                        payload = json.dumps(
                            {"step": snap.step, "entries": entries}
                        ).encode()
                    f.write(str(len(payload)).encode() + b"\n" + payload)
                    f.flush()
                elif line.startswith("FETCHN "):
                    n = int(line[7:])
                    if not (0 <= n <= _MAX_BATCH):
                        return
                    wanted = [_read_line(f) for _ in range(n)]
                    for entry in wanted:
                        self._send_piece(conn, f, self._lookup(snap, entry))
                    f.flush()
                elif line.startswith("FETCH "):
                    self._send_piece(conn, f, self._lookup(snap, line[6:]))
                    f.flush()
                else:
                    return
        except (OSError, ValueError):
            pass  # peer went away mid-request: its restore retries elsewhere
        finally:
            with self._active_lock:
                self._active -= 1
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _lookup(snap: Optional[LocalSnapshot], entry: str):
        if snap is None:
            return None
        key, off, shape = _parse_piece_key(entry)
        for o, arr in snap.pieces.get(key, ()):
            if o == off and tuple(arr.shape) == shape:
                return arr
        return None


class _Conn:
    """One pooled client connection: connect-on-demand, AUTH handshake,
    pipelined FETCHN, reconnect-once retry."""

    def __init__(self, addr: str, token: Optional[str]):
        self.addr = addr
        self.token = token
        self.lock = threading.Lock()
        self.sock = None
        self.file = None

    def _connect_locked(self) -> None:
        """Open + AUTH the socket; ``self.lock`` must be held."""
        host, port = self.addr.rsplit(":", 1)
        self.sock = socket.create_connection(
            (host, int(port)), timeout=_IO_TIMEOUT_S
        )
        self.sock.settimeout(_IO_TIMEOUT_S)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.file = self.sock.makefile("rwb")
        if self.token is not None:
            self.file.write(b"AUTH " + self.token.encode() + b"\n")
            self.file.flush()
            if _read_line(self.file) != "OK":
                raise OSError(f"peer {self.addr} rejected auth")

    def _close_locked(self) -> None:
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = self.file = None

    def close(self) -> None:
        """Public close takes the lock: a teardown racing an in-flight
        ``fetch_batch`` on another thread must not None the file out
        from under a read (it waits for the current batch instead)."""
        with self.lock:
            self._close_locked()

    def fetch_batch(
        self, entries: Sequence[str], dtypes: Dict[str, str]
    ) -> Dict[str, np.ndarray]:
        """Pipelined batch fetch: one FETCHN request, then K payloads
        read back-to-back into preallocated buffers (the arrays are
        views over those buffers — no copy)."""
        out: Dict[str, np.ndarray] = {}
        with self.lock:
            for attempt in (0, 1):  # one reconnect per batch
                try:
                    if self.sock is None:
                        self._connect_locked()
                    req = (f"FETCHN {len(entries)}\n" + "".join(
                        e + "\n" for e in entries
                    )).encode()
                    self.file.write(req)
                    self.file.flush()
                    missing = []
                    for entry in entries:
                        line = self.file.readline()
                        if not line:
                            # server idled out the connection between
                            # batches (30s I/O timeout): clean EOF —
                            # reconnect path, not a parse error
                            raise OSError("peer closed connection")
                        n = int(line)
                        if n < 0:
                            # keep READING the remaining frames: raising
                            # mid-stream would leave unread payloads on
                            # the wire, and the next batch on this
                            # pooled connection would read a stale frame
                            # as its own response
                            missing.append(entry)
                            continue
                        _, _, shape = _parse_piece_key(entry)
                        # receive straight into the final array —
                        # np.empty skips the zeroing pass a bytearray
                        # would pay on multi-MB pieces
                        arr = np.empty(shape, storage_dtype(dtypes[entry]))
                        if arr.nbytes != n:
                            raise ValueError(
                                f"piece {entry}: {n} bytes vs "
                                f"expected {arr.nbytes}"
                            )
                        _read_into(
                            self.file,
                            memoryview(arr).cast("B", (n,))
                            if n
                            else memoryview(b""),
                        )
                        out[entry] = arr
                    if missing:
                        raise KeyError(
                            f"peer {self.addr} lost pieces {missing[:3]}"
                            + ("..." if len(missing) > 3 else "")
                        )
                    return out
                except (OSError, ValueError):
                    self._close_locked()  # self.lock already held here
                    out.clear()
                    if attempt:
                        raise
        raise OSError(f"unreachable peer {self.addr}")  # pragma: no cover


def fetch_index(
    addr: str, timeout_s: float = 2.0, token: Optional[str] = None
) -> Optional[Tuple[int, Dict[str, str]]]:
    """(step, {entry: dtype}) served by a peer, or None if unreachable —
    a dead/departed peer is an expected outcome, not an error."""
    host, port = addr.rsplit(":", 1)
    try:
        conn = socket.create_connection((host, int(port)), timeout=timeout_s)
    except OSError:
        return None
    try:
        conn.settimeout(_IO_TIMEOUT_S)
        f = conn.makefile("rwb")
        if token is not None:
            f.write(b"AUTH " + token.encode() + b"\n")
            f.flush()
            if _read_line(f) != "OK":
                return None
        f.write(b"INDEX\n")
        f.flush()
        n = int(_read_line(f))
        doc = json.loads(bytes(_read_exact(f, n)).decode())
        return int(doc["step"]), dict(doc["entries"])
    except (OSError, ValueError, KeyError):
        return None
    finally:
        try:
            conn.close()
        except OSError:
            pass


class RemotePieces:
    """Piece source over one peer's ShardServer, shaped for
    ``checkpoint._PieceIndex``: ``src[entry]`` returns that piece's
    ndarray, and :meth:`get_many` drains a batch through the connection
    pool — ``nconn`` sockets fetched by parallel threads, each request
    pipelined (``FETCHN``). The checkpoint prefetch pass calls
    ``get_many`` with everything a restore needs from this peer, so
    ``src[entry]`` during assembly is a cache hit. A fetch failure
    raises — the restore's coverage check then surfaces it instead of
    silently assembling a hole."""

    def __init__(
        self,
        addr: str,
        entries: Dict[str, str],
        token: Optional[str] = None,
        nconn: Optional[int] = None,
    ):
        self.addr = addr
        self._dtypes = entries
        self._conns = [
            _Conn(addr, token) for _ in range(nconn or _default_conns())
        ]
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_lock = threading.Lock()

    def entries(self):
        return self._dtypes.keys()

    def fetched_bytes(self) -> int:
        """Bytes of the pieces fetched so far (the cache)."""
        with self._cache_lock:
            return sum(int(a.nbytes) for a in self._cache.values())

    def close(self) -> None:
        for c in self._conns:
            c.close()
        with self._cache_lock:
            self._cache.clear()

    def get_many(self, entries: Iterable[str]) -> Dict[str, np.ndarray]:
        """Fetch a batch, striped round-robin across the connection
        pool and fetched concurrently; results land in the cache and
        are returned. Raises if any stripe ultimately fails."""
        entries = list(entries)  # may be a generator: iterated twice
        with self._cache_lock:
            want = [
                e for e in dict.fromkeys(entries) if e not in self._cache
            ]
        if want:
            nconn = min(len(self._conns), len(want))
            # greedy byte-balanced striping (largest first): piece sizes
            # are known from the entry geometry, and real snapshots mix
            # multi-MB matmul shards with KB-scale vectors — round-robin
            # would leave stripes idle while one drains the big pieces
            def nbytes(e: str) -> int:
                _, _, shape = _parse_piece_key(e)
                return int(
                    np.prod(shape, dtype=np.int64)
                    * storage_dtype(self._dtypes[e]).itemsize
                    if shape
                    else storage_dtype(self._dtypes[e]).itemsize
                )

            stripes: List[List[str]] = [[] for _ in range(nconn)]
            loads = [0] * nconn
            for e in sorted(want, key=nbytes, reverse=True):
                i = loads.index(min(loads))
                stripes[i].append(e)
                loads[i] += nbytes(e)
            errs: List[BaseException] = []
            results: List[Dict[str, np.ndarray]] = []

            def run(conn: _Conn, batch: List[str]) -> None:
                try:
                    results.append(conn.fetch_batch(batch, self._dtypes))
                except BaseException as e:  # surfaced to the caller
                    errs.append(e)

            if nconn == 1:
                run(self._conns[0], stripes[0])
            else:
                threads = [
                    threading.Thread(
                        target=run, args=(c, s), daemon=True
                    )
                    for c, s in zip(self._conns, stripes)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            # cache the stripes that DID land before surfacing any
            # failure: a retry (or lazy assembly) must not refetch
            # multi-MB pieces this call already transferred
            with self._cache_lock:
                for r in results:
                    self._cache.update(r)
            if errs:
                raise errs[0]
        with self._cache_lock:
            return {e: self._cache[e] for e in entries}

    def __getitem__(self, entry: str) -> np.ndarray:
        with self._cache_lock:
            hit = self._cache.get(entry)
        if hit is not None:
            return hit
        return self.get_many([entry])[entry]
