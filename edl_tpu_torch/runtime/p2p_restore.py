"""P2P restore plane — the worker-side brokering of the shard server:
the port of ``edl_tpu/runtime/p2p_restore.py``.

The transfer mechanics live in ``runtime/shard_server.py`` (serve /
probe / fetch) and the assembly in ``runtime/checkpoint.py``
(``load_from_pieces``). This module is the protocol between them, from
the elastic worker's point of view:

- one :class:`P2PRestorePlane` per worker process: starts the shard
  server over the worker's live RAM snapshot, establishes the per-job
  auth token in coordinator KV, publishes this worker's address;
- rank 0 maintains the job's server roster (single writer per epoch)
  and decides each epoch's restore source: the NEWEST step whose pieces
  (peers ∪ own RAM) tile the full state — geometric coverage,
  ``checkpoint.peer_coverage_ok`` — and is no older than the committed
  manifest; the decision is published for every restorer to follow and
  recorded under ``restore_last`` (``p2p:<step>`` or ``none``);
- a worker that fails ASSEMBLING a decided step vetoes it (one KV key
  per step — blind, raceless writes) so the regroup's next decision
  falls through to the manifest instead of re-picking a doomed step;
- a departing worker lingers serving its snapshot until the new world
  confirms a restored step covering it (bounded by ``p2p_linger_s``,
  extended while a peer is mid-fetch) — the drain window of a
  migration to a disjoint worker set.

Epoch-scoped KV writes (the restore decision) route through the
worker's :class:`~edl_tpu_torch.runtime.epoch_gc.EpochKeyGC` ledger
with ``defer_late``: same-epoch peers still poll them after rank 0's
own drain point.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("p2p")

_POLL_S = 0.02
_VETO_TTL_EPOCHS = 4


def _veto_active(raw: Optional[str], epoch: int) -> bool:
    """Whether a per-step p2p veto KV value (the epoch it was written)
    is still in force. One key PER STEP, written blindly on failure:
    writes for different steps never race each other, so no veto can be
    lost to a read-modify-write interleaving (a single set-valued key
    would let a straggler's stale write resurrect a doomed step).
    Malformed values read as expired rather than wedging the decision."""
    if not raw:
        return False
    try:
        return epoch - int(raw) <= _VETO_TTL_EPOCHS
    except ValueError:
        return False


class P2PRestorePlane:
    """Worker-side P2P brokering: server lifecycle, roster, restore
    decision, veto, linger. ``key_fn`` is the worker's job-scoped KV
    key builder; ``get_snapshot`` returns the worker's CURRENT host-RAM
    snapshot (the server follows it across reshards); ``gc`` is the
    worker's epoch-key ledger."""

    def __init__(
        self,
        cfg,
        key_fn: Callable[..., str],
        gc,
        get_snapshot: Callable[[], Any],
    ):
        self.cfg = cfg
        self._k = key_fn
        self._gc = gc
        self._get_snapshot = get_snapshot
        self.server = None
        self.token: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, client) -> None:
        """Start serving our snapshot and publish address + per-job
        token (the weight plane is gated by 'can read the job KV', not
        'can reach the port'). First worker to look writes the token;
        everyone converges on the KV value (re-read after write — last
        write wins for all)."""
        if not self.cfg.p2p:
            return
        from edl_tpu_torch.runtime.shard_server import ShardServer

        tok = client.kv_get(self._k("p2p_token"))
        if not tok:
            import secrets

            client.kv_put(self._k("p2p_token"), secrets.token_hex(16))
            tok = client.kv_get(self._k("p2p_token"))
        # written once at bring-up before any probe/server thread can
        # read it (start() precedes roster publication); immutable after
        # edl: no-lint[lockset-race]
        self.token = tok
        self.server = ShardServer(
            self._get_snapshot,
            check_token=lambda t: bool(t) and t == self.token,
        )
        client.kv_put(
            self._k("shardsrv", self.cfg.worker_id),
            f"{os.environ.get('EDL_HOST_ADDR', '127.0.0.1')}:"
            f"{self.server.port}",
        )

    # -- roster + probing ----------------------------------------------------

    def merge_roster(self, cl, members) -> list:
        """Rank 0 unions the current members into the job's shard-server
        roster (single writer per epoch: no read-modify-write races).
        Departed workers stay listed while recent — exactly the window
        in which a migration needs to find their lingering servers —
        and age out of the 16-name cap."""
        names = json.loads(cl.kv_get(self._k("shardsrv_names")) or "[]")
        for m in members:
            if m.name in names:
                names.remove(m.name)  # refresh recency
            names.append(m.name)
        # cap covers every CURRENT member (they sit at the tail, so the
        # cap can never age out a live worker's only addr publication)
        cap = max(16, len(members))
        for dropped in names[:-cap]:  # GC aged-out workers' addr keys
            cl.kv_del(self._k("shardsrv", dropped))
        names = names[-cap:]
        cl.kv_put(self._k("shardsrv_names"), json.dumps(names))
        return names

    def probe_peers(self, cl) -> Dict[str, Any]:
        """{name: (addr, step, entries)} for every reachable shard
        server on the roster except our own. Probes run in parallel —
        dead entries cost one bounded connect timeout, not a serial
        scan."""
        from edl_tpu_torch.runtime.shard_server import fetch_index

        names = json.loads(cl.kv_get(self._k("shardsrv_names")) or "[]")
        out: Dict[str, Any] = {}
        lock = threading.Lock()

        def probe(name, addr):
            got = fetch_index(addr, timeout_s=1.0, token=self.token)
            if got is not None and got[0] >= 0:
                with lock:
                    out[name] = (addr, got[0], got[1])

        threads = []
        for name in names:
            if name == self.cfg.worker_id:
                continue
            addr = cl.kv_get(self._k("shardsrv", name))
            if not addr:
                continue
            t = threading.Thread(target=probe, args=(name, addr), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(5.0)
        with lock:
            # a straggler thread (slow peer past the bounded join) must
            # not mutate the dict the caller is iterating
            return dict(out)

    # -- the restore ---------------------------------------------------------

    def restore(
        self, cl, epoch, rank, members, like, tx, manifest,
        ram_snapshot, device=None,
    ):
        """Restore from peers' RAM snapshots over the drain window.
        Rank 0 probes the roster, picks the NEWEST step whose pieces
        (peers + its own RAM) tile the full state (``like``, a
        :func:`~edl_tpu_torch.runtime.checkpoint.template_state`) and
        is at least as new as the committed manifest, and publishes the
        decision; everyone assembles that step as a state of ``tx``'s
        optimizer on ``device`` from own RAM + manifest (same step) +
        peer pieces (prefetched in one parallel pass). Returns None
        when the decision is to use disk/fresh (callers fall through)."""
        from edl_tpu_torch.runtime import checkpoint as ckpt
        from edl_tpu_torch.runtime.shard_server import RemotePieces

        # converge on the job token (a cold-start write race can leave
        # an early worker holding the losing value; KV is the truth)
        self.token = cl.kv_get(self._k("p2p_token")) or self.token
        dkey = self._k("restore", str(epoch))
        peers = None
        if rank == 0:
            self.merge_roster(cl, members)
            peers = self.probe_peers(cl)
            own = ram_snapshot
            m_step = int(manifest["step"]) if manifest is not None else -1
            cand = sorted(
                {s for (_, s, _) in peers.values()}
                | ({own.step} if own is not None else set()),
                reverse=True,
            )
            decision = "none"
            for s in cand:
                if s < m_step:
                    break  # never restore older than the committed truth
                # a worker that failed ASSEMBLING step s vetoed it
                # (peer advertised pieces but fetches failed) —
                # otherwise a deterministic decision re-picks the
                # doomed step every regroup until the failure abort,
                # even though the manifest fallback was available. NO
                # GC delete of expired veto keys: a read-then-delete
                # could race a straggler's fresh blind write;
                # boundedness comes from rarity.
                if _veto_active(
                    cl.kv_get(self._k("p2p_veto", str(s))), epoch
                ):
                    continue
                entries = [
                    e
                    for (_, ps, es) in peers.values()
                    if ps == s
                    for e in es
                ]
                if own is not None and own.step == s:
                    entries += [
                        ckpt._piece_key(k, o, tuple(a.shape))
                        for k, plist in own.pieces.items()
                        for o, a in plist
                    ]
                if ckpt.peer_coverage_ok(like, entries):
                    decision = f"p2p:{s}"
                    break
            cl.kv_put(dkey, decision)
        else:
            deadline = time.monotonic() + self.cfg.rendezvous_timeout_s
            rank0 = next((m.name for m in members if m.rank == 0), None)
            decision = cl.kv_get(dkey)
            while decision is None:
                # bail fast instead of burning the whole rendezvous
                # timeout: a DEAD rank 0 can never publish (same rule
                # as _await_go), and an epoch bump means the group is
                # regrouping anyway — unlike a step verb, an unpublished
                # RESTORE decision cannot have a collective in flight,
                # so abandoning it strands nobody
                cl.expire()
                if rank0 not in {m.name for m in cl.members()}:
                    raise RuntimeError(
                        "rank-0 worker died before the restore decision"
                    )
                if cl.epoch() != epoch:
                    raise RuntimeError(
                        "membership moved before the restore decision"
                    )
                if time.monotonic() > deadline:
                    raise TimeoutError("no restore decision from rank 0")
                time.sleep(_POLL_S)
                decision = cl.kv_get(dkey)
        # GC one epoch LATE (defer_late): rank 0 reaches the next GC
        # point while same-epoch peers may still be polling this key —
        # deleting it now would strand them for the full timeout
        self._gc.defer_late(dkey)
        # observability (tests/monitor): how the LAST restore happened
        if rank == 0:
            cl.kv_put(self._k("restore_last"), decision)
        if not decision.startswith("p2p:"):
            return None
        step = int(decision[4:])
        if peers is None:
            peers = self.probe_peers(cl)
        remotes = [
            RemotePieces(addr, entries, token=self.token)
            for (addr, s, entries) in peers.values()
            if s == step
        ]
        t0 = time.perf_counter()
        try:
            state = ckpt.load_from_pieces(
                step, like, tx,
                ram=ram_snapshot,
                manifest=manifest,
                remotes=remotes,
                device=device,
            )
        except Exception:
            # veto this step so the regroup's next decision falls
            # through to the manifest instead of re-picking it (the
            # veto key is NOT epoch-scoped: it must outlive this epoch;
            # one key per step — a blind, raceless write)
            try:
                cl.kv_put(self._k("p2p_veto", str(step)), str(epoch))
            except Exception as ve:
                # a lost veto means the regroup may re-pick this dead
                # step — loud, not silent
                log.warn(
                    "p2p veto publish failed; regroup may retry step",
                    step=step, error=str(ve),
                )
            raise
        finally:
            fetched = sum(r.fetched_bytes() for r in remotes)
            for r in remotes:
                r.close()
        log.info("restored via p2p", step=step, peers=len(remotes),
                 fetched_bytes=fetched, load_s=time.perf_counter() - t0)
        return state

    # -- drain-window linger -------------------------------------------------

    def linger(self, cl) -> None:
        """Drain-window P2P: after deregistering (so the new epoch can
        form), keep the process alive serving our RAM snapshot until the
        new world confirms it restored a step >= ours — the data plane
        of a migration to a disjoint worker set. Bounded by
        p2p_linger_s, extended while a peer is actively fetching."""
        snap = self._get_snapshot()
        srv = self.server
        if not self.cfg.p2p or snap is None or srv is None:
            return
        deadline = time.monotonic() + self.cfg.p2p_linger_s
        while True:
            try:
                restored = int(cl.kv_get(self._k("restored_step")) or "-1")
            except Exception as e:
                # coordinator gone: the job is over — but exiting the
                # drain window mid-migration is worth one warn line on
                # the timeline
                log.warn("coordinator unreachable during p2p linger; "
                         "departing", error=str(e))
                return
            if restored >= snap.step:
                return
            if time.monotonic() > deadline and srv.active == 0:
                log.warn(
                    "departing without restore confirmation",
                    snapshot_step=snap.step,
                    restored_step=restored,
                )
                return
            time.sleep(0.1)
