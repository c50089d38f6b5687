"""Elastic multi-process worker program — the port of
``edl_tpu/runtime/worker_main.py`` for dp meshes: real worker processes,
zero restarts.

Each worker is an OS process driving one device (the card, or the CPU
with ``EDL_LOCAL_DEVICES=1``); peers are discovered through the job
coordinator (runtime/coordinator.py, the etcd/master analog; reference
docker/paddle_k8s:14-32), and data comes from the coordinator's task
queue (reference: cloud_reader + master task queue,
example/fit_a_line/train_ft.py:105-114).

Lifecycle, per membership epoch:

  1. rendezvous: wait until the coordinator's member list is stable,
     take the deterministic rank;
  2. the rank-0 member spawns the epoch's store host
     (runtime/dist_service.py — outside the workers so leader death is
     survivable), whose endpoint is published in coordinator KV; every
     worker joins the epoch's gloo process group as a pure client
     (world = live members);
  3. restore the train state — from peers' RAM snapshots over the p2p
     shard plane (runtime/p2p_restore.py: rank 0 decides the newest
     step the peers' and its own pieces tile, records it under
     ``restore_last``), else from the committed sharded checkpoint
     (its RAM pieces when the step matches), else from this worker's
     complete RAM snapshot, else fresh init (job start); rank 0
     collects every member's restore mark, which releases lingering
     leavers;
  4. lockstep training: every step the rank-0 worker publishes ONE
     decision — ``step`` / ``ckpt`` / ``reshard`` / ``stop`` — in KV
     and all workers obey it, so nobody leaves a peer stranded inside
     an all-reduce. Tasks are leased per step and acked after the
     optimizer update; a rank without a task replays its last batch
     with ``_w = 0``, which adds no gradient (the step is the global
     weighted mean, train/trainer.py ``_mesh_update``);
  5. on ``reshard``: snapshot to host RAM, commit the sharded checkpoint
     (the commit leader refuses it unless every member's param digest
     agrees), destroy the process group, and loop back to (1) — the
     process never restarts.

Scale-up: the launcher starts another worker process; its registration
bumps the membership epoch, rank 0 notices and publishes ``reshard``.
Scale-down: SIGTERM; the worker sets a leaving flag but KEEPS stepping
until rank 0 publishes ``reshard`` (graceful drain), then deregisters,
lingers serving its RAM snapshot to the new world (bounded by
``p2p_linger_s``) and exits 0 — so a job can move to a disjoint set of
workers without reading its checkpoint back from storage. Crash: a
failed all-reduce raises before the optimizer touches anything, so the
survivors hold the last completed step; they
nack their task, persist that state solo when it is newer than the last
commit, wait for the coordinator to reap the dead peer, and regroup.

Each worker serves its current RAM snapshot from one shard server
(``EDL_P2P=1``, the default, as the reference's; ``EDL_P2P=0`` turns
the plane off and every restore reads the commit). Under dp each
worker holds whole leaves, so one peer's pieces tile the state.

Telemetry: every ``EDL_METRICS_PUSH_S`` seconds a worker pushes its
registry snapshot, flight-recorder window, the spans recorded since
its push before last (at least the newest 128) and clock estimate into the coordinator's KV, which the
coordinator process (runtime/coordinator_main.py) serves as the fleet's
``/metrics``, ``/events`` and ``/trace``. Each step runs under the
derived ``("step", job, epoch, i)`` root and each regroup's restore
under ``("reshard", epoch)``, so ``trace --step`` and ``trace
--reshard-epoch`` select them across workers.

Not ported yet: meshes other than dp and several devices a process
(ROADMAP Queue A item 2h, of item 2b's second half) raise at start.

Run as ``python -m edl_tpu_torch.runtime.worker_main`` with the EDL_*
env contract (``WorkerConfig.from_env``).
"""

from __future__ import annotations

import hashlib
import os
import signal
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from edl_tpu_torch.obs import disttrace
from edl_tpu_torch.runtime import entrypoint
from edl_tpu_torch.runtime.coordinator import CoordinatorClient
from edl_tpu_torch.runtime.worker_config import WorkerConfig
from edl_tpu_torch.utils import tracing
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("worker")

_POLL_S = 0.02
_T_MAIN = time.time()  # the boot's first stamp: this module's import
# log a digest of the state each p2p restore brings up and each leaver
# serves (its cost is a hash of the whole state, so only on request)
_DIGESTS = os.environ.get("EDL_P2P_DIGEST", "0") == "1"


def _emit_worker_event(kind: str, worker: str, severity: str = "info",
                       **attrs):
    """Flight-recorder emit keyed by worker. Telemetry never takes the
    worker down."""
    try:
        from edl_tpu_torch.obs import events

        events.emit(kind, severity, worker=worker, **attrs)
    except Exception as e:  # noqa: BLE001 - telemetry boundary
        log.debug("event emit failed", kind=kind, error=str(e))


def _shutdown_distributed() -> None:
    """Destroy the epoch's process group, tolerating a dead peer (and a
    hung teardown: bounded by a thread join)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    done = threading.Event()

    def _go():
        try:
            dist.destroy_process_group()
        except (RuntimeError, ValueError) as e:
            log.warn("distributed shutdown error", error=str(e))
        finally:
            done.set()

    threading.Thread(target=_go, daemon=True).start()
    if not done.wait(timeout=15):
        log.warn("distributed shutdown timed out")


def _param_digest(snap) -> str:
    """Digest of a snapshot's params: replicas of a dp step are
    bit-identical, so every member of a commit publishes the same one."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(snap.pieces):
        if key.startswith("p:"):
            for _, arr in snap.pieces[key]:
                h.update(np.ascontiguousarray(arr).view(np.uint8))
    return h.hexdigest()


def _state_digest(snap) -> str:
    """Digest of every piece of a snapshot (params, moments, steps)."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(snap.pieces):
        h.update(key.encode())
        for _, arr in snap.pieces[key]:
            h.update(np.ascontiguousarray(arr).view(np.uint8))
    return h.hexdigest()


def _snap_bytes(snap) -> int:
    return sum(a.nbytes for ps in snap.pieces.values() for _, a in ps)


class ElasticWorker:
    def __init__(self, cfg: WorkerConfig):
        from edl_tpu_torch.runtime.epoch_gc import EpochKeyGC
        from edl_tpu_torch.runtime.eval_hook import ExportEvaluator
        from edl_tpu_torch.runtime.p2p_restore import P2PRestorePlane

        self.cfg = cfg
        self.client = CoordinatorClient(cfg.coord_host, cfg.coord_port, 30.0)
        self._leaving = False
        self._ram_snapshot = None  # checkpoint.LocalSnapshot
        self._pending_commit: Optional[threading.Thread] = None
        self._last_local: Optional[Dict[str, np.ndarray]] = None
        self._resharded = 0
        self._local_rows = 0
        self._model_meta = None
        self._device = None
        self._gc = EpochKeyGC()
        # p2p shard plane brokering (server lifecycle, roster, restore
        # decision, veto, drain-window linger): runtime/p2p_restore.py
        self._p2p = P2PRestorePlane(cfg, self._k, self._gc,
                                    lambda: self._ram_snapshot)
        self._like = None  # the state's structure template (meta device)
        self._restored_from = None  # how the last restore happened
        self._eval = ExportEvaluator(cfg, self._k)
        self._incarnation = 0
        self._restore_failures = 0
        self._exporter = None
        self._pusher = None
        self._hb_degraded = False
        self._flops_per_example = None

    # -- keys ----------------------------------------------------------------
    def _k(self, *parts: str) -> str:
        return "/".join((self.cfg.job,) + parts)

    # -- telemetry -------------------------------------------------------------
    def _telemetry_start(self) -> None:
        """The process registry (core catalog + tracer bridge), the
        flight recorder's worker context, the clock offset against the
        coordinator, the optional exporter and the periodic push into
        coordinator KV. Telemetry failures degrade to warnings."""
        from edl_tpu_torch import obs
        from edl_tpu_torch.obs import fleet

        cfg = self.cfg
        obs.ensure_core_series()
        obs.bridge_tracer()
        obs.events.default_recorder().set_context(worker=cfg.worker_id)
        self._clock = disttrace.ClockSync()
        clock_kv = fleet.clock_key(cfg.job, cfg.worker_id)

        def _clock_publish():
            try:
                est = self._clock.maybe_sample(self.client.time)
                if est is not None:
                    self.client.kv_put(clock_kv, est.to_json())
            except ConnectionError as e:
                log.warn("clock sync failed", error=str(e))

        _clock_publish()
        tsdb = None
        if cfg.tsdb_dir:
            from edl_tpu_torch.obs.tsdb import TSDB

            tsdb = TSDB(cfg.tsdb_dir)
        if cfg.metrics_port >= 0:
            try:
                self._exporter = obs.start_exporter(
                    port=cfg.metrics_port, history=tsdb)
                self.client.kv_put(
                    self._k("metrics_addr", cfg.worker_id),
                    f"127.0.0.1:{self._exporter.port}")
            except OSError as e:
                log.warn("metrics exporter failed to bind", error=str(e))
        if cfg.metrics_push_s > 0:
            key = fleet.metrics_key(cfg.job, cfg.worker_id)
            ekey = fleet.events_key(cfg.job, cfg.worker_id)
            tkey = fleet.trace_key(cfg.job, cfg.worker_id)
            self._pusher = fleet.MetricsPusher(
                lambda payload: self.client.kv_put(key, payload),
                interval_s=cfg.metrics_push_s,
                events_publish=lambda p: self.client.kv_put(ekey, p),
                trace_publish=lambda p: self.client.kv_put(tkey, p),
                clock_refresh=_clock_publish,
                tsdb=tsdb,
            ).start()

    def _telemetry_stop(self) -> None:
        if self._pusher is not None:
            self._pusher.stop(final_push=True)
            self._pusher = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    # -- SIGTERM: graceful drain ---------------------------------------------
    def _on_sigterm(self, signum, frame):
        # delivered on the main thread; _leaving is a monotonic flag the
        # beat thread only polls — a stale read costs one extra
        # heartbeat, never correctness
        # edl: no-lint[lockset-race]
        self._leaving = True
        try:
            # separate connection: the main client may be mid-call
            c = CoordinatorClient(self.cfg.coord_host, self.cfg.coord_port,
                                  5.0)
            c.kv_put(self._k("leaving", self.cfg.worker_id), "1")
            c.close()
        except (ConnectionError, OSError) as e:
            # an unpublished mark downgrades the drain to an eviction
            log.warn("could not publish leaving mark", error=str(e))

    # -- rendezvous ----------------------------------------------------------
    def _stable_members(self):
        """Wait until membership is stable (same epoch + members across
        two reads, no pending leavers), then return (epoch, members)."""
        cl = self.client
        deadline = time.monotonic() + self.cfg.rendezvous_timeout_s
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("rendezvous: membership never stabilized")
            cl.expire()
            e1 = cl.epoch()
            ms = cl.members()
            names = [m.name for m in ms]
            if self.cfg.worker_id not in names or not names:
                time.sleep(_POLL_S)
                continue
            if any(cl.kv_get(self._k("leaving", n)) for n in names):
                time.sleep(_POLL_S)  # leaver still deregistering
                continue
            time.sleep(0.1)
            if cl.epoch() == e1 and [m.name for m in cl.members()] == names:
                return e1, ms

    def _spawn_dist_service(self, epoch: int, world: int) -> None:
        """Launch the epoch's store host, detached: it must outlive this
        worker so that rank-0 death cannot take the rendezvous with it."""
        import subprocess

        log.info("store host spawned", epoch=epoch, t=time.time())
        log_dir = os.environ.get("EDL_LOG_DIR", "")
        out = (open(os.path.join(log_dir, f"dist_service_e{epoch}.log"), "ab")
               if log_dir else subprocess.DEVNULL)
        try:
            subprocess.Popen(
                [sys.executable, "-m", "edl_tpu_torch.runtime.dist_service",
                 "--job", self.cfg.job, "--epoch", str(epoch), "--world",
                 str(world), "--coordinator",
                 f"{self.cfg.coord_host}:{self.cfg.coord_port}"],
                stdout=out,
                stderr=subprocess.STDOUT if log_dir else subprocess.DEVNULL,
                start_new_session=True,
            )
        finally:
            if log_dir:
                out.close()  # the child holds the fd

    def _rendezvous(self):
        """Agree on (epoch, rank, world, store endpoint) with all live
        peers; restarts if membership shifts underfoot."""
        cl = self.client
        while True:
            epoch, members = self._stable_members()
            me = next(m for m in members if m.name == self.cfg.worker_id)
            world = len(members)
            key = self._k("dist", str(epoch))
            if me.rank == 0 and cl.kv_get(key) is None:
                self._spawn_dist_service(epoch, world)
            addr = None
            deadline = time.monotonic() + self.cfg.rendezvous_timeout_s
            while addr is None:
                addr = cl.kv_get(key)
                if addr is None:
                    if cl.epoch() != epoch:
                        break  # membership moved: restart rendezvous
                    if time.monotonic() > deadline:
                        raise TimeoutError("rendezvous: no dist endpoint")
                    time.sleep(_POLL_S)
            if addr is None:
                continue
            return epoch, me.rank, world, addr, members

    # -- state placement -----------------------------------------------------
    def _restore_state(self, wl, tx, cl=None, epoch=0, rank=0, members=()):
        """P2P peer pieces (rank-0-brokered decision; newest covered
        step) > committed sharded checkpoint (+RAM pieces when the step
        matches) > complete RAM snapshot (no ckpt dir) > fresh init. All
        processes restore the same step: the decision key / the manifest
        is the agreed truth, so a survivor whose RAM ran ahead rolls back
        with everyone else."""
        import torch

        from edl_tpu_torch.runtime import checkpoint as ckpt
        from edl_tpu_torch.train.trainer import TrainState

        manifest = (ckpt.latest_manifest(self.cfg.ckpt_dir)
                    if self.cfg.ckpt_dir else None)
        if self.cfg.p2p and cl is not None:
            if self._like is None:
                self._like = ckpt.template_state(
                    wl.init_params(torch.device("cpu")), tx)
            state = self._p2p.restore(cl, epoch, rank, members, self._like,
                                      tx, manifest, self._ram_snapshot,
                                      device=self._device)
            if state is not None:
                self._restored_from = f"p2p:{state.step}"
                if _DIGESTS:
                    log.info("p2p state", step=state.step,
                             state_digest=_state_digest(
                                 ckpt.snapshot_local(state)))
                return state
        self._restored_from = "disk" if manifest is not None else (
            "ram" if self._ram_snapshot is not None
            and self._ram_snapshot.is_complete() else "fresh")
        if manifest is not None:
            t0 = time.perf_counter()
            state = ckpt.load_sharded(self.cfg.ckpt_dir, tx,
                                      ram=self._ram_snapshot,
                                      manifest=manifest, device=self._device)
            log.info("restored", step=int(manifest["step"]),
                     from_ram=self._ram_snapshot is not None
                     and self._ram_snapshot.step == manifest["step"],
                     load_s=time.perf_counter() - t0)
            return state
        if self._ram_snapshot is not None and self._ram_snapshot.is_complete():
            return ckpt.restore_local(tx, self._ram_snapshot, self._device)
        return TrainState.create(wl.init_params(self._device), tx)

    def _join_pending_commit(self) -> None:
        """At most ONE background commit is in flight; the next commit,
        a crash rescue, or an epoch teardown serializes behind it."""
        t = self._pending_commit
        if t is None:
            return
        t.join(self.cfg.ckpt_commit_timeout_s + 30)
        if t.is_alive():
            log.error("background checkpoint commit did not finish in time")
        self._pending_commit = None

    def _coordinated_checkpoint(self, cl, epoch, state, rank, members,
                                background=False):
        """Commit the state as a sharded checkpoint: every member writes
        its primary pieces (under dp rank 0 writes them all, the others
        empty files) and posts a mark carrying its param digest; the
        leader (lowest live rank) awaits all marks and commits
        manifest.json last — unless a member died (abort) or the
        digests differ (refused: replicas must be bit-identical).

        ``background=True`` (the periodic "ckpt" verb): the host
        snapshot is taken here; the disk write, the marks and the
        leader's wait and commit run on a writer thread with its own
        coordinator connection. Stop/reshard commits are synchronous."""
        from edl_tpu_torch.runtime import checkpoint as ckpt

        cfg = self.cfg
        self._join_pending_commit()
        t0 = time.perf_counter()
        snap = ckpt.snapshot_local(state, rank)
        snap_s = time.perf_counter() - t0
        self._ram_snapshot = snap
        if not cfg.ckpt_dir:
            return
        if int(cl.kv_get(self._k("ckpt_step")) or "-1") >= snap.step:
            return
        world = len(members)

        def _write(client, own_client: bool) -> None:
            try:
                t_w = time.perf_counter()
                digest = _param_digest(snap)
                alive = {m.name for m in client.members()}
                leader = min((m.rank for m in members if m.name in alive),
                             default=rank)
                own = os.path.join(ckpt.step_dir(cfg.ckpt_dir, snap.step),
                                   ckpt.shard_filename(rank, world))
                if rank != leader and os.path.exists(own):
                    # a background commit of this step already wrote this
                    # rank's file (atomic rename: complete); re-post the mark
                    fname = os.path.basename(own)
                else:
                    fname = ckpt.save_shards(cfg.ckpt_dir, snap, rank, world,
                                             host_leaves=(rank == leader))
                mark = lambda n: self._k(  # noqa: E731
                    "ckmark", str(epoch), str(snap.step), n)
                client.kv_put(mark(cfg.worker_id), f"{fname}|{digest}")
                if rank != leader:
                    # leak guard: a leader that saw the step committed
                    # collects no marks; reclaim ours
                    if (int(client.kv_get(self._k("ckpt_step")) or "-1")
                            >= snap.step):
                        client.kv_del(mark(cfg.worker_id))
                    return
                deadline = time.monotonic() + cfg.ckpt_commit_timeout_s
                got = None
                while time.monotonic() < deadline:
                    client.expire()
                    alive = {m.name for m in client.members()}
                    vals, waiting, dead = [], [], []
                    for m in members:
                        v = client.kv_get(mark(m.name))
                        if v:
                            vals.append(v)
                        elif m.name in alive:
                            waiting.append(m.name)
                        else:
                            dead.append(m.name)
                    if not waiting:
                        got = vals if not dead else None
                        break
                    time.sleep(_POLL_S)
                for m in members:  # marks served their purpose either way
                    client.kv_del(mark(m.name))
                digests = {v.rsplit("|", 1)[1] for v in got or ()}
                if got and len(digests) > 1:
                    n = int(client.kv_get(self._k("digest_mismatches"))
                            or "0") + 1
                    client.kv_put(self._k("digest_mismatches"), str(n))
                    log.error("checkpoint commit refused: replica param "
                              "digests differ", step=snap.step,
                              digests=sorted(digests))
                    got = None
                if got:
                    if len(got) > 1:
                        n = int(client.kv_get(self._k("digests_agreed"))
                                or "0") + 1
                        client.kv_put(self._k("digests_agreed"), str(n))
                    ckpt.write_manifest(cfg.ckpt_dir, snap,
                                        [v.rsplit("|", 1)[0] for v in got],
                                        {"job": cfg.job})
                    # monotonic max-write: a stalled commit thread must
                    # not regress a pointer a later commit advanced
                    cur = int(client.kv_get(self._k("ckpt_step")) or "-1")
                    if snap.step > cur:
                        client.kv_put(self._k("ckpt_step"), str(snap.step))
                    ckpt.gc_step_dirs(cfg.ckpt_dir, keep=2)
                    log.info("commit", step=snap.step, world=world,
                             background=background, snapshot_s=snap_s,
                             write_s=time.perf_counter() - t_w,
                             bytes=_snap_bytes(snap), t=time.time())
                    if cfg.export_dir:
                        self._export(client, snap)
                else:
                    aborts = int(client.kv_get(self._k("ckpt_aborts"))
                                 or "0") + 1
                    client.kv_put(self._k("ckpt_aborts"), str(aborts))
                    log.error("checkpoint commit aborted (peer died, write "
                              "timed out or digests differ)",
                              step=snap.step, aborts=aborts)
            except Exception as e:  # noqa: BLE001 - storage faults
                log.error("checkpoint commit failed", error=str(e))
                try:
                    aborts = int(client.kv_get(self._k("ckpt_aborts"))
                                 or "0") + 1
                    client.kv_put(self._k("ckpt_aborts"), str(aborts))
                except ConnectionError as ce:
                    log.warn("abort count not published", error=str(ce))
                if not own_client:
                    # a synchronous (stop/reshard) commit is never lost
                    # silently
                    raise
            finally:
                if own_client:
                    client.close()

        if not background:
            _write(cl, own_client=False)
            return

        def _bg():
            try:
                client = CoordinatorClient(cfg.coord_host, cfg.coord_port,
                                           10.0)
            except OSError as e:
                log.error("background commit could not reach coordinator",
                          error=str(e))
                return
            _write(client, own_client=True)

        t = threading.Thread(target=_bg, name="edl-ckpt-commit", daemon=True)
        t.start()
        self._pending_commit = t

    def _export(self, client, snap) -> None:
        """The servable params-only artifact of a commit (reference
        save_inference_model cadence, example/ctr/ctr/train.py:169-180),
        then the held-out eval of it."""
        from edl_tpu_torch.runtime import export as exp

        try:
            d = exp.export_from_checkpoint(
                self.cfg.ckpt_dir, self.cfg.export_dir,
                dtype=self.cfg.export_dtype, ram=snap,
                model_meta=self._model_meta)
        except (OSError, ValueError) as e:
            log.error("export failed", error=str(e))
            return
        if d:
            log.info("export published", dir=d, step=snap.step)
            self._eval.evaluate(client, snap.step)

    def _crash_checkpoint(self, cl, snap, rank, world) -> None:
        """After a failed collective any survivor may be the only one
        left. Under dp every survivor holds the COMPLETE state, so it
        persists it solo if newer than the last commit (atomic manifest
        rename; lockstep peers write identical content)."""
        from edl_tpu_torch.runtime import checkpoint as ckpt

        if not self.cfg.ckpt_dir:
            return
        self._join_pending_commit()
        known = int(cl.kv_get(self._k("ckpt_step")) or "-1")
        if snap.step <= known or not snap.is_complete():
            return
        t0 = time.perf_counter()
        fname = ckpt.save_shards(self.cfg.ckpt_dir, snap, rank, world,
                                 host_leaves=True, all_pieces=True)
        ckpt.write_manifest(self.cfg.ckpt_dir, snap, [fname],
                            {"job": self.cfg.job})
        cl.kv_put(self._k("ckpt_step"), str(snap.step))
        log.info("crash commit", step=snap.step, world=world,
                 write_s=time.perf_counter() - t0, bytes=_snap_bytes(snap),
                 t=time.time())

    # -- the run -------------------------------------------------------------
    def run(self) -> int:
        cfg = self.cfg
        from edl_tpu_torch.parallel.mesh import check_dp_only

        check_dp_only(cfg.mesh)
        import torch  # the boot's import stage

        from edl_tpu_torch.parallel.mesh import process_device
        from edl_tpu_torch.runtime.workloads import WORKLOADS
        from edl_tpu_torch.train import trainer

        t_imports = time.time()
        self._device = process_device(cfg.local_devices)
        tx = trainer.adam(1e-2 if cfg.model == "linreg" else 1e-3)
        # what a first restore would otherwise pay inside the group's
        # regroup comes up before this worker registers: the CUDA context
        # and cuBLAS, and torch.optim's first optimizer (it imports
        # torch._dynamo: 2 s here, longer on a loaded host)
        x = torch.ones(8, 8, device=self._device, requires_grad=True)
        tx.init({"x": x})
        float((x @ x).sum())
        t_device = time.time()
        self._eval.device = self._device
        wl = WORKLOADS[cfg.model](cfg)
        self._model_meta = wl.model_meta
        self._eval.eval_fn = wl.eval_fn
        self._flops_per_example = wl.flops_per_example
        if cfg.eval_dir and wl.eval_fn is None:
            log.warn("EDL_EVAL_DIR set but workload defines no eval_fn; "
                     "no eval_metric will be published", model=cfg.model)
        if cfg.data_dir:
            from edl_tpu_torch.runtime.shards import FileShardSource

            source = FileShardSource(cfg.data_dir)
            wl.batch_fn = source.fetch_range
            cfg.n_samples = source.n_samples
            log.info("dataset attached", dir=cfg.data_dir,
                     n_samples=cfg.n_samples)

        if self._leaving:  # SIGTERM during startup: never joined
            return 0
        # serve our host-RAM snapshot to peers (the p2p reshard data
        # plane), published before registration
        self._p2p.start(self.client)
        ctx = entrypoint.bootstrap(self.client)
        self._incarnation = ctx.incarnation
        log.info("boot", worker=cfg.worker_id, main=_T_MAIN,
                 imports=t_imports, device_ready=t_device,
                 registered=time.time(), device=str(self._device))
        heartbeat_stop = self._start_heartbeat(ctx.incarnation)
        self._telemetry_start()
        try:
            return self._epochs(cfg, wl, tx)
        except Exception as e:
            entrypoint.record_failure(self.client, cfg.job, f"exception: {e}")
            raise
        finally:
            heartbeat_stop.set()
            self._telemetry_stop()

    def _start_heartbeat(self, incarnation: int) -> threading.Event:
        """TTL keep-alive on its own connection (a step may outlast the
        member TTL); re-registers if a missed TTL already evicted us."""
        stop = threading.Event()
        interval = min(0.5, max(0.1, self.cfg.member_ttl_s / 4))

        def _beat():
            c = None
            while not stop.wait(interval):
                c = self._beat_tick(c, incarnation)
            if c is not None:
                c.close()

        threading.Thread(target=_beat, daemon=True).start()
        return stop

    def _beat_tick(self, c, incarnation: int):
        """One heartbeat attempt; returns the (re)usable client or None
        after a failure. Never raises: a failure flips the
        ``edl_worker_heartbeat_degraded`` gauge and retries every tick;
        the first good beat clears it (re-registering if evicted)."""
        from edl_tpu_torch.obs import metrics as obs_metrics

        cfg = self.cfg
        gauge = obs_metrics.default_registry().gauge(
            "edl_worker_heartbeat_degraded",
            "1 while the heartbeat loop cannot reach the coordinator",
        )
        try:
            if c is None:
                c = CoordinatorClient(cfg.coord_host, cfg.coord_port, 5.0)
            if not c.heartbeat(cfg.worker_id) and not self._leaving:
                log.warn("TTL-evicted while alive; re-registering")
                _emit_worker_event("worker.re_register", cfg.worker_id,
                                   severity="warn")
                c.register(cfg.worker_id, incarnation)
            if self._hb_degraded:
                self._hb_degraded = False
                gauge.set(0)
                log.info("heartbeat recovered")
                _emit_worker_event("worker.heartbeat_recovered",
                                   cfg.worker_id)
            return c
        except (ConnectionError, OSError) as e:
            if not self._hb_degraded:
                self._hb_degraded = True
                gauge.set(1)
                log.warn("heartbeat degraded; retrying until departure",
                         error=f"{type(e).__name__}: {e}")
                _emit_worker_event("worker.heartbeat_degraded",
                                   cfg.worker_id, severity="warn",
                                   error=f"{type(e).__name__}: {e}")
            if c is not None:
                c.close()
            return None

    def _epochs(self, cfg, wl, tx) -> int:
        from edl_tpu_torch.parallel.mesh import MeshPlan
        from edl_tpu_torch.train import trainer

        cl = self.client
        init_failures = 0
        while True:
            if self._leaving:
                return self._depart(code=0)
            epoch, rank, world, addr, members = self._rendezvous()
            log.info("epoch up", epoch=epoch, rank=rank, world=world,
                     dist=addr, device=str(self._device),
                     backend=entrypoint.BACKEND, t=time.time())
            _emit_worker_event("worker.join", cfg.worker_id, epoch=epoch,
                               rank=rank, world=world)
            try:
                entrypoint.init_distributed(
                    addr, world, rank,
                    entrypoint.collective_timeout_s(cfg.member_ttl_s))
                init_failures = 0
            except RuntimeError as e:
                # a peer died between rendezvous and connect, or the
                # store host died with membership unchanged: retract the
                # endpoint (only if still current) so the next
                # rendezvous respawns a host instead of spinning on it
                log.warn("distributed init failed; regrouping", error=str(e))
                _shutdown_distributed()
                if cl.kv_get(self._k("dist", str(epoch))) == addr:
                    cl.kv_del(self._k("dist", str(epoch)))
                    cl.kv_put(self._dist_done_key(epoch, addr), "1")
                    self._gc.defer_late(self._dist_done_key(epoch, addr))
                init_failures += 1
                if init_failures >= 5:
                    raise RuntimeError(
                        f"distributed init failed {init_failures}x; giving up"
                    ) from e
                continue
            t_dist = time.time()
            plan = MeshPlan.parse(cfg.mesh, world)
            mesh = plan.build([self._device])
            self._local_rows = cfg.per_device_batch * plan.batch_shards() // world
            try:
                # the regroup's restore under the reshard root every
                # member derives alike (``trace --reshard-epoch E``)
                with disttrace.root("reshard", epoch), tracing.span(
                        "worker.restore", reshard_epoch=epoch, rank=rank,
                        world=world, worker=cfg.worker_id):
                    state = self._restore_state(wl, tx, cl=cl, epoch=epoch,
                                                rank=rank, members=members)
            except (OSError, ValueError, KeyError, RuntimeError) as e:
                # a p2p source died between decision and fetch, the
                # decision never came, or a torn read of a checkpoint
                # another epoch is reaping: bump our incarnation so
                # everyone regroups
                self._restore_failures += 1
                log.warn("state restore failed; regrouping", error=str(e),
                         failures=self._restore_failures)
                _shutdown_distributed()
                if self._restore_failures >= 3:
                    raise
                if cl.epoch() == epoch:
                    inc_key = self._k("incarnation", cfg.worker_id)
                    self._incarnation = max(
                        self._incarnation, int(cl.kv_get(inc_key) or "0")) + 1
                    cl.kv_put(inc_key, str(self._incarnation))
                    cl.register(cfg.worker_id, self._incarnation)
                continue
            self._restore_failures = 0
            log.info("restore done", epoch=epoch, step=state.step,
                     dist_s=t_dist, source=self._restored_from,
                     t=time.time())
            rmark = lambda n: self._k("restored", str(epoch), n)  # noqa: E731
            cl.kv_put(rmark(cfg.worker_id), "1")
            self._gc.defer_late(rmark(cfg.worker_id))
            if rank == 0:
                self._confirm_restore(cl, epoch, members, state.step)
            loss_fn = wl.loss_for(plan, mesh)
            step = trainer.make_train_step(loss_fn, tx, plan, mesh,
                                           donate=False,
                                           weight_fn=wl.loss_weight)
            stepper = None
            if cfg.sync_every > 1:
                stepper = trainer.LocalSyncStepper(loss_fn, tx, plan, mesh,
                                                   donate=False)
                state = stepper.localize(state)
            # every member has joined this epoch's group, which it does
            # only after finishing the previous epoch's teardown: nobody
            # reads the previous epoch's keys any more (epoch_gc.py)
            self._gc.drain(cl.kv_del)
            if rank == 0:
                self._ensure_queue(cl)
            outcome = self._train_epoch(cfg, cl, epoch, rank, world, state,
                                        step, wl.batch_fn, members,
                                        stepper=stepper)
            self._teardown_epoch(cl, epoch, rank, members, addr)
            if outcome == "stop":
                return self._finish(rank)
            self._resharded += 1
            # monotonic max-write: a late joiner's small count must not
            # clobber the job-wide one
            if self._resharded > int(cl.kv_get(self._k("reshards")) or "0"):
                cl.kv_put(self._k("reshards"), str(self._resharded))
            if self._leaving:
                return self._depart(code=0)

    def _confirm_restore(self, cl, epoch, members, step) -> None:
        """Rank 0 collects every member's restore mark before advancing
        ``restored_step``."""
        rmark = lambda n: self._k("restored", str(epoch), n)  # noqa: E731
        deadline = time.monotonic() + self.cfg.rendezvous_timeout_s
        while time.monotonic() < deadline:
            cl.expire()
            alive = {m.name for m in cl.members()}
            if all(cl.kv_get(rmark(m.name)) or m.name not in alive
                   for m in members):
                if step > int(cl.kv_get(self._k("restored_step")) or "-1"):
                    cl.kv_put(self._k("restored_step"), str(step))
                return
            if cl.epoch() != epoch:
                return  # a peer died mid-restore: regrouping anyway
            time.sleep(_POLL_S)

    def _ensure_queue(self, cl) -> None:
        cfg = self.cfg
        if not cl.kv_get(self._k("queue_inited")):
            # one task = one process's per-step rows; constant across
            # rescales because the growth axis scales with world
            cl.queue_init(cfg.n_samples, self._local_rows, passes=cfg.passes,
                          lease_timeout_s=cfg.lease_timeout_s)
            cl.kv_put(self._k("queue_inited"), "1")

    @staticmethod
    def _pad_to(batch: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
        """Wrap-pad every leaf's leading dim to exactly ``n`` samples:
        peers contribute identical local shapes every step."""
        have = next(iter(batch.values())).shape[0]
        if have == n:
            return batch
        idx = np.resize(np.arange(have), n)
        return {k: v[idx] for k, v in batch.items()}

    def _local_batch(self, cl, batch_fn):
        """Lease one task; with none for us this step, replay the last
        local batch. Every batch carries real-row weights ``_w`` (1 =
        leased row, 0 = wrap padding / replay / zero filler): filler
        rows keep the shapes aligned and add ZERO gradient. Returns
        (local numpy batch, task id or None)."""
        chunk = self._local_rows
        task = cl.lease(self.cfg.worker_id)
        if task is not None:
            have = task.end - task.start
            local = self._pad_to(batch_fn(task.start, task.end), chunk)
            w = np.zeros(chunk, np.float32)
            w[:have] = 1.0
            local["_w"] = w
            self._last_local = local
            return local, task.task_id
        if self._last_local is not None:
            replay = dict(self._last_local)
            replay["_w"] = np.zeros(chunk, np.float32)
            return replay, None
        probe = self._pad_to(batch_fn(0, min(chunk, self.cfg.n_samples)),
                             chunk)
        zero = {k: np.zeros_like(v) for k, v in probe.items()}
        zero["_w"] = np.zeros(chunk, np.float32)
        return zero, None

    def _train_epoch(self, cfg, cl, epoch, rank, world, state, step,
                     batch_fn, members, stepper=None):
        """Lockstep loop. Returns "stop" | "reshard" with
        ``self._ram_snapshot`` holding the last completed (or, after a
        crash, last committed) step. Logs the epoch's step statistics
        (``epoch stats``) on the way out."""
        import torch

        from edl_tpu_torch.obs import metrics as obs_metrics

        reg = obs_metrics.default_registry()
        h = {
            "step": reg.histogram(
                "edl_train_step_seconds",
                "full step wall time (data + dispatch + sync)"),
            "data": reg.histogram(
                "edl_train_data_wait_seconds",
                "host wait for the next batch (data stall)"),
            "block": reg.histogram(
                "edl_train_host_block_seconds",
                "host blocked on device results (sync stall)"),
        }
        c_examples = reg.counter("edl_train_examples_total",
                                 "training rows consumed")
        g_loss = reg.gauge("edl_train_loss", "most recent training loss")
        eff = None
        if self._flops_per_example:
            from edl_tpu_torch.obs import costmodel

            eff = costmodel.EfficiencyMeter(registry=reg)
        stats = {"steps": 0, "rows": 0, "step_s": 0.0, "allreduce_s": 0.0,
                 "first_t": None, "last_t": None}
        if self._device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self._device)
        go_key = self._k("go", str(epoch))
        try:
            while True:
                i = int(state.step)
                if rank == 0:
                    step_tok = disttrace.enter_root("step", cfg.job, epoch, i)
                    verb = self._decide(cl, epoch, i)
                    with tracing.span("coord.go", step=i, verb=verb):
                        disttrace.publish_ctx(cl.kv_put, go_key, tag=str(i))
                        cl.kv_put(go_key, f"{i}:{verb}")
                else:
                    verb = self._await_go(cl, go_key, i, members)
                    step_tok = disttrace.enter_root("step", cfg.job, epoch, i)
                    rctx = disttrace.fetch_ctx(cl.kv_get, go_key, tag=str(i))
                    if rctx is not None:
                        tracing.tracer().record(
                            "coord.go.recv", time.perf_counter(), 0.0,
                            {"step": i, "verb": verb,
                             **disttrace.link_attrs(rctx)})
                try:
                    verb = self._step_verb(cfg, cl, epoch, rank, world,
                                           members, state, step, stepper,
                                           verb, i, batch_fn, h, c_examples,
                                           g_loss, eff, stats)
                finally:
                    disttrace.exit_root(step_tok)
                if isinstance(verb, tuple):  # (new state,): keep looping
                    state = verb[0]
                    continue
                return verb
        finally:
            peak = (torch.cuda.max_memory_allocated(self._device)
                    if self._device.type == "cuda" else 0)
            log.info("epoch stats", epoch=epoch, rank=rank, world=world,
                     peak_mem_bytes=peak, **stats)

    def _step_verb(self, cfg, cl, epoch, rank, world, members, state, step,
                   stepper, verb, i, batch_fn, h, c_examples, g_loss, eff,
                   stats):
        """One published verb's work, under a ``train.step`` span.
        Returns ``(new_state,)`` to continue or the epoch outcome."""
        from edl_tpu_torch.runtime import checkpoint as ckpt
        from edl_tpu_torch.train.trainer import global_batch

        with tracing.span("train.step", step=i, verb=verb,
                          worker=cfg.worker_id):
            if verb not in ("step", "ckpt"):  # stop | reshard: commit
                self._coordinated_checkpoint(
                    cl, epoch,
                    stepper.merge(state) if stepper is not None else state,
                    rank, members)
                return verb
            t_iter = time.perf_counter()
            local, task_id = self._local_batch(cl, batch_fn)
            batch = global_batch(local, device=self._device)
            h["data"].observe(time.perf_counter() - t_iter)
            try:
                if stepper is not None:
                    new_state, metrics = stepper.step(state, batch)
                    if (i + 1) % cfg.sync_every == 0:
                        new_state = stepper.sync(new_state)
                else:
                    new_state, metrics = step(state, batch)
                t_sync = time.perf_counter()
                loss = float(metrics["loss"])
                h["block"].observe(time.perf_counter() - t_sync)
            except RuntimeError as e:
                # a peer died mid-collective: the optimizer has not
                # touched the state (train/trainer.py _mesh_update)
                log.warn("step failed; recovering", step=i, error=str(e))
                if task_id is not None:
                    cl.nack(task_id)
                if stepper is None:
                    snap = ckpt.snapshot_local(state, rank)
                    self._ram_snapshot = snap
                    self._crash_checkpoint(cl, snap, rank, world)
                else:
                    # the grouped state cannot be merged over a dead
                    # group: roll back to the last (merged) commit
                    log.warn("delayed-sync crash: rolling back to last "
                             "commit")
                self._await_peer_reaped(cl, epoch)
                return "reshard"
            state = new_state
            real = int(local["_w"].sum())
            c_examples.inc(self._local_rows)
            g_loss.set(loss)
            step_wall = time.perf_counter() - t_iter
            h["step"].observe(step_wall)
            now = time.time()
            stats["first_t"] = stats["first_t"] or now
            stats["last_t"] = now
            stats["steps"] += 1
            stats["rows"] += real
            stats["step_s"] += step_wall
            stats["allreduce_s"] += metrics.get("allreduce_s", 0.0)
            if eff is not None:
                from edl_tpu_torch.obs.costmodel import Cost

                eff.observe("train", Cost(
                    self._local_rows * self._flops_per_example, 0.0),
                    step_wall)
            if task_id is not None:
                cl.ack(task_id)
            if cfg.step_sleep_s:
                time.sleep(cfg.step_sleep_s)
            if rank == 0:
                if not cl.kv_get(self._k("loss_first")):
                    cl.kv_put(self._k("loss_first"), repr(loss))
                cl.kv_put(self._k("loss_last"), repr(loss))
                cl.kv_put(self._k("progress"), str(i + 1))
            if verb == "ckpt":  # periodic commit of the NEW state
                self._coordinated_checkpoint(
                    cl, epoch,
                    stepper.merge(state) if stepper is not None else state,
                    rank, members, background=True)
        return (state,)

    def _await_peer_reaped(self, cl, failed_epoch: int) -> None:
        """A collective failed, so some peer is dead but may not have
        TTL-expired yet: wait for the epoch to move, then one extra TTL
        for any other silent deaths."""
        deadline = time.monotonic() + self.cfg.rendezvous_timeout_s
        while cl.epoch() == failed_epoch:
            cl.expire()
            if time.monotonic() > deadline:
                raise TimeoutError("dead peer never reaped")
            time.sleep(0.1)
        time.sleep(self.cfg.member_ttl_s)
        cl.expire()

    def _decide(self, cl, epoch: int, i: int) -> str:
        cl.expire()
        if self._leaving or cl.epoch() != epoch:
            return "reshard"
        ms = cl.members()
        if any(cl.kv_get(self._k("leaving", m.name)) for m in ms):
            return "reshard"
        if cl.queue_done():
            return "stop"
        if (self.cfg.ckpt_every and self.cfg.ckpt_dir
                and (i + 1) % self.cfg.ckpt_every == 0):
            return "ckpt"  # step, then commit the resulting state
        return "step"

    def _await_go(self, cl, go_key: str, i: int, members) -> str:
        """Wait for rank 0's decision for step ``i``. A published
        decision always wins; only with NO decision and rank 0 gone from
        membership is it a reshard (a mere epoch bump is not: rank 0 may
        be about to publish ``step`` and be inside the collective)."""
        deadline = time.monotonic() + self.cfg.rendezvous_timeout_s
        prefix = f"{i}:"
        rank0 = next(m.name for m in members if m.rank == 0)
        while True:
            v = cl.kv_get(go_key)
            if v and v.startswith(prefix):
                return v.split(":", 1)[1]
            cl.expire()
            if rank0 not in {m.name for m in cl.members()}:
                log.warn("rank-0 worker gone; resharding", step=i)
                return "reshard"
            if time.monotonic() > deadline:
                raise TimeoutError(f"no go decision for step {i}")
            time.sleep(_POLL_S)

    def _dist_done_key(self, epoch: int, addr: str) -> str:
        """Dismissal key scoped to one store host's address."""
        return self._k("dist_done", str(epoch), addr.rsplit(":", 1)[1])

    def _teardown_epoch(self, cl, epoch: int, rank: int, members,
                        addr: str) -> None:
        """Ordered teardown of the epoch's process group: the live
        leader (the lowest surviving rank) waits for every other live
        member's disconnect mark, destroys its group last and dismisses
        the store host via ``dist_done``."""
        self._join_pending_commit()
        me = self.cfg.worker_id
        disc = lambda name: self._k("disc", str(epoch), name)  # noqa: E731
        self._gc.defer(self._k("go", str(epoch)), self._k("dist", str(epoch)),
                       *[disc(m.name) for m in members])
        self._gc.defer_late(self._dist_done_key(epoch, addr))
        cl.expire()
        alive = {m.name for m in cl.members()}
        leader = min((m.rank for m in members if m.name in alive),
                     default=rank)
        if rank == leader:
            peers = [m.name for m in members if m.name != me]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                cl.expire()
                live = {m.name for m in cl.members()}
                if all(cl.kv_get(disc(p)) or p not in live for p in peers):
                    break
                time.sleep(_POLL_S)
            _shutdown_distributed()
            cl.kv_put(self._dist_done_key(epoch, addr), "1")
            return
        _shutdown_distributed()
        cl.kv_put(disc(me), "1")

    def _finish(self, rank: int) -> int:
        cl = self.client
        if rank == 0:
            cl.kv_put(self._k("phase"), "succeeded")
        log.info("job complete", worker=self.cfg.worker_id)
        _emit_worker_event("worker.leave", self.cfg.worker_id,
                           reason="complete")
        cl.leave(self.cfg.worker_id)
        cl.release_worker(self.cfg.worker_id)
        return 0

    def _depart(self, code: int) -> int:
        cl = self.client
        log.info("departing (scale-down)", worker=self.cfg.worker_id)
        _emit_worker_event("worker.leave", self.cfg.worker_id,
                           reason="scale-down")
        cl.release_worker(self.cfg.worker_id)
        cl.leave(self.cfg.worker_id)
        cl.kv_del(self._k("leaving", self.cfg.worker_id))
        snap = self._ram_snapshot
        if self.cfg.p2p and snap is not None:
            log.info("lingering", step=snap.step, t=time.time(),
                     **({"state_digest": _state_digest(snap)}
                        if _DIGESTS else {}))
        self._p2p.linger(cl)
        log.info("departed", t=time.time())
        return code


def main(argv=None) -> int:
    import argparse

    # provisional shield: a scale-down SIGTERM before the worker joined
    # is a clean no-op departure; the drain handler replaces it below
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    argparse.ArgumentParser(
        prog="edl-worker",
        description="elastic worker entrypoint of the PyTorch port; "
        "configured via the EDL_* environment contract (EDL_JOB_NAME, "
        "EDL_COORDINATOR, EDL_WORKER_ID, EDL_WORKERS_MIN/MAX, "
        "EDL_LOCAL_DEVICES, EDL_P2P, ...)",
    ).parse_args(argv)
    from edl_tpu_torch.utils.logging import configure

    configure(os.environ.get("EDL_LOG_LEVEL", "info"))
    cfg = WorkerConfig.from_env()
    worker = ElasticWorker(cfg)
    # installed BEFORE the heavy torch import: a scale-down SIGTERM can
    # land while the worker is still starting up
    signal.signal(signal.SIGTERM, worker._on_sigterm)
    try:
        return worker.run()
    except entrypoint.FailureGateError as e:
        log.error("failure gate", error=str(e))
        return 2


if __name__ == "__main__":
    sys.exit(main())
