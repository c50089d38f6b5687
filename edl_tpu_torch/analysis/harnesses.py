"""Schedcheck harnesses: the real hot objects under the deterministic
scheduler.

Each harness is a small closed-world driver for one concurrency-bearing
subsystem — the *production class*, not a model of it — exercised by
2–3 tasks under :mod:`edl_tpu_torch.analysis.sched` with its shared state
instrumented for happens-before detection. Three kinds:

* **clean** harnesses assert the shipped locking discipline is
  race-free across every explored schedule (and that the subsystem's
  own invariants hold at quiescence);
* **mutation** harnesses re-open a since-fixed race by swapping the
  guarding lock for :class:`~edl_tpu_torch.analysis.sched.NullLock` (yields,
  no exclusion, no HB edges) — the regression corpus for the three
  races the lockset rule caught, proving ``schedcheck`` would catch
  them again;
* **expected-race** harnesses witness races the static side already
  knows and deliberately tolerates (the ``kube.py`` ``_rv``/``_stop``
  hand-offs behind a baseline entry and ``no-lint`` suppressions),
  upgrading those entries from "suppressed claim" to CONFIRMED.

:data:`STATIC_XREF` maps harness outcomes back to the static
``lockset-race`` sites so the CLI can print a verdict per finding:
CONFIRMED (a witnessing schedule exists) or UNWITNESSED (explored
budget found none — evidence the guard works, not proof).

The port of ``edl_tpu/analysis/harnesses.py``: the same harnesses over
the port's production classes, and :data:`STATIC_XREF` names the port's
sites; :func:`warm_globals` also imports every harnessed module
(:data:`HARNESSED_MODULES`) before the shim goes up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .sched import (
    ExploreResult,
    NullLock,
    TrackedDict,
    checkpoint,
    instrument,
)

__all__ = ["HARNESSES", "Harness", "STATIC_XREF", "verdicts", "warm_globals"]


def warm_globals() -> None:
    """Create process-global singletons *before* the shim is installed.

    The pusher's failure path calls ``default_registry()`` and the
    log→event bridge touches ``default_recorder()``; if their first
    call happened under the shim, a shim lock would be captured in a
    global and outlive the scheduler. Warmed here, they hold real locks
    — safe under the scheduler because only one task runs between
    yields, so real locks never contend.
    """
    import importlib

    from edl_tpu_torch.obs import events as _events
    from edl_tpu_torch.obs import metrics as _metrics
    from edl_tpu_torch.utils import faults as _faults  # noqa: F401  (module lock)

    # the harnessed modules too: what they import at module level
    # (torch, through runtime.shard_server -> runtime.checkpoint) builds
    # its module-level locks here, with the real primitives, and not
    # inside a harness's first schedule
    for name in HARNESSED_MODULES:
        importlib.import_module(name)
    _metrics.default_registry()
    _events.default_recorder()


#: every module a harness imports, imported by :func:`warm_globals`
HARNESSED_MODULES = (
    "edl_tpu_torch.api.job",
    "edl_tpu_torch.obs.fleet",
    "edl_tpu_torch.controller.controller",
    "edl_tpu_torch.runtime.shard_server",
    "edl_tpu_torch.serving.paged",
    "edl_tpu_torch.obs.metrics",
    "edl_tpu_torch.serving.router",
    "edl_tpu_torch.obs.events",
    "edl_tpu_torch.elasticity.broker",
    "edl_tpu_torch.runtime.lease_table",
    "edl_tpu_torch.cluster.kube",
)


# ---------------------------------------------------------------------------
# Shared stubs
# ---------------------------------------------------------------------------


class _StubRegistry:
    """Minimal registry for MetricsPusher: just enough surface for the
    push path, no lock traffic of its own."""

    def snapshot_json(self) -> str:
        return "{}"


class _FakeWire:
    """File-like stand-in for _Conn's socket file."""

    def __init__(self):
        self.writes: List[bytes] = []

    def write(self, b: bytes) -> None:
        self.writes.append(bytes(b))

    def flush(self) -> None:
        pass


class _FakeSock:
    def close(self) -> None:
        pass


class _NullCluster:
    """Cluster stub with no watch/scale surface: Controller's ctor
    skips event wiring, keeping the harness focused on the updaters
    map discipline."""


class _StubUpdater:
    """JobUpdater stand-in: keeps the controller harness about the
    ``updaters`` map + ``_lock``, not FakeCluster's internal locking
    (whose HB edges would confound the mutation's race window)."""

    def __init__(self, job: Any, cluster: Any, parser: Any = None):
        self.job = job

    def step(self) -> None:
        checkpoint("updater-step")

    def delete(self) -> None:
        pass

    def on_scale(self, n: int) -> None:
        pass


def _make_job(name: str):
    from edl_tpu_torch.api.job import TrainingJob

    return TrainingJob.from_dict({
        "metadata": {"name": name},
        "spec": {
            "fault_tolerant": True,
            "worker": {
                "min_replicas": 2,
                "max_replicas": 8,
                "resources": {
                    "requests": {"cpu": "500m", "memory": "1Gi", "tpu": 4},
                    "limits": {"tpu": 4},
                },
            },
        },
    })


class _ScriptedKube:
    """Scripted KubeCluster stand-in: watch call 1 delivers one event
    then dies (stream break), later calls heart-beat until ``_stop`` —
    the exact lifecycle that makes poll() relist (unlocked ``_rv``
    write) while the dead watch thread's locked writes have no join
    edge to the main task."""

    def __init__(self):
        self.api = self
        self.calls = 0

    def training_job_list_path(self, ns: str) -> str:
        return "/apis/edl/v1/trainingjobs"

    def list_training_jobs_resumable(self, ns: str):
        return ([], set(), "0")

    def watch(self, path: str, resource_version: Optional[str] = None,
              timeout_s: Optional[float] = None,
              conn_holder: Optional[list] = None):
        self.calls += 1
        if self.calls == 1:
            yield {"type": "BOOKMARK",
                   "object": {"metadata": {"resourceVersion": "7"}}}
            raise OSError("watch stream broke")
        for _ in range(64):
            checkpoint("watch-heartbeat")
            yield {"type": "HEARTBEAT"}


# ---------------------------------------------------------------------------
# Harness bodies
# ---------------------------------------------------------------------------


def _pusher_backoff(mutate: bool) -> None:
    import threading

    from edl_tpu_torch.obs.fleet import MetricsPusher

    def failing_publish(payload: str) -> None:
        raise OSError("coordinator down")

    p = MetricsPusher(failing_publish, interval_s=0.1,
                      registry=_StubRegistry())
    if mutate:
        p._state_lock = NullLock()
    instrument(p, ["_fail_streak", "_failing", "pushes"], name="MetricsPusher")

    def pushes(n: int) -> Callable[[], None]:
        def run() -> None:
            for _ in range(n):
                p.push_once()
        return run

    t1 = threading.Thread(target=pushes(2), name="pusher-a")
    t2 = threading.Thread(target=pushes(2), name="pusher-b")
    t1.start()
    t2.start()
    p.next_wait_s()  # owner-thread read racing the workers when unguarded
    t1.join()
    t2.join()
    assert p._fail_streak == 4, f"lost streak increments: {p._fail_streak}"
    assert p.next_wait_s() > p.interval_s


def _controller_updaters(mutate: bool) -> None:
    import threading

    from edl_tpu_torch.controller import controller as controller_mod

    real_updater = controller_mod.JobUpdater
    controller_mod.JobUpdater = _StubUpdater
    try:
        ctrl = controller_mod.Controller(_NullCluster())
        if mutate:
            ctrl._lock = NullLock()
        ctrl.updaters = TrackedDict("Controller.updaters", ctrl.updaters)
        jobs = [_make_job(f"j{i}") for i in range(2)]

        def adder() -> None:
            for j in jobs:
                ctrl.on_add(j)

        def ticker() -> None:
            for _ in range(3):
                ctrl.step()

        t1 = threading.Thread(target=adder, name="watch")
        t2 = threading.Thread(target=ticker, name="ticker")
        t1.start()
        t2.start()
        t1.join()
        t2.join()
        assert set(ctrl.updaters) == {j.qualified_name for j in jobs}
    finally:
        controller_mod.JobUpdater = real_updater


def _conn_close(mutate: bool) -> None:
    import threading

    from edl_tpu_torch.runtime.shard_server import _Conn

    conn = _Conn("127.0.0.1:1", token=None)
    if mutate:
        conn.lock = NullLock()
    conn.sock = _FakeSock()
    conn.file = _FakeWire()

    def _reconnect() -> None:  # close-then-fetch is legal: fetch reopens
        conn.sock = _FakeSock()
        conn.file = _FakeWire()

    conn._connect_locked = _reconnect
    instrument(conn, ["sock", "file"], name="_Conn")

    def fetcher() -> None:
        # entries=[] keeps the wire quiet: the fetch is just the header
        # write + flush — exactly the window close() must not None the
        # file out from under
        conn.fetch_batch([], {})

    def closer() -> None:
        conn.close()

    t1 = threading.Thread(target=fetcher, name="fetch")
    t2 = threading.Thread(target=closer, name="close")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    # either order is legal: closer-last leaves it closed, fetcher-last
    # leaves the reopened fakes — consistency is what matters
    assert (conn.sock is None) == (conn.file is None)


def _block_allocator() -> None:
    import threading

    from edl_tpu_torch.serving.paged import BlockAllocator

    alloc = BlockAllocator(n_blocks=6, block_size=4)
    engine_lock = threading.Lock()

    def worker() -> None:
        held: List[int] = []
        for _ in range(3):
            with engine_lock:
                bid = alloc.alloc()
                if bid is not None:
                    held.append(bid)
            checkpoint("between-ops")
            with engine_lock:
                if held:
                    alloc.incref(held[-1])
                    alloc.free(held[-1])
        with engine_lock:
            for bid in held:
                assert alloc.free(bid), f"double free of block {bid}"

    t1 = threading.Thread(target=worker, name="req-a")
    t2 = threading.Thread(target=worker, name="req-b")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    assert alloc.free_blocks == 5, alloc.free_blocks  # block 0 is scratch
    assert len(set(alloc._free)) == len(alloc._free), "free-list duplicates"
    assert all(r == 0 for r in alloc._ref), alloc._ref


def _prefix_cache() -> None:
    import threading

    from edl_tpu_torch.serving.paged import BlockAllocator, PrefixCache

    alloc = BlockAllocator(n_blocks=8, block_size=4)
    cache = PrefixCache(alloc)
    engine_lock = threading.Lock()

    def inserter() -> None:
        for i in range(3):
            with engine_lock:
                bid = alloc.alloc()
                if bid is not None:
                    cache.insert((1, 2, 3, i), bid)
                    alloc.free(bid)  # cache's incref keeps it alive
            checkpoint("insert-gap")

    def evictor() -> None:
        for _ in range(4):
            with engine_lock:
                cache.evict_one()
            checkpoint("evict-gap")

    t1 = threading.Thread(target=inserter, name="insert")
    t2 = threading.Thread(target=evictor, name="evict")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    with engine_lock:
        while cache.evict_one():
            pass
    assert alloc.free_blocks == 7, alloc.free_blocks  # block 0 is scratch
    assert len(cache) == 0


def _serving_admission() -> None:
    import threading

    from edl_tpu_torch.serving.paged import BlockAllocator

    alloc = BlockAllocator(n_blocks=8, block_size=4)
    engine_lock = threading.Lock()
    slots = TrackedDict("Engine.slots")

    def admit() -> None:
        for rid in ("r1", "r2", "r3"):
            with engine_lock:
                blocks = []
                for _ in range(2):
                    bid = alloc.alloc()
                    if bid is None:
                        break
                    blocks.append(bid)
                if len(blocks) == 2:
                    slots[rid] = blocks
                else:  # admission failed: roll back, don't leak
                    for bid in blocks:
                        alloc.free(bid)
            checkpoint("admit-gap")

    def drain() -> None:
        for _ in range(5):
            with engine_lock:
                if slots:
                    rid = next(iter(slots))
                    for bid in slots.pop(rid):
                        assert alloc.free(bid), f"double free draining {rid}"
            checkpoint("drain-gap")

    t1 = threading.Thread(target=admit, name="admit")
    t2 = threading.Thread(target=drain, name="drain")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    with engine_lock:
        for rid in list(slots):
            for bid in slots.pop(rid):
                assert alloc.free(bid)
    assert alloc.free_blocks == 7, alloc.free_blocks  # block 0 is scratch


def _router_table(mutate: bool) -> None:
    import threading

    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving import router as rt

    table = rt.ReplicaTable(
        registry=MetricsRegistry(), suspect_after=1, dead_after=2
    )
    for rid in ("a", "b", "c"):
        table.add(rid, f"http://{rid}")
        table.set_state(rid, rt.READY)
    if mutate:
        table._lock = NullLock()
    table._replicas = TrackedDict(
        "ReplicaTable._replicas", table._replicas
    )

    # the three parties that share the table in production: the
    # supervisor's health prober, the router's acquire/release hot
    # path, and the supervisor's drain→evict sequence
    def prober() -> None:
        for ok in (False, True, False, False):
            table.mark_probe("a", ok, queue_depth=1)
            checkpoint("probe-gap")

    def route() -> None:
        for _ in range(3):
            ref = table.acquire(session="s", prefix_key="71,12")
            checkpoint("route-gap")
            if ref is not None:
                table.release(ref.id)

    def evict() -> None:
        table.set_state("b", rt.DRAINING)
        checkpoint("evict-gap")
        table.remove("b")

    t1 = threading.Thread(target=prober, name="probe")
    t2 = threading.Thread(target=route, name="route")
    t3 = threading.Thread(target=evict, name="evict")
    t1.start()
    t2.start()
    t3.start()
    t1.join()
    t2.join()
    t3.join()
    # a's probe verdicts are False,True,False,False with
    # suspect_after=1 dead_after=2: the final two failures walk
    # READY → SUSPECT → DEAD regardless of interleaving (DEAD sticky)
    rep_a = table.get("a")
    assert rep_a is not None and rep_a.state == rt.DEAD, rep_a
    assert table.get("b") is None, "evicted replica still tabled"
    rep_c = table.get("c")
    assert rep_c is not None and rep_c.state == rt.READY, rep_c
    # every acquire was released: no leaked inflight count survives
    for rep in table.snapshot():
        assert rep.inflight == 0, (rep.id, rep.inflight)
    # remove() purges the session pin when it pointed at the victim
    assert table._sessions.get("s") != "b", table._sessions


def _flight_recorder() -> None:
    import threading

    from edl_tpu_torch.obs.events import FlightRecorder

    rec = FlightRecorder(max_events=4, clock=lambda: 0.0)
    instrument(rec, ["dropped"], name="FlightRecorder")

    def emitter(kind: str) -> Callable[[], None]:
        def run() -> None:
            for i in range(3):
                rec.emit(kind, step=i)
        return run

    def reader() -> None:
        for _ in range(2):
            rec.events()
            checkpoint("read-gap")

    t1 = threading.Thread(target=emitter("step"), name="emit-a")
    t2 = threading.Thread(target=emitter("reshard"), name="emit-b")
    t3 = threading.Thread(target=reader, name="reader")
    t1.start()
    t2.start()
    t3.start()
    t1.join()
    t2.join()
    t3.join()
    evs = rec.events()
    assert len(evs) == 4, len(evs)
    assert rec.dropped == 2, rec.dropped
    counts = rec.counts()
    assert sum(counts.values()) == 6, counts


def _lease_broker(mutate: bool) -> None:
    import threading

    from edl_tpu_torch.elasticity.broker import (
        FREED,
        ChipLeaseBroker,
        LeaseError,
    )
    from edl_tpu_torch.obs.metrics import MetricsRegistry

    b = ChipLeaseBroker(6, registry=MetricsRegistry())
    # pre-scheduler setup: a train lease, and a serving holder whose
    # recall has been sent but will never be acked (crash candidate)
    train = b.grant("train:job", 2)
    stuck = b.grant("serve:x", 2)
    b.recall(stuck.lease_id)
    if mutate:
        b._lock = NullLock()
    instrument(b, ["_epoch", "_free"], name="ChipLeaseBroker")
    b._leases = TrackedDict("ChipLeaseBroker._leases", b._leases)

    # the three parties that share the table in production: the
    # controller granting serving slices, the handover path recalling
    # and freeing the train lease (with an idempotent retry), and the
    # supervisor settling a crashed holder
    def granter() -> None:
        for i in range(3):
            try:
                b.grant(f"serve:g{i}", 1)
            except LeaseError:
                pass  # pool exhausted: a legal outcome, not a race
            checkpoint("grant-gap")

    def recaller() -> None:
        b.recall(train.lease_id)
        checkpoint("recall-gap")
        b.recall(train.lease_id)  # retried RPC: must be a no-op
        b.free(train.lease_id)

    def crasher() -> None:
        checkpoint("crash-gap")
        b.holder_crashed("serve:x")

    t1 = threading.Thread(target=granter, name="grant")
    t2 = threading.Thread(target=recaller, name="recall")
    t3 = threading.Thread(target=crasher, name="crash")
    t1.start()
    t2.start()
    t3.start()
    t1.join()
    t2.join()
    t3.join()
    # conservation: chips under live leases + free pool == inventory,
    # in every explored interleaving
    assert b.check_conservation(), (
        b.free_chips, [(l.lease_id, l.state, l.chips) for l in b.snapshot()]
    )
    # epochs are strictly increasing in grant order
    epochs = sorted(l.epoch for l in b.snapshot())
    assert len(set(epochs)) == len(epochs), epochs
    # both terminal transitions landed exactly once
    assert b.get(train.lease_id).state == FREED
    assert b.get(stuck.lease_id).state == FREED


def _dist_lease_broker(mutate: bool) -> None:
    import threading

    from edl_tpu_torch.runtime.lease_table import FREED, LeaseTable

    # a broker restart mid-flight: one live lease persisted, then the
    # table restored into RECOVERING with a zero re-confirmation window
    docs: list = []
    t0 = LeaseTable(persist=docs.append, recover_window_s=0.0)
    t0.init(4)
    g = t0.grant("serve:old", 4, token="tok-old")
    table = LeaseTable(recover_window_s=0.0)
    table.restore(docs[-1])
    assert table.recovering
    if mutate:
        # strip the epoch fence: confirm stops comparing the holder's
        # remembered epoch against the lease's
        table._stale_locked = lambda row, epoch: False
    instrument(table, ["_free", "_epoch", "_recovering"], name="LeaseTable")
    table._leases = TrackedDict("LeaseTable._leases", table._leases)

    results: dict = {}

    # the zombie: a holder whose memory of its lease predates the
    # restart — wrong epoch. The fence must never answer "ok".
    def zombie() -> None:
        checkpoint("zombie-gap")
        results["zombie"] = table.confirm(g["id"], g["epoch"] - 1)

    # the reaper + the next tenant: force-release the silent holder,
    # then re-grant the same chips
    def reaper() -> None:
        table.expire()
        checkpoint("regrant-gap")
        results["regrant"] = table.grant("serve:new", 4, token="tok-new")

    t1 = threading.Thread(target=zombie, name="zombie")
    t2 = threading.Thread(target=reaper, name="reaper")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    # conservation in every interleaving
    assert table.check_conservation(), table.snap()
    # the fence: a stale-epoch confirm is NEVER accepted — with
    # _stale_locked stripped the zombie's confirm lands "ok", recovery
    # ends without force-releasing, and the zombie keeps chips the
    # reaper should have reclaimed
    assert results["zombie"] != "ok", (
        f"stale-confirm accepted: zombie confirmed epoch "
        f"{g['epoch'] - 1} against lease epoch {g['epoch']}"
    )
    # whoever lost the race, the chips ended in exactly one place: the
    # old lease force-released and re-granted, or still held pending
    # the next reaper sweep — never both
    live = [l for l in table.snap()["leases"] if l["state"] != FREED]
    assert sum(l["chips"] for l in live) + table.snap()["free"] == 4


def _kube_rv() -> None:
    import threading

    from edl_tpu_torch.cluster.kube import KubeJobSource

    src = KubeJobSource(_ScriptedKube(), watch=True)
    instrument(src, ["_rv", "_stop"], name="KubeJobSource")
    sink = lambda job: None  # noqa: E731 — relist of an empty namespace

    # poll 1: relist + start the watch thread (which dies after one event)
    src.poll(sink, sink, sink)
    spins = 0
    while src._watch_healthy() and spins < 200:
        spins += 1
    # poll 2: the watch thread is dead with NO join edge — the relist's
    # unlocked `self._rv = rv` races its locked writes (the baselined
    # finding); then the watch restarts
    src.poll(sink, sink, sink)
    # close while the restarted watch loops: the unlocked `_stop` flip
    # racing the loop-head read (the no-lint'd hand-off)
    src.close()
    spins = 0
    while src._watch_healthy() and spins < 300:
        spins += 1


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclass
class Harness:
    name: str
    fn: Callable[[], None]
    description: str
    #: evidence (race or failure) is EXPECTED — exit status inverts
    expect_evidence: bool = False
    #: substrings that must appear among race vars / failure detail
    #: when evidence is expected
    expect_keys: List[str] = field(default_factory=list)
    mutation: bool = False
    schedules: int = 24
    max_ops: int = 4000


def _mk(name: str, fn: Callable[[], None], description: str, **kw: Any) -> Harness:
    return Harness(name=name, fn=fn, description=description, **kw)


HARNESSES: Dict[str, Harness] = {
    h.name: h
    for h in [
        _mk("pusher-backoff", lambda: _pusher_backoff(False),
            "MetricsPusher backoff streak under concurrent push_once + "
            "next_wait_s (lock-guarded — expect race-free)"),
        _mk("controller-updaters", lambda: _controller_updaters(False),
            "Controller.updaters watch-vs-ticker under _lock "
            "(expect race-free)"),
        _mk("conn-close", lambda: _conn_close(False),
            "_Conn.close vs in-flight fetch_batch holding conn.lock "
            "(expect race-free)"),
        _mk("block-allocator", lambda: _block_allocator(),
            "BlockAllocator alloc/incref/free refcount invariants under "
            "the engine-lock discipline"),
        _mk("prefix-cache", lambda: _prefix_cache(),
            "PrefixCache insert vs evict_one LRU/refcount invariants "
            "under the engine-lock discipline"),
        _mk("serving-admission", lambda: _serving_admission(),
            "serving admission vs drain: slot table + block refcounts, "
            "no leak and no double free"),
        _mk("router-table", lambda: _router_table(False),
            "fleet ReplicaTable: prober vs route vs evict under _lock "
            "(expect race-free; state machine + inflight invariants)"),
        _mk("flight-recorder", lambda: _flight_recorder(),
            "FlightRecorder ring: seq/dropped/counts invariants under "
            "two emitters and a reader"),
        _mk("lease-broker", lambda: _lease_broker(False),
            "elasticity ChipLeaseBroker: granter vs recall/free vs "
            "holder-crash under _lock (expect race-free; conservation "
            "+ epoch monotonicity at quiescence)"),
        _mk("dist-lease-broker", lambda: _dist_lease_broker(False),
            "coordinator LeaseTable in RECOVERING: zombie stale-epoch "
            "confirm vs expire-reaper + re-grant (expect race-free; "
            "conservation + the fence never answers ok)"),
        _mk("kube-rv", lambda: _kube_rv(),
            "KubeJobSource relist/close vs watch thread: witnesses the "
            "baselined _rv hand-off and the no-lint'd _stop flip",
            expect_evidence=True, expect_keys=["._rv", "._stop"],
            schedules=12, max_ops=6000),
        _mk("mut-pusher-backoff", lambda: _pusher_backoff(True),
            "MUTATION: _state_lock removed — the backoff-streak race",
            expect_evidence=True, expect_keys=["_fail_streak"],
            mutation=True),
        _mk("mut-controller-updaters", lambda: _controller_updaters(True),
            "MUTATION: Controller._lock removed — the "
            "watch-vs-ticker updaters race",
            expect_evidence=True, expect_keys=["Controller.updaters"],
            mutation=True),
        _mk("mut-conn-close", lambda: _conn_close(True),
            "MUTATION: conn.lock removed — the close-vs-fetch race "
            "(AttributeError crash or file/sock HB race)",
            expect_evidence=True, expect_keys=["_Conn.file", "_Conn.sock",
                                               "died"],
            mutation=True),
        _mk("mut-router-table", lambda: _router_table(True),
            "MUTATION: ReplicaTable._lock removed — prober/route/evict "
            "race on the shared replica map",
            expect_evidence=True,
            # unlike mut-conn-close the lockless map rarely CRASHES —
            # the HB race report on the shared dict is the evidence
            expect_keys=["ReplicaTable._replicas"],
            mutation=True),
        _mk("mut-lease-broker", lambda: _lease_broker(True),
            "MUTATION: ChipLeaseBroker._lock removed — grant/recall/"
            "crash race on the lease table and the free-chip count",
            expect_evidence=True,
            expect_keys=["ChipLeaseBroker"],
            mutation=True),
        _mk("mut-dist-lease-broker", lambda: _dist_lease_broker(True),
            "MUTATION: LeaseTable._stale_locked stripped — the zombie's "
            "stale-epoch confirm is accepted and it keeps chips the "
            "recovery reaper should have reclaimed",
            expect_evidence=True,
            expect_keys=["stale-confirm accepted"],
            mutation=True),
    ]
}


# Static lockset-race sites → the harness evidence that settles them.
# `guarded`/`mutated` name harnesses; a site with only `witness` is an
# accepted race the harness must actually reproduce.
STATIC_XREF: List[Dict[str, Any]] = [
    {
        "site": "edl_tpu_torch/obs/fleet.py:MetricsPusher._fail_streak",
        "claim": "push_once/next_wait_s share backoff state (fixed; "
                 "_state_lock)",
        "guarded": "pusher-backoff",
        "mutated": "mut-pusher-backoff",
    },
    {
        "site": "edl_tpu_torch/controller/controller.py:Controller.updaters",
        "claim": "watch events vs updater ticker share the map (fixed; "
                 "_lock)",
        "guarded": "controller-updaters",
        "mutated": "mut-controller-updaters",
    },
    {
        "site": "edl_tpu_torch/runtime/shard_server.py:_Conn.close",
        "claim": "teardown vs in-flight fetch share sock/file (fixed; "
                 "conn.lock)",
        "guarded": "conn-close",
        "mutated": "mut-conn-close",
    },
    {
        "site": "edl_tpu_torch/serving/router.py:ReplicaTable._replicas",
        "claim": "health prober, router acquire/release, and supervisor "
                 "drain/evict share the replica map (_lock)",
        "guarded": "router-table",
        "mutated": "mut-router-table",
    },
    {
        "site": "edl_tpu_torch/elasticity/broker.py:ChipLeaseBroker._leases",
        "claim": "controller grants, handover recall/free, and crash "
                 "settlement share the lease table + free count "
                 "(_lock)",
        "guarded": "lease-broker",
        "mutated": "mut-lease-broker",
    },
    {
        "site": "edl_tpu_torch/runtime/lease_table.py:LeaseTable._stale_locked",
        "claim": "epoch fencing: a holder whose remembered epoch differs "
                 "from the lease's must be refused, or a force-released "
                 "zombie keeps chips through recovery",
        "guarded": "dist-lease-broker",
        "mutated": "mut-dist-lease-broker",
    },
    {
        "site": "edl_tpu_torch/cluster/kube.py:KubeJobSource._rv "
                "(edl_tpu_torch/analysis/baseline.json)",
        "claim": "relist writes _rv unlocked vs the watch thread's "
                 "locked writes (baselined as a benign hand-off)",
        "witness": "kube-rv",
        "witness_key": "._rv",
    },
    {
        "site": "edl_tpu_torch/cluster/kube.py:753 KubeJobSource._stop "
                "(no-lint[lockset-race])",
        "claim": "close() flips _stop unlocked vs the watch loop's reads "
                 "(suppressed as a monotonic-bool hand-off)",
        "witness": "kube-rv",
        "witness_key": "._stop",
    },
]


def _evidence_matches(res: ExploreResult, key: str) -> bool:
    for r in res.races:
        if key in r["var"]:
            return True
    if res.failure is not None and key in str(res.failure.get("detail", "")):
        return True
    return False


def verdicts(results: Dict[str, ExploreResult]) -> List[Dict[str, Any]]:
    """Label each static site CONFIRMED / UNWITNESSED / UNKNOWN from
    harness outcomes. For fixed races: the guarded harness must stay
    clean (UNWITNESSED under the current guard) AND the mutation must
    reproduce the race (CONFIRMED the guard is load-bearing). For
    accepted races: the witness harness must reproduce them."""
    out: List[Dict[str, Any]] = []
    for x in STATIC_XREF:
        v: Dict[str, Any] = {"site": x["site"], "claim": x["claim"]}
        if "witness" in x:
            res = results.get(x["witness"])
            if res is None:
                v["verdict"] = "UNKNOWN"
                v["detail"] = f"harness {x['witness']} not run"
            elif _evidence_matches(res, x["witness_key"]):
                v["verdict"] = "CONFIRMED"
                v["detail"] = (
                    f"{x['witness']} witnessed the race "
                    f"(seed-reproducible; see its minimal schedule)"
                )
            else:
                v["verdict"] = "UNWITNESSED"
                v["detail"] = (
                    f"{x['witness']} explored {res.schedules} schedules "
                    "without reproducing it"
                )
        else:
            guarded = results.get(x["guarded"])
            mutated = results.get(x["mutated"])
            if guarded is None or mutated is None:
                v["verdict"] = "UNKNOWN"
                v["detail"] = "guarded+mutation pair not both run"
            elif not guarded.evidence and mutated.evidence:
                v["verdict"] = "CONFIRMED"
                v["detail"] = (
                    f"guard holds over {guarded.schedules} schedules; "
                    f"removing it ({x['mutated']}) reproduces the race "
                    "deterministically"
                )
            elif guarded.evidence:
                v["verdict"] = "REGRESSED"
                v["detail"] = f"{x['guarded']} found evidence under the guard"
            else:
                v["verdict"] = "UNWITNESSED"
                v["detail"] = (
                    f"mutation {x['mutated']} did not reproduce within "
                    f"{mutated.schedules} schedules"
                )
        out.append(v)
    return out
