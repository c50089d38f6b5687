"""Port parity: the in-process coordination plane of ``edl_tpu_torch`` —
``runtime/lease_table.py``, the queue classes of ``runtime/data.py``
(``ElasticDataQueue``, ``QueueBatcher``, ``StaticShardReader``) and the
in-process coordinators of ``runtime/coordinator.py``
(``NativeCoordinator``, ``PyCoordinator``, ``make_coordinator``) —
against the reference's modules on the same scripts.

Every case runs one script on both packages and compares the answers,
the persisted documents and, where a call raises, the error's type and
message. Time is a fake clock on both sides.
"""

import json
import os
import subprocess
import types

import numpy as np
import pytest

from edl_tpu.obs import disttrace as jdt
from edl_tpu.runtime import coordinator as jco
from edl_tpu.runtime import data as jdata
from edl_tpu.runtime import lease_table as jlt
from edl_tpu.utils import faults as jfaults
from edl_tpu_torch.obs import disttrace as tdt
from edl_tpu_torch.runtime import coordinator as tco
from edl_tpu_torch.runtime import data as tdata
from edl_tpu_torch.runtime import lease_table as tlt
from edl_tpu_torch.utils import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = types.SimpleNamespace(lt=jlt, faults=jfaults, data=jdata, co=jco)
PORT = types.SimpleNamespace(lt=tlt, faults=tfaults, data=tdata, co=tco)


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _outcome(fn, *a, **k):
    """A call's value, or its error as (type name, message)."""
    try:
        return ("ok", fn(*a, **k))
    except Exception as e:  # noqa: BLE001 — the error is the answer
        return ("raise", type(e).__name__, str(e))


# -- LeaseTable: the in-process cases of tests/test_dist_lease.py -------------


def _lifecycle(m, rec):
    t = m.lt.LeaseTable()
    rec += [t.init(8)]
    g = t.grant("train:job", 6, token="t1")
    rec += [g, t.check_conservation(), t.recall(g["id"]), t.recall(g["id"]),
            t.free(g["id"]), t.free(g["id"]), t.free(999),
            t.check_conservation(), t.snap()]
    assert g["ok"] and g["epoch"] == 1 and t.snap()["free"] == 8


def _refusals(m, rec):
    t = m.lt.LeaseTable()
    rec += [t.grant("train:job", 2), t.init(4)]
    g = t.grant("train:job", 3, token="t1")
    rec += [g, t.grant("serve:r0", 2), t.init(8), t.init(4),
            t.recall(g["id"]), t.free(g["id"]), t.init(8)]
    g2 = t.grant("serve:r0", 2, token="t2")
    rec += [g2]
    assert rec[3]["reason"] == "nochips" and g2["epoch"] > g["epoch"]


def _token(m, rec):
    t = m.lt.LeaseTable()
    t.init(8)
    g1 = t.grant("train:job", 4, token="tok-a")
    rec += [g1, t.grant("train:job", 4, token="tok-a"), t.snap()["free"],
            t.grant("train:job", 4, token="tok-b"), t.snap()["free"]]
    assert rec[1] == g1 and rec[-1] == 0


def _fencing(m, rec):
    t = m.lt.LeaseTable()
    t.init(8)
    g = t.grant("serve:r0", 2, token="t1")
    rec += [t.confirm(g["id"], g["epoch"]), t.confirm(g["id"], g["epoch"] - 1),
            t.confirm(999, 1), t.recall(g["id"]), t.free(g["id"]),
            t.confirm(g["id"], g["epoch"])]
    assert rec == ["ok", "stale_epoch", "unknown", "ok", 2, "freed"]


def _restore_window(m, rec):
    clk = Clock()
    docs = []
    t = m.lt.LeaseTable(persist=docs.append, clock=clk)
    t.init(8)
    g1 = t.grant("train:job", 4, token="t1")
    t.grant("serve:r0", 2, token="t2")
    t2 = m.lt.LeaseTable(recover_window_s=5.0, clock=clk)
    t2.restore(docs[-1])
    rec += [docs, t2.recovering, t2.snap(), t2.check_conservation(),
            t2.expire(), t2.confirm(g1["id"], g1["epoch"])]
    clk.t += 6.0
    rec += [t2.expire(), t2.recovering, t2.snap(), t2.check_conservation()]
    assert rec[-4] == (1, 0) and rec[-1]


def _all_confirmed(m, rec):
    clk = Clock()
    docs = []
    t = m.lt.LeaseTable(persist=docs.append, clock=clk)
    t.init(4)
    g = t.grant("train:job", 4, token="t1")
    t2 = m.lt.LeaseTable(recover_window_s=100.0, clock=clk)
    t2.restore(docs[-1])
    rec += [t2.recovering, t2.confirm(g["id"], g["epoch"]), t2.recovering]
    assert rec == [True, "ok", False]


def _persist_crash(m, rec):
    docs = []
    t = m.lt.LeaseTable(persist=docs.append)
    t.init(8)
    m.faults.arm("lease.persist:raise@n=1,max=1")
    try:
        rec.append(_outcome(t.grant, "train:job", 4, token="tok-a"))
    finally:
        m.faults.disarm()
    t2 = m.lt.LeaseTable(recover_window_s=0.0)
    t2.restore(docs[-1])
    rec += [t2.check_conservation(), t2.snap()["free"]]
    rec += [t2.grant("train:job", 4, token="tok-a"), t2.snap()["free"],
            t2.check_conservation(), t2.recovering]
    assert rec[0][0] == "raise" and rec[2] == 4 and rec[4] == 4


def _crashed(m, rec):
    t = m.lt.LeaseTable()
    t.init(8)
    t.grant("serve:r0", 2, token="a")
    t.grant("serve:r0", 2, token="b")
    t.grant("train:job", 2, token="c")
    rec += [t.crashed("serve:r0"), t.crashed("serve:r0"), t.snap(),
            t.check_conservation()]
    assert rec[:2] == [4, 0] and rec[2]["free"] == 6


@pytest.mark.parametrize("case", [
    _lifecycle, _refusals, _token, _fencing, _restore_window,
    _all_confirmed, _persist_crash, _crashed], ids=lambda f: f.__name__[1:])
def test_lease_table_cases_match_the_reference(case):
    """Each in-process case of the reference's lease-table tests: the
    reference's assertions hold on both, and every answer, snapshot and
    persisted document is the same."""
    got = {}
    for name, m in (("ref", REF), ("port", PORT)):
        rec = []
        case(m, rec)
        got[name] = json.loads(json.dumps(rec))
    assert got["port"] == got["ref"]


def test_pycoordinator_lease_restore_roundtrip_matches_the_reference():
    out = {}
    for name, co in (("ref", jco), ("port", tco)):
        c1 = co.PyCoordinator()
        rec = [c1.lease_init(8), c1.lease_grant("train:job", 5, token="t1")]
        c2 = co.PyCoordinator()
        c2.kv_put("lease/table", c1.kv_get("lease/table"))
        c2.lease_restore()
        c2.lease_set_recover_window(0.0)
        rec += [c2.lease_snap(), c2.lease_grant("train:job", 5, token="t1"),
                c2.lease_expire(), c2.lease_snap(), c2.wal_stats()]
        assert rec[2]["recovering"] and not rec[5]["recovering"]
        out[name] = json.loads(json.dumps(rec))
    assert out["port"] == out["ref"]


# -- the queue classes ---------------------------------------------------------


def _fake_time(monkeypatch, mod, clock):
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock, time=clock, sleep=lambda s: None))


@pytest.mark.parametrize("seed", range(6))
def test_elastic_data_queue_scripts_match_the_reference(seed, monkeypatch):
    """Leases, acks, nacks, a worker's release, the lease timeout's
    redelivery (the clock jumps past it), the failure cap and the
    passes give the same answers on both."""
    got = {}
    for name, m in (("ref", REF), ("port", PORT)):
        clk = Clock()
        _fake_time(monkeypatch, m.data, clk)
        rng = np.random.RandomState(seed)
        n = int(rng.randint(5, 60))
        q = m.data.ElasticDataQueue(n, int(rng.randint(1, 9)),
                                    passes=int(rng.randint(1, 4)),
                                    lease_timeout_s=5.0)
        out, held = [q.tasks_per_epoch], {}
        for _ in range(150):
            op = rng.choice(["get", "get", "get", "ack", "ack", "nack",
                             "release", "expire"])
            w = f"w{rng.randint(3)}"
            if op == "get":
                t = q.get_task(w)
                if t is not None:
                    held[t.task_id] = w
                out.append(None if t is None else
                           [t.task_id, t.start, t.end, t.epoch, t.failures])
            elif op in ("ack", "nack") and held:
                tid = sorted(held)[rng.randint(len(held))]
                del held[tid]
                getattr(q, op)(tid)
                out.append([op, tid])
            elif op == "release":
                out.append(["release", w, q.release_worker(w)])
                held = {k: v for k, v in held.items() if v != w}
            elif op == "expire":
                clk.t += 6.0
                held.clear()
            out += [q.done(), q.progress()]
        got[name] = out
    assert got["port"] == got["ref"]
    assert any(x is not None and isinstance(x, list) and len(x) == 5
               for x in got["ref"])


@pytest.mark.parametrize("args", [(0, 4), (8, 0), (-1, 1)])
def test_queue_refuses_what_the_reference_refuses(args):
    assert (_outcome(tdata.ElasticDataQueue, *args)
            == _outcome(jdata.ElasticDataQueue, *args))
    assert _outcome(tdata.ElasticDataQueue, *args)[0] == "raise"


@pytest.mark.parametrize("n,chunk,batch,rollover,passes", [
    (64, 6, 4, False, 1), (50, 7, 8, False, 2), (50, 7, 8, True, 2),
    (13, 5, 4, True, 3), (9, 9, 2, False, 1)])
def test_queue_batcher_gives_the_reference_batches(n, chunk, batch, rollover,
                                                   passes):
    """Batches that do not align with the chunks: each task is acked only
    once all its samples are handed out; with ``rollover`` a short batch
    at a pass boundary is topped up from the next pass."""
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got = {}
    for name, m in (("ref", REF), ("port", PORT)):
        q = m.data.ElasticDataQueue(n, chunk, passes=passes)
        b = m.data.QueueBatcher(q, lambda t: {
            "x": data[t.start:t.end], "i": np.arange(t.start, t.end)})
        out = []
        while True:
            x = b.next_batch(batch, rollover=rollover)
            if x is None:
                break
            out.append((x["i"].tolist(), x["x"].tolist(), q.progress()))
        got[name] = out
    assert got["port"] == got["ref"]
    seen = [i for idx, _, _ in got["port"] for i in idx]
    assert sorted(seen) == sorted(list(range(n)) * passes)


@pytest.mark.parametrize("args", [(20, 6, 3, 0), (20, 6, 3, 2), (7, 2, 4, 3),
                                  (5, 1, 2, 2), (5, 0, 2, 0), (0, 1, 1, 0)])
def test_static_shard_reader_matches_the_reference(args):
    def run(mod):
        r = _outcome(mod.StaticShardReader, *args)
        if r[0] == "raise":
            return r
        return ([[t.task_id, t.start, t.end, t.epoch] for t in r[1].chunks()],
                r[1].epoch_indices())

    assert run(tdata) == run(jdata)


# -- the in-process coordinators ------------------------------------------------


def test_native_and_python_coordinators_answer_like_the_reference():
    """chip_smoke's membership / KV / barrier / queue script: the port's
    NativeCoordinator, the port's PyCoordinator and the reference's
    PyCoordinator give the same answers."""
    import chip_smoke

    native = tco.NativeCoordinator()
    try:
        got = [chip_smoke._coordinator_script(c) for c in (
            native, tco.PyCoordinator(), jco.PyCoordinator())]
    finally:
        native.close()
    assert got[0] == got[1] == got[2]
    assert len(got[0]) > 30


def _lease_ops(c):
    """The chip-lease ops through a coordinator, tokens left out."""
    out = [c.lease_init(8), c.lease_init(8)]
    g = [c.lease_grant("train:job", 5, token="a"),
         c.lease_grant("serve:r0", 2, token="b"),
         c.lease_grant("serve:r1", 2, token="c"),
         c.lease_grant("train:job", 5, token="a")]
    out += [{k: v for k, v in x.items() if k != "token"} for x in g]
    out += [c.lease_confirm(g[0]["id"], g[0]["epoch"]),
            c.lease_confirm(g[0]["id"], g[0]["epoch"] - 1),
            c.lease_confirm(99, 1), c.lease_recall(g[1]["id"]),
            c.lease_recall(99), c.lease_free(g[1]["id"]),
            c.lease_free(g[1]["id"]), c.lease_free(99),
            c.lease_crashed("train:job"), c.lease_expire(), c.lease_snap()]
    return json.loads(json.dumps(out))


def test_chip_lease_ops_agree_across_the_in_process_coordinators():
    native = tco.NativeCoordinator()
    try:
        got = [_lease_ops(c) for c in (native, tco.PyCoordinator(),
                                       jco.PyCoordinator())]
    finally:
        native.close()
    assert got[0] == got[1] == got[2]


def test_native_coordinator_wal_replays_into_a_new_instance(tmp_path):
    wal = str(tmp_path / "coord.wal")
    a = tco.NativeCoordinator(wal_path=wal)
    a.kv_put("k", "v")
    a.register("w0", 1)
    a.queue_init(10, 3)
    t = a.lease("w0")
    a.ack(t.task_id)
    stats = a.queue_stats()
    a.close()
    b = tco.NativeCoordinator(wal_path=wal)
    try:
        assert b.kv_get("k") == "v"
        assert [m.name for m in b.members()] == ["w0"]
        assert b.queue_stats() == stats
        assert b.wal_stats()["appended_bytes"] >= 0
    finally:
        b.close()
    with pytest.raises(OSError):
        tco.NativeCoordinator(wal_path=str(tmp_path / "no" / "dir" / "w"))


def test_make_coordinator_is_native_and_falls_back_to_python(monkeypatch):
    c = tco.make_coordinator(member_ttl_s=3.0)
    assert type(c) is tco.NativeCoordinator
    c.close()
    monkeypatch.setattr(tco, "ensure_native_built", lambda: False)
    with pytest.raises(RuntimeError, match="native coordinator unavailable"):
        tco.NativeCoordinator()
    c = tco.make_coordinator()
    assert type(c) is tco.PyCoordinator and c._ttl == 10.0


def test_pycoordinator_membership_expires_on_its_ttl(monkeypatch):
    got = {}
    for name, m in (("ref", REF), ("port", PORT)):
        clk = Clock(100.0)
        monkeypatch.setattr(m.co, "time", types.SimpleNamespace(
            monotonic=clk, time=clk))
        c = m.co.PyCoordinator(member_ttl_s=2.0)
        out = [c.register("a", 1), c.register("b", 1)]
        clk.t += 1.5
        out += [c.heartbeat("a"), c.expire()]
        clk.t += 1.0
        out += [c.expire(), [x.name for x in c.members()], c.heartbeat("b"),
                c.lease("a"), c.queue_done(), c.queue_stats(),
                c.release_worker("a")]
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][4] == 3 and got["port"][5] == ["a"]


@pytest.mark.parametrize("kind", ["native", "python"])
def test_in_process_coordinators_support_the_clock_handshake(kind):
    """The handshake ``obs/disttrace.ClockSync`` runs against a
    coordinator's ``time``: in process, the offset is the local clock's
    (the reference's tests/test_disttrace.py case, on both of the
    port's in-process coordinators)."""
    c = tco.NativeCoordinator() if kind == "native" else tco.PyCoordinator()
    est = tdt.ClockSync().sample(c.time, n=3)
    ref = jdt.ClockSync().sample(jco.PyCoordinator().time, n=3)
    assert est is not None and ref is not None
    assert abs(est.offset_s) < 1.0 and abs(ref.offset_s) < 1.0
    if kind == "native":
        c.close()


def test_native_builds_land_in_the_port_build_dirs(monkeypatch, tmp_path):
    """Both coordinator artifacts (the library and the server) and the
    planner library build into ``edl_tpu_torch/_build``; a missing or
    stale artifact makes the build check fail."""
    from edl_tpu_torch.scheduler import native as tnative

    assert tco.ensure_native_built() and tnative.ensure_native_built()
    build = os.path.join(ROOT, "edl_tpu_torch", "_build")
    assert tco.LIB_PATH == os.path.join(build, "coordinator",
                                        "libedl_coord.so")
    assert tco.BIN_PATH == os.path.join(build, "coordinator",
                                        "edl-coordinator")
    assert tnative.LIB_PATH == os.path.join(build, "scheduler",
                                            "libedl_sched.so")
    for p in (tco.LIB_PATH, tco.BIN_PATH, tnative.LIB_PATH):
        assert os.path.exists(p)
    assert tco._fresh() and tnative._fresh()
    for attr in ("LIB_PATH", "BIN_PATH"):
        monkeypatch.setattr(tco, attr, str(tmp_path / "missing"))
        assert not tco._fresh()
        monkeypatch.undo()
    newer = tmp_path / "src"
    newer.mkdir()
    for s in tco._SOURCES:
        (newer / s).write_text("")
    os.utime(newer / "capi.cc",
             (os.path.getmtime(tco.LIB_PATH) + 60,) * 2)
    monkeypatch.setattr(tco, "NATIVE_DIR", str(newer))
    assert not tco._fresh()


def test_native_build_uses_the_makefiles_compiler(monkeypatch, tmp_path):
    """``CXX`` / ``CXXFLAGS`` from the environment do not reach the
    build (a compiler there may link a static libstdc++ into a library
    that shares a process with torch's libstdc++): a bogus compiler in
    the environment still builds, and the library links the shared
    libstdc++."""
    import shutil
    import threading

    from edl_tpu_torch.scheduler import native as tnative
    from edl_tpu_torch.utils import native_build

    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setenv("CXXFLAGS", "--no-such-flag")
    lib = str(tmp_path / "b" / "libedl_sched.so")
    assert native_build.ensure_built((lib,), tnative.NATIVE_DIR,
                                     str(tmp_path / "b"), tnative._SOURCES,
                                     threading.Lock(), "scheduler")
    assert native_build.fresh((lib,), tnative.NATIVE_DIR, tnative._SOURCES)
    if shutil.which("ldd"):
        deps = subprocess.run(["ldd", lib], capture_output=True,
                              text=True).stdout
        assert "libstdc++" in deps
    assert not native_build.ensure_built(
        (str(tmp_path / "c" / "nothing.so"),), str(tmp_path),
        str(tmp_path / "c"), (), threading.Lock(), "nothing")
