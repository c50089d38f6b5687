"""Port parity: the deterministic scheduler of ``edl_tpu_torch``
(``analysis/{sched,hb,harnesses}.py``) and the ``schedcheck`` verb of the
port's CLI.

The reference's cases (``tests/test_schedcheck.py``: shim fidelity,
seeded exploration and exact replay, the happens-before detector,
deadlock detection, the mutation corpus, the verb) run against the port,
each a parametrised case here, with the static sites named by the port's
paths. Then the reference's and the port's ``explore`` give the same
schedules, traces and races on the reference's toy programs at one seed;
the shim stays off byte for byte after the harnessed modules have
imported torch; and two faults the port repairs show under the port's
scheduler: two steps of one job's updater (``Controller.on_add`` on the
watch thread against the ticker) create a child twice in the reference
and never in the port, and ``MetricsPusher``'s trace marks race without
its state lock.
"""

import collections
import queue
import sys
import threading
import time
import warnings

import pytest

from edl_tpu.analysis import hb as jhb
from edl_tpu.analysis import sched as jsched
from edl_tpu_torch.analysis import harnesses as H
from edl_tpu_torch.analysis import hb as thb
from edl_tpu_torch.analysis import sched as tsched
from tests.port_cases import case_names, port_cases

CASES = port_cases("test_schedcheck", subs=[('"edl_tpu/', '"edl_tpu_torch/')])


def _expand(mod):
    """Each case, a parametrised one once per value."""
    out = []
    for name in case_names(mod):
        fn = getattr(mod, name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, None, id=name))
            continue
        argname, values = marks[0].args
        out += [pytest.param(name, {argname: v}, id=f"{name}[{v}]")
                for v in values]
    return out


@pytest.fixture(autouse=True, scope="module")
def _quiet_logs():
    """As the reference's file: harnesses drive real error paths whose
    logs are noise; the singletons and the harnessed modules are built
    with real locks before any shim goes up."""
    import logging

    prev = logging.root.manager.disable
    logging.disable(logging.ERROR)
    H.warm_globals()
    yield
    logging.disable(prev)


def test_the_reference_file_is_pointed_at_the_port():
    assert CASES.sched is tsched and CASES.H is H
    assert len(_expand(CASES)) == 15


@pytest.mark.parametrize("case,kw", _expand(CASES))
def test_reference_schedcheck_case_on_the_port(case, kw, tmp_path, capsys):
    fn = getattr(CASES, case)
    have = {"tmp_path": tmp_path, "capsys": capsys, **(kw or {})}
    fn(**{k: have[k] for k in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})


# -- the two schedulers on the reference's toy programs ---------------------------


def _racy(sched):
    def h():
        class Obj:
            pass

        o = Obj()
        o.x = 0
        sched.instrument(o, ["x"], "O")

        def w():
            o.x = o.x + 1

        ts = [threading.Thread(target=w, name=f"w{i}") for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return h


def _locked(sched):
    def h():
        class Obj:
            pass

        o = Obj()
        o.x = 0
        lk = threading.Lock()
        sched.instrument(o, ["x"], "L")

        def w():
            with lk:
                o.x = o.x + 1

        ts = [threading.Thread(target=w) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert o.x == 2
    return h


def _abba(sched):
    def h():
        l1, l2 = threading.Lock(), threading.Lock()

        def a():
            with l1:
                with l2:
                    pass

        def b():
            with l2:
                with l1:
                    pass

        ts = [threading.Thread(target=a, name="a"),
              threading.Thread(target=b, name="b")]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return h


def _queue_event(sched):
    """A producer, a consumer and a flag: queue items and an event as
    happens-before channels, a racy counter beside them."""
    def h():
        class Obj:
            pass

        o = Obj()
        o.n = 0
        sched.instrument(o, ["n"], "Q")
        q, done = queue.Queue(), threading.Event()

        def produce():
            for i in range(3):
                o.n = o.n + 1
                q.put(i)
            done.set()

        def consume():
            for _ in range(3):
                q.get()
            done.wait()
            o.n = o.n + 1

        def bystander():
            time.sleep(0)
            o.n = o.n + 1

        ts = [threading.Thread(target=f, name=f.__name__)
              for f in (produce, consume, bystander)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return h


def _record(res):
    d = res.to_record()
    del d["elapsed_s"]
    return d


@pytest.mark.parametrize("toy", [_racy, _locked, _abba, _queue_event],
                         ids=lambda f: f.__name__[1:])
def test_explore_matches_the_reference_on_toy_programs(toy):
    """At one seed: schedules, distinct traces, pruned, races with their
    seeds, forced prefixes and minimal schedules, and failures."""
    ref = jsched.explore(toy(jsched), "toy", schedules=16, seed=5)
    port = tsched.explore(toy(tsched), "toy", schedules=16, seed=5)
    assert _record(port) == _record(ref)
    r1 = jsched.run_one(toy(jsched), seed=3)
    r2 = tsched.run_one(toy(tsched), seed=3)
    assert r2.choices == r1.choices
    assert [t.to_record() for t in r2.trace] == [
        t.to_record() for t in r1.trace]
    assert [r.to_record() for r in r2.races] == [
        r.to_record() for r in r1.races]


def test_hb_detector_matches_the_reference():
    out = []
    for hb in (jhb, thb):
        st = hb.HBState()
        got = [st.access("a", "v", True, "f:1"),
               st.release("a", "ch"), st.acquire("b", "ch"),
               st.access("b", "v", True, "f:2"),
               st.access("c", "v", False, "f:3"),
               st.fork("b", "d"), st.access("d", "v", True, "f:4"),
               st.join("b", "d"), st.access("b", "v", False, "f:5")]
        out.append([r.to_record() if hasattr(r, "to_record") else r
                    for r in got] + [r.to_record() for r in st.races])
    assert out[1] == out[0]


def _stdlib_identity_ok():
    return (threading.Lock is tsched._REAL["Lock"]
            and threading.RLock is tsched._REAL["RLock"]
            and threading.Condition is tsched._REAL["Condition"]
            and threading.Event is tsched._REAL["Event"]
            and threading.Thread is tsched._REAL["Thread"]
            and queue.Queue is tsched._REAL["Queue"]
            and time.sleep is tsched._REAL["sleep"])


def test_shim_off_is_byte_for_byte_stdlib_after_torch_is_imported():
    """``warm_globals`` imports every harnessed module — torch among
    them, through runtime/shard_server -> runtime/checkpoint — before
    any shim: no module of torch or of the port holds a shim primitive,
    and after a schedule the names in threading/queue/time are the
    objects captured at import."""
    H.warm_globals()
    assert "torch" in sys.modules
    assert "edl_tpu_torch.runtime.checkpoint" in sys.modules
    for name in H.HARNESSED_MODULES:
        assert name in sys.modules
    res = tsched.explore(H.HARNESSES["conn-close"].fn, "conn-close",
                         schedules=4, seed=0)
    assert not res.evidence
    assert _stdlib_identity_ok()
    shim = (tsched.ShimLock, tsched.ShimCondition, tsched.ShimEvent,
            tsched.ShimQueue, tsched.NullLock)
    with warnings.catch_warnings():  # deprecated module attributes
        warnings.simplefilter("ignore")
        leaked = [f"{name}.{k}" for name, mod in list(sys.modules.items())
                  if mod is not None and name.startswith(("torch",
                                                          "edl_tpu_torch"))
                  for k, v in list(vars(mod).items()) if isinstance(v, shim)]
    assert leaked == []


# -- faults the port repairs, shown under the scheduler ---------------------------


def _updater_churn(pkg):
    """``Controller.on_add`` of a fault-tolerant job on the watch thread
    while the ticker steps: the new updater is stepped by both."""
    import importlib

    ctl_mod = importlib.import_module(f"{pkg}.controller.controller")
    fake = importlib.import_module(f"{pkg}.cluster.fake")
    job_mod = importlib.import_module(f"{pkg}.api.job")

    def h():
        c = fake.FakeCluster(hosts=[fake.FakeHost("h0", 8000, 16000, 4)])
        ctl = ctl_mod.Controller(c, max_load_desired=1.0)
        job = job_mod.TrainingJob.from_dict({
            "metadata": {"name": "churn"},
            "spec": {"fault_tolerant": True, "worker": {
                "min_replicas": 1, "max_replicas": 2, "resources": {
                    "requests": {"cpu": "500m", "memory": "1Gi", "tpu": 4},
                    "limits": {"tpu": 4}}}}})

        def ticker():
            for _ in range(3):
                ctl.step()

        ts = [threading.Thread(target=lambda: ctl.on_add(job), name="watch"),
              threading.Thread(target=ticker, name="ticker")]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        names = [p.name for p in c.pods.values()] if hasattr(c, "pods") \
            else []
        assert len(names) == len(set(names))
    return h


def test_updater_steps_serialize_in_the_port_and_not_in_the_reference():
    """The cause of the churn test's failures under load
    (test_torch_control.py::test_controller_updaters_map_is_threadsafe_
    under_churn): the reference's updater, stepped on two threads,
    creates the coordinator twice and ``on_add`` dies of "already
    exists"; the port's never does."""
    ref = tsched.explore(_updater_churn("edl_tpu"), "ref-churn",
                         schedules=24, seed=0)
    assert ref.failure is not None and "already exists" in \
        ref.failure["detail"], ref.failure
    assert ref.failure["task"].startswith("watch")
    port = tsched.explore(_updater_churn("edl_tpu_torch"), "port-churn",
                          schedules=24, seed=0)
    assert not port.evidence, (port.races, port.failure)


class _StubRegistry:
    def snapshot_json(self):
        return "{}"


class _TrackedDeque(collections.deque):
    """The marks deque with its reads and appends as shared accesses of
    one variable (a deque mutates in place: no attribute is set)."""

    def _acc(self, write):
        s = tsched._ACTIVE
        if s is not None and s.in_task():
            s.access("MetricsPusher._trace_marks", write=write)

    def append(self, x):
        self._acc(True)
        super().append(x)

    def __getitem__(self, i):
        self._acc(False)
        return super().__getitem__(i)

    def __len__(self):
        self._acc(False)
        return super().__len__()


def _pusher_marks(mutate):
    """Two ``push_once`` on a pusher that ships trace windows (the
    pusher thread and stop()'s last-gasp push)."""
    from edl_tpu_torch.obs.fleet import MetricsPusher
    from edl_tpu_torch.utils import tracing

    def h():
        p = MetricsPusher(lambda s: None, interval_s=0.1,
                          registry=_StubRegistry(),
                          trace_publish=lambda doc: None,
                          tracer=tracing.Tracer())
        if mutate:
            p._state_lock = tsched.NullLock()
        p._trace_marks = _TrackedDeque(p._trace_marks, maxlen=2)
        ts = [threading.Thread(target=p.push_once, name=f"push-{i}")
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(p._trace_marks) == 2
    return h


def test_pusher_trace_marks_are_guarded_by_the_state_lock():
    """``_trace_marks`` (the port's trace window cursor) is read and
    appended under ``_state_lock``: race-free; without the lock the two
    pushes race on it."""
    guarded = tsched.explore(_pusher_marks(False), "marks", schedules=16,
                             seed=0)
    assert not guarded.evidence, (guarded.races, guarded.failure)
    bare = tsched.explore(_pusher_marks(True), "marks-bare", schedules=16,
                          seed=0)
    assert any("_trace_marks" in r["var"] for r in bare.races)


def test_harness_import_strings_name_the_port():
    """Every module a harness imports is one of the port's."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(H))
    names = [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names]
    names += list(H.HARNESSED_MODULES)
    ours = [n for n in names if n.split(".")[0] not in (
        "threading", "dataclasses", "typing", "__future__", "importlib")]
    assert ours and all(n.startswith("edl_tpu_torch.") for n in ours), ours
    assert all(x["site"].startswith("edl_tpu_torch/") for x in H.STATIC_XREF)
