"""Port parity: the fleet's read side — ``MetricsRegistry.merge_snapshot``,
``obs/fleet``'s coordinator half (aggregation, the fleet event log, the
fleet trace, the straggler pass), ``obs/disttrace``'s merge and
critical-path analysis, and the exporter's fleet sources — edl_tpu_torch
against edl_tpu on the same inputs.

Both packages run the same float arithmetic in Python on the same
documents, so every comparison is exact: rendered Prometheus text byte
for byte, merged trace documents and hops equal, gauges and events
equal. The KV cases run against a live native coordinator (the port's
``CoordinatorServer``), which both packages' functions read through the
same client; the reference's tests use its in-process ``PyCoordinator``
for the same cases.
"""

import json
import time
import types

import pytest

from edl_tpu.obs import disttrace as jdt
from edl_tpu.obs import events as jev
from edl_tpu.obs import fleet as jfleet
from edl_tpu.obs import metrics as jm
from edl_tpu.utils import tracing as jtr
from edl_tpu_torch import obs as tobs
from edl_tpu_torch.obs import disttrace as tdt
from edl_tpu_torch.obs import events as tev
from edl_tpu_torch.obs import fleet as tfleet
from edl_tpu_torch.obs import metrics as tm
from edl_tpu_torch.runtime.coordinator import CoordinatorServer
from edl_tpu_torch.utils import tracing as ttr

SIDES = {
    "ref": types.SimpleNamespace(m=jm, ev=jev, fleet=jfleet, dt=jdt, tr=jtr),
    "port": types.SimpleNamespace(m=tm, ev=tev, fleet=tfleet, dt=tdt, tr=ttr),
}


@pytest.fixture(autouse=True)
def _fresh():
    for s in SIDES.values():
        s.m.reset_default_registry()
        s.ev.reset_default_recorder()
        s.fleet._last_straggler = None
    yield
    for s in SIDES.values():
        s.m.reset_default_registry()
        s.ev.reset_default_recorder()


@pytest.fixture
def coord():
    srv = CoordinatorServer(member_ttl_s=30.0)
    c = srv.client()
    yield c
    c.close()
    srv.stop()


def _drive(m, reg, k=1):
    """A worker's registry: labelled counters, gauges, histograms with
    default and custom buckets (``k`` scales the values)."""
    c = reg.counter("edl_train_examples_total", "rows", ("phase",))
    c.inc(100 * k, phase="train")
    c.inc(7 * k, phase="eval")
    reg.gauge("edl_train_loss", "loss").set(0.5 / k)
    h = reg.histogram("edl_train_step_seconds", "steps")
    for i in range(20):
        h.observe(0.01 * k * (1 + i % 5))
    hc = reg.histogram("edl_test_latency", "lat", ("route",),
                       buckets=(0.1, 1.0, 10.0))
    hc.observe(0.5 * k, route="a")
    hc.observe(3.0 * k, route="b")
    return reg


# ---------------------------------------------------------------------------
# merge_snapshot / aggregate_snapshots


def test_merge_snapshot_renders_as_the_reference():
    """Counters and buckets add across merges, gauges overwrite, extra
    labels tag every series; a family whose kind drifted is dropped and a
    histogram whose edges differ is skipped, not raised."""
    out = {}
    for name, s in SIDES.items():
        dst = s.m.MetricsRegistry()
        for k, worker in ((1, "w0"), (2, "w1"), (3, "w0")):
            snap = _drive(s.m, s.m.MetricsRegistry(), k).snapshot()
            dst.merge_snapshot(snap, labels={"worker": worker})
        drift = s.m.MetricsRegistry()
        drift.gauge("edl_train_examples_total", "now a gauge").set(1)
        drift.histogram("edl_test_latency", "lat", ("route",),
                        buckets=(0.5, 5.0)).observe(1.0, route="a")
        dst.merge_snapshot(drift.snapshot(), labels={"worker": "w2"})
        # a kind the registry does not know is ignored
        dst.merge_snapshot({"families": [{"name": "x", "kind": "summary"}]})
        out[name] = dst.render()
    assert out["port"] == out["ref"]
    assert 'edl_train_examples_total{phase="train",worker="w0"} 400' \
        in out["port"]


def test_aggregate_snapshots_skips_bad_values():
    snaps = {"w0": _drive(jm, jm.MetricsRegistry()).snapshot_json(),
             "w1": "{not json", "w2": _drive(jm, jm.MetricsRegistry(),
                                             2).snapshot()}
    got = {n: s.fleet.aggregate_snapshots(dict(snaps)).render()
           for n, s in SIDES.items()}
    assert got["port"] == got["ref"] and 'worker="w2"' in got["port"]


def test_collect_fleet_over_a_live_coordinator(coord):
    """Snapshots pushed by both packages' ``MetricsPusher`` (one worker
    each, plus the reserved ``dist_service`` source) aggregate into the
    same text through both packages' ``collect_fleet``."""
    for name, (s, worker) in {"ref": (SIDES["ref"], "w0"),
                              "port": (SIDES["port"], "w1")}.items():
        coord.register(worker, 1)
        reg = _drive(s.m, s.m.MetricsRegistry(), 1 if worker == "w0" else 3)
        key = s.fleet.metrics_key("j", worker)
        p = s.fleet.MetricsPusher(lambda v, key=key: coord.kv_put(key, v),
                                  registry=reg)
        assert p.push_once()
    ds = tm.MetricsRegistry()
    ds.gauge("edl_dist_service_up", "up", ("epoch",)).set(1, epoch="3")
    coord.kv_put(tfleet.metrics_key("j", "dist_service"), ds.snapshot_json())
    texts = {n: s.fleet.collect_fleet(coord, "j", ("dist_service",)).render()
             for n, s in SIDES.items()}
    assert texts["port"] == texts["ref"]
    assert "edl_fleet_reporting_workers 3" in texts["port"]
    assert 'edl_dist_service_up{epoch="3",worker="dist_service"} 1' \
        in texts["port"]
    assert 'edl_train_loss{worker="w1"}' in texts["port"]


def test_pushed_span_window_reaches_back_to_the_push_before_last():
    """Both pushers ship the newest ``trace_window`` spans; the port's
    also ships every span recorded since its push before last, so a
    worker's window spans two push intervals at any span rate. At its
    first push, before it has a mark, it ships what the reference does."""
    pushed = {}
    for n, s in SIDES.items():
        tr = s.tr.Tracer()
        docs = pushed[n] = []
        p = s.fleet.MetricsPusher(
            lambda v: None, registry=s.m.MetricsRegistry(), tracer=tr,
            trace_publish=lambda v, docs=docs: docs.append(json.loads(v)),
            trace_window=4)
        for k, n_spans in enumerate((6, 7, 8, 2)):
            for _ in range(n_spans):
                tr.record(f"s{k}", time.perf_counter(), 0.001)
            assert p.push_once()
    seqs = {n: [[sp["seq"] for sp in d["spans"]] for d in docs]
            for n, docs in pushed.items()}
    assert seqs["ref"] == [list(range(3, 7)), list(range(10, 14)),
                           list(range(18, 22)), list(range(20, 24))]
    assert seqs["port"] == [list(range(3, 7)), list(range(7, 14)),
                            list(range(7, 22)), list(range(14, 24))]


# ---------------------------------------------------------------------------
# events, clock offsets, fleet trace, straggler pass


def _push_worker_state(c, job, worker, step_s, n=40, join_t=None,
                       clock_off=None):
    """The reference test's pushed state of one worker (step histogram,
    a join event at wall time ``join_t``, a clock estimate)."""
    reg = jm.MetricsRegistry()
    h = reg.histogram("edl_train_step_seconds", "steps")
    for _ in range(n):
        h.observe(step_s)
    c.kv_put(jfleet.metrics_key(job, worker), reg.snapshot_json())
    if join_t is not None:
        rec = jev.FlightRecorder(clock=lambda: join_t)
        rec.emit("worker.join", worker=worker, epoch=1)
        c.kv_put(jfleet.events_key(job, worker), rec.window_json())
    if clock_off is not None:
        c.kv_put(jfleet.clock_key(job, worker),
                 jdt.ClockEstimate(clock_off, 0.001, 3).to_json())


def test_straggler_pass_gauges_and_event(coord):
    coord.register("w0", 1)
    coord.register("w1", 1)
    _push_worker_state(coord, "j", "w0", 0.01, join_t=100.0)
    _push_worker_state(coord, "j", "w1", 0.10, join_t=102.5)
    out = {}
    for name, s in SIDES.items():
        merged = s.fleet.collect_fleet(coord, "j")
        again = s.fleet.collect_fleet(coord, "j")  # same skew: no re-emit
        det = s.ev.default_recorder().events(kind="straggler.detected")
        out[name] = (merged.render(), again.render(),
                     [(e.kind, e.severity, e.corr, e.attrs) for e in det])
    assert out["port"] == out["ref"]
    assert len(out["port"][2]) == 1 and out["port"][2][0][2]["worker"] == "w1"
    assert 'edl_barrier_wait_seconds{worker="w0"} 2.5' in out["port"][0]


def test_straggler_ratio_from_the_environment(coord, monkeypatch):
    """``EDL_STRAGGLER_RATIO`` sets the detection threshold (a bad value
    falls back to 1.5) on both sides alike."""
    coord.register("w0", 1)
    coord.register("w1", 1)
    _push_worker_state(coord, "j", "w0", 0.01)
    _push_worker_state(coord, "j", "w1", 0.03)
    for ratio, fires in (("100", False), ("junk", True)):
        monkeypatch.setenv("EDL_STRAGGLER_RATIO", ratio)
        for s in SIDES.values():
            s.fleet._last_straggler = None
            s.ev.reset_default_recorder()
            reg = s.fleet.collect_fleet(coord, "j")
            assert reg.get("edl_step_skew_ratio").value() > 1.5
            det = s.ev.default_recorder().events(kind="straggler.detected")
            assert len(det) == int(fires)


@pytest.mark.parametrize("apply_clock", [True, False])
def test_fleet_events_on_one_clock(coord, apply_clock):
    coord.register("w0", 1)
    coord.register("w1", 1)
    _push_worker_state(coord, "j", "w0", 0.01, join_t=100.4)
    _push_worker_state(coord, "j", "w1", 0.01, join_t=105.2, clock_off=-5.0)
    coord.kv_put(jfleet.events_key("j", "dist_service"), "{torn")
    got = {n: s.fleet.collect_fleet_events(coord, "j", ("dist_service",),
                                           apply_clock=apply_clock)
           for n, s in SIDES.items()}
    assert got["port"] == got["ref"]
    joins = [e["corr"]["worker"] for e in got["port"]
             if e["kind"] == "worker.join"]
    assert joins == (["w1", "w0"] if apply_clock else ["w0", "w1"])
    offs = {n: s.fleet.load_clock_offsets(coord, "j", ["w0", "w1"])
            for n, s in SIDES.items()}
    assert offs["port"] == offs["ref"] == {"w1": -5.0}


def test_collect_fleet_trace(coord):
    coord.register("w0", 1)
    coord.register("w1", 1)
    coord.kv_put(jfleet.trace_key("j", "w0"),
                 _window([("train.step", 50.0, 0.2)]))
    coord.kv_put(jfleet.trace_key("j", "w1"), "not a window")
    coord.kv_put(jfleet.clock_key("j", "w0"),
                 jdt.ClockEstimate(2.0, 0.001, 3).to_json())
    docs = {}
    for name, s in SIDES.items():
        docs[name] = s.fleet.collect_fleet_trace(coord, "j",
                                                 tracer=s.tr.Tracer())
        assert s.fleet.collect_fleet_trace(coord, "j", local_name="")[
            "workers"] == ["w0"]
    assert docs["port"] == docs["ref"]
    assert docs["port"]["workers"] == ["coordinator", "w0"]
    assert docs["port"]["skipped_windows"] == 1


def test_registry_from_sample():
    sample = types.SimpleNamespace(
        cpu_total_milli=64000, cpu_request_milli=12000, chip_total=8,
        chip_request=4, cpu_util=12.5, chip_util=50.0,
        submitted_jobs=["a", "b"], pending_jobs=["b"],
        running_workers={"a": 3}, parallelism={"a": 4, "b": 2},
        reshards={"a": 1}, last_stall_s={"a": 2.5},
        reshard_fallbacks={}, serving={"tokens": 12, "ttft": 0.25})
    got = {n: s.fleet.registry_from_sample(sample).render()
           for n, s in SIDES.items()}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# disttrace: merge, critical path, straggler primitives


def _window(name_times, skew=0.0, trace=None, extra_args=None):
    """A worker's span window: [(name, t_wall, dur), ...] with ``skew``
    seconds added to its clock (the reference test's fabrication)."""
    spans = []
    for i, (name, t, dur) in enumerate(name_times):
        args = dict(extra_args or {})
        if trace:
            args = jdt.inject(args, trace[i])
        spans.append({"name": name, "seq": i + 1, "t_wall": t + skew,
                      "dur_s": dur, "tid": 1, "args": args})
    return json.dumps({"meta": {"pid": 1}, "spans": spans})


def _ctx(t, s, p=None):
    return jdt.TraceContext(t * 16, s * 16, p * 16 if p else None)


def _case_skew(skew):
    w0 = _window([("go", 1000.0, 0.05)])
    w1 = _window([("recv", 1000.1, 0.05)], skew=skew)
    return {"w0": w0, "w1": w1}, {"w1": -skew}, {}


def _case_link():
    w0 = _window([("coord.go", 10.0, 0.01)], trace=[_ctx("t", "c")])
    bystander = jdt.TraceContext("t" * 16, "b" * 16, "missing-parent")
    w1 = _window([("coord.go.recv", 10.02, 0.001), ("other", 10.5, 0.01)],
                 trace=[_ctx("t", "s", "c"), bystander])
    return {"w0": w0, "w1": w1}, None, {"trace_id": "t" * 16}


def _case_intra():
    w = _window([("outer", 1.0, 0.2), ("inner", 1.05, 0.1)],
                trace=[_ctx("t", "p"), _ctx("t", "q", "p")])
    return {"w0": w, "bad": "not json {"}, None, {"trace_id": "t" * 16}


def _case_longest():
    w0 = _window([("root", 0.0, 0.05)], trace=[_ctx("t", "r")])
    w1 = _window([("short", 0.06, 0.1), ("long", 0.06, 0.5),
                  ("tail", 0.6, 0.2)],
                 trace=[_ctx("t", "a", "r"), _ctx("t", "b", "r"),
                        _ctx("t", "e", "b")])
    return {"w0": w0, "w1": w1}, None, {"trace_id": "t" * 16}


def _case_rid():
    doc = json.loads(_window([("serving.prefill", 1.0, 0.02),
                              ("serving.dispatch", 1.05, 0.001),
                              ("serving.drain", 1.10, 0.01),
                              ("serving.prefill", 2.0, 0.02)]))
    doc["spans"][0]["args"]["rid"] = "r1"
    doc["spans"][1]["args"]["rids"] = ["r1", "r2"]
    doc["spans"][2]["args"]["rids"] = ["r1"]
    doc["spans"][3]["args"]["rid"] = "r2"
    return {"w0": json.dumps(doc)}, None, {"rid": "r1"}


def _case_steps():
    """A 3-worker step: rank 0's go, two followers linked to it, each
    step span carrying ``step``."""
    go = _ctx("s", "g")
    w0 = _window([("coord.go", 5.0, 0.002), ("train.step", 5.003, 0.2)],
                 trace=[go, _ctx("s", "x", "g")], extra_args={"step": 7})
    w1 = _window([("coord.go.recv", 5.004, 0.0), ("train.step", 5.01, 0.3)],
                 skew=1.5, trace=[_ctx("s", "y", "g"), _ctx("s", "z", "y")],
                 extra_args={"step": 7})
    w2 = _window([("train.step", 5.02, 0.25)], extra_args={"step": 8})
    return ({"w0": w0, "w1": w1, "w2": w2}, {"w1": -1.5, "w2": 0.01},
            {"step": 7})


CASES = {"skew+5": lambda: _case_skew(5.0), "skew-5": lambda: _case_skew(-5.0),
         "one_link": _case_link, "intra_and_torn": _case_intra,
         "longest_chain": _case_longest, "rid": _case_rid,
         "steps": _case_steps}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_and_critical_path_equal_the_references(case):
    windows, offsets, filt = CASES[case]()
    out = {}
    for name, s in SIDES.items():
        doc = s.dt.merge_fleet_trace(dict(windows), offsets,
                                     extra_meta={"job": "j"})
        hops = s.dt.critical_path(doc, **filt)
        out[name] = (doc, hops, s.dt.render_critical_path(hops),
                     s.dt.critical_path(doc, rid="zzz"))
    assert out["port"] == out["ref"]
    doc, hops = out["port"][:2]
    flows = [e for e in doc["traceEvents"] if e.get("ph") in ("s", "f")]
    assert len(flows) == 2 * doc["flow_links"]
    if case == "one_link":
        assert doc["flow_links"] == 1
    if case == "intra_and_torn":
        assert doc["flow_links"] == 0 and doc["skipped_windows"] == 1
    if case == "longest_chain":
        assert [h["name"] for h in hops] == ["root", "long", "tail"]
    if case.startswith("skew"):
        xs = {e["name"]: e["ts"] for e in doc["traceEvents"]
              if e.get("ph") == "X"}
        assert xs["recv"] - xs["go"] == pytest.approx(0.1e6, abs=1.0)
    if case == "steps":
        assert doc["flow_links"] == 1 and len(hops) >= 2


def test_critical_path_selects_the_derived_reshard_root():
    """Spans recorded under ``root("reshard", E)`` (the port's worker
    opens it around a regroup's restore) answer ``--reshard-epoch E`` on
    both sides; the window is built by each package's own tracer."""
    docs = {}
    for name, s in SIDES.items():
        tr = s.tr.Tracer()
        with s.dt.root("reshard", 2):
            with tr.span("worker.restore", reshard_epoch=2):
                with tr.span("checkpoint.load_sharded"):
                    pass
        with s.dt.root("step", "j", 2, 0):
            with tr.span("train.step", step=0):
                pass
        docs[name] = s.dt.merge_fleet_trace({"w0": s.dt.span_window_doc(tr)})
    for name, s in SIDES.items():
        for doc in docs.values():
            hops = s.dt.critical_path(doc, reshard_epoch=2)
            assert [h["name"] for h in hops] == [
                "worker.restore", "checkpoint.load_sharded"], name
            assert s.dt.critical_path(doc, reshard_epoch=3) == []
            assert [h["name"] for h in s.dt.critical_path(doc, step=0)] == [
                "train.step"]


def test_remote_child_continues_a_received_trace():
    for s in SIDES.values():
        ctx = s.dt.TraceContext("a" * 16, "b" * 16, None)
        with s.dt.remote_child(ctx) as got:
            assert got.trace_id == ctx.trace_id
            assert got.parent_id == ctx.span_id
        with s.dt.remote_child(None) as got:
            assert got is None


@pytest.mark.parametrize("p50s", [
    {"w0": 0.1, "w1": 0.1, "w2": 0.3}, {"w0": 0.1},
    {"w0": 0.2, "w1": 0.1, "w2": 0.0, "w3": 0.4}, {}])
def test_step_skew_and_barrier_waits(p50s):
    got = {n: (s.dt.step_skew(p50s), s.dt.barrier_waits(p50s))
           for n, s in SIDES.items()}
    assert got["port"] == got["ref"]


def test_barrier_waits_from_events():
    evs = [{"kind": "worker.join", "t_wall": t, "corr": {"worker": w},
            "attrs": {"epoch": ep}}
           for t, w, ep in ((1.0, "w0", 1), (1.3, "w1", 1), (5.0, "w0", 2),
                            (5.9, "w1", 2), (6.0, "w1", 2), (7.0, "w2", 3))]
    evs.append({"kind": "worker.hb", "t_wall": 9.0, "corr": {"worker": "w0"},
                "attrs": {}})
    got = {n: (s.dt.barrier_waits_from_events(evs),
               s.dt.barrier_waits_from_events([]))
           for n, s in SIDES.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"w0": pytest.approx(0.9), "w1": 0.0}


# ---------------------------------------------------------------------------
# recorder / tracer dumps and the exporter's fleet sources


def test_recent_jsonl_and_chrome_trace_equal_the_references():
    out = {}
    for name, s in SIDES.items():
        t = {"v": 10.0}
        rec = s.ev.FlightRecorder(clock=lambda: t["v"])
        for i in range(5):
            t["v"] += 0.5
            rec.emit("k", rid=f"r{i}", n=i)
        tr = s.tr.Tracer()
        with tr.span("a", x=1):
            pass
        ev = tr.to_chrome_trace()
        lines = [json.loads(x) for x in rec.recent_jsonl(3).splitlines()]
        for r in lines[1:]:
            r.pop("t_mono")  # the process's monotonic clock
        out[name] = (lines,
                     [(e["name"], e["ph"], e["args"]) for e in ev],
                     sorted(ev[0]))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 4  # the meta line and 3 events


def test_exporter_fleet_sources_and_trace_paging():
    """A callable source is evaluated per scrape, ``events_source`` and
    ``trace_source`` replace the local views, and the local ``/trace``
    pages by ``since`` and ``n`` as the reference's does."""
    n = {"scrapes": 0}

    def source():
        n["scrapes"] += 1
        reg = tm.MetricsRegistry()
        reg.counter("edl_scrapes_total", "scrapes").inc(n["scrapes"])
        return reg

    doc = {"traceEvents": [], "workers": ["w0"], "flow_links": 0}
    recs = [{"seq": 1, "kind": "a", "severity": "info", "corr": {"rid": "x"}},
            {"seq": 2, "kind": "b", "severity": "warn", "corr": {}}]
    with tobs.MetricsExporter(source, events_source=lambda: recs,
                              trace_source=lambda: doc) as exp:
        assert "edl_scrapes_total 1" in tobs.scrape(exp.url)
        assert "edl_scrapes_total 2" in tobs.scrape(exp.url)
        assert json.loads(tobs.scrape(exp.url, "/trace")) == doc
        lines = tobs.scrape(exp.url, "/events?kind=b").splitlines()
        assert [json.loads(x)["kind"] for x in lines] == ["b"]
    tr = ttr.Tracer()
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    pages = {}
    with tobs.MetricsExporter(tm.MetricsRegistry(), tracer=tr) as exp:
        for q in ("", "?since=3", "?n=2", "?since=5"):
            d = json.loads(tobs.scrape(exp.url, "/trace" + q))
            meta = next(e for e in d["traceEvents"]
                        if e.get("ph") == "M" and e["name"] == "edl_tracer")
            pages[q] = ([e["name"] for e in d["traceEvents"]
                         if e.get("ph") == "X"], meta["args"]["max_seq"])
    assert pages == {"": (["s0", "s1", "s2", "s3", "s4"], 5),
                     "?since=3": (["s3", "s4"], 5),
                     "?n=2": (["s3", "s4"], 5), "?since=5": ([], 5)}
