"""Port parity: the alert engine (``obs/alerts.py``) of edl_tpu_torch
against edl_tpu's. The shipped ``DEFAULT_RULES`` is the reference's
literal; the same rules document over the same recorded history gives
the same fire/resolve transitions, active set, ``to_block`` document,
``alert.*`` flight events and ``edl_alerts_*`` series through both
engines, at the document's own windows and under ``time_scale``; bad
documents raise the same errors. Both engines run the same float
arithmetic in Python, so every comparison is exact.
"""

import json

import pytest

from edl_tpu.obs import alerts as jal
from edl_tpu.obs import events as jev
from edl_tpu.obs import metrics as jm
from edl_tpu.obs import tsdb as jtsdb
from edl_tpu_torch.obs import alerts as tal
from edl_tpu_torch.obs import events as tev
from edl_tpu_torch.obs import metrics as tm
from edl_tpu_torch.obs import tsdb as ttsdb

SIDES = {"ref": (jal, jev, jm, jtsdb), "port": (tal, tev, tm, ttsdb)}

# every rule family and anomaly mode, with windows a 120-point history
# at 1 s spacing exercises (and 0.1 of them under time_scale)
RULES = {"time_scale": 1.0, "rules": [
    {"type": "threshold", "name": "hot", "series": "edl_temp",
     "labels": {}, "op": ">", "value": 5.0, "window_s": 10.0, "agg": "max",
     "severity": "page"},
    {"type": "threshold", "name": "hot_sustained", "series": "edl_temp",
     "op": ">=", "value": 5.0, "window_s": 3.0, "agg": "avg",
     "severity": "warn", "for_s": 4.0},
    {"type": "threshold", "name": "cold", "series": "edl_temp",
     "op": "<", "value": 0.5, "window_s": 5.0, "agg": "min",
     "severity": "info"},
    {"type": "burn_rate", "name": "ttft_burn",
     "series": "edl_slo_ttft_ok_ratio",
     "labels": {"slo_class": "interactive"}, "objective": 0.99,
     "short_s": 5.0, "long_s": 30.0, "factor": 14.4, "severity": "page"},
    {"type": "anomaly", "name": "temp_spike", "series": "edl_temp",
     "mode": "value", "window_s": 60.0, "z": 6.0, "severity": "warn"},
    {"type": "anomaly", "name": "push_burst",
     "series": "edl_metrics_push_failures_total", "mode": "increase",
     "window_s": 60.0, "z": 6.0, "severity": "warn"},
    {"type": "anomaly", "name": "wait_p99", "series": "edl_wait_seconds",
     "mode": "hist_p99", "window_s": 60.0, "z": 6.0, "severity": "warn"},
    {"type": "anomaly", "name": "wait_p50", "series": "edl_wait_seconds",
     "mode": "hist_p50", "window_s": 60.0, "z": 6.0, "severity": "page"},
]}


def _record(path, n=120, t0=1000.0):
    """A recorded history: a temperature with spikes, an SLO ratio that
    collapses for a while, a failure counter with a burst and a restart,
    and a wait histogram whose latency jumps."""
    db = jtsdb.TSDB(str(path))
    r, fails = jm.MetricsRegistry(), None
    h = r.histogram("edl_wait_seconds", "w", buckets=(0.01, 0.1, 1.0))
    for i in range(n):
        temp = 2.0 + 0.1 * (i % 3)
        if i in (40, 41) or 80 <= i < 90:
            temp = 9.0
        if 100 <= i < 103:
            temp = 0.2
        r.gauge("edl_temp", "t").set(temp)
        ok = 0.0 if 50 <= i < 70 else 1.0
        r.gauge("edl_slo_ttft_ok_ratio", "ok", ("slo_class",)).set(
            ok, slo_class="interactive")
        if fails is None or i == 95:  # the process restarts at 95
            fails = jm.MetricsRegistry().counter(
                "edl_metrics_push_failures_total", "f")
        fails.inc(40 if i == 60 else i % 2)
        for _ in range(400 if 85 <= i < 88 else 4):
            h.observe(0.5 if 85 <= i < 88 else 0.005 * (1 + i % 3))
        snap = r.snapshot()
        snap["families"].append({"name": fails.name, "kind": "counter",
                                 "help": "f", "labelnames": [],
                                 "samples": [{"labels": [],
                                              "value": fails.value()}]})
        db.append(snap, t=t0 + i)
    db.flush()
    return str(path)


def _replay(side, path, doc, time_scale):
    al, ev, m, tsdb = SIDES[side]
    rec = ev.FlightRecorder(clock=lambda: 0.0)
    reg = m.MetricsRegistry()
    engine = al.engine_from_doc(doc, time_scale=time_scale, registry=reg,
                                recorder=rec)
    db = tsdb.TSDB(path)
    trs = []
    for t in db.raw_times():
        trs += engine.evaluate(db, t)
    events = [(r["kind"], r["severity"], r["corr"], r["attrs"])
              for r in rec.records()]
    return {"transitions": trs, "active": engine.active(),
            "pages": engine.pages(), "block": engine.to_block(),
            "events": events, "text": reg.render(),
            "rules": sorted(r.name for r in engine.rules),
            "scale": engine.time_scale}


def test_default_rules_are_the_references():
    assert tal.DEFAULT_RULES == jal.DEFAULT_RULES
    assert json.dumps(tal.DEFAULT_RULES) == json.dumps(jal.DEFAULT_RULES)
    doc = tal.load_rules_doc()
    doc["rules"][0]["objective"] = 0.5
    assert tal.DEFAULT_RULES["rules"][0]["objective"] != 0.5
    rules = tal.parse_rules(tal.load_rules_doc())
    registered = {f["name"] for f in tm.ensure_core_series(
        tm.MetricsRegistry()).snapshot()["families"]}
    assert all(r.series in registered for r in rules)


@pytest.mark.parametrize("time_scale", [None, 0.1])
def test_transitions_equal_the_references(tmp_path, time_scale):
    path = _record(tmp_path / "h")
    got = {side: _replay(side, path, RULES, time_scale) for side in SIDES}
    assert got["port"] == got["ref"]
    fired = {t["rule"] for t in got["port"]["transitions"]
             if t["transition"] == "fire"}
    resolved = {t["rule"] for t in got["port"]["transitions"]
                if t["transition"] == "resolve"}
    if time_scale is None:
        # every family and mode fires over this history, and most resolve
        assert fired == {r["name"] for r in RULES["rules"]}, fired
        assert {"hot", "hot_sustained", "cold", "ttft_burn"} <= resolved
        assert 'edl_alerts_fired_total{rule="hot"} 2' in got["port"]["text"]
    else:
        assert got["port"]["scale"] == 0.1 and fired
    kinds = {e[0] for e in got["port"]["events"]}
    assert kinds == {"alert.fire", "alert.resolve"}
    assert all(e[2]["site"] == "alert." + e[3]["rule"]
               for e in got["port"]["events"])


def test_default_rules_over_a_recorded_outage(tmp_path):
    """The shipped rules over a goodput collapse (the reference watch
    test's history) at time_scale 0.01."""
    db = jtsdb.TSDB(str(tmp_path / "h"))
    for i in range(60):
        r = jm.MetricsRegistry()
        v = 1.0 if i < 10 else 0.0
        r.gauge("edl_slo_ttft_ok_ratio", "ok", ("slo_class",)).set(
            v, slo_class="interactive")
        r.gauge("edl_slo_goodput_fraction", "gp").set(v)
        db.append(r.snapshot(), t=1000.0 + i)
    db.flush()
    doc = jal.load_rules_doc()
    got = {side: _replay(side, str(tmp_path / "h"), doc, 0.01)
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"]["pages"] >= 1


BAD_DOCS = [
    {"rules": [{"type": "nope", "name": "r", "series": "edl_x"}]},
    {"rules": [{"type": "threshold", "name": "r", "series": "edl_x"},
               {"type": "threshold", "name": "r", "series": "edl_y"}]},
    {"rules": [{"type": "threshold", "name": "r"}]},
    {"rules": [{"type": "threshold", "series": "edl_x"}]},
    {"rules": [{"type": "threshold", "name": "r", "series": "edl_x",
                "severity": "sev1"}]},
    {"rules": [{"type": "threshold", "name": "r", "series": "edl_x",
                "op": "!="}]},
    {"rules": [{"type": "threshold", "name": "r", "series": "edl_x",
                "agg": "p99"}]},
    {"rules": [{"type": "burn_rate", "name": "r", "series": "edl_x",
                "objective": 1.0}]},
    {"rules": [{"type": "burn_rate", "name": "r", "series": "edl_x",
                "short_s": 60.0, "long_s": 30.0}]},
    {"rules": [{"type": "anomaly", "name": "r", "series": "edl_x",
                "mode": "hist_p90"}]},
]


@pytest.mark.parametrize("i", range(len(BAD_DOCS)))
def test_parse_errors_equal_the_references(i):
    msgs = {}
    for side, (al, *_rest) in SIDES.items():
        with pytest.raises(ValueError) as e:
            al.parse_rules(json.loads(json.dumps(BAD_DOCS[i])))
        msgs[side] = str(e.value)
    assert msgs["port"] == msgs["ref"]
    with pytest.raises(ValueError):
        tal.AlertEngine([], time_scale=0.0)


def test_a_broken_rule_does_not_blind_the_engine(tmp_path):
    class Exploding(tal.Rule):
        def firing(self, db, now):
            raise RuntimeError("boom")

    path = _record(tmp_path / "h", n=45)
    engine = tal.AlertEngine([Exploding("bad"), *tal.parse_rules(
        {"rules": RULES["rules"][:1]})])
    db = ttsdb.TSDB(path)
    trs = [t for now in db.raw_times() for t in engine.evaluate(db, now)]
    assert [t["rule"] for t in trs] == ["hot"]
