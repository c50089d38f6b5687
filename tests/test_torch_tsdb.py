"""Port parity: edl_tpu_torch's metric history (``obs/tsdb.py``), the
registry snapshots it stores (``obs/metrics.py``) and ``/history`` on the
port's exporter, against edl_tpu's. The same snapshots appended at the
same times give the same files and the same query results."""

import json
import math
import os
import urllib.error
import urllib.request

import pytest

from edl_tpu.obs import exporter as jexporter
from edl_tpu.obs import tsdb as jtsdb
from edl_tpu.obs.metrics import MetricsRegistry as JRegistry
from edl_tpu_torch.obs import exporter as texporter
from edl_tpu_torch.obs import tsdb as ttsdb
from edl_tpu_torch.obs.metrics import MetricsRegistry as TRegistry


def _fill(reg, i, restart_at=None):
    """One step of a process's metrics: a labelled counter (restarted
    at ``restart_at``), two gauges, a histogram."""
    n = i - restart_at if restart_at is not None and i >= restart_at else i
    c = reg.counter("edl_test_total", "c", ("kind",))
    c.inc(1.0 + n, kind="a")
    c.inc(2.0 * n, kind="b")
    g = reg.gauge("edl_slo_ttft_ok_ratio", "ok", ("slo_class",))
    g.set(1.0 - 0.01 * (i % 7), slo_class="interactive")
    g.set(0.5 + 0.02 * (i % 5), slo_class="batch")
    reg.gauge("edl_test_gauge", "g").set(float((i * 37) % 11))
    h = reg.histogram("edl_test_seconds", "h", buckets=(0.1, 0.5, 1.0))
    for k in range(n + 1):
        h.observe(0.05 * ((k * 7) % 30))
    return reg


def _snapshots(cls, n=40, restart_at=25):
    return [_fill(cls(), i, restart_at).snapshot() for i in range(n)]


def test_registry_snapshots_equal_the_references():
    tsnaps, jsnaps = _snapshots(TRegistry, 6), _snapshots(JRegistry, 6)
    assert tsnaps == jsnaps
    assert json.dumps(tsnaps) == json.dumps(jsnaps)


def _record(mod, path, snaps, t0=1000.0, dt=1.7, **kw):
    db = mod.TSDB(str(path), **kw)
    for i, s in enumerate(snaps):
        db.append(s if i % 3 else json.dumps(s), t=t0 + dt * i)
    return db


def _files(path):
    return {n: open(os.path.join(path, n)).read()
            for n in sorted(os.listdir(path))}


_QUERIES = [
    "", "name=edl_test_gauge", "name=edl_test_gauge&t0=1010&t1=1040",
    "name=edl_test_gauge&t0=1000&t1=1070&step=10",
    "name=edl_slo_ttft_ok_ratio&slo_class=interactive&step=30&t0=1000",
    "name=edl_test_total&kind=b", "name=edl_nothing",
]


def _queries(db):
    out = {
        "names": db.series_names(), "raw": db.raw_times(),
        "bytes": db.total_bytes(),
        "points": [db.points("edl_test_gauge", t0=t0, t1=t1)
                   for t0, t1 in ((-math.inf, math.inf), (1005, 1030))],
        "series": [db.series("edl_test_gauge", t0=1000, t1=1070, step=s)
                   for s in (None, 5.0, 20.0)],
        "increase": [db.increase("edl_test_total", {"kind": k}, t0, t1)
                     for k in ("a", "b")
                     for t0, t1 in ((-math.inf, math.inf), (1030, 1060))],
        "hist": [db.hist_delta("edl_test_seconds", t0=t0, t1=t1)
                 for t0, t1 in ((1000, 1020), (1030, 1060), (1000, 1100))],
        "hist_points": db.hist_points("edl_test_seconds", t0=1040),
    }
    out["history"] = [
        db.render_history({k: [v] for k, v in (
            kv.split("=") for kv in q.split("&") if kv)})
        for q in _QUERIES]
    return out


@pytest.mark.parametrize("kw", [
    {}, {"segment_bytes": 4096, "max_bytes": 24 << 10},
    {"segment_bytes": 2048, "max_bytes": 12 << 10, "tiers": (5.0, 20.0)},
], ids=["default", "retained", "small_tiers"])
def test_files_and_queries_equal_the_references(tmp_path, kw):
    tsnaps, jsnaps = _snapshots(TRegistry), _snapshots(JRegistry)
    tdb = _record(ttsdb, tmp_path / "t", tsnaps, **kw)
    jdb = _record(jtsdb, tmp_path / "j", jsnaps, **kw)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    if "max_bytes" in kw:  # retention dropped the oldest raw segments
        assert tdb.raw_times()[0] > 1000.0
    assert _queries(tdb) == _queries(jdb)
    tdb.flush()
    jdb.flush()
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    # a reopened directory resumes its numbering and answers alike
    tdb2 = _record(ttsdb, tmp_path / "t", tsnaps[:9], t0=1100.0, **kw)
    jdb2 = _record(jtsdb, tmp_path / "j", jsnaps[:9], t0=1100.0, **kw)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert _queries(tdb2) == _queries(jdb2)


@pytest.mark.parametrize("kw", [
    {}, {"segment_bytes": 2048, "max_bytes": 12 << 10, "tiers": (5.0, 20.0)},
], ids=["default", "retained"])
def test_queries_between_appends_equal_a_fresh_references(tmp_path, kw):
    """The port's store keeps each segment's parsed lines and reads only
    what was appended since its last query. Queried after appends (rolls
    and retention included), and across a torn tail that a writer later
    completes, it answers as the reference's store (which parses every
    line on every query) given the same appends."""
    tdb = ttsdb.TSDB(str(tmp_path / "t"), **kw)
    jdb = jtsdb.TSDB(str(tmp_path / "j"), **kw)
    snaps = _snapshots(TRegistry, 30, restart_at=20)
    for i, snap in enumerate(snaps):
        tdb.append(snap, t=1000.0 + 1.7 * i)
        jdb.append(snap, t=1000.0 + 1.7 * i)
        if i % 4 == 0 or i == len(snaps) - 1:
            got = _queries(tdb)
            assert got == _queries(jdb), i
            for _, h in got["hist_points"]:  # a caller that changes what
                h["counts"].clear()          # it was given changes no
                h["count"] = -1.0            # later answer
    line = json.dumps({"t": 2000.0, "snap": snaps[3]},
                      separators=(",", ":")) + "\n"
    raws = [sorted(p.glob("raw-*"))[-1] for p in (tmp_path / "t",
                                                  tmp_path / "j")]
    for cut in (slice(None, 40), slice(40, None)):
        for raw in raws:
            with open(raw, "a") as f:
                f.write(line[cut])  # a writer's half-written line, then
        assert _queries(tdb) == _queries(jdb)  # the rest of it
    assert tdb.raw_times()[-1] == 2000.0


def test_helpers_equal_the_references(tmp_path):
    reg_t, reg_j = _fill(TRegistry(), 4), _fill(JRegistry(), 4)
    assert ttsdb.flatten_snapshot(reg_t.snapshot()) == \
        jtsdb.flatten_snapshot(reg_j.snapshot())
    assert ttsdb.snapshot_from_prometheus_text(reg_t.render()) == \
        jtsdb.snapshot_from_prometheus_text(reg_j.render())
    for name, labels in (("edl_x", {"b": "2", "a": "1"}), ("edl_y", None)):
        key = ttsdb.series_key(name, labels)
        assert key == jtsdb.series_key(name, labels)
        assert ttsdb.parse_series_key(key) == jtsdb.parse_series_key(key)
    with pytest.raises(ValueError, match="not a registry snapshot"):
        ttsdb.TSDB(str(tmp_path / "h")).append({"not": "a snapshot"}, t=1.0)


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.reason


def test_history_endpoint_answers_as_the_references(tmp_path):
    tdb = _record(ttsdb, tmp_path / "t", _snapshots(TRegistry))
    jdb = _record(jtsdb, tmp_path / "j", _snapshots(JRegistry))
    tex = texporter.start_exporter(TRegistry(), history=tdb)
    jex = jexporter.start_exporter(JRegistry(), history=jdb)
    # a directory path opens a store too
    tex2 = texporter.start_exporter(TRegistry(), history=str(tmp_path / "t"))
    tbare, jbare = (texporter.start_exporter(TRegistry()),
                    jexporter.start_exporter(JRegistry()))
    try:
        for q in _QUERIES:
            got, want = _get(tex.url, "/history?" + q), _get(
                jex.url, "/history?" + q)
            assert got == want and got[0] == 200
            assert _get(tex2.url, "/history?" + q) == got
        t_hz = json.loads(_get(tex.url, "/healthz")[1])
        j_hz = json.loads(_get(jex.url, "/healthz")[1])
        assert t_hz["endpoints"] == j_hz["endpoints"]
        assert "/history" in t_hz["endpoints"]
        # without a store: the reference's 404, and no /history listed
        assert _get(tbare.url, "/history") == _get(jbare.url, "/history")
        assert _get(tbare.url, "/history")[0] == 404
        assert json.loads(_get(tbare.url, "/healthz")[1])["endpoints"] == \
            json.loads(_get(jbare.url, "/healthz")[1])["endpoints"]
    finally:
        for ex in (tex, jex, tex2, tbare, jbare):
            ex.stop()
