"""Port parity: the operator verbs of ``python -m edl_tpu_torch`` —
``top``, ``watch``, ``postmortem``, ``trace``, ``profile SOURCE``,
``export-status``, ``job-status`` and ``generate`` — against the
reference CLI (``edl_tpu.cli.main``) on the same inputs, and the
coordinator process (``runtime/coordinator_main.py``) as a subprocess.

Outputs are compared whole (stdout, exit code, the ``--json`` documents)
where both verbs print the same text; ``top`` by its summary lines (its
header names the endpoint's pid and uptime). ``generate`` compares greedy
tokens exactly: the tiny model runs in f32 on both sides. The
device-free verbs run in one subprocess that must import neither torch
nor jax.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from edl_tpu.cli.main import main as jcli
from edl_tpu.models import llama as jl
from edl_tpu.obs import events as jev
from edl_tpu.obs import metrics as jm
from edl_tpu.obs import postmortem as jpm
from edl_tpu.obs import top as jtop
from edl_tpu.obs import tsdb as jtsdb
from edl_tpu.runtime import export as jexport
from edl_tpu_torch import cli as tcli_mod
from edl_tpu_torch import obs as tobs
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.obs import disttrace as tdt
from edl_tpu_torch.obs import events as tev
from edl_tpu_torch.obs import fleet as tfleet
from edl_tpu_torch.obs import metrics as tm
from edl_tpu_torch.obs import postmortem as tpm
from edl_tpu_torch.obs import top as ttop
from edl_tpu_torch.runtime.coordinator import (CoordinatorClient,
                                               CoordinatorServer)
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
from edl_tpu_torch.utils import faults as tfaults
from edl_tpu_torch.utils import tracing as ttr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
tcli = tcli_mod.main


@pytest.fixture(autouse=True)
def _fresh():
    for m, ev in ((jm, jev), (tm, tev)):
        m.reset_default_registry()
        ev.reset_default_recorder()
    yield
    for m, ev in ((jm, jev), (tm, tev)):
        m.reset_default_registry()
        ev.reset_default_recorder()


def _both(capsys, argv):
    """(rc, stdout, stderr) of the reference verb and of the port's."""
    out = {}
    for side, main in (("ref", jcli), ("port", tcli)):
        jev.reset_default_recorder()
        tev.reset_default_recorder()
        rc = main(list(argv))
        o, e = capsys.readouterr()
        out[side] = (rc, o, e)
    return out


# ---------------------------------------------------------------------------
# top


def _fleet_registry(m):
    """A fleet-like registry: per-worker training series, serving
    histograms, reshard stalls, checkpoint I/O, alerts, incidents."""
    reg = m.MetricsRegistry()
    for w, k in (("w0", 1.0), ("w1", 2.5)):
        h = reg.histogram("edl_train_step_seconds", "s", ("worker",))
        for i in range(30):
            h.observe(0.01 * k * (1 + i % 4), worker=w)
        reg.counter("edl_train_examples_total", "x", ("worker",)).inc(
            4096 * k, worker=w)
    ttft = reg.histogram("edl_serving_ttft_seconds", "ttft")
    for i in range(40):
        ttft.observe(0.02 * (1 + i % 7))
    reg.histogram("edl_reshard_stall_seconds", "stall").observe(3.2)
    reg.gauge("edl_mfu", "mfu", ("phase",)).set(0.41, phase="serve")
    reg.gauge("edl_hbm_bytes", "hbm", ("category",)).set(2 ** 30,
                                                         category="kv")
    reg.gauge("edl_alerts_active", "a", ("severity",)).set(1,
                                                           severity="page")
    reg.counter("edl_alerts_fired_total", "f", ("rule",)).inc(2, rule="x")
    reg.counter("edl_events_total", "e", ("kind", "severity")).inc(
        3, kind="fault.injected", severity="warn")
    return reg


def test_top_summarize_lines_equal_the_references():
    lines = {}
    for side, (m, top) in {"ref": (jm, jtop), "port": (tm, ttop)}.items():
        text = _fleet_registry(m).render()
        lines[side] = top.summarize(m.parse_prometheus_text(text))
    assert lines["port"] == lines["ref"]
    assert len(lines["port"]) >= 5
    reg = _fleet_registry(tm)
    # a callable source, as the coordinator serves its fleet union
    with tobs.MetricsExporter(lambda: reg) as exp:
        body = ttop.top_once(exp.url).splitlines()
        ref_body = jtop.top_once(exp.url).splitlines()
        assert body[0].startswith(f"EDL TOP  {exp.url}  up ")
    assert body[1:] == ref_body[1:]


# ---------------------------------------------------------------------------
# watch (tests/test_tsdb.py's replay cases)


def _record_slo_dir(path, ratios):
    db = jtsdb.TSDB(str(path))
    for i, v in enumerate(ratios):
        r = jm.MetricsRegistry()
        r.gauge("edl_slo_ttft_ok_ratio", "ok", ("slo_class",)).set(
            v, slo_class="interactive")
        r.gauge("edl_slo_goodput_fraction", "gp").set(v)
        db.append(r.snapshot(), t=1000.0 + i)
    db.flush()
    return str(path)


GP_FAST = {"time_scale": 1.0, "rules": [{
    "type": "burn_rate", "name": "gp_fast",
    "series": "edl_slo_goodput_fraction", "labels": {},
    "objective": 0.95, "short_s": 3.0, "long_s": 30.0, "factor": 14.4,
    "severity": "page"}]}


@pytest.mark.parametrize("case", ["clean", "outage", "outage_text",
                                  "scaled_defaults", "bad_rules"])
def test_watch_equals_the_references(tmp_path, capsys, case):
    ratios = [1.0] * 30 if case == "clean" else [1.0] * 5 + [0.0] * 25
    rec = _record_slo_dir(tmp_path / "rec", ratios)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(GP_FAST) if case != "bad_rules"
                     else '{"rules": [{"type": "nope", "name": "r"}]}')
    argv = ["watch", rec, "--once"]
    if case != "outage_text":
        argv.append("--json")
    if case in ("outage", "outage_text", "bad_rules"):
        argv += ["--rules", str(rules)]
    if case == "scaled_defaults":
        argv += ["--time-scale", "0.01"]
    got = _both(capsys, argv)
    assert got["port"] == got["ref"]
    rc, out, _ = got["port"]
    if case == "bad_rules":
        assert rc == 2
        return
    if case == "outage_text":
        assert rc == 1 and "FIRE    gp_fast severity=page" in out
        return
    summary = json.loads(out)
    assert set(summary) == {"rules", "time_scale", "transitions", "active",
                            "pages", "fired_total"}
    # the shipped rules page on both the TTFT and the goodput burn
    pages = {"clean": 0, "outage": 1, "scaled_defaults": 2}[case]
    assert rc == summary["pages"] == pages
    # a second replay of the same directory prints the same document
    assert tcli(argv) == rc and capsys.readouterr().out == out


def test_watch_events_out_chains_in_postmortem(tmp_path, capsys):
    rec = _record_slo_dir(tmp_path / "rec", [1.0] * 5 + [0.0] * 25)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(GP_FAST))
    ev = tmp_path / "events.jsonl"
    assert tcli(["watch", rec, "--once", "--json", "--rules", str(rules),
                 "--events-out", str(ev)]) == 1
    capsys.readouterr()
    events = tpm.load_events(str(ev))
    problems = tpm.verify_recovered(events, site_prefix="alert.")
    assert problems == jpm.verify_recovered(events, site_prefix="alert.")
    assert any("never resolved" in p for p in problems)


def test_watch_tails_a_live_endpoint(tmp_path, capsys):
    reg = tm.MetricsRegistry()
    reg.gauge("edl_slo_goodput_fraction", "gp").set(1.0)
    with tobs.MetricsExporter(reg) as exp:
        rc = tcli(["watch", exp.url, "--polls", "2", "--interval", "0.05",
                   "--json", "--record", str(tmp_path / "rec")])
    summary = json.loads(capsys.readouterr().out)
    assert rc == 0 and summary["transitions"] == []
    assert len(jtsdb.TSDB(str(tmp_path / "rec")).raw_times()) == 2
    assert tcli(["watch", "127.0.0.1:9", "--once"]) == 2


# ---------------------------------------------------------------------------
# postmortem on the port's engine (tests/test_events.py's chain case)

PLAN = "serve.dispatch:raise@n=2;serve.drain:raise@n=5"


def _engine_dump(path, plan=None):
    """The port's engine on LlamaConfig.tiny (CPU) under a fault plan;
    its flight recorder dumped to ``path``."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=0, device="cpu")
    rec = tev.reset_default_recorder()
    if plan:
        tfaults.arm(plan, seed=0)
    try:
        eng = ContinuousBatchingEngine(params, cfg, max_slots=2, max_len=64,
                                       horizon=4, device="cpu")
        eng.submit("x", [1, 2, 3], 8)
        eng.submit("y", [4, 5, 6], 7)
        eng.step()
        eng.submit("z", [7, 8], 6)
        res = eng.run()
    finally:
        tfaults.disarm()
    assert {r.outcome for r in res.values()} <= {"done", "eos"}
    rec.dump(str(path))
    return eng


def test_postmortem_equals_the_reference_on_a_port_dump(tmp_path, capsys):
    eng = _engine_dump(tmp_path / "fault.jsonl", PLAN)
    assert eng.recoveries == 2
    _engine_dump(tmp_path / "clean.jsonl")
    dump, clean = str(tmp_path / "fault.jsonl"), str(tmp_path / "clean.jsonl")
    recs = tpm.load_events(dump)
    assert recs == jpm.load_events(dump)
    for fn in ("fault_chains", "incidents", "alert_chains",
               "verify_no_incidents", "ring_dropped"):
        assert getattr(tpm, fn)(recs) == getattr(jpm, fn)(recs), fn
    assert tpm.by_rid(recs) == jpm.by_rid(recs)
    assert tpm.verify_recovered(recs) == jpm.verify_recovered(recs) == []
    assert len(tpm.fault_chains(recs)) == 2
    cases = {
        ("--assert-recovered",): 0,
        ("--assert-no-incidents",): 1,
        ("--rid", "y"): 0,
        ("--assert-recovered", "--sites", "coord."): 1,
    }
    for flags, want in cases.items():
        got = _both(capsys, ["postmortem", dump, *flags])
        assert got["port"] == got["ref"], flags
        assert got["port"][0] == want, (flags, got["port"])
    got = _both(capsys, ["postmortem", clean, "--assert-no-incidents"])
    assert got["port"] == got["ref"] and got["port"][0] == 0
    assert "postmortem assertions OK" in got["port"][1]
    got = _both(capsys, ["postmortem", str(tmp_path / "nope.jsonl")])
    assert got["port"][0] == got["ref"][0] == 2


def test_postmortem_loads_a_live_events_url():
    rec = tev.default_recorder()
    rec.emit("live.k", rid="u1")
    with tobs.MetricsExporter(tm.MetricsRegistry()) as exp:
        assert [e["kind"] for e in tpm.load_events(exp.url)] == ["live.k"]
        assert [e["kind"] for e in tpm.load_events(exp.url + "/events")] \
            == ["live.k"]
        with pytest.raises(ValueError):
            tpm.load_events(exp.url + "/events?rid=nope")


# ---------------------------------------------------------------------------
# trace


def _trace_file(path):
    tr = ttr.Tracer()
    with tdt.root("reshard", 4):
        with tr.span("worker.restore", reshard_epoch=4):
            with tr.span("checkpoint.load_sharded"):
                pass
    for i in (7, 8):
        with tdt.root("step", "j", 4, i):
            with tr.span("coord.go", step=i):
                pass
            with tr.span("train.step", step=i):
                pass
    doc = tdt.merge_fleet_trace({"w0": tdt.span_window_doc(tr)})
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("flags,want", [
    (("--step", "7", "--json"), 0),
    (("--reshard-epoch", "4", "--json", "--assert-critical-path"), 0),
    (("--reshard-epoch", "4"), 0),
    (("--step", "9", "--assert-critical-path"), 1),
    (("--rid", "nope", "--json"), 0)])
def test_trace_equals_the_reference(tmp_path, capsys, flags, want):
    src = _trace_file(tmp_path / "t.json")
    got = _both(capsys, ["trace", src, *flags])
    assert got["port"] == got["ref"]
    assert got["port"][0] == want
    if "--json" in flags and want == 0 and "--rid" not in flags:
        hops = json.loads(got["port"][1].splitlines()[-1])["hops"]
        assert len(hops) == 2
    bad = _both(capsys, ["trace", str(tmp_path / "missing"), "--timeout",
                         "0.5"])
    assert bad["port"][0] == bad["ref"][0] == 2


# ---------------------------------------------------------------------------
# profile SOURCE, export-status, job-status


def test_profile_source_equals_the_reference(capsys):
    for src in ("BENCH_r05.json", "BENCH_r06.json"):
        for fmt in ((), ("--json",)):
            got = _both(capsys, ["profile", os.path.join(ROOT, src), *fmt])
            assert got["port"] == got["ref"] and got["port"][0] == 0
    got = _both(capsys, ["profile"])
    assert got["port"] == got["ref"] and got["port"][0] == 2


def test_profile_dryrun_and_generate_mesh_name_item_2b(tmp_path, capsys):
    """``profile --dryrun`` runs since the mesh slice (ElasticTrainer):
    on the CPU when asked, never silently there; ``generate --mesh``
    waits for item 2f of 2b's second half."""
    from edl_tpu_torch.obs import memledger as tmem

    # the fixture swapped the default registry: the ledger publishes there
    tmem.reset_default_ledger(tm.default_registry())
    assert tcli(["profile", "--dryrun", "--device", "cpu", "--steps",
                 "2"]) == 0
    assert "profile dryrun OK" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert tcli(["profile", "--dryrun"]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    assert tcli(["generate", str(tmp_path), "--prompt", "1,2",
                 "--mesh", "tp=2"]) == 1
    err = capsys.readouterr().err
    assert "not ported yet (ROADMAP item 2f" in err and "item 2b" in err
    assert tcli(["generate", str(tmp_path), "--prompt", "1,2", "--mesh",
                 "tp=2", "--int8"]) == 1
    assert capsys.readouterr().err.strip() == \
        "--int8 and --mesh are mutually exclusive"


JCFG = jl.LlamaConfig.tiny()
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def export_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    jexport.export_params(str(root), JP, step=3, dtype="float32",
                          model_meta=JCFG.to_meta())
    return str(root)


def test_export_status_equals_the_reference(tmp_path, capsys, export_root):
    got = _both(capsys, ["export-status", export_root])
    assert got["port"] == got["ref"] and got["port"][0] == 0
    assert got["port"][1].startswith("step=3 dtype=float32 ")
    for side, main in (("ref", jcli), ("port", tcli)):
        dst = tmp_path / side
        assert main(["export-status", export_root, "--fetch", str(dst)]) == 0
        assert sorted(os.listdir(dst)) == ["manifest.json", "params.npz"]
    assert capsys.readouterr().out.count("fetched -> ") == 2
    got = _both(capsys, ["export-status", str(tmp_path / "none")])
    assert got["port"] == got["ref"] and got["port"][0] == 1


def test_job_status_equals_the_reference(capsys):
    with CoordinatorServer() as srv:
        c = srv.client()
        c.register("w000", 1)
        c.register("w001", 1)
        for k, v in (("phase", "running"), ("progress", "41"),
                     ("reshards", "2"), ("loss_first", "0.69"),
                     ("loss_last", "0.41"), ("eval_metric", "auc:0.71"),
                     ("restore_last", "p2p:40")):
            c.kv_put(f"job1/{k}", v)
        c.queue_init(100, 10, passes=1, lease_timeout_s=30.0)
        t = c.lease("w000")
        c.ack(t.task_id)
        c.lease("w001")
        got = _both(capsys, ["job-status", "job1", "--coordinator",
                             f"127.0.0.1:{srv.port}"])
        c.close()
    assert got["port"] == got["ref"] and got["port"][0] == 0
    assert "queue          todo=8 leased=1 done=1 dead=0" in got["port"][1]
    assert "workers        w000,w001" in got["port"][1]
    assert tcli(["job-status", "job1", "--coordinator", "127.0.0.1:x"]) == 1


# ---------------------------------------------------------------------------
# generate (tests/test_llama_generate.py's verb cases)


def _tokens(out):
    return [int(t) for t in out.strip().split(",")]


@pytest.mark.parametrize("int8", [False, True])
def test_generate_greedy_tokens_equal_the_references(capsys, export_root,
                                                     int8):
    argv = ["generate", export_root, "--prompt", "1,2,3,4,9,11",
            "--max-new", "7"] + (["--int8"] if int8 else [])
    assert jcli(argv) == 0
    want = _tokens(capsys.readouterr().out)
    assert tcli(argv + ["--device", "cpu"]) == 0
    assert _tokens(capsys.readouterr().out) == want
    direct = (jl.generate(jl.quantize_params_int8(JP) if int8 else JP,
                          jax.numpy.asarray([[1, 2, 3, 4, 9, 11]]), JCFG,
                          max_new=7))
    assert want == np.asarray(direct)[0].tolist()


def test_generate_samples_deterministically_per_seed(capsys, export_root):
    argv = ["generate", export_root, "--prompt", "1,2,3", "--max-new", "6",
            "--temperature", "0.9", "--top-k", "8", "--top-p", "0.9",
            "--device", "cpu"]
    runs = []
    for seed in ("5", "5", "6"):
        assert tcli(argv + ["--seed", seed]) == 0
        runs.append(_tokens(capsys.readouterr().out))
    assert runs[0] == runs[1] and len(runs[0]) == 6
    assert all(0 <= t < JCFG.vocab for t in runs[2])


@pytest.mark.parametrize("flags", [
    ("--top-k", "5"), ("--top-p", "0.5"),
    ("--temperature", "0.9", "--top-k", "-1"),
    ("--temperature", "0.9", "--top-p", "1.5"),
    ("--temperature", "0.9", "--top-p", "0"),
    ("--prompt", "1,a"), ("--max-new", "0"), ("--prompt", "1,999"),
    ("--temperature", "0.9", "--top-k", "999"), ("--export", "none")])
def test_generate_flag_checks_equal_the_references(capsys, export_root,
                                                   tmp_path, flags):
    flags = list(flags)
    root = export_root
    if flags[0] == "--export":
        root, flags = str(tmp_path / "none"), []
    if "--prompt" not in flags:
        flags = ["--prompt", "1,2"] + flags
    out = {}
    for side, main, extra in (("ref", jcli, []),
                              ("port", tcli, ["--device", "cpu"])):
        rc = main(["generate", root, *flags, *extra])
        o, e = capsys.readouterr()
        out[side] = (rc, o, e)
    assert out["port"][0] == 1 and out["port"][:2] == out["ref"][:2]
    if "999" in flags and "--top-k" in flags:
        # the bound check's wording is each generate's own
        assert "top_k" in out["port"][2]
    else:
        assert out["port"][2] == out["ref"][2]


# ---------------------------------------------------------------------------
# coordinator_main as a process; the device-free verbs without torch


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))


def test_coordinator_main_serves_the_fleet(tmp_path):
    """``--metrics-port 0 --tsdb-dir``: ``/metrics`` is the reference's
    aggregation of the pushed snapshots (one pushed by each package),
    ``/events`` and ``/trace`` carry the worker, the history directory
    gets appends, and SIGTERM exits 0."""
    from edl_tpu.obs import fleet as jfleet

    s = __import__("socket").socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    db = tmp_path / "db"
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.runtime.coordinator_main",
         "--port", str(port), "--metrics-port", "0", "--job", "smoke",
         "--tsdb-dir", str(db), "--watch-interval", "0.5"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"coordinator on :(\d+); fleet metrics at (\S+)/metrics"
                     r" \(fleet event log at /events, merged fleet trace at"
                     r" /trace\)$", line.strip())
        assert m and int(m.group(1)) == port, line
        url = m.group(2)
        c = CoordinatorClient("127.0.0.1", port)
        for worker, (mod, fl, ev) in (("smoke0", (tm, tfleet, tev)),
                                      ("smoke1", (jm, jfleet, jev))):
            c.register(worker, 1)
            reg = mod.MetricsRegistry()
            reg.counter("edl_train_examples_total", "x").inc(12)
            rec = ev.FlightRecorder()
            rec.set_context(worker=worker)
            rec.emit("worker.join", epoch=1)
            tr = ttr.Tracer()
            with tr.span("train.step", step=1):
                pass
            p = fl.MetricsPusher(
                lambda v, k=fl.metrics_key("smoke", worker): c.kv_put(k, v),
                registry=reg, recorder=rec, tracer=tr,
                events_publish=lambda v, k=fl.events_key("smoke", worker):
                c.kv_put(k, v),
                trace_publish=lambda v, k=fl.trace_key("smoke", worker):
                c.kv_put(k, v))
            assert p.push_once()
        from edl_tpu_torch.obs.exporter import scrape

        got = scrape(url)
        want = jfleet.collect_fleet(c, "smoke", ("dist_service",)).render()
        assert got == want
        assert 'edl_train_examples_total{worker="smoke0"} 12' in got
        evs = [json.loads(x) for x in scrape(url, "/events").splitlines()]
        assert {e["corr"]["worker"] for e in evs} == {"smoke0", "smoke1"}
        doc = json.loads(scrape(url, "/trace"))
        assert {"smoke0", "smoke1"} <= set(doc["workers"])
        deadline = time.monotonic() + 10
        while not (db.exists() and jtsdb.TSDB(str(db)).raw_times()):
            assert time.monotonic() < deadline, "no history appends"
            time.sleep(0.1)
        c.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
    assert rc == 0, proc.stderr.read()


def test_device_free_verbs_import_neither_torch_nor_jax(tmp_path):
    """top, watch, postmortem, trace, job-status and profile SOURCE in
    one process: each exits as expected and neither torch nor jax is
    ever imported."""
    rec_dir = _record_slo_dir(tmp_path / "rec", [1.0] * 10)
    trace = _trace_file(tmp_path / "t.json")
    dump = tmp_path / "ev.jsonl"
    r = jev.FlightRecorder()
    r.emit("serve.submit", rid="a")
    r.dump(str(dump))
    code = f"""
import sys
from edl_tpu_torch import obs
from edl_tpu_torch.cli import main
from edl_tpu_torch.runtime.coordinator import CoordinatorServer
with obs.MetricsExporter(obs.MetricsRegistry()) as exp, \\
        CoordinatorServer() as srv:
    rcs = [main(["top", exp.url, "--polls", "1"]),
           main(["watch", {rec_dir!r}, "--once", "--json"]),
           main(["postmortem", {str(dump)!r}, "--assert-no-incidents"]),
           main(["trace", {trace!r}, "--step", "7", "--json"]),
           main(["job-status", "j", "--coordinator",
                 f"127.0.0.1:{{srv.port}}"]),
           main(["profile", {os.path.join(ROOT, "BENCH_r06.json")!r}])]
bad = [m for m in ("torch", "jax") if m in sys.modules]
print("RESULT", rcs, bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT")][0]
    assert line == "RESULT [0, 0, 0, 0, 0, 0] []", out.stdout



def test_chip_smoke_generate_gate_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's generate gate at LlamaConfig.tiny with flash on:
    both verbs' tokens equal the in-process generate's on the loader's
    params, and each verb run counts one forward a layer (the plain
    forward counted as the kernel); a planted divergence of the verb's
    tokens trips it, and so does a verb run that counts no launch."""
    import dataclasses

    import chip_smoke
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime import export as texport

    plain = fa.flash_attention_ref

    def counting(*a, **k):
        fa._launched("flash_fwd")
        return plain(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_ref", counting)
    monkeypatch.setattr(chip_smoke, "SL_GENERATE",
                        dict(chip_smoke.SL_GENERATE, prompt=24, max_new=5))
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True)
    root = str(tmp_path / "export")
    texport.export_params(root, tl.init_params(cfg, seed=4, device="cpu"),
                          step=1, model_meta=cfg.to_meta())
    rows, launches = chip_smoke._generate_check(root, cfg.vocab, "cpu")
    assert launches == {"bf16": cfg.n_layers, "int8": cfg.n_layers}
    assert [r["tokens_equal"] for r in rows] == [True, True]
    real, calls = tl.generate, []

    def verb_shifted(*a, **k):  # the verb's call is the first
        calls.append(1)
        return (real(*a, **k) + (len(calls) == 1)) % cfg.vocab

    monkeypatch.setattr(tl, "generate", verb_shifted)
    with pytest.raises(AssertionError, match="the verb's tokens"):
        chip_smoke._generate_check(root, cfg.vocab, "cpu")
    monkeypatch.setattr(tl, "generate", real)
    monkeypatch.setattr(fa, "flash_attention_ref", plain)  # uncounted
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke._generate_check(root, cfg.vocab, "cpu")
