"""Port parity: the obs layer of edl_tpu_torch vs edl_tpu.

The port keeps its own copies of the reference's jax-free telemetry
modules — the metrics registry and its Prometheus text, the fault plan
grammar, the flight recorder, the tracer and the trace context, the
compile watch, the cost model and efficiency meter, the memory ledger,
the HTTP exporter, the tracer bridge and the profile report — and each
is held here to the reference module for the same operations: equal
values, and byte-equal rendered text. Also the port's own parts: the
card's peak table (no fallback on an unnamed card), the torch.profiler
helper, the ledger's allocator cross-check, the checkpoint's
``ckpt.commit`` site and events, and the compile watch on
``llama.generate`` and the train-step factories.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.obs import compilewatch as jcw
from edl_tpu.obs import costmodel as jcm
from edl_tpu.obs import disttrace as jdt
from edl_tpu.obs import events as jev
from edl_tpu.obs import memledger as jml
from edl_tpu.obs import metrics as jm
from edl_tpu.obs import profile as jprof
from edl_tpu.utils import faults as jfaults
from edl_tpu.utils import tracing as jtr
from edl_tpu_torch import obs as tobs
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import compilewatch as tcw
from edl_tpu_torch.obs import costmodel as tcm
from edl_tpu_torch.obs import disttrace as tdt
from edl_tpu_torch.obs import events as tev
from edl_tpu_torch.obs import exporter as texp
from edl_tpu_torch.obs import memledger as tml
from edl_tpu_torch.obs import metrics as tm
from edl_tpu_torch.obs import profile as tprof
from edl_tpu_torch.utils import faults as tfaults
from edl_tpu_torch.utils import tracing as ttr

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# both sides' process-wide state, swapped for fresh objects per test
SIDES = {
    "ref": (jm, jev, jml, jcw, jfaults, jtr),
    "port": (tm, tev, tml, tcw, tfaults, ttr),
}


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh default registry, ledger, recorder and tracer on both
    sides; faults disarmed and the compile watch back to warmup."""
    for m, ev, ml, cw, fa, tr in SIDES.values():
        ml.reset_default_ledger(m.reset_default_registry())
        ev.reset_default_recorder()
        tr.tracer().clear()
        cw.reset()
        fa.disarm()
    yield
    for m, ev, ml, cw, fa, tr in SIDES.values():
        cw.reset()
        fa.disarm()


def _drive_registry(m, reg):
    """One fixed sequence of registry operations (labels with escapes,
    weighted observations, +Inf, integral and fractional values)."""
    m.ensure_core_series(reg)
    c = reg.counter("edl_x_total", 'a "help"\nline\\', ("k", "q"))
    c.inc(k="a", q='x"y')
    c.inc(2.5, k="b\\n", q="z\nw")
    g = reg.gauge("edl_g", "gauge help")
    g.set(3.0)
    g.inc(0.25)
    h = reg.histogram("edl_h_seconds", "h help", ("phase",),
                      buckets=(0.1, 1.0, 10.0))
    for v, n in ((0.05, 1), (0.5, 3), (5.0, 2), (50.0, 1)):
        h.observe(v, n=n, phase="decode")
    h.observe(0.2, phase="prefill")
    reg.histogram("edl_serving_ttft_seconds").observe(0.012)
    reg.gauge("edl_mfu", "", ("phase",)).set(1e-7, phase="decode")
    reg.gauge("edl_big", "").set(1e16)
    return reg


def test_rendered_text_is_byte_equal_to_the_reference():
    ref = _drive_registry(jm, jm.MetricsRegistry()).render()
    got = _drive_registry(tm, tm.MetricsRegistry()).render()
    assert got == ref
    assert "edl_faults_injected_total" in got  # the core catalog rendered
    # the default-registry path: same text after the same operations
    assert (_drive_registry(tm, tm.default_registry()).render()
            == _drive_registry(jm, jm.default_registry()).render())


def test_prometheus_parse_and_bucket_percentiles_match():
    text = _drive_registry(jm, jm.MetricsRegistry()).render()
    want = jm.parse_prometheus_text(text)
    got = tm.parse_prometheus_text(text)
    assert got == want
    pairs = got["edl_h_seconds_bucket"]
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert (tm.percentile_from_buckets(pairs, q)
                == jm.percentile_from_buckets(pairs, q))
    reg_t, reg_j = tm.MetricsRegistry(), jm.MetricsRegistry()
    for r in (reg_t, reg_j):
        h = r.histogram("edl_p", "", ())
        for v in (0.0005, 0.003, 0.02, 0.4, 7.0, 100.0):
            h.observe(v)
    for q in (0.5, 0.95, 0.99):
        assert (reg_t.get("edl_p").percentile(q)
                == reg_j.get("edl_p").percentile(q))


# -- faults ---------------------------------------------------------------------


PLANS = [
    "serve.dispatch:raise@n=3",
    "serve.dispatch:raise@n=2;serve.drain:raise@n=5",
    "a:drop@every=2,max=3;b:delay@p=0.5,s=0",
    "x:raise@p=0.3",
]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_plans_fire_as_the_reference(plan):
    """The same plan and seed fire at the same calls with the same
    exception types, and the per-site counts and the injection counter
    agree."""
    def drive(fa, m):
        specs = fa.arm(plan, seed=7)
        fired = []
        sites = [s.site for s in specs]
        for i in range(40):
            site = sites[i % len(sites)]
            try:
                fa.fault_point(site)
            except Exception as e:  # the injected kinds
                fired.append((i, site, type(e).__bases__[0].__name__,
                              str(e)))
        c = m.default_registry().get("edl_faults_injected_total")
        return ([tuple(vars(s).values()) for s in specs], fired,
                fa.counts(), sorted(c.samples()) if c else [])

    assert drive(tfaults, tm) == drive(jfaults, jm)


@pytest.mark.parametrize("bad", ["", "nosep", "s:boom@n=1", "s:raise@n=1,p=0.5",
                                 "s:raise@q=1", "s:raise@p=2"])
def test_bad_fault_plans_raise_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_plan(bad)
    with pytest.raises(ValueError) as got:
        tfaults.parse_plan(bad)
    assert str(got.value) == str(want.value)


def test_faults_arm_from_the_environment(tmp_path, monkeypatch):
    """``EDL_FAULTS`` as the grammar (seeded by ``EDL_FAULTS_SEED``) and
    as a JSON file, the reference's two forms; an unarmed site is a
    no-op."""
    tfaults.fault_point("serve.dispatch")  # unarmed: nothing happens
    monkeypatch.setenv("EDL_FAULTS", "serve.drain:raise@n=1")
    tfaults._maybe_arm_from_env()
    with pytest.raises(tfaults.InjectedFault, match="serve.drain"):
        tfaults.fault_point("serve.drain")
    doc = {"seed": 3, "faults": [{"site": "ckpt.commit", "action": "drop",
                                  "n": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setenv("EDL_FAULTS", "@" + str(path))
    tfaults._maybe_arm_from_env()
    assert tfaults.armed()
    with pytest.raises(ConnectionError):
        tfaults.fault_point("ckpt.commit")
    assert tfaults.counts() == {"ckpt.commit": 1}
    assert [e.kind for e in tev.default_recorder().events()] == [
        "fault.injected", "fault.injected"]


# -- flight recorder, tracer, trace context -------------------------------------


def _norm_record(r):
    return {k: v for k, v in r.items() if k not in ("t_wall", "t_mono")}


def _drive_recorder(ev, dt):
    rec = ev.FlightRecorder(max_events=4)
    rec.set_context(worker="w1")
    rec.emit("serve.submit", rid="r1", prompt_len=3)
    with dt.root("rid", "r1"):
        rec.emit("serve.prefill", rid="r1", slot=0, bucket=8)
    rec.emit("ckpt.commit", step=5, fmt="dense")
    rec.emit("fault.injected", "warn", site="serve.drain", nth=2)
    rec.emit("serve.finish", rid="r1", outcome="done", tokens=4)
    rec.emit("serve.submit", rid="r2")
    with pytest.raises(ValueError):
        rec.emit("x", severity="fatal")
    return rec


def test_flight_recorder_matches_the_reference():
    want = _drive_recorder(jev, jdt)
    got = _drive_recorder(tev, tdt)
    assert ([_norm_record(r) for r in got.records()]
            == [_norm_record(r) for r in want.records()])
    assert got.dropped == want.dropped == 2 and got.counts() == want.counts()
    assert ([_norm_record(r) for r in got.records(rid="r1")]
            == [_norm_record(r) for r in want.records(rid="r1")])
    # the prefill under the rid root carries the derived trace id
    pf = got.records(kind="serve.prefill")
    assert pf == [] or pf[0]["corr"]["trace_id"] == tdt.derived_trace_id(
        "rid", "r1")
    # JSONL and the one-line window both load back through either side
    for text in (got.to_jsonl(), got.window_json()):
        assert ([_norm_record(r) for r in tev.load_jsonl(text)]
                == [_norm_record(r) for r in jev.load_jsonl(text)])
    assert tev.default_recorder().counts() == {}


def test_events_count_into_the_registry_and_crash_dump(tmp_path, monkeypatch):
    tev.emit("serve.block", active=2, horizon=8)
    tev.emit("serve.block", active=1, horizon=8)
    c = tm.default_registry().get("edl_events_total")
    assert c.value(kind="serve.block") == 2
    assert tev.crash_dump("serving") is None  # EDL_BLACKBOX_DIR unset
    monkeypatch.setenv("EDL_BLACKBOX_DIR", str(tmp_path))
    path = tev.crash_dump("serving", RuntimeError("boom"))
    recs = tev.load_jsonl(path)
    assert [r["kind"] for r in recs] == ["serve.block", "serve.block",
                                         "blackbox.crash"]
    assert recs[-1]["attrs"]["error"] == "RuntimeError: boom"
    # warn/error log lines mirror onto the timeline
    from edl_tpu_torch.utils.logging import kv_logger

    kv_logger("serving").warn("engine fault; recovering", live=2)
    ev = tev.default_recorder().events(kind="log.warn")[-1]
    assert ev.attrs == {"logger": "edl_tpu_torch.serving",
                        "msg": "engine fault; recovering", "live": 2}


def _drive_tracer(tr, dt):
    t = tr.Tracer(max_spans=3)
    seen = []
    t.add_listener(lambda s: seen.append(s.name))
    with dt.root("rid", "r7"):
        with t.span("serving.prefill", bucket=8, rid="r7"):
            with t.span("inner"):
                pass
    for i in range(3):
        with t.span("serving.dispatch", horizon=4):
            pass
    return t, seen


def test_tracer_and_trace_context_match_the_reference():
    (jt, jseen), (tt, tseen) = _drive_tracer(jtr, jdt), _drive_tracer(ttr, tdt)
    assert tseen == jseen
    assert ({k: v["count"] for k, v in tt.summary().items() if k != "_tracer"}
            == {k: v["count"] for k, v in jt.summary().items()
                if k != "_tracer"})
    assert tt.summary()["_tracer"] == jt.summary()["_tracer"]
    assert tt.dropped == jt.dropped == 2
    doc = tt.to_chrome_doc()
    meta = doc["traceEvents"][-1]
    assert meta["ph"] == "M" and meta["args"]["dropped"] == 2
    assert len(tt.to_chrome_doc(since_seq=4)["traceEvents"]) == 2
    for rid in ("r0", "r17", "warm3"):
        assert tdt.derived_trace_id("rid", rid) == jdt.derived_trace_id(
            "rid", rid)
    assert tdt.derived_trace_id("step", "job", 2, 9) == jdt.derived_trace_id(
        "step", "job", 2, 9)
    # inject / extract / ids_of / without_ids round trips
    ctx = tdt.TraceContext("t1", "s1", "p1")
    d = tdt.inject({"x": 1}, ctx)
    assert d == jdt.inject({"x": 1}, jdt.TraceContext("t1", "s1", "p1"))
    assert tdt.extract(d) == ctx and tdt.ids_of(d) == ("t1", "s1", "p1")
    assert tdt.without_ids(d) == {"x": 1}
    assert tdt.extract({}) is None
    # the span window: the same records through both loaders
    raw = tdt.span_window_json(tt, last_n=2)
    got, want = tdt.load_span_window(raw), jdt.load_span_window(raw)
    assert got == want and len(got["spans"]) == 2
    assert tdt.load_span_window("not json") is None


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    """The profiler helper has no silent branch: it profiles and writes
    the trace (here the CPU activity)."""
    path = tmp_path / "prof" / "trace.json"
    with ttr.torch_profile(str(path), cuda=False) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    doc = json.loads(path.read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


# -- compile watch ----------------------------------------------------------------


def test_compile_watch_matches_the_reference():
    """First calls are counted once per wrapper; after ``mark_warm`` a
    new wrapper's first call is an ``obs.recompile`` event on both
    sides."""
    def drive(cw, ev, m):
        a, b = cw.wrap(lambda x: x + 1, "serve.block"), cw.wrap(
            lambda x: x, "serve.prefill")
        assert [a(1), a(2), b(3)] == [2, 3, 3]
        cw.mark_warm()
        c = cw.wrap(lambda: None, "serve.prefill")
        c()
        c()
        r = m.default_registry()
        return (sorted(r.get("edl_compiles_total").samples()),
                r.get("edl_compile_seconds").stats(program="serve.prefill")[
                    "count"],
                [(e.kind, e.attrs["program"])
                 for e in ev.default_recorder().events()])

    assert drive(tcw, tev, tm) == drive(jcw, jev, jm)


def test_generate_and_train_factories_are_compile_watched():
    """``llama.generate`` counts one ``llama.generate`` first call per
    reference program key (shapes, max_new, sampling mode), as the
    reference does; each train-step factory instance one
    ``train.step`` / ``train.multistep``."""
    from edl_tpu_torch.train import trainer

    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jl._generate_programs.clear()
    tl._generate_programs.clear()
    calls = [([[1, 2, 3]], 4), ([[1, 2, 3]], 4), ([[4, 5, 6]], 4),
             ([[1, 2]], 4), ([[1, 2, 3], [3, 2, 1]], 4), ([[1, 2, 3]], 2)]
    for prompt, n in calls:
        want = jl.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg, n)
        got = tl.generate(tp, torch.tensor(prompt), tcfg, n)
        assert got.tolist() == np.asarray(want).tolist()
    gw = tm.default_registry().get("edl_compiles_total")
    assert (gw.value(program="llama.generate")
            == jm.default_registry().get("edl_compiles_total").value(
                program="llama.generate") == 4)

    params = trainer.trainable(tl.init_params(tcfg, seed=0, device="cpu"))
    loss_fn = tl.make_loss_fn(tcfg)
    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(params, tx)
    tok = torch.randint(0, tcfg.vocab, (2, 9), generator=torch.Generator()
                        .manual_seed(0))
    step = trainer.make_train_step(loss_fn, tx)
    for _ in range(3):
        state, _ = step(state, {"tokens": tok})
    multi = trainer.make_train_multistep(loss_fn, tx)
    state, out = multi(state, {"tokens": tok[None].repeat(2, 1, 1)})
    assert out["losses"].shape == (2,)
    c = tm.default_registry().get("edl_compiles_total")
    assert c.value(program="train.step") == 1
    assert c.value(program="train.multistep") == 1
    assert tm.default_registry().get("edl_train_steps_total").value() == 5


# -- cost model -------------------------------------------------------------------


def _cfg_pairs():
    return [(jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()),
            (jl.LlamaConfig.llama3_8b(), tl.LlamaConfig.llama3_8b())]


@pytest.mark.parametrize("which", ["tiny", "8b"])
def test_cost_formulas_equal_the_reference(which):
    jc, tc = _cfg_pairs()[which == "8b"]
    for f, args in (
        ("matmul_params", ()), ("n_params", ()), ("param_bytes", ()),
        ("param_bytes", (4,)), ("train_flops_per_token", (2048,)),
        ("fwd_flops_per_token", (512,)), ("prefill_flops", (1024,)),
        ("decode_flops_per_token", (2048,)),
        ("kv_cache_bytes", (8, 2048)), ("kv_cache_bytes", (8, 2048, 0.5)),
        ("kv_pool_bytes", (129, 16)), ("kv_pool_bytes", (129, 16, 1)),
        ("kv_scale_bytes", (8, 2048, 16)), ("kv_scale_bytes", (8, 2048, 0)),
        ("decode_step_bytes", (16.06e9, 8, 2048)),
        ("decode_step_bytes", (16.06e9, 8, 2048, 1, 16)),
        ("train_step_bytes", (8192,)), ("attn_flops_per_token_train", (8192,)),
    ):
        assert getattr(tcm, f)(tc, *args) == getattr(jcm, f)(jc, *args), f
    for q in ("off", "int8", "int4"):
        assert tcm.kv_quant_bytes_per_el(q) == jcm.kv_quant_bytes_per_el(q)
    assert (tcm.ctr_train_flops_per_example()
            == jcm.ctr_train_flops_per_example())
    # the CostModel bundle at one peak, with and without quantized KV
    for kw in ({}, {"param_bytes_total": 8.5e9, "kv_bytes_per_el": 1,
                    "kv_block_size": 16}):
        tmod = tcm.CostModel(tc, peak=tcm.DevicePeak("p", 989e12, 3.35e12),
                             **kw)
        jmod = jcm.CostModel(jc, peak=jcm.DevicePeak("p", 989e12, 3.35e12),
                             **kw)
        for name, args in (("train_step", (4, 2048)), ("prefill", (512,)),
                           ("decode_block", (8, 8, 2048)),
                           ("verify_block", (8, 5, 2048))):
            a, b = getattr(tmod, name)(*args), getattr(jmod, name)(*args)
            assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes), name
        assert tmod.mfu(1e14) == jmod.mfu(1e14)
        assert tmod.bw_util(1e12) == jmod.bw_util(1e12)


def test_efficiency_meter_matches_the_reference():
    def drive(cm, m):
        reg = m.MetricsRegistry()
        meter = cm.EfficiencyMeter(cm.DevicePeak("p", 989e12, 3.35e12),
                                   registry=reg)
        meter.observe("prefill", cm.Cost(3e12, 2e10), 0.05)
        meter.observe("decode", cm.Cost(1e11, 1.7e11), 0.2)
        meter.observe("decode", cm.Cost(1e11, 1.7e11), 0.0)  # ignored
        meter.observe("decode", cm.Cost(2e11, 3e11), 0.3)
        meter.set_rates("train", 4e14, 1e12)
        return reg.render(), cm.efficiency_snapshot(reg)

    assert drive(tcm, tm) == drive(jcm, jm)


def test_peak_table_is_the_cards_and_has_no_fallback(monkeypatch):
    """The table names the H100 SXM and PCIe (PCIe matched first); the
    CPU gets the SXM row labelled as assumed; an unnamed card raises
    unless both overrides are set, which also apply on top of a named
    card."""
    monkeypatch.delenv("EDL_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("EDL_PEAK_HBM_GBS", raising=False)
    sxm = tcm.peak_for_kind("NVIDIA H100 80GB HBM3")
    assert (sxm.flops, sxm.hbm_bytes_s) == (989e12, 3.35e12)
    pcie = tcm.peak_for_kind("NVIDIA H100 PCIe")
    assert (pcie.flops, pcie.hbm_bytes_s) == (756e12, 2.0e12)
    for name in ("NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        with pytest.raises(KeyError):
            tcm.peak_for_kind(name)
    cpu = tcm.detect_peak("cpu")
    assert "assumed" in cpu.kind and cpu.flops == 989e12
    # an unnamed card (faked: the query is all torch.cuda offers)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA B200")
    with pytest.raises(ValueError, match="EDL_PEAK_TFLOPS"):
        tcm.detect_peak("cuda")
    monkeypatch.setenv("EDL_PEAK_TFLOPS", "2250")
    with pytest.raises(ValueError, match="EDL_PEAK_HBM_GBS"):
        tcm.detect_peak("cuda")
    monkeypatch.setenv("EDL_PEAK_HBM_GBS", "8000")
    p = tcm.detect_peak()
    assert (p.kind, p.flops, p.hbm_bytes_s) == ("NVIDIA B200+env", 2250e12,
                                                8000e9)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.delenv("EDL_PEAK_TFLOPS")
    p = tcm.detect_peak("cuda")
    assert (p.kind, p.flops, p.hbm_bytes_s) == ("H100 SXM+env", 989e12,
                                                8000e9)


# -- memory ledger ----------------------------------------------------------------


def _drive_ledger(ml, m):
    reg = m.MetricsRegistry()
    led = ml.MemoryLedger(reg)
    led.register("e1", "params", 1000, "params")
    led.register("e1", "kv", 4096, "kv")
    led.register("e1", "kv", 2048, "kv")  # replace, not add
    led.register("e2", "kv", 512, "kv")
    led.register("e2", "slot_state", 40, "slot_state")
    led.set_kv_usage("e1", 10, 100)
    led.set_kv_usage("e2", 30, 100)
    led.set_kv_blocks_free("e2", 7)
    led.set_kv_bytes_per_token("e2", 512, 64)
    led.count_prefix_hits(3)
    mid = (led.total(), led.total("kv"), led.owner_total("e1"),
           led.categories(), led.kv_occupancy())
    assert led.release("e2", "missing") == 0
    released = led.release_owner("e2")
    return mid, released, led.categories(), reg.render()


def test_memory_ledger_matches_the_reference():
    assert _drive_ledger(tml, tm) == _drive_ledger(jml, jm)


def test_tree_nbytes_walks_tensors_and_int8_records():
    tree = {"embed": torch.zeros(4, 8, dtype=torch.bfloat16),
            "layers": [{"wq": {"q8": torch.zeros(8, 8, dtype=torch.int8),
                               "s8": torch.zeros(8)}}],
            "cfg": "x", "none": None, "n": 3}
    assert tml.tree_nbytes(tree) == 64 + 64 + 32
    jtree = {"embed": jnp.zeros((4, 8), jnp.bfloat16),
             "layers": [{"wq": {"q8": jnp.zeros((8, 8), jnp.int8),
                                "s8": jnp.zeros(8)}}]}
    assert jml.tree_nbytes(jtree) == tml.tree_nbytes(tree)


def test_crosscheck_is_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tml.default_ledger().register("e", "kv", 10, "kv")
    assert tml.default_ledger().crosscheck() is None


# -- exporter, bridge, profile ------------------------------------------------------


def test_exporter_round_trip_on_an_ephemeral_port():
    """``/metrics`` parses and holds the core catalog and the bridged
    span histogram, ``/trace`` holds the spans and the events as
    instant markers, ``/events`` filters by rid and kind, ``/healthz``
    lists the endpoints and ``/history`` answers 404 as the reference
    does without a store."""
    import urllib.error

    listener = tobs.bridge_tracer()
    try:
        with texp.start_exporter(port=0) as ex:
            assert ex.port > 0
            with ttr.span("serving.dispatch", horizon=4, rids=["r1"]):
                tev.emit("serve.block", active=1, horizon=4)
            tev.emit("serve.finish", rid="r1", outcome="done", tokens=3)
            tev.emit("serve.finish", rid="r2", outcome="eos", tokens=1)
            text = texp.scrape(ex.url)
            fams = tm.parse_prometheus_text(text)
            typed = {line.split()[2] for line in text.splitlines()
                     if line.startswith("# TYPE ")}
            # every family of the core catalog is declared, labelled
            # ones before their first sample too
            core = tm.ensure_core_series(tm.MetricsRegistry())
            assert {f.name for f in core.families()} <= typed
            assert fams["edl_serving_ttft_seconds_count"] == [({}, 0.0)]
            spans = fams["edl_span_seconds_count"]
            assert ({"name": "serving.dispatch"}, 1.0) in spans
            doc = json.loads(texp.scrape(ex.url, "/trace"))
            names = [e["name"] for e in doc["traceEvents"]]
            assert "serving.dispatch" in names and "serve.block" in names
            lines = texp.scrape(ex.url, "/events?rid=r1").splitlines()
            assert [json.loads(x)["kind"] for x in lines] == ["serve.finish"]
            lines = texp.scrape(f"127.0.0.1:{ex.port}",
                                "/events?kind=serve.finish&n=1").splitlines()
            assert [json.loads(x)["corr"]["rid"] for x in lines] == ["r2"]
            health = json.loads(texp.scrape(ex.url, "/healthz"))
            assert health["status"] == "ok" and "/history" not in health[
                "endpoints"]
            with pytest.raises(urllib.error.HTTPError) as e:
                texp.scrape(ex.url, "/history")
            assert e.value.code == 404
    finally:
        ttr.tracer().remove_listener(listener)


def test_profile_report_matches_the_reference(tmp_path):
    reg_t, reg_j = tm.MetricsRegistry(), jm.MetricsRegistry()
    for cm, reg, cw, m, ev in ((tcm, reg_t, tcw, tm, tev),
                               (jcm, reg_j, jcw, jm, jev)):
        meter = cm.EfficiencyMeter(cm.DevicePeak("p", 989e12, 3.35e12),
                                   registry=reg)
        meter.observe("decode", cm.Cost(1e11, 1.7e11), 0.2)
        meter.observe("prefill", cm.Cost(3e12, 2e10), 0.05)
        reg.gauge("edl_hbm_bytes", "", ("category",)).set(2e9, category="kv")
        reg.histogram("edl_compile_seconds", "", ("program",)).observe(
            1.5, program="serve.block")
        reg.counter("edl_events_total", "", ("kind",)).inc(
            kind="obs.recompile")
    text = reg_t.render()
    assert text == reg_j.render()
    want = jprof.report_from_fams(jm.parse_prometheus_text(text), "x")
    got = tprof.report_from_fams(tm.parse_prometheus_text(text), "x")
    assert got == want
    assert tprof.render_report(got) == jprof.render_report(want)
    bench = {"parsed": {"mfu": 0.28, "decode_ladder": [
        {"b": 1, "decode_pct_peak_bw": 0.04, "decode_tokens_per_sec": 60.0}],
        "prefill_s": 0.02, "peak_tflops": 989.0, "compile_s": 3.0}}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    assert (tprof.report_for_source(str(path))
            == jprof.report_for_source(str(path)))
    # the dryrun trains through the port's ElasticTrainer: on the card
    # unless the CPU is named
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tprof.run_dryrun()
    report = tprof.run_dryrun(device="cpu", steps=2)
    assert {"train", "decode", "prefill"} <= set(report["phases"])


# -- checkpoint hooks ---------------------------------------------------------------


def test_checkpoint_commit_site_and_events(tmp_path):
    """``save`` is the ``ckpt.commit`` fault site (a raise there
    publishes nothing) and emits ``ckpt.commit``; ``load`` emits
    ``ckpt.load``; both feed the checkpoint I/O series."""
    from edl_tpu_torch.runtime import checkpoint
    from edl_tpu_torch.train import trainer

    cfg = tl.LlamaConfig.tiny()
    params = trainer.trainable(tl.init_params(cfg, seed=0, device="cpu"))
    state = trainer.TrainState.create(params, trainer.adam(1e-3))
    state = trainer.TrainState(step=3, params=state.params,
                               opt_state=state.opt_state)
    tfaults.arm("ckpt.commit:raise@n=1")
    with pytest.raises(tfaults.InjectedFault, match="ckpt.commit"):
        checkpoint.save(str(tmp_path / "a"), state)
    assert not os.path.exists(tmp_path / "a" / "state.npz")
    checkpoint.save(str(tmp_path / "a"), state)
    checkpoint.load(str(tmp_path / "a"), state)
    evs = [(e.kind, e.corr.get("step"), e.attrs.get("fmt"))
           for e in tev.default_recorder().events()
           if e.kind.startswith("ckpt.")]
    assert evs == [("ckpt.commit", 3, "dense"), ("ckpt.load", 3, "dense")]
    r = tm.default_registry()
    assert r.get("edl_checkpoint_save_seconds").stats(kind="dense")[
        "count"] == 1
    assert r.get("edl_checkpoint_bytes_total").value(op="read") > 0
