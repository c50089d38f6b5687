"""Port parity: edl_tpu_torch's serving-under-load path against edl_tpu's.

The workload generator (``serving/loadgen.py``), the SLO figures
(``obs/slo.py``), the wall-clock replay against the port's engine and the
reference's on a fake clock, the ``loadgen`` verb against the reference
CLI, and chip_smoke's serving_load gates (bench.py's horizon and goodput
rungs) on the CPU, including their trips on planted faults.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from edl_tpu.cli import main as jmain
from edl_tpu.models import llama as jl
from edl_tpu.obs import slo as jslo
from edl_tpu.obs.metrics import MetricsRegistry as JRegistry
from edl_tpu.serving import loadgen as jloadgen
from edl_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from edl_tpu.serving.metrics import ServingMetrics as JMetrics
from edl_tpu.serving.scheduler import RequestQueue as JQueue
from edl_tpu_torch.cli import main as tmain
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import slo as tslo
from edl_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from edl_tpu_torch.ops import flash_attention as tfa
from edl_tpu_torch.serving import loadgen as tloadgen
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
from edl_tpu_torch.serving.metrics import ServingMetrics as TMetrics
from edl_tpu_torch.serving.scheduler import RequestQueue as TQueue

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from scripts import exp_serving  # noqa: E402

torch.set_num_threads(1)

JCFG = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash=True)
TCFG = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True)
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")


def _spec(mod, slo_mod, **kw):
    return mod.WorkloadSpec(classes=slo_mod.default_classes(1.0, 0.25), **kw)


# -- the generator -------------------------------------------------------------


@pytest.mark.parametrize("knobs", [
    {}, {"shared_prefix_frac": 0.4, "shared_prefix_len": 6},
    {"repetition_frac": 0.5, "repetition_len": 3},
    {"shared_prefix_frac": 1.0, "repetition_frac": 0.3},
], ids=["plain", "shared_prefix", "repetition", "both"])
@pytest.mark.parametrize("arrival", ["poisson", "burst", "fixed"])
def test_workload_jsonl_is_the_references_byte_for_byte(arrival, knobs):
    kw = dict(seed=11, n_requests=40, rate_rps=9.0, arrival=arrival,
              vocab=1000, **knobs)
    got = tloadgen.workload_jsonl(tloadgen.build(_spec(tloadgen, tslo, **kw)))
    want = jloadgen.workload_jsonl(
        jloadgen.build(_spec(jloadgen, jslo, **kw)))
    assert got == want
    reqs = tloadgen.build(_spec(tloadgen, tslo, **kw))
    assert tloadgen.max_total_len(reqs) == jloadgen.max_total_len(
        jloadgen.build(_spec(jloadgen, jslo, **kw)))


@pytest.mark.parametrize("bad", [
    {"rate_rps": 0.0}, {"arrival": "zipf"}, {"shared_prefix_frac": 1.5},
    {"shared_prefix_len": 0}, {"repetition_frac": -0.1},
    {"repetition_len": 0}, {"tenants": ()},
])
def test_bad_specs_raise_the_references_errors(bad):
    with pytest.raises(ValueError) as want:
        jloadgen.build(jloadgen.WorkloadSpec(**bad))
    with pytest.raises(ValueError) as got:
        tloadgen.build(tloadgen.WorkloadSpec(**bad))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [12, 48])
def test_step_indexed_workloads_are_the_references(n):
    got = tloadgen.step_indexed_workload(
        n, 512, np.random.RandomState(3), prompt_range=(3, 8),
        max_new_range=(4, 12), max_gap=5)
    want = jloadgen.step_indexed_workload(
        n, 512, np.random.RandomState(3), prompt_range=(3, 8),
        max_new_range=(4, 12), max_gap=5)
    assert got == want
    # chip_smoke's copy of exp_serving's builder, on its card branch
    # (the horizon rung's deep workload)
    assert chip_smoke.build_workload(
        n, 32768, np.random.RandomState(7)
    ) == exp_serving.build_workload(
        n, 32768, np.random.RandomState(7), True, deep=True)


# -- the SLO figures -----------------------------------------------------------


def _drive(m, t, rid, submit, pop, first, finish, tokens, outcome,
           tenant="t", slo_class="interactive"):
    t[0] = submit
    m.on_submit(rid, tenant=tenant, slo_class=slo_class)
    if pop is None:
        m.on_reject(rid, "queue_full")
        return
    t[0] = pop
    m.on_pop(rid)
    t[0] = first
    m.on_admit(rid, 2)
    m.on_token(rid)
    if tokens > 1:
        t[0] = finish
        m.on_tokens(rid, tokens - 1)
    t[0] = finish
    m.on_finish(rid, outcome)


_WALK = [
    ("good", 0.0, 0.2, 0.5, 4.5, 21, "done", "acme", "interactive"),
    ("late", 10.0, 11.8, 12.0, 13.0, 11, "done", "acme", "interactive"),
    ("slow", 20.0, 20.1, 20.3, 28.0, 12, "eos", "tailco", "interactive"),
    ("shed", 30.0, None, 0, 0, 0, "", "batchco", "batch"),
    ("to", 31.0, 31.1, 31.2, 33.0, 4, "timeout", "batchco", "batch"),
    ("bat", 32.0, 33.0, 39.0, 41.0, 30, "done", "batchco", "batch"),
    ("one", 40.0, 40.1, 40.2, 40.2, 1, "done", "", ""),
    ("odd", 41.0, 41.5, 41.6, 45.0, 8, "done", "acme", "mystery"),
]


def _records(metrics_cls, registry_cls):
    t = [0.0]
    m = metrics_cls(clock=lambda: t[0], registry=registry_cls())
    for rid, *stamps, tenant, cls in _WALK:
        _drive(m, t, rid, *stamps, tenant=tenant, slo_class=cls)
    return m


def test_goodput_report_percentiles_text_and_gauges_equal_the_references():
    tm = _records(TMetrics, TRegistry)
    jm = _records(JMetrics, JRegistry)
    trecs, jrecs = tslo.request_records(tm), jslo.request_records(jm)
    assert trecs == jrecs
    assert tslo.request_records(tm, since_s=30.0) == jslo.request_records(
        jm, since_s=30.0)
    for ttft, itl in ((1.0, 0.25), (0.4, 0.9)):
        tc = tslo.classes_by_name(tslo.default_classes(ttft, itl))
        jc = jslo.classes_by_name(jslo.default_classes(ttft, itl))
        got = tslo.compute_goodput(trecs, tc, 50.0)
        want = jslo.compute_goodput(jrecs, jc, 50.0)
        assert got == want
        assert tslo.render_report(got) == jslo.render_report(want)
        treg, jreg = TRegistry(), JRegistry()
        tslo.update_gauges(got, registry=treg)
        jslo.update_gauges(want, registry=jreg)
        assert treg.render() == jreg.render()
    for vals in ([], [3.0], list(range(1, 101)), [0.5, 0.1, 7.0, 2.0]):
        assert tslo.percentiles(vals, (0.5, 0.9, 0.99)) == jslo.percentiles(
            vals, (0.5, 0.9, 0.99))
    assert tslo.compute_goodput([], {}, 0.0) == jslo.compute_goodput(
        [], {}, 0.0)


# -- the wall-clock replay on both engines ----------------------------------------


def _replay(make, depth):
    """The seeded burst workload replayed on a fake clock (10 ms a step,
    sleeps advance it) against a 2-slot engine behind a queue of
    ``depth``."""
    t = [0.0]

    def clock():
        return t[0]

    def sleep(dt):
        t[0] += max(dt, 1e-4)

    spec = _spec(jloadgen, jslo, seed=3, n_requests=14, rate_rps=400.0,
                 arrival="burst", vocab=JCFG.vocab)
    reqs = jloadgen.build(spec)
    eng, metrics = make(clock, depth)
    orig = eng.step

    def step():
        t[0] += 0.01
        return orig()

    eng.step = step
    res = (tloadgen if isinstance(eng, ContinuousBatchingEngine)
           else jloadgen).replay(eng, reqs, clock=clock, sleep=sleep)
    out = {rid: (r.tokens, r.outcome) for rid, r in eng.results.items()}
    return res, out, metrics


def _port_engine(clock, depth):
    metrics = TMetrics(clock=clock, registry=TRegistry())
    queue = TQueue(max_total_len=96, max_depth=depth, clock=clock)
    return ContinuousBatchingEngine(
        TP, TCFG, max_slots=2, max_len=96, horizon=4, queue=queue,
        metrics=metrics, device="cpu", clock=clock), metrics


def _reference_engine(clock, depth):
    metrics = JMetrics(clock=clock, registry=JRegistry())
    queue = JQueue(max_total_len=96, max_depth=depth, clock=clock)
    return JEngine(JP, JCFG, max_slots=2, max_len=96, horizon=4,
                   queue=queue, metrics=metrics, clock=clock), metrics


@pytest.mark.parametrize("depth", [64, 2], ids=["roomy", "shedding"])
def test_replay_gives_the_reference_engines_counts_tokens_and_phases(depth):
    got, got_out, tm = _replay(_port_engine, depth)
    want, want_out, jm = _replay(_reference_engine, depth)
    assert got == want
    assert got_out == want_out
    assert got["submitted"] + got["rejected"] == 14
    if depth == 2:
        assert got["rejected"] > 0
    trecs, jrecs = tslo.request_records(tm), jslo.request_records(jm)
    assert trecs == jrecs
    for r in trecs:
        if r["outcome"] in ("done", "eos"):
            assert abs(r["queue_wait_s"] + r["prefill_s"] + r["decode_s"]
                       - r["total_s"]) <= chip_smoke.SL_PHASE_SUM_ATOL


# -- the loadgen verb ----------------------------------------------------------------


def _main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_loadgen_workload_only_writes_the_reference_clis_bytes(tmp_path):
    argv = ["loadgen", "--workload-only", "--seed", "4", "--requests", "30",
            "--arrival", "poisson", "--shared-prefix", "0.25",
            "--repetition", "0.2", "--rate", "6"]
    rc, out, _ = _main(tmain, argv + ["--workload-out",
                                     str(tmp_path / "port.jsonl")])
    jrc, jout, _ = _main(jmain, argv + ["--workload-out",
                                       str(tmp_path / "ref.jsonl")])
    assert rc == jrc == 0 and out == jout
    assert (tmp_path / "port.jsonl").read_bytes() == (
        tmp_path / "ref.jsonl").read_bytes()


def test_loadgen_dryrun_report_has_the_reference_clis_keys(tmp_path):
    argv = ["loadgen", "--dryrun", "--json", "--requests", "8",
            "--rate", "40", "--no-warmup"]
    rc, out, err = _main(tmain, argv + ["--device", "cpu", "--metrics-port",
                                       "0", "--tsdb-dir",
                                       str(tmp_path / "h")])
    jrc, jout, _ = _main(jmain, argv)
    assert rc == 0 and jrc == 0, err
    got, want = json.loads(out), json.loads(jout)
    assert set(got) == set(want) == chip_smoke.LOADGEN_REPORT_KEYS
    assert set(got["workload"]) == set(want["workload"])
    assert got["requests"] == got["served"] == 8
    assert "loadgen scrape OK" in err


@pytest.mark.parametrize("argv,msg", [
    (["loadgen", "EXPORT", "--mesh", "fsdp=2"], "--mesh is not ported yet"),
    (["loadgen", "--dryrun", "--speed", "0"], "--speed must be > 0"),
    (["loadgen", "--dryrun", "--kv-quant", "int8"],
     "--kv-quant requires the paged KV cache"),
    (["loadgen"], "need an EXPORT_DIR, --dryrun, or --workload-only"),
])
def test_loadgen_refusals(argv, msg):
    rc, _, err = _main(tmain, argv)
    assert rc == 1 and msg in err


# -- chip_smoke's serving_load gates ---------------------------------------------


@pytest.fixture
def counted_plain(monkeypatch):
    """The plain forward counted as the kernel's wrapper counts a launch
    (the CPU has no kernel to launch)."""
    plain = tfa.flash_attention_ref

    def counting(q, k, v, causal=True, block_q=512, block_k=1024):
        tfa._launched("flash_fwd")
        return plain(q, k, v, causal, block_q, block_k)

    monkeypatch.setattr(tfa, "flash_attention_ref", counting)
    yield
    tfa.reset_launches()  # the next test in this process counts from 0


def test_horizon_rung_holds_its_gates_at_tiny_size(counted_plain):
    cfg = dataclasses.replace(TCFG, vocab=512)
    params = tl.init_params(cfg, seed=4, device="cpu")
    fig, launches, bucket = chip_smoke.horizon_rung(params, cfg, "cpu")
    assert fig["serving_dispatch_reduction"] >= 4.0
    assert launches[1] == launches[8] == 12 * cfg.n_layers
    assert bucket == 64  # prompts of 16..63 tokens


def test_goodput_rung_holds_its_gates_at_tiny_size(counted_plain,
                                                  monkeypatch):
    cfg = dataclasses.replace(TCFG, vocab=512)
    params = tl.init_params(cfg, seed=4, device="cpu")
    # bench.py's burst workload, 12 requests at 60 req/s (0.2 s of replay)
    monkeypatch.setattr(chip_smoke, "SL_GOODPUT", dict(
        chip_smoke.SL_GOODPUT, n_requests=12, rate_rps=60.0))
    fig, report, replay, launches, bucket = chip_smoke.goodput_rung(
        params, cfg, "cpu")
    assert replay["submitted"] == 12 and report["requests"] == 12
    assert launches == report["served"] * cfg.n_layers
    assert set(fig) == {"serving_goodput_rps", "serving_ttft_slo_attainment",
                        "serving_queue_wait_p99_s", "serving_goodput_config"}


def _horizon_runs():
    reqs = [{"rid": f"r{i}", "max_new": 10} for i in range(4)]
    runs = {}
    for h, decode in ((1, 40), (8, 5)):
        runs[h] = {
            "results": {r["rid"]: ("done", 10) for r in reqs},
            "snap": {"dispatches_per_token": (decode + 4) / 40,
                     "dispatches_prefill": 4},
            "tokens": 40, "elapsed": 1.0}
    return reqs, runs


def test_horizon_gates_trip_on_planted_faults():
    reqs, runs = _horizon_runs()
    assert chip_smoke._horizon_check(reqs, runs)[
        "serving_dispatch_reduction"] == pytest.approx(44 / 9)
    # an H=8 dispatch ratio above 1/8 plus admissions
    reqs, runs = _horizon_runs()
    runs[8]["snap"]["dispatches_per_token"] = (6 + 4) / 40
    with pytest.raises(AssertionError, match="H=8 dispatches a token"):
        chip_smoke._horizon_check(reqs, runs)
    # a reduction below the reference's 4x
    reqs, runs = _horizon_runs()
    runs[1]["snap"]["dispatches_per_token"] = 30 / 40
    with pytest.raises(AssertionError, match="dispatch reduction"):
        chip_smoke._horizon_check(reqs, runs)
    # a request short of its budget (an EOS, or a lost block)
    reqs, runs = _horizon_runs()
    runs[8]["results"]["r2"] = ("eos", 7)
    with pytest.raises(AssertionError, match="r2"):
        chip_smoke._horizon_check(reqs, runs)


def _goodput_inputs():
    recs = [{"rid": f"q{i}", "outcome": "done", "queue_wait_s": 0.1,
             "prefill_s": 0.2, "decode_s": 0.3, "total_s": 0.1 + 0.2 + 0.3}
            for i in range(3)]
    recs.append({"rid": "q3", "outcome": "rejected:queue_full",
                 "queue_wait_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
                 "total_s": 0.0})
    replay = {"submitted": 3.0, "rejected": 1.0, "wall_s": 2.0}
    report = {"goodput_rps": 1.0}
    return [4, replay, recs, report, 3 * 16, 3, 16]


def test_goodput_gates_trip_on_planted_faults():
    chip_smoke._goodput_check(*_goodput_inputs())
    # a broken phase sum
    args = _goodput_inputs()
    args[2][1]["decode_s"] += 1e-6
    with pytest.raises(AssertionError, match="phases sum"):
        chip_smoke._goodput_check(*args)
    # a request without an outcome (still in flight when the replay ended)
    args = _goodput_inputs()
    args[2][2]["outcome"] = ""
    with pytest.raises(AssertionError, match="without an outcome"):
        chip_smoke._goodput_check(*args)
    # a request the replay never accounted for
    args = _goodput_inputs()
    args[1]["rejected"] = 0.0
    with pytest.raises(AssertionError, match="submitted"):
        chip_smoke._goodput_check(*args)
    # goodput above what finished
    args = _goodput_inputs()
    args[3]["goodput_rps"] = 1.6
    with pytest.raises(AssertionError, match="goodput"):
        chip_smoke._goodput_check(*args)
    # a prefill that did not run the kernel
    args = _goodput_inputs()
    args[4] -= 1
    with pytest.raises(AssertionError, match="primal launches"):
        chip_smoke._goodput_check(*args)


def test_loadgen_verb_records_its_measured_replays_own_launches(
        counted_plain, tmp_path):
    """The verb on a flash export: its wrapper's count, recorded in the
    metric history as ``edl_kernel_launches``, starts after the warm pass
    and equals the measured replay's prefills x layers; chip_smoke reads
    and gates it from the history."""
    from edl_tpu_torch.obs.metrics import reset_default_registry
    from edl_tpu_torch.obs.tsdb import TSDB
    from edl_tpu_torch.runtime import export

    reset_default_registry()
    root = str(tmp_path / "export")
    export.export_params(root, TP, step=1, model_meta=TCFG.to_meta())
    rc, out, err = _main(tmain, [
        "loadgen", root, "--json", "--requests", "6", "--rate", "40",
        "--device", "cpu", "--tsdb-dir", str(tmp_path / "h")])
    assert rc == 0, err
    assert json.loads(out)["served"] == 6
    got = chip_smoke._recorded_launches(TSDB(str(tmp_path / "h")))
    # the warm pass prefilled the same 6 prompts: its launches are not
    # in the count
    assert got == {"launches": 6 * TCFG.n_layers, "prefills": 6}
    assert tfa.launch_counts()["flash_fwd"] == 6 * TCFG.n_layers
    chip_smoke._launch_check({"loadgen": got}, TCFG.n_layers)


@pytest.mark.parametrize("fault", ["a_prefill_without_the_kernel",
                                   "warm_pass_counted", "never_recorded"])
def test_launch_gate_trips_on_planted_faults(fault):
    counted = {"launches": 6 * 16, "prefills": 6}
    chip_smoke._launch_check({"r0": counted}, 16)
    planted = {"a_prefill_without_the_kernel": {"launches": 5 * 16},
               "warm_pass_counted": {"launches": 12 * 16},
               "never_recorded": {"launches": None}}[fault]
    with pytest.raises(AssertionError, match="r0: .* primal launches"):
        chip_smoke._launch_check({"r0": {**counted, **planted}}, 16)
