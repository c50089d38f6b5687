"""Port parity: the serving engine's observability, edl_tpu_torch vs
edl_tpu.

The port's ContinuousBatchingEngine emits the reference engine's flight
events, tracer spans, fault sites, compile-watch counts, cost-model
integrals and memory-ledger entries at the same points. For the same
request stream on ``LlamaConfig.tiny`` (the reference's JAX init carried
across by ``params_from_numpy``) this file holds, on three engine modes
(contiguous; paged with the prefix cache, chunked prefill, a
copy-on-write and preemption; speculative decoding with spec_k 4):

* the events as (kind, severity, correlation keys with the trace id,
  every attribute but floats and the logger's name) identical, in order;
* the span counts by name equal, and each request's prefill under
  ``derived_trace_id("rid", rid)`` on both sides;
* ``edl_compiles_total{program}`` equal from cleared program memos, and
  after ``mark_warm`` exactly one ``obs.recompile`` for a new prefill
  bucket on each side;
* ``edl_costmodel_flops_total{phase}`` and ``…hbm_bytes_total{phase}``
  equal within 1e-9 relative;
* the ledger's ``params`` and ``kv`` bytes equal, released when the
  engine is collected.

Under the reference recovery suite's fault plans (and ``serve.dispatch``
on the paged and speculative engines) the tokens, the events and the
injection counts are equal; the livelock reproducer's ``serve.preempt``
events are identical. And ``serve --metrics-port 0`` serves a tiny
export on the CPU. Each JAX stream runs once per module.
"""

import gc
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.obs import compilewatch as jcw
from edl_tpu.obs import events as jev
from edl_tpu.obs import memledger as jml
from edl_tpu.obs import metrics as jm
from edl_tpu.runtime import export as jexport
from edl_tpu.serving import engine as jeng
from edl_tpu.serving.metrics import ServingMetrics as JMetrics
from edl_tpu.utils import faults as jfaults
from edl_tpu.utils import tracing as jtr
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import compilewatch as tcw
from edl_tpu_torch.obs import disttrace as tdt
from edl_tpu_torch.obs import events as tev
from edl_tpu_torch.obs import memledger as tml
from edl_tpu_torch.obs import metrics as tm
from edl_tpu_torch.serving import engine as teng
from edl_tpu_torch.serving.metrics import ServingMetrics as TMetrics
from edl_tpu_torch.utils import faults as tfaults
from edl_tpu_torch.utils import tracing as ttr

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")

SIDES = {
    "ref": dict(m=jm, ev=jev, ml=jml, cw=jcw, fa=jfaults, tr=jtr,
                eng=jeng, metrics=JMetrics, params=JP, cfg=JCFG, kw={}),
    "port": dict(m=tm, ev=tev, ml=tml, cw=tcw, fa=tfaults, tr=ttr,
                 eng=teng, metrics=TMetrics, params=TP, cfg=TCFG,
                 kw={"device": "cpu"}),
}

PROMPTS = [list(range(2, 2 + n)) for n in (4, 7, 3, 9, 5, 6)]
MAX_NEWS = [6, 3, 13, 5, 7, 9]
PREFIX = list(range(30, 46))  # two full 8-blocks


def _joins(eng):
    """The recovery suite's workload: 3 requests, one block in flight,
    3 more join."""
    for i in range(3):
        eng.submit(f"r{i}", PROMPTS[i], MAX_NEWS[i])
    eng.step()
    for i in range(3, 6):
        eng.submit(f"r{i}", PROMPTS[i], MAX_NEWS[i])
    return eng.run()


def _paged_modes(eng):
    """A cold prompt publishes the prefix (its admission chunked); then
    warm prompts hit it, one of them in full (copy-on-write), beside a
    long prompt that prefills in chunks — decode growth overruns the
    9-block pool and preempts."""
    eng.submit("cold", PREFIX + [100, 101], 10)
    eng.run()
    eng.submit("warm1", PREFIX + [102], 12)
    eng.submit("dup", PREFIX, 12)
    eng.submit("long", list(range(150, 180)), 12)
    eng.submit("warm2", PREFIX + [103, 104], 12)
    return eng.run(max_steps=400)


def _spec(eng):
    feed = [[1, 2, 3, 4] * 3, [5, 9] * 5, list(range(7, 15)) * 2, [3] * 6]
    for i, p in enumerate(feed):
        eng.submit(f"s{i}", p, 12)
    return eng.run()


STREAMS = {
    "contiguous": (_joins, dict(max_slots=3, max_len=64, horizon=4)),
    "paged": (_paged_modes, dict(max_slots=3, max_len=64, horizon=4,
                                 block_size=8, pool_blocks=9,
                                 prefix_cache=True, prefill_chunk=8)),
    "spec": (_spec, dict(max_slots=3, max_len=64, horizon=4, spec_k=4)),
}
# the recovery suite's plans (tests/test_serving_recovery.py) on its
# mixed workload, and serve.dispatch on the paged and speculative engines
FAULTS = {
    "drain": ("serve.drain:raise@n=2", _joins,
              dict(max_slots=3, max_len=64, horizon=8, max_recoveries=3)),
    "prefill": ("serve.prefill:raise@n=2", _joins,
                dict(max_slots=3, max_len=64, horizon=8, max_recoveries=3)),
    "combined": ("serve.dispatch:raise@n=2;serve.drain:raise@n=5", _joins,
                 dict(max_slots=3, max_len=64, horizon=8, max_recoveries=3)),
    "paged_dispatch": ("serve.dispatch:raise@n=3", _paged_modes,
                       STREAMS["paged"][1]),
    "spec_dispatch": ("serve.dispatch:raise@n=2", _spec, STREAMS["spec"][1]),
}


def _reset(side, programs=True):
    """Fresh process telemetry on one side; ``programs`` also clears the
    engine's program memo (the JAX side then compiles anew), which only
    the compile-count comparisons need."""
    s = SIDES[side]
    s["ml"].reset_default_ledger(s["m"].reset_default_registry())
    s["ev"].reset_default_recorder()
    s["tr"].tracer().clear()
    s["cw"].reset()
    s["fa"].disarm()
    if programs:
        s["eng"]._programs.clear()


def _events(ev):
    """Each event as (kind, severity, corr without the random span ids,
    attrs without floats — times — and the logger's package name)."""
    out = []
    for r in ev.default_recorder().records():
        corr = {k: v for k, v in r["corr"].items()
                if k not in ("span_id", "parent_id")}
        attrs = {k: v for k, v in r["attrs"].items()
                 if k != "logger" and not isinstance(v, float)}
        out.append((r["kind"], r["severity"], corr, attrs))
    return out


def _run(side, drive, engine_kw, plan=None):
    """One stream on a fresh engine with fresh process telemetry; what
    the parity tests compare."""
    s = SIDES[side]
    _reset(side, programs=plan is None)
    reg = s["m"].MetricsRegistry()
    eng = s["eng"].ContinuousBatchingEngine(
        s["params"], s["cfg"], metrics=s["metrics"](registry=reg),
        **engine_kw, **s["kw"])
    if plan:
        s["fa"].arm(plan, seed=0)
    res = drive(eng)
    counts = s["fa"].counts()
    s["fa"].disarm()
    spans = s["tr"].tracer().spans()
    compiles = s["m"].default_registry().get("edl_compiles_total")
    cost = {}
    for name in ("edl_costmodel_flops_total", "edl_costmodel_hbm_bytes_total"):
        fam = reg.get(name)
        cost[name] = dict(fam.samples()) if fam else {}
    led = s["ml"].default_ledger()
    out = {
        "tokens": {k: (v.tokens, v.outcome) for k, v in res.items()},
        "recoveries": eng.recoveries,
        "faults": counts,
        "events": _events(s["ev"]),
        "spans": {n: sum(1 for x in spans if x.name == n)
                  for n in sorted({x.name for x in spans})},
        "trace_ids": {x.attrs["rid"]: x.attrs.get("trace_id")
                      for x in spans if x.name == "serving.prefill"
                      and x.attrs.get("rid") and not x.attrs.get("chunk")},
        "compiles": {k[0]: v[0] for k, v in compiles.samples()}
        if compiles else {},
        "cost": {n: {k[0]: v[0] for k, v in d.items()}
                 for n, d in cost.items()},
        "ledger": {c: led.owner_total(eng._ledger_owner, c)
                   for c in ("params", "kv")},
    }
    owner = eng._ledger_owner
    del eng
    gc.collect()
    out["ledger_after_gc"] = led.owner_total(owner)
    return out


_REF = {}


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's record of a named stream, computed once."""
    def get(name):
        if name not in _REF:
            if name in STREAMS:
                drive, kw = STREAMS[name]
                _REF[name] = _run("ref", drive, kw)
            else:
                plan, drive, kw = FAULTS[name]
                _REF[name] = _run("ref", drive, kw, plan)
        return _REF[name]

    yield get
    for side in SIDES:
        _reset(side)


@pytest.mark.parametrize("mode", list(STREAMS))
def test_engine_telemetry_matches_the_reference(ref, mode):
    want = ref(mode)
    drive, kw = STREAMS[mode]
    got = _run("port", drive, kw)
    assert got["tokens"] == want["tokens"]
    assert all(o in ("done", "eos") for _, o in got["tokens"].values())
    assert got["events"] == want["events"]
    kinds = {e[0] for e in got["events"]}
    assert {"serve.submit", "serve.admit", "serve.prefill", "serve.block",
            "serve.finish"} <= kinds
    if mode == "paged":  # the stream reaches every paged decision
        assert {"serve.prefix_hit", "serve.prefill_chunk", "serve.kv_cow",
                "serve.preempt"} <= kinds
    if mode == "spec":
        assert "serve.verify" in kinds
    assert got["spans"] == want["spans"]
    assert got["trace_ids"] == want["trace_ids"]
    assert got["trace_ids"] and all(
        t == tdt.derived_trace_id("rid", r)
        for r, t in got["trace_ids"].items())
    assert got["compiles"] == want["compiles"]
    assert {"serve.block", "serve.prefill"} <= set(got["compiles"])
    for name, phases in want["cost"].items():
        assert set(got["cost"][name]) == set(phases) == {"decode", "prefill"}
        for ph, v in phases.items():
            assert got["cost"][name][ph] == pytest.approx(v, rel=1e-9)
    assert got["ledger"] == want["ledger"] and got["ledger"]["kv"] > 0
    assert got["ledger_after_gc"] == want["ledger_after_gc"] == 0


@pytest.mark.parametrize("case", list(FAULTS))
def test_fault_plans_recover_as_the_reference(ref, case):
    want = ref(case)
    plan, drive, kw = FAULTS[case]
    got = _run("port", drive, kw, plan)
    assert got["tokens"] == want["tokens"]
    assert got["recoveries"] == want["recoveries"] >= 1
    assert got["faults"] == want["faults"] and sum(got["faults"].values())
    assert got["events"] == want["events"]
    assert got["spans"] == want["spans"] and got["spans"]["serving.recover"]


def test_preemption_events_match_in_the_livelock_reproducer():
    """test_torch_paged's two-requests-cannot-share feed: both engines
    preempt the same slots' requests in the same order, as
    ``serve.preempt`` events."""
    reqs = [(list(range(2, 21)), 9), (list(range(2, 18)), 7),
            (list(range(40, 76)), 6), ([1, 2, 3, 4] * 3, 14),
            (list(range(2, 18)), 5), ([5, 9] * 5, 11)]
    got = {}
    for side, s in SIDES.items():
        _reset(side, programs=False)
        eng = s["eng"].ContinuousBatchingEngine(
            s["params"], s["cfg"], max_slots=4, max_len=64, block_size=8,
            pool_blocks=9, horizon=4, **s["kw"])
        for i, (p, mn) in enumerate(reqs):
            eng.submit(f"r{i}", p, mn)
        eng.run(max_steps=40)
        got[side] = [e for e in _events(s["ev"]) if e[0] == "serve.preempt"]
    assert got["port"] == got["ref"] and len(got["port"]) > 20


def test_new_prefill_bucket_after_warmup_is_one_recompile():
    counts = {}
    for side, s in SIDES.items():
        _reset(side)
        eng = s["eng"].ContinuousBatchingEngine(
            s["params"], s["cfg"], max_slots=2, max_len=64, horizon=4,
            **s["kw"])
        eng.submit("a", [1, 2, 3], 4)
        eng.run()
        s["cw"].mark_warm()
        eng.submit("b", [4, 5, 6], 4)  # same bucket: no program is new
        eng.run()
        eng.submit("c", list(range(1, 21)), 4)  # bucket 32: new
        eng.run()
        counts[side] = [e[3]["program"] for e in _events(s["ev"])
                        if e[0] == "obs.recompile"]
        s["cw"].reset()
    assert counts["port"] == counts["ref"] == ["serve.prefill"]


def test_cli_serve_metrics_port(tmp_path):
    """``serve --metrics-port 0`` binds an ephemeral loopback port, says
    so on stderr and serves the feed as without it."""
    jexport.export_params(str(tmp_path), JP, step=1, dtype="float32",
                          model_meta=JCFG.to_meta())
    feed = tmp_path / "reqs.jsonl"
    feed.write_text(json.dumps({"id": "a", "prompt": [1, 2, 3],
                                "max_new": 4}) + "\n")
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch", "serve", str(tmp_path),
         "--requests", str(feed), "--device", "cpu", "--max-len", "32",
         "--metrics-port", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert re.search(r"^# metrics endpoint http://127\.0\.0\.1:\d+/metrics$",
                     out.stderr, re.M), out.stderr
    rec = json.loads(out.stdout.strip())
    assert rec["id"] == "a" and rec["outcome"] == "done"
