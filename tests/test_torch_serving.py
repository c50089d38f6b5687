"""Port parity: edl_tpu_torch serving vs edl_tpu serving.

The port's ContinuousBatchingEngine must emit the same greedy tokens as
the reference engine and as the port's own ``generate`` — at horizons
1, 4 and 16, with mid-stream joins, EOS inside a block, deadline
evictions and crash recovery. Weights are the reference's JAX init
carried across by ``params_from_numpy``; ``LlamaConfig.tiny`` in f32
with ``use_flash=True`` on both sides. Greedy tokens are compared for
identity (no tolerance). Also: export loading (bit-exact), the
``python -m edl_tpu_torch serve`` CLI, the no-JAX import rule, and the
device rules.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.runtime import export as jexport
from edl_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.runtime import export as texport
from edl_tpu_torch.serving import engine as teng
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
from edl_tpu_torch.serving.metrics import ServingMetrics
from edl_tpu_torch.serving.scheduler import AdmissionError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash=True)
TCFG = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True)
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")


def _engine(**kw):
    kw.setdefault("max_len", 64)
    return ContinuousBatchingEngine(TP, TCFG, device="cpu", **kw)


def _sequential(prompt, max_new):
    toks = tl.generate(TP, torch.tensor([prompt]), TCFG, max_new=max_new)
    return toks[0].tolist()


def _serve(make, horizon):
    """The reference test's workload: 6 requests over 3 slots, budgets
    not divisible by H, the last three joining after the first step."""
    prompts = [list(range(2, 2 + n)) for n in (4, 7, 3, 9, 5, 6)]
    max_news = [6, 3, 13, 5, 7, 9]
    eng = make(max_slots=3, max_len=64, horizon=horizon)
    for i in range(3):
        eng.submit(f"r{i}", prompts[i], max_news[i])
    eng.step()
    for i in range(3, 6):
        eng.submit(f"r{i}", prompts[i], max_news[i])
    res = eng.run()
    return prompts, max_news, {k: (v.tokens, v.outcome) for k, v in res.items()}


@pytest.mark.parametrize("horizon", [1, 4, 16])
def test_engine_matches_reference_engine_and_generate(horizon):
    prompts, max_news, got = _serve(
        lambda **kw: ContinuousBatchingEngine(TP, TCFG, device="cpu", **kw),
        horizon,
    )
    _, _, want = _serve(lambda **kw: JEngine(JP, JCFG, **kw), horizon)
    assert got == want
    for i in range(6):
        assert got[f"r{i}"] == (_sequential(prompts[i], max_news[i]), "done")


def test_eos_mid_block():
    prompt = [5, 6, 7, 8]
    full = _sequential(prompt, 8)
    eng = _engine(max_slots=2, horizon=8)
    eng.submit("stops", prompt, 8, eos_id=full[2])
    eng.submit("runs", [9, 10, 11], 6)
    res = eng.run()
    assert res["stops"].tokens == full[:3] and res["stops"].outcome == "eos"
    assert res["runs"].tokens == _sequential([9, 10, 11], 6)
    assert res["runs"].outcome == "done"


def test_midstream_join_evict_and_single_token_budget():
    prompts = [list(range(2, 2 + n)) for n in (4, 7, 3, 9, 5, 6, 8, 4)]
    max_news = [6, 3, 8, 5, 7, 1, 4, 8]
    eng = _engine(max_slots=3)
    for i in range(4):
        eng.submit(f"r{i}", prompts[i], max_news[i])
    for _ in range(3):
        eng.step()
    for i in range(4, 8):
        eng.submit(f"r{i}", prompts[i], max_news[i])
    res = eng.run()
    for i in range(8):
        assert res[f"r{i}"].tokens == _sequential(prompts[i], max_news[i])
        assert res[f"r{i}"].outcome == "done"
    snap = eng.metrics.snapshot()
    assert snap["dispatches_prefill"] == 8
    assert snap["tokens_out"] == sum(max_news)


def _clocked(t, **kw):
    return _engine(clock=lambda: t[0], metrics=ServingMetrics(
        clock=lambda: t[0], registry=MetricsRegistry()), **kw)


def test_deadline_shed_and_eviction_count_once():
    t = [0.0]
    eng = _clocked(t, max_slots=1)
    eng.submit("busy", [1, 2, 3], 6)
    eng.submit("stale", [4, 5, 6], 4, deadline_s=5.0)
    t[0] = 10.0  # the queued request's deadline passes
    res = eng.run()
    assert res["stale"].outcome == "timeout" and res["stale"].tokens == []
    assert res["busy"].tokens == _sequential([1, 2, 3], 6)
    assert eng.metrics.rejected == {"timeout": 1}
    assert eng.metrics.outcomes == {"done": 1}

    t = [0.0]
    eng = _clocked(t, max_slots=2)
    eng.submit("slow", [1, 2, 3], 40, deadline_s=5.0)
    eng.submit("ok", [4, 5, 6], 4)
    for _ in range(3):
        eng.step()
    t[0] = 10.0  # mid-flight
    res = eng.run()
    assert res["slow"].outcome == "timeout"
    assert 0 < len(res["slow"].tokens) < 40
    assert res["slow"].tokens == _sequential([1, 2, 3], 40)[
        :len(res["slow"].tokens)]
    assert eng.metrics.outcomes == {"timeout": 1, "done": 1}
    assert eng.metrics.rejected == {}


def test_deadline_evicted_lane_reuse_leaks_no_stale_tokens():
    t = [0.0]
    eng = _engine(max_slots=1, horizon=4, clock=lambda: t[0])
    eng.submit("old", [1, 2, 3], 20, deadline_s=5.0)
    eng.step()
    assert eng._inflight
    t[0] = 10.0
    eng.submit("new", [4, 5, 6], 6)
    res = eng.run()
    assert res["old"].outcome == "timeout"
    assert res["new"].tokens == _sequential([4, 5, 6], 6)


@pytest.mark.parametrize("where", ["dispatch", "drain", "prefill"])
def test_recovery_is_token_identical(monkeypatch, where):
    """A one-shot exception injected into a dispatch, a drain or an
    admission prefill: the engine recovers (re-prefills live slots from
    prompt + generated) and every request still gets the fault-free
    greedy tokens."""
    target = {"dispatch": "_dispatch_block", "drain": "_drain_one",
              "prefill": "_prefill_into"}[where]
    orig = getattr(teng.ContinuousBatchingEngine, target)
    calls = {"n": 0}

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError(f"injected {where} fault")
        return orig(self, *a, **kw)

    monkeypatch.setattr(teng.ContinuousBatchingEngine, target, flaky)
    prompts = [[1, 2, 3, 4], [5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    max_news = [9, 7, 5, 6]
    eng = _engine(max_slots=2, horizon=2)
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p, max_news[i])
    res = eng.run()
    assert eng.recoveries == 1
    for i, p in enumerate(prompts):
        assert res[f"r{i}"].outcome == "done"
        assert res[f"r{i}"].tokens == _sequential(p, max_news[i]), f"r{i}"


def test_recovery_budget_exhausted_fails_request(monkeypatch):
    def always(self, *a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(teng.ContinuousBatchingEngine, "_dispatch_block",
                        always)
    eng = _engine(max_slots=1, max_recoveries=1)
    eng.submit("doomed", [1, 2, 3], 5)
    res = eng.run(max_steps=10)
    assert res["doomed"].outcome == "failed"
    assert eng.recoveries == 2


def test_drain_half_close_and_reopen():
    eng = _engine(max_slots=2)
    eng.submit("in0", [1, 2, 3, 4], 6)
    eng.submit("in1", [5, 6, 7], 5)
    eng.step()
    eng.step()
    eng.submit("q0", [8, 9, 10], 4)
    residual = eng.drain()
    assert eng.results["in0"].tokens == _sequential([1, 2, 3, 4], 6)
    assert eng.results["in1"].tokens == _sequential([5, 6, 7], 5)
    assert [r.rid for r in residual] == ["q0"] and "q0" not in eng.results
    assert eng.draining and not eng.has_work
    eng.submit("late", [2, 3], 2)
    eng.reopen()
    assert eng.run()["late"].tokens == _sequential([2, 3], 2)


def test_sampling_deterministic_per_seed():
    runs = []
    for _ in range(2):
        eng = _engine(max_slots=2, temperature=0.9, seed=11, horizon=3)
        eng.submit("s0", [1, 2, 3], 6)
        eng.submit("s1", [4, 5, 6, 7], 4)
        runs.append({k: v.tokens for k, v in eng.run().items()})
    assert runs[0] == runs[1]
    assert len(runs[0]["s0"]) == 6 and len(runs[0]["s1"]) == 4
    assert all(0 <= t < TCFG.vocab for ts in runs[0].values() for t in ts)


def test_submit_rejections_and_not_ported_modes():
    eng = _engine(max_slots=1, max_len=16)
    eng.submit("a", [1, 2], 3)
    with pytest.raises(AdmissionError) as e:
        eng.submit("bad", [1, TCFG.vocab + 5], 3)
    assert e.value.reason == "bad_request"
    with pytest.raises(AdmissionError) as e:
        eng.submit("huge", [1, 2, 3], 99)
    assert e.value.reason == "budget"
    eng.run()
    with pytest.raises(AdmissionError):
        eng.submit("a", [1, 2], 3)
    # the serving modes are ported: each rejects what the reference's
    # constructor rejects, with the reference's message, and serves
    for kw, msg in (
        ({"block_size": 8, "max_len": 60}, "multiple of block_size"),
        ({"block_size": 8, "pool_blocks": 4}, "pool_blocks 4 < 9"),
        ({"prefix_cache": True}, "require block_size > 0"),
        ({"prefill_chunk": 4}, "require block_size > 0"),
        ({"kv_quant": "int8"}, "requires the paged KV cache"),
        ({"kv_quant": "fp8", "block_size": 8}, "one of off/int8/int4"),
        ({"spec_k": -1}, "spec_k must be >= 0"),
        ({"spec_k": 2, "temperature": 0.5}, "requires greedy decoding"),
    ):
        with pytest.raises(ValueError, match=msg):
            JEngine(JP, JCFG, **{"max_len": 64, **kw})
        with pytest.raises(ValueError, match=msg):
            _engine(**kw)
    for kw in ({"block_size": 8, "prefix_cache": True, "prefill_chunk": 4},
               {"block_size": 8, "kv_quant": "int4"}, {"spec_k": 2}):
        eng = _engine(max_slots=1, **kw)
        eng.submit("m", [1, 2, 3], 4)
        got = eng.run()["m"]
        assert got.outcome == "done" and len(got.tokens) == 4, kw


def test_bucket_cap_takes_dense_path_like_reference():
    """A max_len that is not a power of two caps the bucket at a length
    flash_supported rejects; that prefill takes the dense attention, as
    in the reference, and tokens still match generate."""
    from edl_tpu_torch.ops import flash_attention as tfa

    eng = _engine(max_slots=1, max_len=600)
    assert eng._bucket(520) == 600 and not tfa.flash_supported(600)
    from edl_tpu.ops.flash_attention import flash_supported as ref_supported

    assert not ref_supported(600)
    prompt = [i % 255 + 1 for i in range(520)]
    eng.submit("long", prompt, 4)
    assert eng.run()["long"].tokens == _sequential(prompt, 4)


# -- export + CLI --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_load_export_bit_exact(tmp_path, dtype):
    jexport.export_params(str(tmp_path), JP, step=3, dtype=dtype,
                          model_meta=JCFG.to_meta())
    want, _ = jexport.load_export(str(tmp_path))
    got, doc = texport.load_export(str(tmp_path), device="cpu")
    assert doc["step"] == 3 and doc["model"] == JCFG.to_meta()
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        g = flat_g[k]
        assert str(g.dtype) == f"torch.{dtype}"
        w = np.asarray(w)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def _cli(*args, stdin=None):
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch", *args], input=stdin,
        capture_output=True, text=True, env=env, cwd=ROOT,
    )


def test_cli_serve_cpu_matches_reference_engine(tmp_path):
    jexport.export_params(str(tmp_path), JP, step=1, dtype="float32",
                          model_meta=JCFG.to_meta())
    feed = tmp_path / "reqs.jsonl"
    feed.write_text(
        json.dumps({"id": "a", "prompt": [1, 2, 3, 4], "max_new": 5}) + "\n"
        + json.dumps({"prompt": [7, 8, 9], "max_new": 4}) + "\n"
        + json.dumps({"id": "big", "prompt": [1], "max_new": 500}) + "\n"
    )
    out = _cli("serve", str(tmp_path), "--requests", str(feed),
               "--max-slots", "2", "--max-len", "32", "--horizon", "4",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    recs = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["id"] for r in recs] == ["a", "req-2", "big"]
    ref = JEngine(JP, JCFG, max_slots=2, max_len=32, horizon=4)
    ref.submit("a", [1, 2, 3, 4], 5)
    ref.submit("req-2", [7, 8, 9], 4)
    want = ref.run()
    assert recs[0]["tokens"] == want["a"].tokens
    assert recs[1]["tokens"] == want["req-2"].tokens
    assert recs[0]["outcome"] == "done" and recs[0]["ttft_s"] >= 0
    assert recs[0]["tokens_per_s"] > 0
    assert recs[2]["outcome"] == "rejected:budget"
    assert '"tokens_out": 9.0' in out.stderr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_serve_int8_matches_reference_engine(tmp_path, dtype):
    """``serve --int8`` quantizes the export as stored (the reference
    quantizes what ``load_export`` returns) and serves the records: the
    reference engine's greedy tokens on the reference's records."""
    jexport.export_params(str(tmp_path), JP, step=1, dtype=dtype,
                          model_meta=JCFG.to_meta())
    feed = '{"id": "a", "prompt": [1, 2, 3, 4], "max_new": 6}\n'
    out = _cli("serve", str(tmp_path), "--int8", "--max-slots", "2",
               "--max-len", "32", "--horizon", "4", "--device", "cpu",
               stdin=feed)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[0])
    jp, _ = jexport.load_export(str(tmp_path))
    ref = JEngine(jl.quantize_params_int8(jp), JCFG, max_slots=2, max_len=32,
                  horizon=4)
    ref.submit("a", [1, 2, 3, 4], 6)
    assert rec["outcome"] == "done"
    assert rec["tokens"] == ref.run()["a"].tokens


def test_cli_serve_flag_validation(tmp_path):
    bad = _cli("serve", str(tmp_path), "--requests",
               str(tmp_path / "missing"), "--device", "cpu")
    assert bad.returncode == 1 and "bad request feed" in bad.stderr
    # the reference verb's checks and messages (edl_tpu/cli/main.py)
    for flags, msg in (
        (["--block-size", "-1"], "--block-size must be >= 0"),
        (["--block-size", "24", "--max-len", "64"], "must be a multiple of"),
        (["--prefix-cache"], "require --block-size > 0"),
        (["--prefill-chunk", "8"], "require --block-size > 0"),
        (["--kv-quant", "int8"], "requires the paged KV cache"),
        (["--spec-k", "-1"], "--spec-k must be >= 0"),
        (["--spec-k", "2", "--temperature", "0.5"],
         "requires greedy decoding"),
        (["--spec-ngram", "0"], "--spec-ngram must be >= 1"),
    ):
        out = _cli("serve", str(tmp_path), "--device", "cpu", *flags,
                   stdin='{"prompt": [1]}\n')
        assert out.returncode == 1 and msg in out.stderr, flags
    # sharded loading is still to port; --int8 with --mesh is the
    # reference's error, checked first
    for flags, msg in ((["--mesh", "tp=2"], "not ported yet"),
                       (["--int8", "--mesh", "tp=2"],
                        "--int8 and --mesh are mutually exclusive")):
        out = _cli("serve", str(tmp_path), "--device", "cpu", *flags,
                   stdin='{"prompt": [1]}\n')
        assert out.returncode == 1 and msg in out.stderr, flags


# -- package rules -------------------------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "edl_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "edl_tpu",
                               "ml_dtypes"), f"{path} imports {mod}"


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch, tmp_path):
    """No CUDA and no explicit "cpu": every entry point raises instead of
    silently running on the CPU."""
    from edl_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.init_params(TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(TP, TCFG)
    jexport.export_params(str(tmp_path), JP, step=1, dtype="float32",
                          model_meta=JCFG.to_meta())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.load_export(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(2)})
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="params live on"):
        ContinuousBatchingEngine(
            {"embed": torch.zeros(1, device="meta")}, TCFG, device="cpu")
    # the CLI defaults to cuda and fails cleanly without it
    out = _cli("serve", str(tmp_path), stdin='{"prompt": [1]}\n')
    assert out.returncode == 1 and "CUDA is not available" in out.stderr
