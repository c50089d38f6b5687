"""Port parity: speculative decoding (``spec_k``) of edl_tpu_torch vs
edl_tpu.

Mirrors the reference's tests/test_serving_spec.py. The port's n-gram
drafter and acceptance policy behave as the reference's; its
``verify_step_slots[_paged]`` and ``_spec_accept`` give the JAX
functions' committed tokens and carries exactly and their caches within
atol/rtol 1e-4 (tests/test_torch_llama.py's tolerance); and with
``spec_k`` 2/4/8 at horizons 1 and 4, on the contiguous and the paged
cache, the port's engine emits greedy tokens identical to JAX greedy
``generate`` (what the reference's own spec tests hold it to), with
mid-stream joins, evictions, mid-verify EOS, a zero-acceptance streak
and rows that verify past the end of their cache. Weights are the
reference's JAX init carried across by ``params_from_numpy``;
``LlamaConfig.tiny`` in f32. Each ``generate`` stream is computed once
per module (a module-scoped fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.serving import spec as jspec
from edl_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.serving import spec
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
from edl_tpu_torch.serving.metrics import ServingMetrics

torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")
TOL = dict(atol=1e-4, rtol=1e-4)

# a prompt whose tail repeats: the drafter fires from the first decode
# step, and tiny()'s greedy continuations fall into repetitive attractors
REPETITIVE = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]


@pytest.fixture(scope="module")
def seq():
    """JAX greedy ``generate`` per (prompt, max_new), computed once."""
    cache = {}

    def get(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in cache:
            toks = jl.generate(JP, jnp.asarray([prompt], jnp.int32), JCFG,
                               max_new=max_new)
            cache[key] = [int(t) for t in np.asarray(toks)[0]]
        return cache[key]

    return get


def _engine(**kw):
    kw.setdefault("metrics", ServingMetrics(registry=MetricsRegistry()))
    return ContinuousBatchingEngine(TP, TCFG, device="cpu", **kw)


# -- drafter + policy ----------------------------------------------------------


def test_draft_ngram_prompt_lookup():
    ctx = [1, 2, 3, 4, 9, 3, 4, 5, 6, 3, 4]
    assert spec.draft_ngram(ctx, ngram=2, max_draft=2) == [5, 6]
    assert spec.draft_ngram(ctx, ngram=2, max_draft=4) == [5, 6, 3, 4]
    assert spec.draft_ngram([1, 2, 3, 4, 5], ngram=3, max_draft=4) == []
    assert spec.draft_ngram([7, 1, 8, 1], ngram=3, max_draft=2) == [8, 1]
    assert spec.draft_ngram([], 3, 4) == []
    assert spec.draft_ngram([5], 3, 4) == []
    assert spec.draft_ngram([5, 5], 3, 0) == []


def test_draft_ngram_matches_reference_on_random_contexts():
    rng = np.random.RandomState(5)
    for _ in range(300):
        ctx = list(rng.randint(0, 4, rng.randint(0, 24)))
        n, k = rng.randint(1, 5), rng.randint(0, 9)
        assert spec.draft_ngram(ctx, n, k) == jspec.draft_ngram(ctx, n, k)


def test_spec_policy_warmup_then_disable():
    pol = spec.SpecPolicy(min_accept=0.5, warmup=8)
    assert pol.should_draft("a")
    pol.observe("a", drafted=4, accepted=0)
    assert pol.should_draft("a")  # 4 < warmup: still probing
    pol.observe("a", drafted=4, accepted=0)
    assert not pol.should_draft("a")  # 0/8 < 0.5: disabled
    pol.observe("b", drafted=16, accepted=12)
    assert pol.should_draft("b")
    pol.forget("a")
    assert pol.should_draft("a")
    free = spec.SpecPolicy(min_accept=0.0, warmup=1)
    free.observe("c", drafted=100, accepted=0)
    assert free.should_draft("c")


def test_spec_engine_validation():
    for kw, msg in (({"spec_k": -1}, "spec_k"),
                    ({"spec_k": 2, "temperature": 0.7}, "temperature"),
                    ({"spec_k": 2, "spec_ngram": 0}, "spec_ngram")):
        with pytest.raises(ValueError, match=msg):
            JEngine(JP, JCFG, **kw)
        with pytest.raises(ValueError, match=msg):
            _engine(**kw)


# -- function-level parity -------------------------------------------------------


def _verify_inputs(seed, s):
    """Rows: drafts that match nothing, a row near the end of its cache
    (lanes past S drop), a frozen row, an EOS row, sentinel tails."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, JCFG.vocab, 4)
    draft = rng.randint(0, JCFG.vocab, (4, 4))
    draft[1, 2:] = -1
    pos = np.array([5, s - 2, 9, 12], np.int64)
    active = np.array([True, True, False, True])
    rem = np.array([9, 9, 0, 2], np.int64)
    eosv = np.array([-1, -1, -1, int(draft[3, 0])], np.int64)
    return tok, draft, pos, active, rem, eosv


def _jints(*arrs):
    return [jnp.asarray(a, jnp.int32) if a.dtype != bool else jnp.asarray(a)
            for a in arrs]


def _tints(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _head_major(a):
    """A reference-layout cache or pool ([L, B|nb, S|bs, KV, hd]) as the
    port's head-major tensor ([L, B|nb, KV, S|bs, hd])."""
    return torch.from_numpy(np.ascontiguousarray(a.swapaxes(2, 3)))


def _check_carries(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_verify_step_slots_parity():
    s = 24
    rng = np.random.RandomState(0)
    shape = (JCFG.n_layers, 4, s, JCFG.n_kv_heads, JCFG.head_dim)
    kc, vc = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    tok, draft, pos, active, rem, eosv = _verify_inputs(0, s)
    want = jl.verify_step_slots(
        JP, *_jints(tok, draft, pos, active, rem, eosv), jnp.asarray(kc),
        jnp.asarray(vc), JCFG)
    got = tl.verify_step_slots(
        TP, *_tints(tok, draft, pos, active, rem, eosv),
        _head_major(kc), _head_major(vc), TCFG)
    _check_carries(got[:5], want[:5])
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_allclose(g.numpy().swapaxes(2, 3), np.asarray(w),
                                   **TOL)


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_verify_step_slots_paged_parity(kv_quant):
    bs, nb, m = 8, 14, 3
    rng = np.random.RandomState(1)
    table = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0], [7, 8, 0]], np.int64)
    tok, draft, pos, active, rem, eosv = _verify_inputs(1, m * bs)
    kw_j, kw_t = {}, {}
    if kv_quant == "off":
        shape = (JCFG.n_layers, nb, bs, JCFG.n_kv_heads, JCFG.head_dim)
        kc, vc = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        live = list(range(1, nb))
    else:
        shape = (JCFG.n_layers, nb, bs, JCFG.n_kv_heads, JCFG.head_dim)
        kc, vc = (rng.randint(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        sshape = (JCFG.n_layers, nb, JCFG.n_kv_heads)
        ks, vs = (rng.uniform(0.001, 0.02, sshape).astype(np.float32)
                  for _ in range(2))
        kw_j = dict(kv_quant=kv_quant, ks=jnp.asarray(ks),
                    vs=jnp.asarray(vs))
        kw_t = dict(kv_quant=kv_quant, ks=torch.from_numpy(ks.copy()),
                    vs=torch.from_numpy(vs.copy()))
        live = list(range(1, nb))
    want = jl.verify_step_slots_paged(
        JP, *_jints(tok, draft, pos, active, rem, eosv, table),
        jnp.asarray(kc), jnp.asarray(vc), JCFG, block_size=bs, **kw_j)
    got = tl.verify_step_slots_paged(
        TP, *_tints(tok, draft, pos, active, rem, eosv, table),
        _head_major(kc), _head_major(vc), TCFG, block_size=bs, **kw_t)
    _check_carries(got[:5], want[:5])
    for g, w in zip(got[5:], want[5:]):
        g, w = g.numpy(), np.asarray(w)
        if g.ndim == 5:  # the port's head-major pools
            g = g.swapaxes(2, 3)
        g, w = g[:, live], w[:, live]
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w)
        elif w.ndim == 3:  # scale planes
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_spec_accept_matches_reference_on_random_rows():
    """Acceptance is integer bookkeeping: exact on random rows with
    planted matches, budgets and EOS lanes."""
    rng = np.random.RandomState(2)
    for _ in range(20):
        b, d = 6, 4
        out = rng.randint(0, 5, (b, d + 1))
        draft = np.where(rng.rand(b, d) < 0.6, out[:, :d],
                         rng.randint(-1, 5, (b, d)))
        tok = rng.randint(0, 5, b)
        pos = rng.randint(0, 30, b)
        active = rng.rand(b) < 0.8
        rem = rng.randint(0, 6, b)
        eosv = rng.randint(-1, 5, b)
        want = jl._spec_accept(*_jints(tok, draft, out, pos, active, rem,
                                       eosv), None, None)
        got = tl._spec_accept(*_tints(tok, draft, out, pos, active, rem,
                                      eosv), None, None)
        _check_carries(got[:5], want[:5])


# -- engine: token identity with generate ----------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("spec_k", [2, 4, 8])
def test_spec_greedy_token_identity(seq, spec_k, horizon, paged):
    prompts = [list(REPETITIVE), [5, 6, 7, 8, 9, 10], [3] * 8]
    max_news = [17, 11, 13]  # not divisible by K or horizon
    kw = {"block_size": 8, "pool_blocks": 64} if paged else {}
    eng = _engine(max_slots=2, max_len=96, horizon=horizon, spec_k=spec_k,
                  spec_ngram=3, **kw)
    eng.submit("r0", prompts[0], max_news[0])
    eng.submit("r1", prompts[1], max_news[1])
    eng.step()  # r2 joins while r0/r1 are mid-speculation
    eng.submit("r2", prompts[2], max_news[2])
    res = eng.run()
    for i in range(3):
        assert res[f"r{i}"].tokens == seq(prompts[i], max_news[i]), (
            f"r{i} at spec_k={spec_k} h={horizon} paged={paged}")
        assert res[f"r{i}"].outcome == "done"
    assert eng.metrics.snapshot()["dispatches_verify"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_spec_verify_past_the_cache_end(seq, paged):
    """Requests whose prompt plus budget fill the cache exactly: the last
    verify lanes fall past S and are dropped (or go to scratch), and the
    streams stay sequential."""
    kw = {"block_size": 8} if paged else {}
    eng = _engine(max_slots=2, max_len=32, horizon=1, spec_k=8, **kw)
    eng.submit("a", list(REPETITIVE), 22)
    eng.submit("b", [3] * 8, 24)
    res = eng.run()
    assert res["a"].tokens == seq(REPETITIVE, 22)
    assert res["b"].tokens == seq([3] * 8, 24)


def test_spec_midstream_join_evict_token_identity(seq):
    prompts = [list(REPETITIVE), [9, 10], [4] * 6, list(REPETITIVE),
               [11, 12, 13], [2, 5, 2, 5, 2, 5]]
    max_news = [15, 2, 7, 9, 3, 11]
    eng = _engine(max_slots=3, max_len=96, horizon=1, spec_k=4)
    for i in range(4):
        eng.submit(f"r{i}", prompts[i], max_news[i])
    for _ in range(3):
        eng.step()
    for i in range(4, 6):
        eng.submit(f"r{i}", prompts[i], max_news[i])
    res = eng.run()
    for i in range(6):
        assert res[f"r{i}"].tokens == seq(prompts[i], max_news[i]), f"r{i}"


def test_spec_mid_verify_eos(seq):
    full = seq(REPETITIVE, 20)
    eos = full[6]
    want = full[:full.index(eos) + 1]
    eng = _engine(max_slots=2, max_len=96, horizon=1, spec_k=4)
    eng.submit("stops", list(REPETITIVE), 20, eos_id=eos)
    eng.submit("runs", [3] * 8, 13)
    res = eng.run()
    assert res["stops"].tokens == want and res["stops"].outcome == "eos"
    assert res["runs"].tokens == seq([3] * 8, 13)
    assert res["runs"].outcome == "done"


def test_spec_zero_acceptance_streak_stays_identical(seq):
    prompt = list(range(20, 29))
    eng = _engine(max_slots=1, max_len=96, horizon=1, spec_k=4,
                  spec_min_accept=1.1, spec_ngram=3)
    eng._spec_policy.warmup = 4  # disable every request after warm-up
    eng.submit("r0", prompt, 24)
    assert eng.run()["r0"].tokens == seq(prompt, 24)
    assert eng.metrics.snapshot()["spec_drafted"] <= 12


def test_spec_metrics(seq):
    """A repetitive stream drafts and accepts: the counters move, the
    snapshot's acceptance rate is accepted/drafted, more than one token
    lands per decode-phase dispatch, and the registry's series agree."""
    eng = _engine(max_slots=2, max_len=96, horizon=1, spec_k=4)
    eng.submit("r0", list(REPETITIVE), 40)
    assert eng.run()["r0"].tokens == seq(REPETITIVE, 40)
    snap = eng.metrics.snapshot()
    assert snap["spec_drafted"] > 0 and snap["spec_accepted"] > 0
    assert snap["spec_acceptance_rate"] == pytest.approx(
        snap["spec_accepted"] / snap["spec_drafted"])
    decode = snap["dispatches_verify"] + snap["dispatches_decode"]
    assert snap["tokens_out"] / decode > 1.0
    m = eng.metrics
    assert m._m_spec_drafted.value() == snap["spec_drafted"]
    assert m._m_spec_accepted.value() == snap["spec_accepted"]


def test_spec_disabled_is_zero_overhead():
    def counts(**kw):
        eng = _engine(max_slots=2, max_len=64, horizon=4, **kw)
        eng.submit("a", [2, 3, 4], 9)
        eng.submit("b", [5, 6], 7)
        res = eng.run()
        return eng.metrics.snapshot(), {r: res[r].tokens for r in res}

    base_snap, base_toks = counts()
    off_snap, off_toks = counts(spec_k=0, spec_ngram=5, spec_min_accept=0.9)
    assert off_toks == base_toks
    for k in ("dispatches_decode", "dispatches_prefill",
              "dispatches_verify", "tokens_out"):
        assert off_snap[k] == base_snap[k], k
    assert off_snap["spec_drafted"] == 0
