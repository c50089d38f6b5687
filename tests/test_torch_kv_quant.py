"""Port parity: quantized paged KV (``kv_quant`` int8 / int4) of
edl_tpu_torch vs edl_tpu.

Mirrors the reference's tests/test_kv_quant.py. The port's int4 packing
and ``_kvq_store`` give the JAX functions' integer entries exactly and
their scales within 1e-6 relative; the quantized ``prefill_paged`` and
``decode_step_slots_paged`` give their logits within atol/rtol 1e-4
(tests/test_torch_llama.py's tolerance) with equal integer pools; the
port's int8 engine emits the JAX int8 engine's tokens and reaches the
reference's quality pin against the float pool (>= 0.9 agreement,
tests/test_kv_quant.py:200); int4 runs to completion; the off lane is
the float paged engine; copy-on-write carries scales; recovery replays
within the reference's tolerance; and the speculative-acceptance guard
fires on a regression. Weights are the reference's JAX init carried
across by ``params_from_numpy``; ``LlamaConfig.tiny`` in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.serving import engine as teng
from edl_tpu_torch.serving.engine import (ContinuousBatchingEngine,
                                          SpecAcceptGuard)
from edl_tpu_torch.serving.metrics import ServingMetrics

torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
SCALE_RTOL = 1e-6

PROMPTS = [list(range(2, 2 + n)) for n in (4, 7, 3, 9, 5, 6)]
MAX_NEWS = [6, 3, 13, 5, 7, 9]
L, KV, HD = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
BS, NB = 8, 6


def _engine(**kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("metrics", ServingMetrics(registry=MetricsRegistry()))
    return ContinuousBatchingEngine(TP, TCFG, device="cpu", **kw)


def _run_all(eng, reqs=None):
    reqs = reqs if reqs is not None else list(zip(PROMPTS, MAX_NEWS))
    for i, (p, mn) in enumerate(reqs):
        eng.submit(f"r{i}", p, mn)
    res = eng.run()
    return [res[f"r{i}"].tokens for i in range(len(reqs))]


def _agreement(a, b):
    n = max(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / n if n else 1.0


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's streams at horizon 4, per kv_quant, run once."""
    cache = {}

    def get(kv_quant):
        if kv_quant not in cache:
            eng = JEngine(JP, JCFG, max_slots=3, max_len=64, block_size=8,
                          horizon=4, kv_quant=kv_quant)
            cache[kv_quant] = _run_all(eng)
        return cache[kv_quant]

    return get


def _ref_layout(a):
    """A port plane as the reference lays it out: the head-major pool
    [L, nb, KV, bs, hdp] becomes [L, nb, bs, KV, hdp]; scale planes
    [L, nb, KV] are the same on both sides."""
    return a.swapaxes(2, 3) if a.ndim == 5 else a


def _cmp_quant(got, want, blocks):
    """Integer planes equal, scale planes within SCALE_RTOL, on
    ``blocks`` (scratch takes colliding pad writes on both sides); the
    port's pools are permuted into the reference's layout first."""
    for g, w in zip(got, want):
        g, w = _ref_layout(g.numpy())[:, blocks], np.asarray(w)[:, blocks]
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0)


# -- pack / unpack / store parity -----------------------------------------------


def test_kvq_pack_unpack_match_reference_exhaustively():
    """Every int8 byte unpacks to the reference's int4 pair, and every
    pair of int4 values in [-7, 7] packs to the reference's byte."""
    allb = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for q in ("int8", "int4"):
        np.testing.assert_array_equal(
            tl._kvq_unpack(torch.from_numpy(allb), q).numpy(),
            np.asarray(jl._kvq_unpack(jnp.asarray(allb), q)))
    v = np.arange(-7, 8, dtype=np.float32)
    pairs = np.stack(np.meshgrid(v, v), -1).reshape(-1, 2)
    np.testing.assert_array_equal(
        tl._kvq_pack(torch.from_numpy(pairs), "int4").numpy(),
        np.asarray(jl._kvq_pack(jnp.asarray(pairs), "int4")))
    back = tl._kvq_unpack(tl._kvq_pack(torch.from_numpy(pairs), "int4"),
                          "int4")
    np.testing.assert_array_equal(back.numpy(), pairs)


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_kvq_store_matches_reference(kv_quant):
    """A sequence of lane writes — decode order into one block, a batch
    spanning blocks with a scratch collision, then a fresh tenant at
    offset 0 over a full block — through both stores: integer entries
    equal, scales within 1e-6 relative."""
    rng = np.random.RandomState(3)
    hdp = tl.kvq_packed_head_dim(kv_quant, HD)
    tp = torch.zeros((L, NB, KV, BS, hdp), dtype=torch.int8)
    ts = torch.zeros((L, NB, KV), dtype=torch.float32)
    jp = jnp.zeros((L, NB, BS, KV, hdp), jnp.int8)
    js = jnp.asarray(ts.numpy())
    writes = [([1], [off], 1.0) for off in range(BS)]
    writes += [([2, 2, 3, 0, 0], [0, 1, 0, 0, 0], 3.0),
               ([2, 3], [2, 1], 0.2), ([1], [0], 0.5)]
    for layer, (blk, off, amp) in enumerate(writes):
        i = layer % L
        new = (amp * rng.randn(len(blk), KV, HD)).astype(np.float32)
        wb, wo = np.asarray(blk), np.asarray(off)
        jp, js = jl._kvq_store(jp, js, i, jnp.asarray(wb, jnp.int32),
                               jnp.asarray(wo, jnp.int32), jnp.asarray(new),
                               kv_quant)
        tp, ts = tl._kvq_store(tp, ts, i, torch.from_numpy(wb),
                               torch.from_numpy(wo), torch.from_numpy(new),
                               kv_quant)
        _cmp_quant((tp, ts), (jp, js), list(range(1, NB)))


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_kvq_store_roundtrip_error_bound(kv_quant):
    """Decode-order writes into one block: dequantized content tracks the
    written values within the quantization step at the block's final
    scale (the last write exactly; earlier offsets gain at most half a
    step per rescale)."""
    rng = np.random.RandomState(3)
    hdp = tl.kvq_packed_head_dim(kv_quant, HD)
    pool = torch.zeros((L, 5, KV, BS, hdp), dtype=torch.int8)
    scale = torch.zeros((L, 5, KV), dtype=torch.float32)
    vals = rng.randn(BS, KV, HD).astype(np.float32)
    for off in range(BS):
        pool, scale = tl._kvq_store(
            pool, scale, 0, torch.tensor([1]), torch.tensor([off]),
            torch.from_numpy(vals[off][None]), kv_quant)
    sc = scale[0, 1].numpy()
    assert np.all(sc > 0)
    # the head-major block [KV, bs, hd] read by offset: [bs, KV, hd]
    deq = tl._kvq_unpack(pool[0, 1], kv_quant).numpy().swapaxes(0, 1)
    deq = deq * sc[None, :, None]
    step = sc[None, :, None]
    assert np.all(np.abs(deq[-1] - vals[-1]) <= 0.5 * step[0] + 1e-6)
    assert np.all(np.abs(deq - vals) <= (0.5 * BS) * step + 1e-6)
    assert np.all(np.abs(vals).max(axis=(0, 2))
                  <= sc * tl._KVQ_QMAX[kv_quant] * (1 + 1e-6))


def test_kvq_store_fresh_block_resets_scale():
    """A write at offset 0 marks the block FRESH: the previous tenant's
    large scale is dropped and its stale content reads back as zero."""
    pool = torch.zeros((1, 3, KV, 4, 8), dtype=torch.int8)
    scale = torch.zeros((1, 3, KV), dtype=torch.float32)
    big = torch.full((1, KV, 8), 100.0)
    for off in range(4):
        tl._kvq_store(pool, scale, 0, torch.tensor([1]), torch.tensor([off]),
                      big, "int8")
    tl._kvq_store(pool, scale, 0, torch.tensor([1]), torch.tensor([0]),
                  torch.full((1, KV, 8), 0.5), "int8")
    sc = scale[0, 1].numpy()
    assert np.all(sc == pytest.approx(0.5 / 127.0))  # reset, not 100/127
    deq = tl._kvq_unpack(pool[0, 1], "int8").numpy().swapaxes(0, 1)
    assert np.all(deq[1:] == 0)  # stale offsets zeroed
    assert deq[0] * sc[:, None] == pytest.approx(0.5, abs=1e-5)


def test_kvq_int4_needs_even_head_dim():
    with pytest.raises(ValueError, match="even head_dim"):
        tl.kvq_packed_head_dim("int4", 5)
    assert tl.kvq_packed_head_dim("int4", 16) == 8
    assert tl.kvq_packed_head_dim("int8", 16) == 16


# -- quantized forward functions ----------------------------------------------


def _qpool(kv_quant):
    hdp = tl.kvq_packed_head_dim(kv_quant, HD)
    z = np.zeros((L, 12, BS, KV, hdp), np.int8)
    s = np.zeros((L, 12, KV), np.float32)
    return z, z.copy(), s, s.copy()


def _jq(planes):
    return [jnp.asarray(p) for p in planes]


def _tq(planes):
    """Reference-layout planes as the port's (pools head-major)."""
    return [torch.from_numpy(np.ascontiguousarray(_ref_layout(p)))
            for p in planes]


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_prefill_then_decode_parity(kv_quant):
    """A 13-token prefill through a 3-block table, then one decode step
    of three rows (one parked past its table) over the same pool:
    logits within 1e-4, integer pools equal, scales within 1e-6."""
    kc, vc, ks, vs = _qpool(kv_quant)
    jkc, jvc, jks, jvs = _jq((kc, vc, ks, vs))
    tkc, tvc, tks, tvs = _tq((kc, vc, ks, vs))
    table = np.array([3, 5, 7, 0], np.int64)
    toks = np.random.RandomState(1).randint(0, JCFG.vocab, (1, 16))
    want = jl.prefill_paged(JP, jnp.asarray(toks, jnp.int32), jnp.int32(0),
                            jnp.int32(12), jnp.asarray(table, jnp.int32),
                            jkc, jvc, JCFG, BS, kv_quant=kv_quant, ks=jks,
                            vs=jvs)
    got = tl.prefill_paged(TP, torch.from_numpy(toks), 0, 12,
                           torch.from_numpy(table), tkc, tvc, TCFG, BS,
                           kv_quant=kv_quant, ks=tks, vs=tvs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    live = [3, 5]
    _cmp_quant(got[1:], want[1:], live)
    dtable = np.array([[3, 5, 0, 0], [1, 2, 0, 0], [4, 0, 0, 0]], np.int64)
    pos = np.array([13, 4, 32], np.int64)
    tok = np.array([7, 9, 11], np.int64)
    want = jl.decode_step_slots_paged(
        JP, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(dtable, jnp.int32), *want[1:3], JCFG, BS,
        kv_quant=kv_quant, ks=want[3], vs=want[4])
    got = tl.decode_step_slots_paged(
        TP, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(dtable), *got[1:3], TCFG, BS, kv_quant=kv_quant,
        ks=got[3], vs=got[4])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _cmp_quant(got[1:], want[1:], [1, 3, 5])


# -- the off lane, validation, layout ------------------------------------------


def test_kv_quant_off_is_the_float_paged_engine():
    plain, off = _engine(horizon=4), _engine(horizon=4, kv_quant="off")
    assert _run_all(plain) == _run_all(off)
    s1, s2 = plain.metrics.snapshot(), off.metrics.snapshot()
    for k in ("dispatches_decode", "dispatches_prefill", "tokens_out"):
        assert s1[k] == s2[k], k
    assert off._ks is None and off._vs is None
    assert off._kc.dtype == TCFG.dtype
    assert off._kvq_guard is None


def test_kv_quant_constructor_validation():
    for kw in ({"kv_quant": "int8"}, {"kv_quant": "fp8", "block_size": 8}):
        with pytest.raises(ValueError, match="kv_quant"):
            JEngine(JP, JCFG, max_len=64, **kw)
        with pytest.raises(ValueError, match="kv_quant"):
            ContinuousBatchingEngine(TP, TCFG, device="cpu", max_len=64,
                                     **kw)


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_kv_quant_pool_layout_and_bytes(kv_quant):
    """Quantized pools are int8 with the packed head dim plus
    [L, pool_blocks, KV] f32 scales: per block and plane, bs * hdp bytes
    of values and one 4-byte scale per layer and head — at least 1.8x
    under the float pool (the reference's bound)."""
    eng = _engine(kv_quant=kv_quant)
    hdp = tl.kvq_packed_head_dim(kv_quant, TCFG.head_dim)
    assert eng._kc.dtype == torch.int8 and eng._kc.shape[-1] == hdp
    assert tuple(eng._ks.shape) == (TCFG.n_layers, eng.pool_blocks,
                                    TCFG.n_kv_heads)
    per_block = TCFG.n_layers * TCFG.n_kv_heads * (BS * hdp + 4)
    assert eng.kv_nbytes == 2 * eng.pool_blocks * per_block
    float_b = _engine().kv_nbytes
    assert float_b / eng.kv_nbytes >= 1.8


# -- engine: quality and identity ----------------------------------------------


def test_kv_quant_int8_matches_reference_and_quality_pin(ref):
    """int8 greedy streams are the JAX int8 engine's, and they track the
    float paged engine within the reference's pin (>= 0.9 agreement)."""
    toks_q = _run_all(_engine(horizon=4, kv_quant="int8"))
    assert toks_q == ref("int8")
    toks_f = _run_all(_engine(horizon=4))
    assert toks_f == ref("off")
    agr = [_agreement(a, b) for a, b in zip(toks_f, toks_q)]
    assert np.mean(agr) >= 0.9, agr
    assert all(len(t) > 0 for t in toks_q)


def test_kv_quant_int4_runs_to_completion(ref):
    eng = _engine(horizon=4, kv_quant="int4")
    toks = _run_all(eng)
    assert toks == ref("int4")
    for t, mn in zip(toks, MAX_NEWS):
        assert 0 < len(t) <= mn
    assert eng._balloc.allocated_blocks == 0


def test_cow_block_copy_carries_scales():
    """The copy-on-write copy moves the block's SCALES with its values,
    across every layer, and nothing else."""
    eng = _engine(max_slots=2, kv_quant="int8", prefix_cache=True)
    eng._kc[:, 3] = 5
    eng._vc[:, 3] = -3
    eng._ks[:, 3] = 0.25
    eng._vs[:, 3] = 0.5
    bid = eng._balloc.alloc()
    eng._balloc.incref(bid)  # shared: refcount 2
    eng._kc[:, bid] = eng._kc[:, 3]
    eng._vc[:, bid] = eng._vc[:, 3]
    eng._ks[:, bid] = eng._ks[:, 3]
    eng._vs[:, bid] = eng._vs[:, 3]
    eng._tables[0][0] = bid
    eng._pg_make_writable(0, 0)
    dst = eng._tables[0][0]
    assert dst != bid and eng._balloc.refcount(bid) == 1
    assert bool((eng._kc[:, dst] == 5).all())
    assert bool((eng._vc[:, dst] == -3).all())
    assert bool((eng._ks[:, dst] == 0.25).all())
    assert bool((eng._vs[:, dst] == 0.5).all())
    others = [b for b in range(eng.pool_blocks) if b not in (3, bid, dst)]
    assert bool((eng._ks[:, others] == 0).all())


def test_prefix_full_hit_cow_identical_under_int8():
    """An identical prompt served from the prefix cache reads the SAME
    quantized blocks the first request wrote: the streams match."""
    prompt = list(range(2, 26))  # three full 8-blocks
    eng = _engine(kv_quant="int8", prefix_cache=True)
    eng.submit("one", prompt, 7)
    res = eng.run()
    eng.submit("two", prompt, 7)
    res2 = eng.run()
    assert res2["two"].tokens == res["one"].tokens
    assert eng._prefix.hits >= 3


@pytest.mark.parametrize("target,n", [
    ("_dispatch_block", 2),
    ("_dispatch_prefill_final", 1),
])
def test_int8_recovery_replay_within_tolerance(ref, monkeypatch, target, n):
    """Recovery rebuilds the quantized pool and scale planes and replays
    through the quantized prefill; replay quantizes whole blocks at
    their final amax, so the pin is the reference's agreement >= 0.8
    against a fault-free quantized run."""
    orig = getattr(teng.ContinuousBatchingEngine, target)
    calls = {"n": 0}

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == n:
            raise RuntimeError("injected fault")
        return orig(self, *a, **kw)

    monkeypatch.setattr(teng.ContinuousBatchingEngine, target, flaky)
    eng = _engine(kv_quant="int8", horizon=4, max_recoveries=3)
    toks = _run_all(eng)
    assert eng.recoveries >= 1
    assert eng._kc.dtype == torch.int8  # the rebuilt pool is quantized
    agr = [_agreement(a, b) for a, b in zip(ref("int8"), toks)]
    assert np.mean(agr) >= 0.8, agr
    for t, mn in zip(toks, MAX_NEWS):
        assert 0 < len(t) <= mn


# -- the speculative-acceptance quality gate -----------------------------------


def test_spec_accept_guard_fires_on_injected_regression():
    reg = MetricsRegistry()
    g = SpecAcceptGuard(reg, warmup=5, tol=0.05, alpha=0.5)
    gauge = reg.gauge("edl_kv_quant_quality_ok")  # get-or-create
    assert gauge.value() == 1.0
    g.observe(0, 0)  # no drafts: ignored
    for _ in range(5):
        g.observe(10, 8)
    assert g.baseline == pytest.approx(0.8)
    assert g.ok and gauge.value() == 1.0
    for _ in range(10):  # acceptance collapses
        g.observe(10, 2)
    assert not g.ok and gauge.value() == 0.0
    assert g.ema < g.baseline - g.tol
    for _ in range(30):  # and the flag clears when quality returns
        g.observe(10, 8)
    assert g.ok and gauge.value() == 1.0


def test_engine_wires_guard_only_for_quantized_spec():
    assert _engine(kv_quant="int8", spec_k=2, spec_ngram=2)._kvq_guard
    assert _engine(spec_k=2, spec_ngram=2)._kvq_guard is None
    assert _engine(kv_quant="int8")._kvq_guard is None


def test_int8_spec_decoding_accepts_and_observes():
    """Speculation composes with the quantized pool: a repetitive prompt
    yields real acceptances, and the JAX int8 engine's tokens."""
    kw = dict(max_slots=1, max_len=64, block_size=8, kv_quant="int8",
              spec_k=4, spec_ngram=3, horizon=1)
    eng = _engine(**kw)
    eng.submit("rep", [5, 9] * 6, 24)
    got = eng.run()["rep"].tokens
    jeng = JEngine(JP, JCFG, **kw)
    jeng.submit("rep", [5, 9] * 6, 24)
    assert got == jeng.run()["rep"].tokens
    snap = eng.metrics.snapshot()
    assert snap["spec_drafted"] > 0 and snap["spec_accepted"] > 0
    assert eng._kvq_guard.ema is not None
