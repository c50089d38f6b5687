"""Port parity: the paged KV cache of edl_tpu_torch vs edl_tpu.

Mirrors the reference's tests/test_paged_kv.py. The port's block
allocator and prefix cache behave as the reference's; its
``prefill_paged``, ``decode_step_slots_paged`` and
``decode_horizon_slots_paged`` give the JAX functions' logits and pools
within atol/rtol 1e-4 (tests/test_torch_llama.py's tolerance); and the
port's paged engine emits GREEDY tokens identical to the JAX paged
engine's at horizons 1/4/16, with mid-stream joins, prompts straddling
block boundaries, mid-block EOS, deadline evictions, prefix-cache hits
(shared blocks and copy-on-write), chunked prefill, block-gated
admission, preemption, and crash recovery at a dispatch, a drain and a
prefill. Weights are the reference's JAX init carried across by
``params_from_numpy``; ``LlamaConfig.tiny`` in f32. Each JAX engine
stream is computed once per module (a module-scoped fixture).
"""

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
from edl_tpu.serving import paged as jpaged
from edl_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.serving import engine as teng
from edl_tpu_torch.serving import paged
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")
TOL = dict(atol=1e-4, rtol=1e-4)

PROMPTS = [list(range(2, 2 + n)) for n in (4, 7, 3, 9, 5, 6)]
MAX_NEWS = [6, 3, 13, 5, 7, 9]


def _paged_kw(kw):
    kw = dict(kw)
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", 8)
    return kw


def _port(**kw):
    return ContinuousBatchingEngine(TP, TCFG, device="cpu", **_paged_kw(kw))


def _jax(**kw):
    return JEngine(JP, JCFG, **_paged_kw(kw))


def _tokens(res):
    return {k: v.tokens for k, v in res.items()}


# each scenario drives an engine and returns its results; the JAX engine
# runs it once per module (fault-free), the port in each test


def _joins(eng):
    """Six requests over three slots, the last three joining after the
    first step (a block in flight)."""
    for i in range(3):
        eng.submit(f"r{i}", PROMPTS[i], MAX_NEWS[i])
    eng.step()
    for i in range(3, 6):
        eng.submit(f"r{i}", PROMPTS[i], MAX_NEWS[i])
    return eng.run()


def _eos(eng, eos):
    eng.submit("stops", [5, 6, 7, 8], 8, eos_id=eos)
    eng.submit("runs", [9, 10, 11], 6)
    return eng.run()


BOUNDARY = [(7, 9), (8, 8), (9, 7), (16, 5), (17, 4)]


def _boundary(eng):
    for j, (plen, mn) in enumerate(BOUNDARY):
        eng.submit(f"b{j}", list(range(2, 2 + plen)), mn)
    return eng.run()


def _deadline(eng, t):
    eng.submit("slow", [1, 2, 3], 40, deadline_s=5.0)
    eng.submit("ok", [4, 5, 6], 4)
    for _ in range(3):
        eng.step()
    t[0] = 10.0  # past slow's deadline
    eng.step()
    eng.submit("next", [7, 8, 9, 10], 6)
    return eng.run()


SHARED = list(range(2, 18))  # two full 8-blocks


def _prefix_hit(eng):
    eng.submit("a", SHARED + [30, 31, 32], 6)
    res = dict(eng.run())
    eng.submit("b", SHARED + [40, 41], 6)
    res.update(eng.run())
    return res


FULL = list(range(2, 26))  # 24 tokens: three full 8-blocks


def _full_hit(eng):
    eng.submit("one", FULL, 7)
    res = dict(eng.run())
    eng.submit("two", FULL, 7)  # full hit -> CoW of the last block
    eng.submit("three", FULL[:16] + [50] * 8, 5)  # diverges at block 2
    res.update(eng.run())
    return res


LONG = list(range(2, 42))  # 40 tokens: 4 chunks of 8 + the final piece


def _chunked(eng):
    eng.submit("short", [3, 4, 5], 12)
    eng.step()
    eng.submit("long", LONG, 6)
    return eng.run()


def _chunked_two(eng):
    eng.submit("long", list(range(2, 30)), 8)
    eng.submit("short", [9, 9, 2], 6)
    return eng.run()


def _six(eng):
    for i in range(6):
        eng.submit(f"r{i}", PROMPTS[i], MAX_NEWS[i])
    return eng.run()


def _preempt(eng):
    eng.submit("deep", [1, 2, 3, 4], 44)  # grows to 6 blocks
    eng.submit("young", list(range(5, 21)), 20)  # 2 blocks + growth
    return eng.run()


STUCK_STEPS = 40  # steps of the two-requests-cannot-share feed


def _two_long(eng):
    eng.submit("a", PROMPTS[0], 20)
    eng.submit("b", PROMPTS[1], 20)
    return eng.run()


SCENARIOS = {
    "h1": (lambda make: _joins(make(horizon=1))),
    "h4": (lambda make: _joins(make(horizon=4))),
    "h16": (lambda make: _joins(make(horizon=16))),
    "boundary": (lambda make: _boundary(make(max_slots=2))),
    "prefix_hit": (lambda make: _prefix_hit(make(max_slots=2,
                                                 prefix_cache=True))),
    "full_hit": (lambda make: _full_hit(make(max_slots=3,
                                             prefix_cache=True))),
    "chunked": (lambda make: _chunked(make(max_slots=2, prefill_chunk=8,
                                           horizon=2))),
    "chunked_two": (lambda make: _chunked_two(make(max_slots=2,
                                                   prefill_chunk=8,
                                                   horizon=4))),
    "gated": (lambda make: _six(make(max_slots=4, pool_blocks=9))),
    "preempt": (lambda make: _preempt(make(max_slots=2, pool_blocks=9))),
    "recovery": (lambda make: _joins(make(horizon=8, max_recoveries=3,
                                          prefix_cache=True))),
    "two_long": (lambda make: _two_long(make(max_slots=2, horizon=4))),
}


@pytest.fixture(scope="module")
def ref():
    """The JAX paged engine's tokens per scenario, each run once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _tokens(SCENARIOS[name](_jax))
        return cache[name]

    return get


# -- host-side allocator / prefix cache units --------------------------------


def test_block_allocator_basics():
    a = paged.BlockAllocator(5, 8)
    assert a.free_blocks == 4  # block 0 is scratch
    b1, b2 = a.alloc(), a.alloc()
    assert b1 == 1 and b2 == 2  # ascending, never scratch
    assert a.allocated_blocks == 2
    a.incref(b1)
    assert a.refcount(b1) == 2
    assert a.free(b1) is False  # one ref remains
    assert a.free(b1) is True  # back to the pool
    with pytest.raises(ValueError):
        a.free(b1)  # double free
    with pytest.raises(ValueError):
        a.incref(paged.SCRATCH)
    assert a.free(paged.SCRATCH) is False  # scratch no-op
    while a.alloc() is not None:
        pass
    assert a.free_blocks == 0  # exhaustion returns None, never raises


def test_chain_keys_and_blocks_for():
    toks = list(range(20))
    keys = paged.chain_keys(toks, 8)
    assert keys == [tuple(range(8)), tuple(range(16))]  # full blocks only
    assert keys == jpaged.chain_keys(toks, 8)
    for n in (0, 1, 8, 9, 63, 64, 65):
        assert paged.blocks_for(n, 8) == jpaged.blocks_for(n, 8)
    assert [paged.blocks_for(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]


def test_prefix_cache_match_insert_evict():
    a = paged.BlockAllocator(8, 4)
    c = paged.PrefixCache(a)
    b1, b2 = a.alloc(), a.alloc()
    k = paged.chain_keys(list(range(8)), 4)
    c.insert(k[0], b1)
    c.insert(k[1], b2)
    assert a.refcount(b1) == 2  # cache holds its own ref
    assert c.match(list(range(8))) == [b1, b2]
    assert c.match(list(range(4)) + [99, 99, 99, 99]) == [b1]  # divergence
    assert c.match([7, 7, 7, 7]) == []
    a.free(b1), a.free(b2)
    assert c.evictable() == 2
    assert c.evict_one() is True  # LRU first
    assert len(c) == 1 and a.free_blocks == 6
    assert c.evict_one() is True and c.evict_one() is False


def test_allocator_and_cache_track_the_reference_op_for_op():
    """A seeded random sequence of alloc / incref / free / insert /
    match / evict on the port's copies and the reference's modules: the
    same return values and the same free lists after every op."""
    rng = np.random.RandomState(7)
    ta, ja = paged.BlockAllocator(12, 4), jpaged.BlockAllocator(12, 4)
    tc, jc = paged.PrefixCache(ta), jpaged.PrefixCache(ja)
    held = []
    for _ in range(400):
        op = rng.randint(6)
        if op == 0:
            got, want = ta.alloc(), ja.alloc()
            assert got == want
            if got is not None:
                held.append(got)
        elif op == 1 and held:
            b = held[rng.randint(len(held))]
            ta.incref(b), ja.incref(b)
            held.append(b)
        elif op == 2 and held:
            b = held.pop(rng.randint(len(held)))
            assert ta.free(b) == ja.free(b)
        elif op == 3 and held:
            prompt = list(rng.randint(0, 3, 8))
            b = held[rng.randint(len(held))]
            key = paged.chain_keys(prompt, 4)[rng.randint(2)]
            tc.insert(key, b), jc.insert(key, b)
        elif op == 4:
            prompt = list(rng.randint(0, 3, 8))
            assert tc.match(prompt) == jc.match(prompt)
        elif op == 5:
            assert tc.evict_one() == jc.evict_one()
        assert ta._free == ja._free and ta._ref == ja._ref
        assert tc.evictable() == jc.evictable() and len(tc) == len(jc)


# -- function-level parity ---------------------------------------------------

L, KV, HD = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
BS, NB = 8, 12


def _pool(seed):
    """A pool with resident content in every block (scratch included),
    in the reference's [L, nb, bs, KV, hd] layout."""
    rng = np.random.RandomState(seed)
    shape = (L, NB, BS, KV, HD)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _tpool(a):
    """A reference-layout pool as the port's head-major [L, nb, KV, bs,
    hd] tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.swapaxes(2, 3)))


def _cmp_pools(got, want, live):
    """Pools agree on every non-scratch block (scratch takes colliding
    pad writes in an unspecified order on both sides); the port's
    head-major pools are permuted into the reference's layout."""
    for g, w in zip(got, want):
        g, w = g.numpy().swapaxes(2, 3)[:, live], np.asarray(w)[:, live]
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("start,n,tb", [(0, 13, 16), (8, 8, 8), (16, 3, 8)])
def test_prefill_paged_parity(start, n, tb):
    """A chunk at ``start`` with ``n`` real tokens in a bucket of
    ``tb``: positions below ``start`` are read from the pool (earlier
    chunks), pads write to scratch."""
    kc, vc = _pool(start + n)
    table = np.array([3, 5, 7, 0], np.int64)
    toks = np.random.RandomState(n).randint(0, JCFG.vocab, (1, tb))
    want = jl.prefill_paged(JP, jnp.asarray(toks, jnp.int32),
                            jnp.int32(start), jnp.int32(n - 1),
                            jnp.asarray(table, jnp.int32), jnp.asarray(kc),
                            jnp.asarray(vc), JCFG, BS)
    got = tl.prefill_paged(TP, torch.from_numpy(toks), start, n - 1,
                           torch.from_numpy(table), _tpool(kc), _tpool(vc),
                           TCFG, BS)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _cmp_pools(got[1:], want[1:], list(range(1, NB)))


def _decode_inputs(seed):
    rng = np.random.RandomState(seed)
    table = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 0, 0, 0]], np.int64)
    # row 2 sits past its table (a parked lane): its write goes to scratch
    pos = np.array([11, 20, 32], np.int64)
    tok = rng.randint(0, JCFG.vocab, 3)
    return tok, pos, table


def test_decode_step_slots_paged_parity():
    kc, vc = _pool(1)
    tok, pos, table = _decode_inputs(1)
    want = jl.decode_step_slots_paged(
        JP, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(table, jnp.int32), jnp.asarray(kc), jnp.asarray(vc),
        JCFG, BS)
    got = tl.decode_step_slots_paged(
        TP, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(table), _tpool(kc), _tpool(vc), TCFG, BS)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _cmp_pools(got[1:], want[1:], list(range(1, NB)))


def test_decode_horizon_slots_paged_parity():
    """Four fused steps with per-row budgets, an EOS and a frozen row:
    emitted tokens, carries and pools match."""
    kc, vc = _pool(2)
    tok, pos, table = _decode_inputs(2)
    pos = np.array([11, 17, 5], np.int64)
    active = np.array([True, True, False])
    rem = np.array([4, 2, 0], np.int64)
    eosv = np.array([-1, 7, -1], np.int64)
    want = jl.decode_horizon_slots_paged(
        JP, *(jnp.asarray(a, jnp.int32) for a in (tok, pos)),
        jnp.asarray(active), *(jnp.asarray(a, jnp.int32) for a in (
            rem, eosv, table)),
        jnp.asarray(kc), jnp.asarray(vc), JCFG, block_size=BS, horizon=4)
    got = tl.decode_horizon_slots_paged(
        TP, *(torch.from_numpy(a) for a in (tok, pos, active, rem, eosv,
                                            table)),
        _tpool(kc), _tpool(vc), TCFG, block_size=BS, horizon=4)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _cmp_pools(got[5:], want[5:], list(range(1, NB)))


# -- engine: token identity with the JAX paged engine -------------------------


@pytest.mark.parametrize("name", ["h1", "h4", "h16"])
def test_paged_greedy_token_identity(ref, name):
    eng = _port(horizon=int(name[1:]))
    got = _tokens(_joins(eng))
    assert got == ref(name)
    assert all(r.outcome == "done" for r in eng.results.values())
    assert eng._balloc.allocated_blocks == 0  # every block came back


def test_paged_eos_mid_block():
    full = _tokens(_eos(_jax(max_slots=2, horizon=8), eos=-1))["stops"]
    eos = full[2]  # mid-block at H=8
    want = _tokens(_eos(_jax(max_slots=2, horizon=8), eos=eos))
    eng = _port(max_slots=2, horizon=8)
    res = _eos(eng, eos)
    assert _tokens(res) == want
    assert res["stops"].tokens == full[:3] and res["stops"].outcome == "eos"


def test_paged_block_boundary_prompts(ref):
    """Prompt lengths at, one under and one over a block boundary."""
    assert _tokens(SCENARIOS["boundary"](_port)) == ref("boundary")


def test_paged_deadline_evict_then_reuse():
    """A deadline eviction frees the slot's blocks mid-decode; a new
    request reuses the lane and pool without cross-request leaks."""
    tj, tt = [0.0], [0.0]
    want = _tokens(_deadline(_jax(max_slots=2, clock=lambda: tj[0]), tj))
    eng = _port(max_slots=2, clock=lambda: tt[0])
    res = _deadline(eng, tt)
    assert _tokens(res) == want
    assert res["slow"].outcome == "timeout"
    assert eng._balloc.allocated_blocks == 0


# -- prefix cache: shared blocks, CoW, skipped prefill ------------------------


def test_prefix_hit_skips_prefill_and_stays_identical(ref):
    eng = _port(max_slots=2, prefix_cache=True)
    got = _tokens(_prefix_hit(eng))
    assert got == ref("prefix_hit")
    assert eng._prefix.hits == 2  # both shared blocks of b hit
    # one prefill dispatch each: b's covers only its tail
    assert eng.metrics.snapshot()["dispatches_prefill"] == 2


def test_full_prefix_hit_cow_divergence(ref):
    """An identical prompt (a full-chain hit) re-prefills only its last
    token into a copy-on-written block; the shared blocks survive for a
    third, divergent request."""
    eng = _port(max_slots=3, prefix_cache=True)
    got = _tokens(_full_hit(eng))
    assert got == ref("full_hit")
    assert got["two"] == got["one"]
    assert eng._prefix.hits >= 5  # 3 (full) + 2 (partial)
    assert eng._balloc.allocated_blocks == len(eng._prefix)  # cache refs


# -- chunked prefill -----------------------------------------------------------


def test_chunked_prefill_token_identity_and_interleave(ref):
    eng = _port(max_slots=2, prefill_chunk=8, horizon=2)
    got = _tokens(_chunked(eng))
    assert got == ref("chunked")
    # short: 1; long: 4 chunks + 1 final piece
    assert eng.metrics.snapshot()["dispatches_prefill"] == 6


def test_chunked_prefill_recovery_replays_inline(ref, monkeypatch):
    _flaky(monkeypatch, "_dispatch_block", 2)
    eng = _port(max_slots=2, prefill_chunk=8, horizon=4)
    assert _tokens(_chunked_two(eng)) == ref("chunked_two")
    assert eng.recoveries >= 1


# -- pool pressure: block-gated admission + preemption ------------------------


def test_admission_gates_on_blocks_not_slots(ref):
    """Usable pool = 8 blocks of 8 = one full-length sequence: admission
    waits for blocks, FIFO kept through requeues."""
    eng = _port(max_slots=4, pool_blocks=9)
    assert _tokens(_six(eng)) == ref("gated")
    assert eng._balloc.allocated_blocks == 0


def test_preemption_restores_and_completes(ref, monkeypatch):
    """Decode growth under a tight pool preempts the youngest slot back
    to the queue; it restarts and both streams stay exact."""
    calls = []
    orig = teng.ContinuousBatchingEngine._pg_preempt

    def counted(self, exclude):
        calls.append(exclude)
        return orig(self, exclude)

    monkeypatch.setattr(teng.ContinuousBatchingEngine, "_pg_preempt",
                        counted)
    eng = _port(max_slots=2, pool_blocks=9)
    assert _tokens(_preempt(eng)) == ref("preempt")
    assert calls  # the pool really ran out
    assert eng._balloc.allocated_blocks == 0


def _victims(monkeypatch, cls, out):
    """Record the rid of every slot ``cls._pg_preempt`` sends back."""
    orig = cls._pg_preempt

    def recorded(self, exclude):
        live = {sl.rid for sl in self._slots if sl is not None}
        done = orig(self, exclude)
        out.extend(sorted(live - {sl.rid for sl in self._slots
                                  if sl is not None}))
        return done

    monkeypatch.setattr(cls, "_pg_preempt", recorded)


def test_preemption_follows_the_reference_when_two_requests_cannot_share(
        monkeypatch):
    """Two requests that do not fit the pool together (6 + 4 blocks of
    8 usable) while others come and go: the port preempts the same
    requests in the same order as the JAX engine, and the requests that
    finish within the steps give the same tokens. The policy (the
    youngest slot other than the one that needs a block) lets a younger
    slot preempt an older one, so on this feed both engines preempt in
    nearly every step and the two never finish: ROADMAP Queue C."""
    reqs = [(list(range(2, 21)), 9), (list(range(2, 18)), 7),
            (list(range(40, 76)), 6), ([1, 2, 3, 4] * 3, 14),
            (list(range(2, 18)), 5), ([5, 9] * 5, 11)]
    got, want = [], []
    _victims(monkeypatch, teng.ContinuousBatchingEngine, got)
    _victims(monkeypatch, JEngine, want)
    runs = []
    for make in (_port, _jax):
        eng = make(max_slots=4, pool_blocks=9, horizon=4)
        for i, (p, mn) in enumerate(reqs):
            eng.submit(f"r{i}", p, mn)
        runs.append(_tokens(eng.run(max_steps=STUCK_STEPS)))
    assert got == want and len(got) > STUCK_STEPS // 2
    assert runs[0] == runs[1] and len(runs[0]) < len(reqs)


# -- crash recovery rebuilds pool + tables ------------------------------------


def _flaky(monkeypatch, target, n):
    """Make the n-th call of an engine method raise once."""
    orig = getattr(teng.ContinuousBatchingEngine, target)
    calls = {"n": 0}

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == n:
            raise RuntimeError(f"injected {target} fault")
        return orig(self, *a, **kw)

    monkeypatch.setattr(teng.ContinuousBatchingEngine, target, flaky)


@pytest.mark.parametrize("target,n", [
    ("_dispatch_block", 3),
    ("_drain_one", 2),
    ("_dispatch_prefill_final", 2),
])
def test_paged_recovery_token_identity(ref, monkeypatch, target, n):
    _flaky(monkeypatch, target, n)
    eng = _port(horizon=8, max_recoveries=3, prefix_cache=True)
    assert _tokens(_joins(eng)) == ref("recovery")
    assert eng.recoveries >= 1
    # only the prefix cache's own refs remain once every slot freed
    assert eng._balloc.allocated_blocks == len(eng._prefix)


def test_recovery_rebuilds_consistent_tables(ref, monkeypatch):
    """After a crash, live slots' tables cover exactly their resident
    tokens and reference only allocated blocks."""
    _flaky(monkeypatch, "_dispatch_block", 2)
    eng = _port(max_slots=2, horizon=4)
    eng.submit("a", PROMPTS[0], 20)
    eng.submit("b", PROMPTS[1], 20)
    for _ in range(3):
        eng.step()
    assert eng.recoveries >= 1
    for i, sl in enumerate(eng._slots):
        if sl is None:
            continue
        resident = len(sl.prompt) + len(sl.generated)
        tbl = eng._tables[i]
        for j in range(paged.blocks_for(resident, eng.block_size)):
            assert tbl[j] != paged.SCRATCH
            assert eng._balloc.refcount(tbl[j]) >= 1
    assert _tokens(eng.run()) == ref("two_long")


# -- construction validation and the CLI ---------------------------------------


def test_paged_constructor_validation():
    for kw, msg in (
        ({"max_len": 60, "block_size": 8}, "multiple"),
        ({"max_len": 64, "block_size": 8, "pool_blocks": 4}, "pool_blocks"),
        ({"max_len": 64, "prefix_cache": True}, "block_size"),
        ({"max_len": 64, "prefill_chunk": 8}, "block_size"),
        ({"max_len": 64, "block_size": 8, "prefill_chunk": -1},
         "prefill_chunk"),
    ):
        with pytest.raises(ValueError, match=msg):
            JEngine(JP, JCFG, **kw)
        with pytest.raises(ValueError, match=msg):
            ContinuousBatchingEngine(TP, TCFG, device="cpu", **kw)


def test_cli_serve_paged_modes_match_reference_engine(tmp_path):
    """``serve --block-size 16 --prefix-cache --kv-quant int8 --spec-k
    4`` serves a feed; its tokens are the JAX engine's in the same
    configuration."""
    jexport.export_params(str(tmp_path), JP, step=1, dtype="float32",
                          model_meta=JCFG.to_meta())
    feed = [{"id": "a", "prompt": SHARED + [30, 31], "max_new": 9},
            {"id": "b", "prompt": SHARED + [40], "max_new": 7},
            {"id": "c", "prompt": [1, 2, 3, 1, 2, 3, 1, 2], "max_new": 12}]
    path = tmp_path / "reqs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in feed))
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch", "serve", str(tmp_path),
         "--requests", str(path), "--max-slots", "2", "--max-len", "64",
         "--horizon", "4", "--block-size", "16", "--prefix-cache",
         "--kv-quant", "int8", "--spec-k", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    recs = [json.loads(line) for line in out.stdout.strip().splitlines()]
    ref = JEngine(JP, JCFG, max_slots=2, max_len=64, horizon=4,
                  block_size=16, prefix_cache=True, kv_quant="int8",
                  spec_k=4)
    for r in feed:
        ref.submit(r["id"], r["prompt"], r["max_new"])
    want = ref.run()
    assert [r["id"] for r in recs] == ["a", "b", "c"]
    for r in recs:
        assert r["outcome"] == "done"
        assert r["tokens"] == want[r["id"]].tokens, r["id"]
