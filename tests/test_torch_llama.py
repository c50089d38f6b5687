"""Port parity: edl_tpu_torch.models.llama vs edl_tpu.models.llama.

Same weights (the JAX init, carried across through NumPy by
``params_from_numpy``), same tokens (NumPy seeds), ``LlamaConfig.tiny``
in f32 with ``use_flash=True`` on both sides (the reference's Pallas
kernel in interpret mode, the port's plain flash version on the CPU).
Tolerance atol/rtol 1e-4, as tests/test_llama_generate.py holds the
reference's own alternate paths; greedy tokens must be identical.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

JCFG = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash=True)
TCFG = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True)
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(seed, b, t):
    return np.random.RandomState(seed).randint(0, JCFG.vocab, (b, t)).astype(
        np.int32
    )


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_config_meta_round_trip_matches_reference():
    assert TCFG.to_meta() == JCFG.to_meta()
    big = tl.LlamaConfig.llama3_8b()
    assert big.to_meta() == jl.LlamaConfig.llama3_8b().to_meta()
    assert tl.LlamaConfig.from_meta(big.to_meta()) == big
    with pytest.raises(ValueError, match="not a llama"):
        tl.LlamaConfig.from_meta({"family": "ctr"})


def test_forward_parity():
    toks = _tokens(0, 2, 16)
    want = np.asarray(jl.forward(JP, jnp.asarray(toks), JCFG))
    got = tl.forward(TP, _t(toks), TCFG).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_dense_path_parity():
    """use_flash=False on both sides: the dense masked attention."""
    jc = dataclasses.replace(JCFG, use_flash=False)
    tc = dataclasses.replace(TCFG, use_flash=False)
    toks = _tokens(1, 2, 12)
    want = np.asarray(jl.forward(JP, jnp.asarray(toks), jc))
    got = tl.forward(TP, _t(toks), tc).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_padded_logits_and_cache_parity():
    toks = _tokens(2, 2, 16)
    last = np.array([9, 15], np.int32)
    wl, wk, wv = jl.prefill_padded(JP, jnp.asarray(toks), jnp.asarray(last),
                                   JCFG)
    gl, gk, gv = tl.prefill_padded(TP, _t(toks), _t(last), TCFG)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


def _cache(seed, b, s):
    """A cache in the reference's [L, B, S, KV, hd] layout."""
    rng = np.random.RandomState(seed)
    shape = (JCFG.n_layers, b, s, JCFG.n_kv_heads, JCFG.head_dim)
    return [rng.randn(*shape).astype(np.float32) for _ in range(2)]


def _head_major(a):
    """The reference's [L, B, S, KV, hd] cache as the port's head-major
    [L, B, KV, S, hd] tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.swapaxes(2, 3)))


def _pos_major(t):
    """The port's head-major cache back in the reference's layout."""
    return t.numpy().swapaxes(2, 3)


def test_decode_step_slots_parity():
    kc, vc = _cache(3, 3, 24)
    tok = np.array([5, 17, 200], np.int32)
    pos = np.array([4, 11, 0], np.int32)
    wl, wk, wv = jl.decode_step_slots(
        JP, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(kc),
        jnp.asarray(vc), JCFG,
    )
    tk, tv = _head_major(kc), _head_major(vc)
    gl, gk, gv = tl.decode_step_slots(TP, _t(tok), _t(pos), tk, tv, TCFG)
    assert gk is tk and gv is tv  # updated in place
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(_pos_major(gk), np.asarray(wk), **TOL)
    np.testing.assert_allclose(_pos_major(gv), np.asarray(wv), **TOL)


def test_decode_horizon_slots_parity():
    """H=5 fused steps with per-slot freezing: row 0 runs out of budget
    mid-horizon, row 1 stops on its EOS, row 2 starts inactive."""
    kc, vc = _cache(4, 3, 32)
    tok = np.array([5, 17, 200], np.int32)
    pos = np.array([4, 11, 6], np.int32)
    active = np.array([True, True, False])
    rem = np.array([2, 9, 3], np.int32)
    # row 1's greedy 2nd token as its stop token
    probe = jl.decode_horizon_slots(
        JP, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(rem), jnp.full((3,), -1, jnp.int32), jnp.asarray(kc),
        jnp.asarray(vc), JCFG, horizon=5,
    )
    eosv = np.array([-1, int(np.asarray(probe[0])[1, 1]), -1], np.int32)
    want = jl.decode_horizon_slots(
        JP, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(rem), jnp.asarray(eosv), jnp.asarray(kc),
        jnp.asarray(vc), JCFG, horizon=5,
    )
    got = tl.decode_horizon_slots(
        TP, _t(tok), _t(pos), torch.from_numpy(active), _t(rem), _t(eosv),
        _head_major(kc), _head_major(vc), TCFG, horizon=5,
    )
    for w, g in zip(want[:5], got[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[1, 2:] == -1).all()  # frozen after EOS
    np.testing.assert_allclose(_pos_major(got[5]), np.asarray(want[5]),
                               **TOL)
    np.testing.assert_allclose(_pos_major(got[6]), np.asarray(want[6]),
                               **TOL)


@pytest.mark.parametrize("t0,max_new", [(6, 7), (11, 4)])
def test_generate_greedy_tokens_identical(t0, max_new):
    toks = _tokens(5 + t0, 2, t0)
    want = np.asarray(jl.generate(JP, jnp.asarray(toks), JCFG,
                                  max_new=max_new))
    got = tl.generate(TP, _t(toks), TCFG, max_new=max_new).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_sampling_deterministic_per_seed():
    """torch.Generator draws differ from jax.random's, so sampling is
    held to determinism per seed (and the controls' validity)."""
    toks = _t(_tokens(7, 2, 5))
    runs = [
        tl.generate(TP, toks, TCFG, max_new=6, temperature=0.8,
                    generator=torch.Generator().manual_seed(s),
                    top_k=20, top_p=0.9)
        for s in (3, 3)
    ]
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
    assert runs[0].shape == (2, 6)
    assert ((runs[0] >= 0) & (runs[0] < TCFG.vocab)).all()
    with pytest.raises(ValueError, match="torch.Generator"):
        tl.generate(TP, toks, TCFG, max_new=2, temperature=0.5)
    with pytest.raises(ValueError, match="temperature > 0"):
        tl.generate(TP, toks, TCFG, max_new=2, top_k=5)
    # top_k=1 is greedy whatever the temperature
    greedy = tl.generate(TP, toks, TCFG, max_new=4)
    k1 = tl.generate(TP, toks, TCFG, max_new=4, temperature=2.0,
                     generator=torch.Generator().manual_seed(0), top_k=1)
    torch.testing.assert_close(k1, greedy, atol=0, rtol=0)


def test_int8_records_not_ported_yet():
    """The weight-only int8 records are ported: ``forward`` on
    ``quantize_params_int8``'s tree against the reference's on its own
    (the name is kept from when records raised)."""
    toks = _tokens(8, 2, 16)
    want = np.asarray(jl.forward(jl.quantize_params_int8(JP),
                                 jnp.asarray(toks), JCFG))
    got = tl.forward(tl.quantize_params_int8(TP), _t(toks), TCFG).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_params_from_numpy_bf16_bit_exact_and_cast():
    a = np.asarray(jnp.asarray(np.random.RandomState(9).randn(5, 7),
                               jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    tree = params_from_numpy({"w": a, "i": np.arange(3)}, "cpu",
                             torch.float32)
    assert tree["w"].dtype == torch.float32
    assert tree["i"].dtype == torch.int64  # integer leaves keep their type
    np.testing.assert_array_equal(tree["w"].numpy(), a.astype(np.float32))


def test_init_params_shapes_and_seed():
    p1 = tl.init_params(TCFG, seed=3, device="cpu")
    p2 = tl.init_params(TCFG, seed=3, device="cpu")
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(JP),
                         jax.tree_util.tree_leaves(
                             jax.tree_util.tree_map(lambda x: x, p1))):
        assert tuple(a.shape) == tuple(b.shape), k
    torch.testing.assert_close(p1["layers"]["wq"], p2["layers"]["wq"],
                               atol=0, rtol=0)


# __graft_entry__.entry()'s config: the flagship forward compile-checked
# on one chip (vocab 32768, d512/L4/H8/KV4, d_ff 1536, bf16, flash)
GRAFT = dict(vocab=32768, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
             d_ff=1536, use_flash=True)
# Both forwards round to bf16 at the same points, ten a layer (the two
# norms, the q/k/v, o, w1, w3 and w2 products, rope, the two residual
# adds) and once at the logits. The frameworks sum in f32 in other
# orders, so at any point an element may land one bf16 ulp (2^-8
# relative) apart. Were every element one ulp apart at every point, each
# independently, a position's logits would differ by
# sqrt(10 * 4 + 1) * 2^-8 of their RMS: the bound on every position.
GRAFT_ROW_RTOL = math.sqrt(10 * GRAFT["n_layers"] + 1) * 2 ** -8


def _row_rel(got, want):
    """Per position: RMS of the difference over the RMS of ``want``."""
    return (np.sqrt(((got - want) ** 2).mean(-1))
            / np.sqrt((want ** 2).mean(-1)))


def test_bf16_forward_parity_at_the_graft_entry_config():
    """The port's bf16 ``forward`` against the reference's (its flash in
    Pallas interpret mode) at ``__graft_entry__.entry()``'s config and
    tokens [4, 256], weights carried over by ``params_from_numpy``: every
    position within GRAFT_ROW_RTOL, and a planted wrong ``rope_theta``
    far outside it."""
    jc = jl.LlamaConfig(**GRAFT, dtype=jnp.bfloat16)
    tc = tl.LlamaConfig(**GRAFT, dtype=torch.bfloat16)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.RandomState(0).randint(0, jc.vocab, (4, 256), np.int32)
    want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jc), np.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = tl.forward(tp, _t(tokens), tc)
    assert got.dtype == torch.float32 and got.shape == (4, 256, jc.vocab)
    assert _row_rel(got.numpy(), want).max() <= GRAFT_ROW_RTOL
    bad = tl.forward(tp, _t(tokens), dataclasses.replace(tc, rope_theta=1e4))
    assert _row_rel(bad.numpy(), want).max() > 10 * GRAFT_ROW_RTOL
