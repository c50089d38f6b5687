"""Port parity of the int8 lever: ``edl_tpu_torch.ops.int8_matmul``,
``int8_mxu`` training, the weight-only int8 records and their serving,
against ``edl_tpu``.

Inputs come from NumPy seeds and go through the JAX function and its
port on the CPU. The quantizer's q and s must be equal bit for bit; the
products' forward and STE gradients within 2^-8 relative of the
reference's (one bf16 rounding); ``LlamaConfig.tiny`` with ``int8_mxu``
within 1e-4 of each gradient leaf's largest entry, and every remat
policy equal to the port's "full" bit for bit; the records equal, and
greedy tokens through them identical to the JAX ``generate`` and
engines. Also the decode roofline's byte formulas, and
``chip_smoke.py``'s int8 gates tripping on planted faults.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from edl_tpu.models import llama as jl
from edl_tpu.obs import costmodel as jcost
from edl_tpu.ops import int8_matmul as jim
from edl_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import costmodel as tcost
from edl_tpu_torch.ops import int8_matmul as tim
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
REL = 2 ** -8  # one bf16 rounding


def _tp():
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu",
                             torch.float32)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, rel=REL):
    """Within ``rel`` of the reference's largest entry."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# -- the op ----------------------------------------------------------------


@pytest.mark.parametrize("shape,axis,dtype", [
    ((64, 96), 0, "float32"), ((64, 96), 1, "float32"),
    ((4, 24, 40), -2, "float32"), ((4, 24, 40), -1, "float32"),
    ((64, 96), 1, "bfloat16"), ((64, 96), 0, "bfloat16")])
def test_absmax_quant_bit_equal(shape, axis, dtype):
    x = np.random.RandomState(len(shape) + axis).randn(*shape) * 3
    x.reshape(-1, shape[-1])[5] = 0  # an all-zero row: scale 1, no NaN
    x[..., 7] = 0  # an all-zero column
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    tx = tx.to(getattr(torch, dtype))
    qj, sj = jim.absmax_quant(jx, axis)
    qt, st = tim.absmax_quant(tx, axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.isfinite(st.numpy()).all() and (st.numpy() > 0).all()


def _operands(seed, m=48, k=64, n=40, a_dtype=np.float32):
    rng = np.random.RandomState(seed)
    a = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    ct = rng.randn(m, n).astype(np.float32)
    ct[0, 0] = 50.0  # a gradient outlier
    if a_dtype != np.float32:
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a, w, ct


@pytest.mark.parametrize("wgrad_bf16", [False, True])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_int8_matmul_forward_and_grads(wgrad_bf16, a_dtype):
    a, w, ct = _operands(1 + wgrad_bf16, a_dtype=a_dtype)
    ja = jnp.asarray(a, a_dtype)
    (y, vjp) = jax.vjp(lambda a, w: jim.int8_matmul(a, w, wgrad_bf16),
                       ja, jnp.asarray(w))
    jda, jdw = vjp(jnp.asarray(ct, a_dtype))
    ta = torch.from_numpy(a).to(getattr(torch, a_dtype)).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = tim.int8_matmul(ta, tw, wgrad_bf16)
    assert ty.dtype == ta.dtype and ty.shape == (a.shape[0], w.shape[1])
    tda, tdw = torch.autograd.grad(
        ty, (ta, tw), torch.from_numpy(ct).to(ta.dtype))
    assert tda.dtype == ta.dtype and tdw.dtype == torch.float32
    for got, want in ((ty, y), (tda, jda), (tdw, jdw)):
        _close(got, want)


def test_int8_matmul_3d_zero_and_registered():
    """Leading dims fold into M; all-zero operands give zeros and finite
    gradients; the op is one registered operator with a fake kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a = torch.zeros(2, 3, 16, requires_grad=True)
    w = torch.zeros(16, 8, requires_grad=True)
    y = tim.int8_matmul(a, w)
    assert y.shape == (2, 3, 8) and not y.any()
    assert "edl_tpu_torch_int8_matmul" in y.grad_fn.name()
    da, dw = torch.autograd.grad(y.sum(), (a, w))
    assert torch.isfinite(da).all() and torch.isfinite(dw).all()
    with FakeTensorMode():
        out = torch.ops.edl_tpu_torch.int8_matmul(
            torch.empty(5, 7, 32, dtype=torch.bfloat16), torch.empty(32, 24),
            False)
    assert out.shape == (5, 7, 24) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("wgrad_bf16", [False, True])
def test_int8_batched_matmul_forward_and_grads(wgrad_bf16):
    rng = np.random.RandomState(4)
    a = rng.randn(3, 24, 32).astype(np.float32)
    w = rng.randn(3, 32, 16).astype(np.float32)
    ct = rng.randn(3, 24, 16).astype(np.float32)
    y, vjp = jax.vjp(lambda a, w: jim.int8_batched_matmul(a, w, wgrad_bf16),
                     jnp.asarray(a), jnp.asarray(w))
    jda, jdw = vjp(jnp.asarray(ct))
    ta, tw = (torch.from_numpy(x).requires_grad_() for x in (a, w))
    ty = tim.int8_batched_matmul(ta, tw, wgrad_bf16)
    tda, tdw = torch.autograd.grad(ty, (ta, tw), torch.from_numpy(ct))
    for got, want in ((ty, y), (tda, jda), (tdw, jdw)):
        _close(got, want)


@pytest.mark.parametrize("m,k,n", [(48, 64, 40), (5, 64, 40),
                                   (33, 60, 36), (16, 7, 9)])
def test_dot8_is_exact_on_the_cpu(m, k, n):
    """The int8 product equals the exact one on the CPU, whose
    ``_int_mm`` takes every shape: those the card's GEMM takes (M > 16,
    K and N multiples of 8) and those it refuses (tests/test_torch_cuda
    holds that the card raises on them), in the K-innermost layouts the
    op hands it."""
    rng = np.random.RandomState(m + k + n)
    qa = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    qbt = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    got = tim._dot8(qa, qbt.t())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    want = qa.long() @ qbt.long().t()
    assert torch.equal(got.long(), want)


def test_wgrad_bf16_refuses_tf32_on_the_card(monkeypatch):
    """The bf16 wgrad needs exact f32 products: with TF32 allowed, a
    CUDA operand raises (the check reads only the flag and the device)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a2 = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tim._wgrad(a2, None, True)


# -- int8_mxu training -----------------------------------------------------


@pytest.mark.parametrize("wgrad_bf16", [False, True])
def test_int8_mxu_loss_and_grads_match_reference(wgrad_bf16):
    jc = dataclasses.replace(JCFG, int8_mxu=True, int8_wgrad_bf16=wgrad_bf16)
    tc = dataclasses.replace(TCFG, int8_mxu=True, int8_wgrad_bf16=wgrad_bf16)
    nb = tl.synthetic_tokens(np.random.RandomState(5), 2, 16, JCFG.vocab)
    jloss, jgrads = jax.value_and_grad(jl.make_loss_fn(jc))(
        JP, jax.tree_util.tree_map(jnp.asarray, nb))
    tim.reset_calls()
    tloss, tgrads = trainer.value_and_grad(tl.make_loss_fn(tc))(
        trainer.trainable(_tp()), {"tokens": torch.from_numpy(nb["tokens"])})
    L = TCFG.n_layers
    assert tim.calls == {"fwd": 7 * L, "bwd": 7 * L}  # lm_head stays dense
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for g, w in zip(trainer.leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        _close(g, w, 1e-4)


# per layer, the int8 products the backward recomputes under each
# policy: chip_smoke's REMAT_RECOMPUTED_MM for the dense products plus
# w2's, which the dense path never recomputes. Non-reentrant
# checkpointing stops once the backward's last saved tensor is back;
# aten.mm saves its inputs before it runs, a registered op's autograd
# after, so the recompute runs the w2 op to reach its saves.
INT8_RECOMPUTED = {"full": 7, "attn": 7, "mlp": 5, "dots": 0}


@pytest.mark.parametrize("policy", sorted(INT8_RECOMPUTED))
def test_int8_mxu_remat_policies_equal_full(policy):
    """Under int8_mxu the remat policies save the int8 op's outputs as
    they save ``aten.mm``'s ("mlp": w1 and w3; "dots": all seven): the
    recomputed products are the reckoned ones and loss and gradients
    equal "full"'s bit for bit."""
    cfg = dataclasses.replace(TCFG, int8_mxu=True, remat=True, use_flash=True)
    nb = tl.synthetic_tokens(np.random.RandomState(6), 2, 16, JCFG.vocab)
    batch = {"tokens": torch.from_numpy(nb["tokens"])}
    ref = chip_smoke._remat_step(trainer.trainable(_tp()), cfg, batch)
    got = chip_smoke._remat_step(
        trainer.trainable(_tp()),
        dataclasses.replace(cfg, remat_policy=policy), batch)
    L = TCFG.n_layers
    assert got[2]["recomputed_mm"] == INT8_RECOMPUTED[policy] * L
    lse = chip_smoke.REMAT_LSE_PER_LAYER[policy] * L
    assert got[2]["flash_fwd_ops"] == lse
    assert float(got[0]) == float(ref[0])
    for g, r in zip(got[1], ref[1]):
        assert torch.equal(g, r)


# -- weight-only int8 records ----------------------------------------------


def test_quantize_params_int8_records_bit_equal():
    jq = jl.quantize_params_int8(JP)
    tq = tl.quantize_params_int8(_tp())
    for name in tl._INT8_WEIGHTS:
        assert set(tq["layers"][name]) == {"q8", "s8"}
    assert set(tq["lm_head"]) == {"q8", "s8"}
    assert not isinstance(tq["embed"], dict)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(jq)]
    for name, t, j in zip(paths, trainer.leaves(tq),
                          jax.tree_util.tree_leaves(jq), strict=True):
        assert t.dtype == {np.int8: torch.int8, np.float32: torch.float32}[
            np.asarray(j).dtype.type], name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.fixture(scope="module")
def records():
    return jl.quantize_params_int8(JP), tl.quantize_params_int8(_tp())


@pytest.mark.parametrize("t0,max_new", [(4, 6), (9, 5)])
def test_generate_with_records_token_identical(records, t0, max_new):
    jq, tq = records
    prompt = np.random.RandomState(t0).randint(0, JCFG.vocab, (2, t0))
    want = np.asarray(jl.generate(jq, jnp.asarray(prompt, jnp.int32), JCFG,
                                  max_new=max_new))
    got = tl.generate(tq, torch.from_numpy(prompt), TCFG, max_new=max_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_drops_int8_mxu():
    """The training-only flag would quantize the decode's _qkv/_mlp
    products dynamically: generate drops it, as the reference's does."""
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, JCFG.vocab, (2, 5)))
    tp = _tp()
    want = tl.generate(tp, prompt, TCFG, max_new=6)
    tim.reset_calls()
    got = tl.generate(tp, prompt, dataclasses.replace(
        TCFG, int8_mxu=True, int8_wgrad_bf16=True), max_new=6)
    assert tim.calls == {"fwd": 0, "bwd": 0}
    assert torch.equal(got, want)


def _serve(engine_cls, params, cfg, **kw):
    prompts = [list(range(2, 2 + n)) for n in (4, 7, 3, 9, 5)]
    eng = engine_cls(params, cfg, max_slots=3, max_len=32, horizon=4, **kw)
    for i in range(3):
        eng.submit(f"r{i}", prompts[i], 5 + i)
    eng.step()
    for i in range(3, 5):
        eng.submit(f"r{i}", prompts[i], 6)
    return {k: v.tokens for k, v in eng.run().items()}


@pytest.mark.parametrize("block_size", [0, 8])
def test_engines_with_records_token_identical(records, block_size):
    """The contiguous and the paged engine on the int8 tree emit the JAX
    engine's greedy tokens."""
    jq, tq = records
    kw = {"block_size": block_size} if block_size else {}
    want = _serve(JEngine, jq, JCFG, **kw)
    tim.reset_calls()
    got = _serve(ContinuousBatchingEngine, tq, TCFG, device="cpu", **kw)
    assert got == want
    assert tim.calls == {"fwd": 0, "bwd": 0}


# -- the decode roofline's bytes -------------------------------------------


def _flagship(mod, dtype):
    return mod.LlamaConfig(vocab=32768, d_model=2048, n_layers=16,
                           n_heads=16, n_kv_heads=8, d_ff=6144, dtype=dtype)


@pytest.mark.parametrize("which", ["tiny", "flagship", "llama3_8b"])
def test_decode_bytes_match_reference(which):
    jc, tc = {"tiny": (JCFG, TCFG),
              "flagship": (_flagship(jl, jnp.bfloat16),
                           _flagship(tl, torch.bfloat16)),
              "llama3_8b": (jl.LlamaConfig(), tl.LlamaConfig())}[which]
    assert tcost.n_params(tc) == jcost.n_params(jc)
    assert tcost.param_bytes(tc) == jcost.param_bytes(jc)
    for b, s in ((1, 704), (8, 704), (32, 300)):
        assert tcost.kv_cache_bytes(tc, b, s) == jcost.kv_cache_bytes(jc, b, s)
        assert (tcost.kv_scale_bytes(tc, b, s, 16)
                == jcost.kv_scale_bytes(jc, b, s, 16))
        for kw in ({}, {"kv_bytes_per_el": 1, "kv_block_size": 16}):
            assert (tcost.decode_step_bytes(tc, 1e9, b, s, **kw)
                    == jcost.decode_step_bytes(jc, 1e9, b, s, **kw))
    if which == "flagship":
        assert tcost.n_params(tc) == 939_591_680


# -- chip_smoke's int8 gates -----------------------------------------------


@pytest.mark.parametrize("fault", [None, "s8_bf16", "left_dense",
                                   "q8_shape", "embed_quantized"])
def test_chip_smoke_int8_tree_check_trips(fault):
    """The int8 tree gate on a bf16 tree proportioned like the flagship
    (embedding a small share): it holds on quantize_params_int8's tree
    and trips on an s8 cast to bf16, a record left dense, a q8 of
    another shape and a quantized embedding."""
    cfg = dataclasses.replace(TCFG, vocab=256, d_model=128, d_ff=512,
                              dtype=torch.bfloat16)
    params = tl.init_params(cfg, seed=1, device="cpu")
    q = tl.quantize_params_int8(params)
    if fault == "s8_bf16":
        q["lm_head"] = {**q["lm_head"],
                        "s8": q["lm_head"]["s8"].to(torch.bfloat16)}
    elif fault == "left_dense":
        q["layers"] = {**q["layers"], "w1": params["layers"]["w1"]}
    elif fault == "q8_shape":
        rec = q["layers"]["wo"]
        q["layers"] = {**q["layers"], "wo": {**rec, "q8": rec["q8"][:, :-1]}}
    elif fault == "embed_quantized":
        q["embed"] = params["embed"].clone()
    if fault is None:
        got, dense = chip_smoke._int8_tree_check(q, params)
        assert got / dense <= chip_smoke.INT8_TREE_MOST
        return
    with pytest.raises(AssertionError, match="int8 tree"):
        chip_smoke._int8_tree_check(q, params)


def test_chip_smoke_decode_gate_trips_when_generate_keeps_int8_mxu(
        monkeypatch):
    """The decode ladder hands generate the int8 training config; the
    gate holds while generate drops int8_mxu and trips when it does
    not."""
    cfg = dataclasses.replace(TCFG, int8_mxu=True)
    tp = _tp()
    out = chip_smoke._measure_decode(tp, cfg, 2, 6, 4, "cpu")
    assert out[3].shape == (2, 6)
    monkeypatch.setattr(tl, "dataclasses", types.SimpleNamespace(
        replace=lambda c, **kw: c))
    with pytest.raises(AssertionError, match="int8_mxu was left on"):
        chip_smoke._measure_decode(tp, cfg, 2, 6, 4, "cpu")


@pytest.mark.parametrize("fault", [None, "bf16_rung_calls", "fwd_calls",
                                   "bwd_calls"])
def test_chip_smoke_int8_ladder_check_trips(fault):
    n_layers, steps = 16, 10
    losses = [10.4, 10.1, 9.7]
    counts = {"flash_fwd": 0, "flash_fwd_lse": 32 * steps,
              "flash_bwd_dq": 16 * steps, "flash_bwd_dkv": 16 * steps}
    per = 7 * n_layers * steps
    calls, int8 = {"fwd": 2 * per, "bwd": per}, True
    if fault == "bf16_rung_calls":
        int8 = False  # a bf16 rung that ran int8 products
    elif fault == "fwd_calls":
        calls["fwd"] = per  # the recompute skipped the int8 path
    elif fault == "bwd_calls":
        calls["bwd"] -= 1
    if fault is None:
        chip_smoke._ladder_check(losses, counts, n_layers, steps, calls, int8)
        chip_smoke._ladder_check(losses, counts, n_layers, steps,
                                 {"fwd": 0, "bwd": 0}, False)
        return
    with pytest.raises(AssertionError, match="int8_matmul calls"):
        chip_smoke._ladder_check(losses, counts, n_layers, steps, calls, int8)


@pytest.mark.parametrize("fault", [None, "sa_ulp", "k_inner", "fwd_out",
                                   "dgrad", "wgrad"])
def test_chip_smoke_int8_products_check_trips(monkeypatch, fault):
    """The int8_products phase's comparisons, run CPU against CPU at a
    small M: every q, s and int32 accumulator equal and every output
    exact, and each check trips on a fault planted on the side it holds
    to the plain sequence: the activation's row scales one ulp high, a
    scrambled K-innermost layout, and the op's forward, dgrad or wgrad
    a few ulps off."""
    m, k, n = 96, 64, 48
    monkeypatch.setattr(chip_smoke, "I8_ROWS", 16)
    monkeypatch.setattr(chip_smoke, "I8_COLS", 8)
    quant, mm, dgrad, wgrad = (tim.absmax_quant, tim._mm, tim._dgrad,
                               tim._wgrad)

    def off(x, rel):
        return x * (1 + rel)

    if fault == "sa_ulp":  # only the whole-M row quantize is the card's
        def faulty(x, axis):
            q, s = quant(x, axis)
            if x.shape[0] == m and axis == 1:
                s = torch.nextafter(s, torch.full_like(s, math.inf))
            return q, s
        monkeypatch.setattr(tim, "absmax_quant", faulty)
    elif fault == "k_inner":
        monkeypatch.setattr(tim, "_k_inner",
                            lambda q: q.t().contiguous().view(q.shape))
    elif fault == "fwd_out":
        monkeypatch.setattr(tim, "_mm", lambda a, w: off(mm(a, w), 2 ** -6))
    elif fault == "dgrad":
        monkeypatch.setattr(tim, "_dgrad",
                            lambda g2, w: off(dgrad(g2, w), 2 ** -6))
    elif fault == "wgrad":
        monkeypatch.setattr(tim, "_wgrad", lambda a2, g2, bf: off(
            wgrad(a2, g2, bf), 2 ** -20))
    if fault is None:
        row = chip_smoke._int8_product_row(k, n, m, "cpu", "cpu")
        assert row["max_abs_err"] == {"forward": 0.0, "dgrad": 0.0,
                                      "wgrad": 0.0}
        return
    match = {"sa_ulp": "int8 sa ", "k_inner": "forward int32",
             "fwd_out": "int8 forward ", "dgrad": "int8 dgrad ",
             "wgrad": "int8 wgrad "}[fault]
    with pytest.raises(AssertionError, match=match):
        chip_smoke._int8_product_row(k, n, m, "cpu", "cpu")
