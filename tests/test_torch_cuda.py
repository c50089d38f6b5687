"""Hopper kernels of edl_tpu_torch on the card, held against their
plain PyTorch versions, and one training step on the card. Needs a CUDA
card and nvcc; skips without one. This file imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from edl_tpu_torch.ops import flash_attention as tfa

# bf16 backward tolerance: |kernel - plain| <= 1e-2 * max|plain| +
# 2^-7 * |plain|. Both sides round p and ds to bf16 before the same
# products and sum in f32 in different orders, then round the result to
# bf16 (one ulp is 2^-8 relative); the absolute term covers entries near
# zero, whose sums cancel.
GRAD_ATOL_OF_MAX = 1e-2
# lse is f32 on both sides, from the same base-2 online softmax on the
# forward kernel's 128 x 128 tiles: only the f32 summation order of s and
# l (and the kernel's one fused multiply-add in the exponent) differs.
LSE_ATOL = 1e-4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _plain_block(t):
    """The forward kernel's 128-row tiles where T divides them; else one
    block, the reference's own blocking below T=128 (T=8, T=100). P is
    rounded to bf16 against the running max of each key tile, so the
    plain version runs on the kernel's key tiles."""
    return 128 if t % 128 == 0 else t


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 100, 128, 1024, 1536])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [128, 64])
def test_cuda_kernel_matches_plain_version(t, causal, d):
    """The Hopper kernel against flash_attention_ref on the card (bf16,
    H=32, KV=8, both head dims; T=100 is the ragged edge the kernel masks
    itself over TMA's zero fill). Tolerance: 2e-2 absolute plus 2^-7
    relative — both sides round the output to bf16 and sum in different
    orders."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (_randn(gen, 1, t, n, d) for n in (32, 8, 8))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    blk = _plain_block(t)
    want = tfa.flash_attention_ref(q, k, v, causal, blk, blk)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("view",
                         ["fused_qkv", "broadcast_kv", "batch_of_one"])
def test_cuda_kernel_takes_strided_views(view):
    """The wrapper takes any view whose rows are 16-byte aligned; the
    kernel's tensor maps carry the caller's strides: q/k/v cut from one
    fused [B, T, H + 2 KV, d] projection, K/V broadcast over the KV heads
    (stride 0), and a batch of one with an unusual batch stride. Held to
    the plain version on contiguous copies, tolerance as above."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, t, h, kv, d = 2, 384, 8, 2, 128
    if view == "fused_qkv":
        qkv = _randn(gen, b, t, h + 2 * kv, d)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    elif view == "broadcast_kv":
        q = _randn(gen, b, t, h, d)
        k, v = (_randn(gen, b, t, 1, d).expand(b, t, kv, d)
                for _ in range(2))
    else:
        q, k, v = (_randn(gen, 1, t, n, d) for n in (h, kv, kv))
        q, k, v = (x.as_strided(x.shape, (8,) + x.stride()[1:])
                   for x in (q, k, v))
    got = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    blk = _plain_block(t)
    want = tfa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), True, blk, blk)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)


def _assert_grad_close(got, want, name):
    want = want.float()
    diff = (got.float() - want).abs()
    tol = GRAD_ATOL_OF_MAX * want.abs().max() + 2 ** -7 * want.abs()
    assert torch.isfinite(got.float()).all(), name
    assert bool((diff <= tol).all()), (
        f"{name}: max abs err {float(diff.max())}, "
        f"max |plain| {float(want.abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [100, 128, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(32, 8), (16, 8)])
def test_cuda_training_kernels_match_plain_versions(t, causal, heads):
    """flash_fwd_lse, flash_bwd_dq and flash_bwd_dkv against
    flash_attention_lse_ref / flash_attention_bwd_ref on the card (bf16,
    d=128, the plain versions on the forward kernel's 128 x 128 tiles;
    the backward's arithmetic is per element, so its blocking changes
    only the f32 summation order). T=100 is the ragged edge the kernels
    mask themselves (the plain versions take it as one block)."""
    _need_card()
    h, kv = heads
    b = 2
    gen = torch.Generator(device="cuda").manual_seed(t + 7 * causal + h)
    q = _randn(gen, b, t, h, 128)
    k, v = (_randn(gen, b, t, kv, 128) for _ in range(2))
    do = _randn(gen, b, t, h, 128)
    counts = tfa.launch_counts()
    out, lse = tfa.flash_attention_lse_cuda(q, k, v, causal)
    dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    after = tfa.launch_counts()
    assert {n: after[n] - counts[n] for n in tfa.KERNELS} == {
        "flash_fwd": 0, "flash_fwd_lse": 1, "flash_bwd_dq": 1,
        "flash_bwd_dkv": 1}
    blk = _plain_block(t)
    want_out, want_lse = tfa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                     blk)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0)
    # the backward from the same residuals on both sides
    want = tfa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, blk,
                                       blk)
    for g, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        _assert_grad_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(8, 8), (16, 8), (32, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [8, 100, 128, 1024, 1536, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_backward_kernels_match_plain_version(d, t, causal, heads):
    """flash_bwd_dq and flash_bwd_dkv against flash_attention_bwd_ref on
    the card at every instantiation (both head dims, causal and not),
    GQA groups of 1, 2 and 4, ragged T (8, 100) and the T that
    _fit_block steps down for (1536); both sides from the lse forward
    kernel's own residuals. Tolerance as in the training test."""
    _need_card()
    h, kv = heads
    b = 2 if t <= 128 else 1
    gen = torch.Generator(device="cuda").manual_seed(
        7 * t + d + h + causal)
    q, do = (_randn(gen, b, t, h, d) for _ in range(2))
    k, v = (_randn(gen, b, t, kv, d) for _ in range(2))
    out, lse = tfa.flash_attention_lse_cuda(q, k, v, causal)
    counts = tfa.launch_counts()
    dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    after = tfa.launch_counts()
    assert (after["flash_bwd_dq"] - counts["flash_bwd_dq"],
            after["flash_bwd_dkv"] - counts["flash_bwd_dkv"]) == (1, 1)
    blk = _plain_block(t)
    want = tfa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, blk,
                                       blk)
    for g, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        _assert_grad_close(g, w, name)


@pytest.mark.cuda
def test_cuda_backward_takes_strided_views():
    """The backward's tensor maps carry the caller's strides: q/k/v cut
    from one fused [B, T, H + 2 KV, d] projection and dO cut from a wider
    tensor, held to the plain version on contiguous copies (tolerance as
    in the training test)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, t, h, kv, d = 2, 384, 8, 2, 128
    qkv = _randn(gen, b, t, h + 2 * kv, d)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    do = _randn(gen, b, t, 2 * h, d)[:, :, h:]
    out, lse = tfa.flash_attention_lse_cuda(q, k, v, True)
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    blk = _plain_block(t)
    want = tfa.flash_attention_bwd_ref(q.contiguous(), k.contiguous(),
                                       v.contiguous(), out, lse,
                                       do.contiguous(), True, blk, blk)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _assert_grad_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [100, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_lse_forward_head_dim_64(t, causal):
    """The lse forward at d=64 (H=16, KV=8) against
    flash_attention_lse_ref on the kernel's tiles: the instantiations the
    d=128 training test does not reach."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(t + causal)
    q = _randn(gen, 2, t, 16, 64)
    k, v = (_randn(gen, 2, t, 8, 64) for _ in range(2))
    before = tfa.lse_launches
    out, lse = tfa.flash_attention_lse_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.lse_launches == before + 1
    blk = _plain_block(t)
    want_out, want_lse = tfa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                     blk)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_train_step_launch_counts():
    """One make_train_step step of a small Llama on the card, full remat:
    per layer the lse forward runs twice (the first forward and the
    recompute both run with grad on, as the reference's fwd rule runs in
    both) and each backward sweep once; the primal forward never."""
    _need_card()
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    cfg = dataclasses.replace(
        llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=2,
                          n_kv_heads=1, d_ff=512),
        use_flash=True, remat=True)
    params = llama.init_params(cfg, seed=0, dtype=torch.float32)
    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(params, tx)
    batch = {"tokens": torch.from_numpy(llama.synthetic_tokens(
        np.random.RandomState(0), 2, 256, cfg.vocab)["tokens"]).cuda()}
    step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
    tfa.reset_launches()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert state.step == 1
    L = cfg.n_layers
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_fwd_lse": 2 * L,
                                   "flash_bwd_dq": L, "flash_bwd_dkv": L}


# the serving modes on the card: (engine options, requests). Prompts share
# a two-block prefix (prefix hits, a full hit's copy-on-write), one is long
# enough to chunk, and two repeat (speculation accepts).
_SHARED = list(range(2, 18))
_MODE_REQS = [(_SHARED + [30, 31, 32], 9), (_SHARED, 7),
              (list(range(40, 76)), 6), ([1, 2, 3, 4] * 3, 14),
              (_SHARED, 5), ([5, 9] * 5, 11)]
_MODES = {
    "paged": dict(block_size=8, prefix_cache=True, prefill_chunk=8),
    # 9 usable blocks: growth preempts 4 times and every request ends (at
    # 8 the reference's policy preempts r2 and r3 in turn forever,
    # ROADMAP Queue C)
    "preempt": dict(block_size=8, pool_blocks=10, max_slots=4),
    "int8": dict(block_size=8, prefix_cache=True, kv_quant="int8"),
    "int4": dict(block_size=8, kv_quant="int4", prefill_chunk=8),
    "spec": dict(spec_k=4),
    "spec_paged_int8": dict(block_size=8, kv_quant="int8", spec_k=4),
}


def _serve_tiny(device, mode):
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, seed=0, device="cpu")
    params = {k: ({n: t.to(device) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    kw = {"max_slots": 3, "max_len": 64, "horizon": 4, **_MODES[mode]}
    eng = ContinuousBatchingEngine(params, cfg, device=device, **kw)
    for i, (prompt, max_new) in enumerate(_MODE_REQS[:3]):
        eng.submit(f"r{i}", prompt, max_new)
    eng.step()
    for i, (prompt, max_new) in enumerate(_MODE_REQS[3:], start=3):
        eng.submit(f"r{i}", prompt, max_new)
    res = eng.run()
    assert eng.recoveries == 0
    return {rid: (r.tokens, r.outcome) for rid, r in res.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(_MODES))
def test_cuda_serving_modes_match_cpu(mode):
    """The paged (prefix cache, chunked prefill, preemption), quantized
    and speculative engines on the tiny config in f32: the card's greedy
    tokens are the port's CPU run's (which the CPU tests hold to the
    reference engine's)."""
    _need_card()
    want = _serve_tiny("cpu", mode)
    tfa.reset_launches()
    got = _serve_tiny("cuda", mode)
    assert got == want
    assert all(outcome == "done" for _, outcome in got.values())
    assert tfa.launch_counts()["flash_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,wgrad_bf16", [(24, False), (24, True),
                                          (336, False), (336, True),
                                          (333, True)])
def test_cuda_int8_matmul_matches_cpu_at_a_ragged_m(m, wgrad_bf16):
    """``torch._int_mm`` and the absmax quantizer on the card against the
    same op sequence on the CPU, K64 N40, at M that are not multiples of
    the card GEMM's tile (the GEMM takes M > 16 and K, N multiples of 8;
    the int8 wgrad contracts over M, so the ragged M=333 runs with the
    bf16 wgrad): q, s and the int32 accumulator equal; the outputs and
    STE gradients of ``int8_matmul`` equal but for one rounding of the
    scale products (2^-8 relative in bf16, 2^-22 in f32; the bf16 wgrad
    1e-5 of its largest entry)."""
    _need_card()
    from edl_tpu_torch.ops import int8_matmul as im

    k, n = 64, 40
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(m)
    a = _randn(gen, m, k)
    w = torch.randn(k, n, generator=gen, device="cuda")
    g = _randn(gen, m, n)
    for x, axis in ((a, 1), (a, 0), (w, 0), (w, 1)):
        q, s = im.absmax_quant(x, axis)
        qc, sc = im.absmax_quant(x.cpu(), axis)
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    qa, _ = im.absmax_quant(a, 1)
    qw, _ = im.absmax_quant(w, 0)
    acc = im._dot8(qa, im._k_inner(qw))
    assert acc.dtype == torch.int32
    assert torch.equal(acc.cpu(), im._dot8(qa.cpu(), qw.cpu()))
    outs = []
    for dev in ("cuda", "cpu"):
        ad = a.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        y = im.int8_matmul(ad, wd, wgrad_bf16)
        outs.append((y, *torch.autograd.grad(y, (ad, wd), g.to(dev))))
    # the bf16 wgrad is an f32 product, summed in another order on the
    # card: within 1e-5 of its largest entry
    of_max = (0, 0, 1e-5 if wgrad_bf16 else 0)
    for got, want, rel, om in zip(outs[0], outs[1], (2 ** -8, 2 ** -8,
                                                     2 ** -22), of_max):
        want = want.float()
        diff = (got.cpu().float() - want).abs()
        tol = rel * want.abs() + om * want.abs().max()
        assert bool((diff <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,where", [(5, 64, 40, "forward"),
                                         (40, 60, 36, "forward"),
                                         (333, 64, 40, "wgrad")])
def test_cuda_int8_matmul_raises_where_the_card_gemm_refuses(m, k, n,
                                                            where):
    """Where the card's int8 GEMM refuses a product (M <= 16, or a
    contraction or output width not a multiple of 8) ``torch._int_mm``
    raises; ``_dot8`` zero-pads those shapes, so the op computes them:
    its output and STE gradients (int8 and bf16 wgrad) equal the CPU's
    but for one rounding of the scale products. At M=333 the forward and
    dgrad are the GEMM's own shapes and the int8 wgrad, which contracts
    over M, is the padded one."""
    _need_card()
    from edl_tpu_torch.ops import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(m)
    a = _randn(gen, m, k)
    w = torch.randn(k, n, generator=gen, device="cuda")
    g = _randn(gen, m, n)
    qa, _ = im.absmax_quant(a, 1)
    qw, _ = im.absmax_quant(w, 0)
    qam, _ = im.absmax_quant(a, 0)
    qgm, _ = im.absmax_quant(g, 0)
    refused = ((qa, im._k_inner(qw)) if where == "forward" else
               (qam.t().contiguous(), im._k_inner(qgm)))
    with pytest.raises(RuntimeError):
        torch._int_mm(*refused)
    for wgrad_bf16 in (False, True):
        outs = []
        for dev in ("cuda", "cpu"):
            ad = a.to(dev).requires_grad_()
            wd = w.to(dev).requires_grad_()
            y = im.int8_matmul(ad, wd, wgrad_bf16)
            outs.append((y, *torch.autograd.grad(y, (ad, wd), g.to(dev))))
        of_max = (0, 0, 1e-5 if wgrad_bf16 else 0)
        for got, want, rel, om in zip(outs[0], outs[1], (2 ** -8, 2 ** -8,
                                                         2 ** -22), of_max):
            want = want.float()
            diff = (got.cpu().float() - want).abs()
            assert bool((diff <= rel * want.abs()
                         + om * want.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 7, 16)
                                   for k in (12, 100) for n in (12, 100)])
def test_cuda_dot8_pads_ragged_shapes_like_the_cpu(m, k, n):
    """The padded int8 product on the card equals the CPU's bit for bit
    (and the exact integer product) at shapes the card's GEMM refuses:
    M <= 16, K and N not multiples of 8."""
    _need_card()
    from edl_tpu_torch.ops import int8_matmul as im

    rng = np.random.RandomState(m * 10000 + k * 100 + n)
    qa = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    qbt = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    got = im._dot8(qa.cuda(), qbt.cuda().t())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), im._dot8(qa, qbt.t()))
    assert torch.equal(got.cpu().long(), qa.long() @ qbt.long().t())


@pytest.mark.cuda
def test_cuda_moe_int8_step_matches_cpu():
    """The MoE's int8 experts on the card at ragged shapes, f32, TF32
    off. ``moe_ffn`` with ``int8_mxu`` on 8 tokens (an expert's capacity
    is 5 slots, so every int8 product takes the padded path) from the
    same inputs on the card and the CPU: the expert inputs are gathered
    copies and the int8 products exact, so y and the grads of x,
    router, w_in and w_out agree within 1e-5 of each one's largest
    entry (the router's f32 product and softmax sum in other orders).
    Then one adamw step of ``MoEConfig.tiny`` with ``int8_mxu`` at B1 T8
    on both: 4 + 2·E int8 ops a layer forward and backward, a finite
    loss within 1e-3 (relative) of the CPU's. A whole step is held no
    tighter: one f32 rounding of a quantizer's input can flip an int8
    value or a near-tie of the router (on the CPU, perturbing the tiny
    model's weights by 1e-7 relative moved this loss by up to 3.2e-4)."""
    _need_card()
    from edl_tpu_torch.models import moe
    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.parallel import moe as pm
    from edl_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    layer = pm.init_moe_params(gen, 64, 96, 4, device="cpu")
    x = torch.randn(1, 8, 64, generator=gen)
    ct = torch.randn(1, 8, 64, generator=gen)
    out = []
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_() for k, v in layer.items()}
        xd = x.to(dev).requires_grad_()
        y, aux = pm.moe_ffn(p, xd, int8_mxu=True)
        g = torch.autograd.grad((y * ct.to(dev)).sum() + aux,
                                [xd, p["router"], p["w_in"], p["w_out"]])
        out.append([t.detach().cpu() for t in (y, *g)])
    for got, want in zip(*out):
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())

    cfg = dataclasses.replace(moe.MoEConfig.tiny(), int8_mxu=True)
    init = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(moe.synthetic_tokens(
        np.random.RandomState(0), 1, 8, cfg.vocab)["tokens"])
    losses = []
    for dev in ("cuda", "cpu"):
        params = trainer.replace_leaves(
            init, [p.to(dev, copy=True) for p in trainer.leaves(init)])
        tx = trainer.adamw(1e-3)
        state = trainer.TrainState.create(params, tx)
        step = trainer.make_train_step(moe.make_loss_fn(cfg), tx)
        im.reset_calls()
        state, m = step(state, {"tokens": tokens.to(dev)})
        n = (4 + 2 * cfg.n_experts) * cfg.n_layers
        assert im.calls == {"fwd": n, "bwd": n}
        assert all(bool(torch.isfinite(p).all())
                   for p in trainer.leaves(state.params))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1])


# -- observability on the card ------------------------------------------------


@pytest.mark.cuda
def test_cuda_detect_peak_names_the_card(monkeypatch):
    """``detect_peak`` reads the card's name: the H100 rows of the table,
    or a raise for a card it does not name — unless both overrides are
    set, which then give the peak."""
    _need_card()
    from edl_tpu_torch.obs import costmodel

    monkeypatch.delenv("EDL_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("EDL_PEAK_HBM_GBS", raising=False)
    name = torch.cuda.get_device_name(0)
    try:
        want = costmodel.peak_for_kind(name)
    except KeyError:
        with pytest.raises(ValueError, match="EDL_PEAK_TFLOPS"):
            costmodel.detect_peak("cuda")
        monkeypatch.setenv("EDL_PEAK_TFLOPS", "100")
        monkeypatch.setenv("EDL_PEAK_HBM_GBS", "1000")
        p = costmodel.detect_peak("cuda")
        assert (p.kind, p.flops, p.hbm_bytes_s) == (name + "+env", 1e14,
                                                    1e12)
        return
    assert "H100" in name
    assert costmodel.detect_peak("cuda") == want
    assert costmodel.detect_peak() == want  # the current card by default
    # a name the table does not hold raises on the card too
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA B200")
    with pytest.raises(ValueError, match="EDL_PEAK_HBM_GBS"):
        costmodel.detect_peak("cuda")


@pytest.mark.cuda
def test_cuda_memledger_crosscheck_reads_the_allocator():
    """On the card the cross-check returns numbers: the allocator's live
    bytes hold at least the engine's registered kv + slot state."""
    _need_card()
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs import memledger
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, seed=0, device="cuda")
    eng = ContinuousBatchingEngine(params, cfg, max_slots=2, max_len=64,
                                   device="cuda")
    xc = memledger.default_ledger().crosscheck()
    assert xc is not None
    assert xc["live_bytes"] == float(torch.cuda.memory_allocated())
    own = sum(memledger.default_ledger().owner_total(eng._ledger_owner, c)
              for c in ("params", "kv", "slot_state"))
    assert xc["ledger_bytes"] >= own > 0
    assert xc["live_bytes"] >= own
    assert xc["unaccounted_bytes"] == xc["live_bytes"] - xc["ledger_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_cuda_fault_plan_recovery_gives_the_same_tokens(mode):
    """Under ``serve.dispatch:raise@n=2;serve.drain:raise@n=5`` the card
    recovers to the unfaulted card run's greedy tokens, and both
    planned faults fired."""
    _need_card()
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.utils import faults

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, seed=0, device="cuda")
    kw = {"max_slots": 3, "max_len": 64, "horizon": 4, "max_recoveries": 3}
    if mode == "paged":
        kw.update(block_size=8, prefix_cache=True)

    def run(plan):
        eng = ContinuousBatchingEngine(params, cfg, device="cuda", **kw)
        if plan:
            faults.arm(plan, seed=0)
        try:
            for i, (prompt, max_new) in enumerate(_MODE_REQS[:3]):
                eng.submit(f"r{i}", prompt, max_new)
            eng.step()
            for i, (prompt, max_new) in enumerate(_MODE_REQS[3:], start=3):
                eng.submit(f"r{i}", prompt, max_new)
            res = eng.run()
            counts = faults.counts()
        finally:
            faults.disarm()
        return ({rid: r.tokens for rid, r in res.items()}, eng.recoveries,
                counts)

    want, rec0, _ = run(None)
    got, rec, counts = run("serve.dispatch:raise@n=2;serve.drain:raise@n=5")
    assert rec0 == 0 and rec >= 1
    assert counts == {"serve.dispatch": 1, "serve.drain": 1}
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["fit_a_line", "resnet", "bert"])
def test_cuda_small_model_step_matches_cpu(model):
    """f32 Adam steps of fit_a_line (20), tiny ResNet and tiny BERT (one
    each) on the card against the same steps on the CPU, TF32 off: the
    loss, params and first moments within chip_smoke's
    SMALL_STEP_OF_MAX of each leaf's largest entry; and the tiny
    models' f32 forwards against chip_smoke's NumPy float64 reference."""
    _need_card()
    import chip_smoke

    worst = chip_smoke._small_step_agreement(model, "cuda")
    assert worst <= chip_smoke.SMALL_STEP_OF_MAX[model]
    if model != "fit_a_line":
        errs = chip_smoke._small_reference_check(model, "cuda")
        assert max(errs.values()) <= chip_smoke.SMALL_REF_OF_MAX[model]


@pytest.mark.cuda
def test_cuda_adamw_state_round_trip():
    """An adamw state placed on the card by shard_state and back holds
    every param and moment bit for bit (rebind_state rebuilds the
    AdamW), and the placed state steps on the card."""
    _need_card()
    from edl_tpu_torch.models import bert
    from edl_tpu_torch.train import trainer

    cfg = bert.BertConfig.tiny()
    params = bert.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    nb = bert.synthetic_mlm_batch(np.random.RandomState(0), 2, 16, cfg.vocab)
    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(bert.make_loss_fn(cfg), tx)
    state, _ = step(state, trainer.global_batch(nb, device="cpu"))

    def tensors(st):
        return ([p.detach().cpu() for p in trainer.leaves(st.params)]
                + [t.cpu() for _, _, t, _ in trainer.optimizer_tensors(st)])

    placed = trainer.shard_state(state, device="cuda")
    assert type(placed.opt_state) is torch.optim.AdamW
    assert placed.opt_state.defaults == state.opt_state.defaults
    back = trainer.shard_state(placed, device="cpu")
    for a, b, c in zip(tensors(state), tensors(placed), tensors(back)):
        assert torch.equal(a, b) and torch.equal(a, c)
    placed, m = step(placed, trainer.global_batch(nb, device="cuda"))
    assert torch.isfinite(m["loss"]) and placed.step == 2


@pytest.mark.cuda
def test_cuda_launch_gauge_is_the_wrappers_count():
    """Each launch sets the default registry's ``edl_kernel_launches``
    to its kernel's count (what a replica's ``/metrics`` reports), and
    ``reset_launches`` zeroes both."""
    _need_card()
    from edl_tpu_torch.obs.metrics import default_registry

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (_randn(gen, 1, 128, n, 128) for n in (16, 8, 8))
    tfa.reset_launches()
    for _ in range(3):
        tfa.flash_attention(q, k, v, causal=True)
    tfa.flash_attention_lse_cuda(q, k, v, True)
    torch.cuda.synchronize()
    gauge = default_registry().get(tfa.LAUNCH_METRIC)
    for name, n in tfa.launch_counts().items():
        assert gauge.value(kernel=name) == n
    assert tfa.launch_counts()["flash_fwd"] == 3
    tfa.reset_launches()
    assert all(gauge.value(kernel=name) == 0 for name in tfa.KERNELS)


@pytest.mark.cuda
def test_cuda_fleet_failover_gives_a_single_engines_tokens(tmp_path,
                                                           monkeypatch):
    """Two replica subprocesses of the f32 tiny model (``--dryrun``, one
    seed) on the card behind the router; the first is SIGKILLed while it
    streams. Every request finishes, at least one fails over, and every
    request's tokens are one in-process engine's on the card: token
    identity across a failover holds in f32 (in bf16, near-ties flip when
    the batch changes; chip_smoke holds the bf16 flagship to the
    teacher-forced margin)."""
    _need_card()
    import threading

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs.exporter import scrape
    from edl_tpu_torch.obs.metrics import (MetricsRegistry,
                                           parse_prometheus_text)
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.fleet import (ReplicaSpec, ReplicaSupervisor,
                                             ServingFleet)
    from edl_tpu_torch.serving.router import (HttpTransport, ReplicaTable,
                                              Router)
    from edl_tpu_torch.serving.scheduler import Request

    # every decode dispatch of the replicas stalls 20 ms (a delay, not a
    # failure), so the kill lands while the victim streams
    monkeypatch.setenv("EDL_FAULTS", "serve.dispatch:delay@every=1,s=0.02")
    vocab, seed = 256, 1
    kw = {"max_slots": 4, "max_len": 96, "horizon": 4}
    spec = ReplicaSpec(workdir=str(tmp_path), vocab=vocab, slots=4,
                       max_len=96, horizon=4, seed=seed, device="cuda")
    reg = MetricsRegistry()
    table = ReplicaTable(registry=reg)
    sup = ReplicaSupervisor(table, spec, spawn_retries=0)
    fleet = ServingFleet(sup, Router(table, transport=HttpTransport(),
                                     seed=0, registry=reg))
    rng = np.random.RandomState(3)
    reqs = [Request(rid=f"q{i}", prompt=rng.randint(1, vocab, 4 + i % 5)
                    .tolist(), max_new=40) for i in range(8)]
    results = {}
    try:
        ids = fleet.start(2)
        victim = sup.handle(ids[0])
        threads = [threading.Thread(target=lambda r=r: results.__setitem__(
            r.rid, fleet.generate(r))) for r in reqs]
        for t in threads:
            t.start()
        for _ in range(12000):
            # /metrics (read, like /healthz, without the engine lock):
            # streaming, and not every request finished
            fams = parse_prometheus_text(scrape(victim.url, "/metrics"))
            toks = sum(v for _, v in fams.get("edl_serving_tokens_total",
                                              ()))
            done = sum(v for lb, v in fams.get("edl_serving_requests_total",
                                               ())
                       if lb.get("event") == "completed")
            if toks > 0 and done < 2:
                break
        victim.proc.kill()
        victim.proc.wait()
        for t in threads:
            t.join(timeout=120)
    finally:
        fleet.stop()
    assert {r.rid: r.outcome for r in results.values()} == {
        r.rid: "done" for r in reqs}
    assert sum(r.failovers for r in results.values()) >= 1
    cfg = llama.LlamaConfig.tiny(vocab=vocab)
    eng = ContinuousBatchingEngine(
        llama.init_params(cfg, seed=seed, device="cuda"), cfg,
        device="cuda", **kw)
    for r in reqs:
        eng.submit(r.rid, r.prompt, r.max_new)
    want = eng.run()
    assert {rid: r.tokens for rid, r in results.items()} == {
        r.rid: want[r.rid].tokens for r in reqs}
