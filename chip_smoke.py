#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # what the card check runs
    python3 chip_smoke.py --profile   # also: torch.profiler over one
                                      # decode block and one admission
                                      # per KV layout, and over one
                                      # train step (CUDA events per
                                      # phase)

1. Builds every kernel of the serving and training paths from the
   sources in this checkout (``edl_tpu_torch/ops/csrc/*.cu``, one nvcc
   per source, all at once, sm_90a).
2. Kernel phase: the flash-attention forward kernel against its plain
   PyTorch version (``flash_attention_ref``) on the card, bf16, B=1,
   H=32, KV=8, d=128 (Llama-3-8B's attention), T in {8, 128, 1024,
   1536, 2048}, causal and not; and d=64 at T=1024, causal and not,
   where the lse variant is held to its plain version too, so every
   instantiation of the forward template is checked. Tolerance:
   |kernel - plain| <= 2e-2 + 2^-7 * |plain| elementwise — both round
   the output to bf16 (one ulp is 2^-8 relative) and sum in different
   orders; the plain version runs on the kernel's 128 x 128 tiles (one
   block below T=128) so P is rounded against the same running maxima.
   Times for the kernel and ``scaled_dot_product_attention`` (a
   yardstick only): device time a call, on CUDA events around calls the
   host has queued behind a sleep kernel (after warm-up, inputs left
   warm in L2 as a prefill leaves them), so the host's launch overhead
   is not in it; ``kernel_call_ms`` is the kernel's time a call with the
   host in the loop. The plain version, hundreds of small launches a
   call, is host-bound: its time is a call's on CUDA events with the
   host in the loop.
3. Training-kernel phase: the lse forward and the dQ and dK/dV backward
   kernels against ``flash_attention_lse_ref`` / ``flash_attention_bwd_ref``
   on the card, bf16, d=128: B=4 T=2048 H=16 KV=8 causal (the flagship's
   attention, the main shape), T in {100, 128, 1024} causal, T=1024
   non-causal (H=16, KV=8), and H=32 KV=8 at T=1024; and d=64 at B=2
   T=1024 H=16 KV=8 causal, so every instantiation of the three
   training kernels is checked (the non-causal d=64 backward by
   ``tests/test_torch_cuda.py``). Tolerances: the
   forward output as in 2; lse |kernel - plain| <= 1e-4 (f32 on both
   sides, the forward's 128 x 128 tiles, only the f32 summation order
   differs); dq/dk/dv <= 1e-2 * max|plain| + 2^-7 * |plain| (both
   round p and ds to bf16 before the same products, sum in f32 in
   different orders, and round the result to bf16; the absolute term
   covers entries whose sums cancel). The backward is compared from
   the kernel's own residuals. Times (as in 2) for each kernel, the
   plain versions, and SDPA (``enable_gqa=True``) forward and
   ``backward`` under autograd as the library yardstick (never called
   by the port).
4. Slice phase: Llama-3-8B at full width and depth, bf16,
   ``use_flash=True``, random weights from a seeded generator on the
   card, served through ``ContinuousBatchingEngine`` (8 slots x 2048
   positions, horizon 8): eight requests with prompts in the buckets
   8..1024, 32 new tokens each, half of them submitted after the first
   step. Checks: every outcome ``done``, zero recoveries, flash launches
   == prefills x 32 layers, and teacher-forced agreement — a dense
   forward over prompt + generated puts every chosen token within
   0.1 x (row std) of its row's maximum logit.
5. Serving-modes phase: the slice's model and weights through the
   PAGED engine (8 slots x 2048, horizon 8, block 16), once with float
   KV, then under ``kv_quant`` int8, then int4: (a) the prefix cache
   with chunked prefill (256) on the default pool — a cold 552-token
   request (512-token prefix + 40) runs first, then five warm ones with
   the same prefix and other tails beside a 1500-token prompt that
   shares nothing; (b) a pool of 129 blocks that 8 prompts of 250
   tokens fill at admission, so decode growth preempts; (c) ``spec_k``
   4 on prompts of a repeating 64-token pattern. Checks: every request
   done, zero recoveries, no flash launch in the phase, prefix hits ==
   5 x 32 blocks, the long prompt's ceil(1500/256) = 6 prefill
   dispatches, >= 1 preemption in (b), drafts in (c), int8 / int4 pool
   bytes <= 0.51 / 0.26 of float's, and the teacher-forced margin <= 0.1
   row std (float) or 0.25 (int8); int4 only finite logits. The margin
   is taken over the cold, a warm and the long (chunked) request of (a),
   every request preempted in (b) (restarted into reclaimed blocks) and
   two others, and three of (c).
6. Train phase: the flagship training config (bench.py:69
   ``flagship_train_config``: d2048/L16/H16/KV8/ff6144/v32768, bf16
   activations, f32 masters, ``use_flash``, full remat) at full width and
   depth, one ``synthetic_tokens`` batch [4, 2048+1] (seed 0),
   ``adamw(1e-3)`` through ``make_train_step``: one warm-up step, then
   5 timed steps on the same batch.
   Checks: finite losses, the last below the first; per step exactly
   32 ``flash_fwd_lse`` (two per layer: the forward and the remat
   recompute both run with grad on), 16 ``flash_bwd_dq``, 16
   ``flash_bwd_dkv`` and 0 ``flash_fwd`` launches; and at the first
   batch the flash loss and gradients against the dense (non-flash)
   path's: loss within 1e-4 relative, every leaf's gradient cosine
   >= 0.999.

Prints one JSON line per phase, then ``{"kernels": [...]}`` (each
kernel's device ms, its bound, TF/s and bound share at its main-path
shape, and its launches on the main path), then the
card's name and power limit, then ``{"ok": true, "device": ...}`` as
the last line. Any failure raises (non-zero exit); without CUDA it
exits 1 before printing any result. Needs one card.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TEACHER_EPS = 0.1  # chosen logit within EPS x row std of the row max
# primal forward: (T, causal, head dim); Llama-3-8B's attention at d=128,
# and d=64 so that every instantiation of the template is checked
KERNEL_SHAPES = ([(t, c, 128) for t in (8, 128, 1024, 1536, 2048)
                  for c in (True, False)]
                 + [(1024, True, 64), (1024, False, 64)])
# training kernels: (B, T, H, KV, causal, head dim); the first is the
# main shape, the last holds the d=64 instantiations of all three
TRAIN_MAIN = (4, 2048, 16, 8, True, 128)
TRAIN_SHAPES = [TRAIN_MAIN, (4, 100, 16, 8, True, 128),
                (4, 128, 16, 8, True, 128), (4, 1024, 16, 8, True, 128),
                (4, 1024, 16, 8, False, 128), (1, 1024, 32, 8, True, 128),
                (2, 1024, 16, 8, True, 64)]
LSE_ATOL = 1e-4
GRAD_ATOL_OF_MAX = 1e-2
TRAIN_STEPS = 5
# flash vs dense at the first batch (H100, first runs: loss rel diff
# 5.7e-6, worst leaf cosine 0.99949 on wq -- the dense path's bf16
# scores are the coarser of the two)
LOSS_RTOL = 1e-4
GRAD_MIN_COS = 0.999
# serving-modes phase: the slice's engine (8 slots, horizon 8) paged
SM_MAX_LEN = 2048
SM_BLOCK = 16
SM_CHUNK = 256  # prefill chunk of part (a)
SM_PREFIX = 512  # shared prefix of part (a)
SM_TAIL = 40
SM_LONG = 1500  # the long prompt of part (a): ceil(1500/256) dispatches
SM_NEW = 16  # new tokens a request (32 in part (c))
# part (b): 8 prompts of 250 tokens take 16 blocks each, the whole
# usable pool of 128 (one full-length sequence, the least the engine
# allows), so the first decode growth past a block boundary preempts
SM_PRESSURE_PROMPT = 250
SM_PRESSURE_POOL = 129
SM_REPEATS = 4  # part (c): a 64-token pattern repeated
# teacher-forced worst margin (row std) against the dense float forward;
# int4 is gated on completion and finite logits only, as in the
# reference
SM_TEACHER_EPS = {"off": TEACHER_EPS, "int8": 0.25, "int4": None}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _plain_block(t):
    """The forward kernel's 128 x 128 tiles where T divides them, else
    one block (the reference's own blocking below T=128)."""
    return 128 if t % 128 == 0 else t


def _bound(b, t, h, kv, d, causal, flops_per_pair=4, q_like=2, kv_like=2,
           rows_f32=0):
    """Least time on the card: the larger of the FLOPs over the bf16 peak
    and the bytes over the HBM rate. ``flops_per_pair`` x d FLOPs per
    live (query, key) pair per query head (4 for the forward's two
    products, 2 more per further product); ``q_like`` bf16 [B,T,H,d]
    and ``kv_like`` bf16 [B,T,KV,d] tensors each read or written once,
    plus ``rows_f32`` f32 [B,H,T] rows (lse, delta). Returns (ms, what
    bounds it, FLOPs)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = float(flops_per_pair) * d * h * b * pairs
    nbytes = (2.0 * (q_like * b * t * h * d + kv_like * b * t * kv * d)
              + 4.0 * rows_f32 * b * h * t)
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    b_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes"),
            flops)


def _check_out(got, want, what):
    """Max abs error; raises past 2e-2 + 2^-7 * |plain| elementwise."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol_ok = bool((diff <= 2e-2 + 2 ** -7 * want.float().abs()).all())
    if not (torch.isfinite(got.float()).all() and tol_ok):
        raise AssertionError(f"{what}: max abs err {err}")
    return err


def kernel_phase(card):
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops.bench_flash import device_ms

    rows = {}
    for t, causal, d in KERNEL_SHAPES:
        where = f"T={t} causal={causal} d={d}"
        gen = torch.Generator(device="cuda").manual_seed(t + causal + d)
        q, k, v = (
            torch.randn(1, t, n, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            for n in (32, 8, 8)
        )
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        blk = _plain_block(t)
        want_out, want_lse = fa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                        blk)
        err = _check_out(got, want_out, f"flash_fwd at {where}")
        row = {"phase": "kernel", "kernel": "flash_fwd", "T": t,
               "causal": causal, "d": d, "max_abs_err": err}
        if d == 64:  # the lse instantiations the training phase skips
            out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
            torch.cuda.synchronize()
            row["lse_out_max_abs_err"] = _check_out(
                out, want_out, f"flash_fwd_lse at {where}")
            lse_err = float((lse - want_lse).abs().max())
            if not (torch.isfinite(lse).all() and lse_err <= LSE_ATOL):
                raise AssertionError(f"flash_fwd_lse lse disagrees at "
                                     f"{where}: max abs err {lse_err}")
            row["lse_max_abs_err"] = lse_err
        del want_out, want_lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal),
                               20)
        bound_ms, bound_by, flops = _bound(1, t, 32, 8, d, causal)
        row.update({
            "tol": "2e-2 + 2^-7*|plain|", "kernel_ms": kernel_ms,
            "kernel_call_ms": _time_ms(
                lambda: fa.flash_attention(q, k, v, causal), 20),
            "ref_ms": _time_ms(lambda: fa.flash_attention_ref(
                q, k, v, causal, blk, blk), 2, 1),
            "library_ms": device_ms(lib, 20),
            "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "tflops": flops / kernel_ms / 1e9,
            "card": card,
        })
        print(json.dumps(row), flush=True)
        rows[(t, causal, d)] = row
    return rows


def _grad_err(got, want, name, where):
    """Max abs error; raises past 1e-2 * max|plain| + 2^-7 * |plain|."""
    import torch

    want = want.float()
    diff = (got.float() - want).abs()
    tol = GRAD_ATOL_OF_MAX * want.abs().max() + 2 ** -7 * want.abs()
    if not (torch.isfinite(got.float()).all() and bool((diff <= tol).all())):
        raise AssertionError(f"{name} disagrees at {where}: max abs err "
                             f"{float(diff.max())}, max |plain| "
                             f"{float(want.abs().max())}")
    return float(diff.max())


def train_kernel_phase(card):
    """lse forward, dQ and dK/dV kernels against their plain versions at
    TRAIN_SHAPES; returns the rows by shape."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops.bench_flash import device_ms

    rows = {}
    for shape in TRAIN_SHAPES:
        b, t, h, kv, causal, d = shape
        where = f"B={b} T={t} H={h} KV={kv} causal={causal} d={d}"
        gen = torch.Generator(device="cuda").manual_seed(b * t + h + causal)
        q, do = (torch.randn(b, t, h, d, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
        dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        blk = _plain_block(t)
        want_out, want_lse = fa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                        blk)
        _check_out(out, want_out, f"flash_fwd_lse output at {where}")
        lse_err = float((lse - want_lse).abs().max())
        if not (torch.isfinite(lse).all() and lse_err <= LSE_ATOL):
            raise AssertionError(f"flash_fwd_lse lse disagrees at {where}: "
                                 f"max abs err {lse_err}")

        def plain_bwd():
            return fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                              blk, blk)

        wdq, wdk, wdv = plain_bwd()
        errs = {"dq": _grad_err(dq, wdq, "flash_bwd_dq", where),
                "dk": _grad_err(dk, wdk, "flash_bwd_dkv dk", where),
                "dv": _grad_err(dv, wdv, "flash_bwd_dkv dv", where)}
        del wdq, wdk, wdv

        # the library yardstick: SDPA forward (grad on, so it keeps its
        # logsumexp) and its backward, dq, dk and dv in one call
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_out = lib_fwd()
        lib_fwd_ms = device_ms(lib_fwd, 10)
        lib_bwd_ms = device_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), 10)
        del lib_out
        delta = fa._delta(out, do).contiguous()
        fwd_ms = device_ms(
            lambda: fa.flash_attention_lse_cuda(q, k, v, causal), 10)
        dq_ms = device_ms(lambda: fa.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, causal), 10)
        dkv_ms = device_ms(lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal), 10)
        plain_fwd_ms = _time_ms(lambda: fa.flash_attention_lse_ref(
            q, k, v, causal, blk, blk), 1, 1)
        plain_bwd_ms = _time_ms(plain_bwd, 1, 1)
        bounds = {
            "flash_fwd_lse": _bound(b, t, h, kv, d, causal, 4, 2, 2, 1),
            "flash_bwd_dq": _bound(b, t, h, kv, d, causal, 6, 3, 2, 2),
            "flash_bwd_dkv": _bound(b, t, h, kv, d, causal, 8, 2, 4, 2),
            # the whole backward: FA2's five products, q k v o dO lse
            # delta read once, dq dk dv written once
            "backward": _bound(b, t, h, kv, d, causal, 10, 4, 4, 2),
        }
        row = {
            "phase": "train_kernels", "B": b, "T": t, "H": h, "KV": kv,
            "causal": causal, "d": d, "lse_max_abs_err": lse_err,
            "dq_max_abs_err": errs["dq"], "dk_max_abs_err": errs["dk"],
            "dv_max_abs_err": errs["dv"],
            "tol": {"lse": LSE_ATOL,
                    "grads": "1e-2*max|plain| + 2^-7*|plain|"},
            "flash_fwd_lse_ms": fwd_ms, "flash_bwd_dq_ms": dq_ms,
            "flash_bwd_dkv_ms": dkv_ms, "plain_fwd_lse_ms": plain_fwd_ms,
            "plain_bwd_ms": plain_bwd_ms, "library_fwd_ms": lib_fwd_ms,
            "library_bwd_ms": lib_bwd_ms,
            "bound_ms": {n: v[0] for n, v in bounds.items()},
            "bound_by": {n: v[1] for n, v in bounds.items()},
            "flops": {n: v[2] for n, v in bounds.items()},
            "card": card,
        }
        rows[shape] = row
        print(json.dumps(row), flush=True)
    return rows


def slice_phase(card):
    """Returns the flash launches of the run and the model's (params,
    cfg), which the serving-modes phase reuses."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), use_flash=True)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    metrics = ServingMetrics(registry=MetricsRegistry())
    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=2048, horizon=8,
        metrics=metrics, device="cuda",
    )
    rng = np.random.RandomState(0)
    lens = [5, 12, 30, 60, 100, 250, 500, 1000]  # buckets 8 .. 1024
    prompts = [rng.randint(0, cfg.vocab, n).tolist() for n in lens]
    max_new = 32

    # warm-up request (cuBLAS handles, allocator), outside the counts
    eng.submit("warmup", prompts[0], 2)
    eng.run()

    prefills0 = metrics.dispatches["prefill"]
    fa.reset_launches()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for i in range(4):
        eng.submit(f"r{i}", prompts[i], max_new)
    eng.step()
    for i in range(4, 8):
        eng.submit(f"r{i}", prompts[i], max_new)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = fa.launch_counts()
    launches = counts["flash_fwd"]
    prefills = metrics.dispatches["prefill"] - prefills0
    if any(counts[k] for k in fa.KERNELS if k != "flash_fwd"):
        raise AssertionError(f"serving launched a training kernel: {counts}")

    if eng.recoveries:
        raise AssertionError(f"engine recovered {eng.recoveries} times")
    for i in range(8):
        r = res[f"r{i}"]
        if r.outcome != "done" or len(r.tokens) != max_new:
            raise AssertionError(f"r{i}: outcome {r.outcome}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= x < cfg.vocab for x in r.tokens):
            raise AssertionError(f"r{i}: token outside the vocab")
    if launches != prefills * cfg.n_layers or prefills < 8:
        raise AssertionError(f"flash launches {launches} != prefills "
                             f"{prefills} x {cfg.n_layers} layers")

    # teacher-forced agreement on the dense (non-flash) path
    dense = dataclasses.replace(cfg, use_flash=False)
    worst = 0.0
    for i in range(8):
        seq = prompts[i] + res[f"r{i}"].tokens
        toks = torch.tensor([seq[:-1]], device="cuda")
        logits = llama.forward(params, toks, dense)[0, len(prompts[i]) - 1:]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"r{i}: non-finite logits")
        chosen = logits.gather(
            1, torch.tensor(res[f"r{i}"].tokens, device="cuda")[:, None])[:, 0]
        margin = (logits.max(dim=1).values - chosen) / logits.std(dim=1)
        worst = max(worst, float(margin.max()))
        del logits
    if worst > TEACHER_EPS:
        raise AssertionError(f"teacher-forced margin {worst:.4f} row std "
                             f"> {TEACHER_EPS}")
    ttfts = [metrics.request_stats(f"r{i}")["ttft_s"] for i in range(8)]
    snap = metrics.snapshot()
    blk = metrics.block_hist.stats()
    row = {
        "phase": "slice", "model": "llama3_8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", "requests": 8, "prompt_lens": lens,
        "max_new": max_new, "prefills": prefills,
        "flash_launches": launches, "recoveries": eng.recoveries,
        "tokens_out": 8 * max_new, "wall_s": wall,
        "tokens_per_s": 8 * max_new / wall,
        "ttft_s": ttfts, "ttft_max_s": max(ttfts),
        # warm-up request included in these two
        "decode_blocks": snap["dispatches_decode"],
        "block_mean_s": blk["sum"] / max(blk["count"], 1),
        "teacher_forced_worst_margin_std": worst,
        "teacher_forced_eps_std": TEACHER_EPS,
        "init_params_s": init_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    print(json.dumps(row), flush=True)
    return launches, params, cfg


def _teacher_margin(params, cfg, prompt, tokens, device):
    """Worst (row max - chosen logit) / row std over the generated
    tokens, on the dense (non-flash) forward over prompt + generated;
    raises on non-finite logits."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama

    dense = dataclasses.replace(cfg, use_flash=False)
    seq = prompt + tokens
    toks = torch.tensor([seq[:-1]], device=device)
    logits = llama.forward(params, toks, dense)[0, len(prompt) - 1:]
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    chosen = logits.gather(
        1, torch.tensor(tokens, device=device)[:, None])[:, 0]
    margin = (logits.max(dim=1).values - chosen) / logits.std(dim=1)
    return float(margin.max())


def _block_mean(metrics):
    """Mean dispatch-to-drain seconds of a run's decode / verify blocks."""
    st = metrics.block_hist.stats()
    return st["sum"] / max(st["count"], 1)


def _serve_modes_part(params, cfg, kv_quant, device, reqs, waves=None,
                      **kw):
    """One engine run of the serving-modes phase: ``reqs`` [(rid,
    prompt, max_new)] submitted in ``waves`` (lists of rids, each run to
    completion before the next), on the paged engine with ``kw``.
    Returns (engine, results, wall seconds, the rids preempted, in
    order)."""
    import torch

    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving import engine as teng
    from edl_tpu_torch.serving.metrics import ServingMetrics

    preempted = []

    class Engine(teng.ContinuousBatchingEngine):
        # the reference reports preemptions only as a flight event
        def _pg_preempt(self, exclude):
            live = {sl.rid for sl in self._slots if sl is not None}
            done = super()._pg_preempt(exclude)
            preempted.extend(sorted(live - {sl.rid for sl in self._slots
                                            if sl is not None}))
            return done

    eng = Engine(params, cfg, max_slots=8, max_len=SM_MAX_LEN, horizon=8,
                 block_size=SM_BLOCK, kv_quant=kv_quant,
                 metrics=ServingMetrics(registry=MetricsRegistry()),
                 device=device, **kw)
    prompts = {rid: (p, n) for rid, p, n in reqs}
    res = {}
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves or [list(prompts)]:
        for rid in wave:
            eng.submit(rid, prompts[rid][0], prompts[rid][1])
        res.update(eng.run())
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.recoveries:
        raise AssertionError(f"{kv_quant}: engine recovered "
                             f"{eng.recoveries} times")
    for rid, (_, n) in prompts.items():
        r = res[rid]
        if r.outcome != "done" or len(r.tokens) != n:
            raise AssertionError(f"{kv_quant} {rid}: outcome {r.outcome}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= x < cfg.vocab for x in r.tokens):
            raise AssertionError(f"{kv_quant} {rid}: token outside the vocab")
    return eng, res, wall, preempted


def serving_modes_phase(card, params, cfg, device="cuda"):
    """The paged engine at the slice's width (Llama-3-8B, 8 slots x
    SM_MAX_LEN, horizon 8, block SM_BLOCK) under each kv_quant: (a) the
    prefix cache with chunked prefill, (b) preemption in a tight pool,
    (c) speculative decoding. No flash kernel runs on this path."""
    from edl_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(1)
    vocab = cfg.vocab
    # (a) a cold request with a shared prefix runs first (a prompt's
    # blocks enter the prefix cache after its last prefill dispatch),
    # then warm ones with other tails beside a long prompt that shares
    # nothing with the prefix and prefills in chunks
    prefix = rng.randint(0, vocab // 2, SM_PREFIX).tolist()
    tails = rng.randint(0, vocab // 2, (6, SM_TAIL))
    tails[:, 0] = np.arange(6)  # every tail's first block differs
    long_p = rng.randint(vocab // 2, vocab, SM_LONG).tolist()
    a_reqs = ([("cold", prefix + tails[0].tolist(), SM_NEW)]
              + [(f"warm{j}", prefix + tails[j].tolist(), SM_NEW)
                 for j in range(1, 6)]
              + [("long", long_p, SM_NEW)])
    a_waves = [["cold"], [f"warm{j}" for j in range(1, 6)] + ["long"]]
    # (b) prompts that fill the pool at admission, so decode growth
    # preempts
    b_reqs = [(f"p{j}", rng.randint(0, vocab, SM_PRESSURE_PROMPT).tolist(),
               SM_NEW) for j in range(8)]
    # (c) prompts of a repeating 64-token pattern, for the n-gram drafter
    c_reqs = [(f"s{j}", rng.randint(0, vocab, 64).tolist() * SM_REPEATS,
               2 * SM_NEW) for j in range(8)]
    hit_blocks = SM_PREFIX // SM_BLOCK
    long_dispatches = -(-SM_LONG // SM_CHUNK)
    rows, pool_bytes = [], {}
    fa.reset_launches()
    for kv_quant in ("off", "int8", "int4"):
        row = {"phase": "serving_modes", "kv_quant": kv_quant,
               "model": "llama3_8b", "layers": cfg.n_layers,
               "max_len": SM_MAX_LEN, "block_size": SM_BLOCK}
        # (a)
        eng, res, wall, pre = _serve_modes_part(
            params, cfg, kv_quant, device, a_reqs, a_waves,
            prefix_cache=True, prefill_chunk=SM_CHUNK)
        m = eng.metrics
        ttft = {rid: m.request_stats(rid)["ttft_s"] for rid in res}
        prefill_s = {rid: m.phase_breakdown(rid)["prefill_s"] for rid in res}
        hits = eng._prefix.hits
        # the cold prompt's own hits are 0: its blocks were not cached
        if hits != 5 * hit_blocks:
            raise AssertionError(f"{kv_quant}: prefix hits {hits} != 5 x "
                                 f"{hit_blocks}")
        # cold: its chunks + final; warm: one each; long: its chunks
        cold_dispatches = -(-(SM_PREFIX + SM_TAIL) // SM_CHUNK)
        pf = m.dispatches["prefill"]
        if pf != cold_dispatches + 5 + long_dispatches:
            raise AssertionError(
                f"{kv_quant}: {pf} prefill dispatches, want {cold_dispatches}"
                f" + 5 + {long_dispatches} (the long prompt's chunks)")
        pool_bytes[kv_quant] = eng.kv_nbytes
        worst_a = max(_teacher_margin(params, cfg, p, res[rid].tokens,
                                      device)
                      for rid, p, _ in a_reqs if rid in ("cold", "warm1",
                                                         "long"))
        row["prefix_chunk"] = {
            "requests": len(a_reqs), "tokens_per_s": sum(
                len(r.tokens) for r in res.values()) / wall,
            "wall_s": wall, "prefix_hit_blocks": hits,
            "prefill_dispatches": pf,
            "long_prefill_dispatches": long_dispatches,
            "ttft_cold_s": ttft["cold"],
            "ttft_warm_s": [ttft[f"warm{j}"] for j in range(1, 6)],
            "prefill_cold_s": prefill_s["cold"],
            "prefill_warm_s": [prefill_s[f"warm{j}"] for j in range(1, 6)],
            "ttft_long_s": ttft["long"], "preemptions": len(pre),
            "block_mean_s": _block_mean(m), "pool_mb": eng.kv_nbytes / 2**20,
        }
        del eng
        # (b)
        eng, res, wall, pre = _serve_modes_part(
            params, cfg, kv_quant, device, b_reqs,
            pool_blocks=SM_PRESSURE_POOL)
        if not pre:
            raise AssertionError(f"{kv_quant}: no preemption in a pool of "
                                 f"{SM_PRESSURE_POOL} blocks")
        # the preempted requests restarted by recomputation into blocks
        # that others held: their tokens are the ones to hold
        sample = sorted(set(pre)) + [r for r, _, _ in b_reqs[:2]
                                     if r not in pre]
        worst_b = max(_teacher_margin(params, cfg, p, res[rid].tokens,
                                      device)
                      for rid, p, _ in b_reqs if rid in sample)
        row["preempt"] = {
            "requests": len(b_reqs), "pool_blocks": SM_PRESSURE_POOL,
            "tokens_per_s": sum(len(r.tokens) for r in res.values()) / wall,
            "wall_s": wall, "preemptions": len(pre), "preempted": pre,
            "margin_sample": sample,
            "prefill_dispatches": eng.metrics.dispatches["prefill"],
            "block_mean_s": _block_mean(eng.metrics),
            "pool_mb": eng.kv_nbytes / 2**20,
        }
        del eng
        # (c)
        eng, res, wall, pre = _serve_modes_part(
            params, cfg, kv_quant, device, c_reqs, spec_k=4)
        snap = eng.metrics.snapshot()
        if snap["spec_drafted"] <= 0:
            raise AssertionError(f"{kv_quant}: speculation drafted nothing")
        worst_c = max(_teacher_margin(params, cfg, p, res[rid].tokens,
                                      device) for rid, p, _ in c_reqs[:3])
        row["spec"] = {
            "requests": len(c_reqs), "spec_k": 4,
            "tokens_per_s": sum(len(r.tokens) for r in res.values()) / wall,
            "wall_s": wall, "drafted": snap["spec_drafted"],
            "accepted": snap["spec_accepted"],
            "acceptance": snap["spec_acceptance_rate"],
            "verify_dispatches": snap["dispatches_verify"],
            "decode_dispatches": snap["dispatches_decode"],
            "block_mean_s": _block_mean(eng.metrics), "preemptions": len(pre),
        }
        del eng
        worst = max(worst_a, worst_b, worst_c)
        gate = SM_TEACHER_EPS[kv_quant]
        if gate is not None and worst > gate:
            raise AssertionError(f"{kv_quant}: teacher-forced margin "
                                 f"{worst:.4f} row std > {gate}")
        row.update({"teacher_forced_worst_margin_std": worst,
                    "teacher_forced_eps_std": gate, "card": card})
        rows.append(row)
        print(json.dumps(row), flush=True)
    counts = fa.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the paged engine launched kernels: {counts}")
    for kv_quant, most in (("int8", 0.51), ("int4", 0.26)):
        ratio = pool_bytes[kv_quant] / pool_bytes["off"]
        if ratio > most:
            raise AssertionError(f"{kv_quant} pool {ratio:.4f} of float's "
                                 f"> {most}")
    print(json.dumps({
        "phase": "serving_modes_summary", "flash_launches": counts,
        "pool_mb": {k: v / 2**20 for k, v in pool_bytes.items()},
        "pool_ratio": {k: pool_bytes[k] / pool_bytes["off"]
                       for k in ("int8", "int4")},
        "card": card}), flush=True)
    return rows


def _flagship_train_config():
    """bench.py:69 ``flagship_train_config``, as a literal: d2048/L16/
    H16/KV8/ff6144/v32768, bf16 activations (f32 masters), flash
    attention, full per-layer remat."""
    import torch

    from edl_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab=32768, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=6144, dtype=torch.bfloat16, use_flash=True, remat=True)


def _dense_agreement(params, cfg, batch):
    """Flash vs dense (use_flash=False, plain autograd attention) loss
    and gradients at the same params and batch."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    f_loss, f_grads = trainer.value_and_grad(llama.make_loss_fn(cfg))(
        params, batch)
    dense = dataclasses.replace(cfg, use_flash=False)
    d_loss, d_grads = trainer.value_and_grad(llama.make_loss_fn(dense))(
        params, batch)
    cos = {}
    for (name, a), b in zip(_named_leaves(f_grads), trainer.leaves(d_grads)):
        cos[name] = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
    del f_grads, d_grads
    rel = abs(float(f_loss) - float(d_loss)) / abs(float(d_loss))
    worst = min(cos, key=cos.get)
    if not (rel <= LOSS_RTOL and cos[worst] >= GRAD_MIN_COS):
        raise AssertionError(
            f"flash vs dense: loss {float(f_loss)} vs {float(d_loss)} "
            f"(rel {rel:.3g} > {LOSS_RTOL}?), worst grad cosine "
            f"{cos[worst]:.5f} on {worst} (< {GRAD_MIN_COS}?)")
    return {"flash_loss": float(f_loss), "dense_loss": float(d_loss),
            "loss_rel_diff": rel, "loss_rtol": LOSS_RTOL,
            "grad_min_cos": cos[worst], "grad_min_cos_leaf": worst,
            "grad_cos_gate": GRAD_MIN_COS}


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _named_leaves(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix, tree)]


def train_phase(card, profile: bool):
    """The flagship at full width and depth through make_train_step."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.train import trainer

    cfg = _flagship_train_config()
    b, t = 4, 2048
    # one batch, every step: the loss must fall on it
    batch = {"tokens": torch.from_numpy(llama.synthetic_tokens(
        np.random.RandomState(0), b, t, cfg.vocab)["tokens"]).cuda()}
    params = trainer.trainable(
        llama.init_params(cfg, seed=0, device="cuda", dtype=torch.float32))
    agree = _dense_agreement(params, cfg, batch)
    torch.cuda.empty_cache()

    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
    state, m = step(state, batch)  # warm-up (allocator, cuBLAS)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()

    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # per step: the forward and the remat recompute both run with grad
    # on, so each runs the lse forward once per layer; each backward
    # sweep runs once per layer; the primal (no-grad) forward never
    L = cfg.n_layers
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L}
    if counts != {k: TRAIN_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"launches over {TRAIN_STEPS} steps {counts}, "
                             f"want {want} per step")
    step_s = wall / TRAIN_STEPS
    tok_s = b * t / step_s
    flops_tok = llama.train_flops_per_token(cfg, t)
    row = {
        "phase": "train", "model": "flagship_train (bench.py:69)",
        "layers": L, "batch": b, "seq": t, "params_f32": True,
        "remat": "full", "optimizer": "adamw(1e-3)", "steps": TRAIN_STEPS,
        "losses": losses, "launches": counts, "launches_per_step": want,
        "step_s": step_s, "tokens_per_s": tok_s,
        "train_flops_per_token": flops_tok,
        "mfu": flops_tok * tok_s / PEAK_BF16_FLOPS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        **agree, "card": card,
    }
    print(json.dumps(row), flush=True)
    if profile:
        _profile_step(card, step, state, batch, llama, cfg, step_s)
    return counts


def _kernel_family(name):
    n = name.lower()
    for keys, fam in (
            (("flash_bwd_dq",), "flash_bwd_dq"),
            (("flash_bwd_dkv",), "flash_bwd_dkv"),
            (("flash_fwd",), "flash_fwd_lse"),
            (("nvjet", "gemm", "xmma", "cutlass"), "matmul"),
            (("multi_tensor", "adam"), "optimizer"),
            (("softmax", "nll_loss", "cross_entropy"), "cross_entropy"),
            (("copy",), "cast/copy"),
            (("reduce",), "reduction")):
        if any(k in n for k in keys):
            return fam
    return "elementwise/other"


def _profiled(fn):
    """A torch.profiler session (host and device) around ``fn()`` and a
    device sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _device_kernels(prof):
    """({kernel name: device ms}, kernel launches) of a profiler
    session."""
    from torch.autograd import DeviceType

    kernels, calls = {}, 0
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or re.fullmatch(r"[\w.]+#[\w.]+", ev.key)):
            # CPU ops and annotated ranges (Optimizer.step#AdamW.step):
            # the kernels inside them are listed on their own. Kernel
            # names may hold a '#' too ({lambda()#3}), never this form.
            continue
        ms = getattr(ev, "self_device_time_total", 0) / 1e3
        if ms > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ms
            calls += ev.count
    return kernels, calls


def _top(kernels, n, width):
    return [(k[:width], ms) for k, ms in
            sorted(kernels.items(), key=lambda kv: -kv[1])[:n]]


# the serving profile's KV layouts: the slice's contiguous cache and the
# serving-modes phase's paged pool under each kv_quant
SERVE_LAYOUTS = {
    "contiguous": {},
    "paged_off": {"block_size": SM_BLOCK},
    "paged_int8": {"block_size": SM_BLOCK, "kv_quant": "int8"},
    "paged_int4": {"block_size": SM_BLOCK, "kv_quant": "int4"},
}
PROFILE_PREFILL = 256  # tokens of the profiled admission


def _profile_serving(card, params, cfg):
    """Where a decode block and an admission of the slice's engine (8
    slots x 2048, horizon 8) spend their time, per KV layout: six
    250-token prompts are admitted and decoded for two blocks; then one
    decode block (dispatch + drain) and the admission of one
    PROFILE_PREFILL-token prompt into a free slot (one prefill dispatch,
    the contiguous cache's on the flash kernel) each run once on the
    host clock through a device sync and once under torch.profiler. One
    line per layout: host seconds, device kernel ms and launches of
    each, and the top kernels."""
    import torch

    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, _device_kernels(_profiled(fn))

    for name, kw in SERVE_LAYOUTS.items():
        eng = ContinuousBatchingEngine(
            params, cfg, max_slots=8, max_len=SM_MAX_LEN, horizon=8,
            metrics=ServingMetrics(registry=MetricsRegistry()),
            device="cuda", **kw)
        rng = np.random.RandomState(0)
        for j in range(6):  # two slots stay free for the admissions
            eng.submit(f"r{j}", rng.randint(0, cfg.vocab, 250).tolist(), 256)
        for _ in range(3):  # admit the six, then two decode blocks
            eng.step()
        eng._drain_all()

        def block():
            eng._dispatch_block()
            eng._drain_all()

        admitted = []

        def admit():
            admitted.append(f"a{len(admitted)}")
            eng.submit(admitted[-1],
                       rng.randint(0, cfg.vocab, PROFILE_PREFILL).tolist(), 2)
            eng._admit()

        block_s, (b_k, b_calls) = timed(block)
        prefill_s, (p_k, p_calls) = timed(admit)
        b_ms = sum(b_k.values())
        print(json.dumps({
            "phase": "serving_profile", "layout": name,
            "layers": cfg.n_layers, "horizon": 8, "slots": 8,
            "block_host_s": block_s, "block_device_ms": b_ms,
            "block_kernel_launches": b_calls,
            "block_device_busy_share": b_ms / (block_s * 1e3),
            "block_top_kernels_ms": _top(b_k, 6, 60),
            "prefill_tokens": PROFILE_PREFILL, "prefill_host_s": prefill_s,
            "prefill_device_ms": sum(p_k.values()),
            "prefill_kernel_launches": p_calls,
            "prefill_top_kernels_ms": _top(p_k, 6, 60),
            "kv_mb": eng.kv_nbytes / 2**20, "card": card,
        }), flush=True)
        del eng
        torch.cuda.empty_cache()


def _profile_step(card, step, state, batch, llama, cfg, step_s):
    """Where one train step's device time goes: torch.profiler's device
    kernels summed by name and by family, against the unprofiled step
    time; and CUDA events around the forward, the backward (with the
    remat recompute) and the optimizer."""
    import torch

    kernels, calls = _device_kernels(_profiled(lambda: step(state, batch)))
    fams = {}
    for name, ms in kernels.items():
        fam = _kernel_family(name)
        fams[fam] = fams.get(fam, 0.0) + ms
    device_ms = sum(kernels.values())

    opt = state.opt_state
    loss_fn = llama.make_loss_fn(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    loss = loss_fn(state.params, batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    ev[3].synchronize()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "train_profile.json"), "w") as f:
        json.dump({"kernels_ms": kernels, "card": card}, f, indent=1)
    print(json.dumps({
        "phase": "train_profile", "kernel_launches": calls,
        "device_kernel_ms": device_ms, "step_ms": step_s * 1e3,
        "device_busy_share": device_ms / (step_s * 1e3),
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": _top(kernels, 12, 90),
        "events_ms": {"forward": ev[0].elapsed_time(ev[1]),
                      "backward_with_recompute": ev[1].elapsed_time(ev[2]),
                      "optimizer": ev[2].elapsed_time(ev[3])},
        "card": card,
    }), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from edl_tpu_torch.ops import _build
    from edl_tpu_torch.ops import flash_attention as fa

    card = _smi()
    print(f"# card {card}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    profile = "--profile" in sys.argv[1:]

    sources = ["flash_fwd", "flash_bwd"]
    t0 = time.perf_counter()
    _build.build_all(sources)  # one nvcc each, all at once
    for entry in ("flash_fwd_bf16", "flash_fwd_lse_bf16", "flash_bwd_dq_bf16",
                  "flash_bwd_dkv_bf16"):
        fa._kernel(entry)
    print(json.dumps({
        "phase": "build", "kernels": list(fa.KERNELS),
        "sources": [f"{n}.cu" for n in sources],
        "build_s": time.perf_counter() - t0,
        # <head dim, causal[, with lse]>: registers a thread, spill bytes,
        # whether ptxas serialized the kernel's wgmma
        "ptxas": {k: v for n in sources
                  for k, v in _build.ptxas_info(n).items()},
    }), flush=True)

    rows = kernel_phase(card)
    train_rows = train_kernel_phase(card)
    torch.cuda.empty_cache()
    launches, params, cfg = slice_phase(card)
    torch.cuda.empty_cache()
    serving_modes_phase(card, params, cfg)
    if profile:
        _profile_serving(card, params, cfg)
    del params
    torch.cuda.empty_cache()
    train_counts = train_phase(card, profile)

    # the serving path's largest prefill: the 1000-token prompt's bucket
    main = rows[(1024, True, 128)]
    tmain = train_rows[TRAIN_MAIN]
    tshape = "B4 T2048 H16 KV8 d128 causal bf16"
    src = "edl_tpu_torch/ops/csrc/"
    ref = "edl_tpu/ops/flash_attention.py:"

    def entry(name, source, replaces, launched, err, ms, plain, bound,
              library, shape):
        return {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": ref + replaces, "launches": launched,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library, "tflops": bound[2] / ms / 1e9,
            "bound_share": bound[0] / ms, "shape": shape,
        }

    def train_entry(name, source, replaces, errs, ms, plain, library):
        err = max(r[e] for r in list(train_rows.values()) + list(rows.values())
                  for e in errs if e in r)
        return entry(name, source, replaces, train_counts[name], err,
                     tmain[ms], tmain[plain],
                     (tmain["bound_ms"][name], tmain["bound_by"][name],
                      tmain["flops"][name]),
                     tmain[library], tshape)

    summary = {"kernels": [
        entry("flash_fwd", "flash_fwd.cu", "100", launches,
              max(r["max_abs_err"] for r in rows.values()),
              main["kernel_ms"], main["ref_ms"],
              _bound(1, 1024, 32, 8, 128, True), main["library_ms"],
              "B1 T1024 H32 KV8 d128 causal bf16"),
        # with_lse=True: the fwd rule _flash_fwd (:363) of the same kernel
        train_entry("flash_fwd_lse", "flash_fwd.cu", "100",
                    ["lse_max_abs_err"],
                    "flash_fwd_lse_ms", "plain_fwd_lse_ms", "library_fwd_ms"),
        # the plain backward and SDPA's backward each compute dq, dk and
        # dv in one call: their times stand beside both sweeps
        train_entry("flash_bwd_dq", "flash_bwd.cu", "226",
                    ["dq_max_abs_err"], "flash_bwd_dq_ms", "plain_bwd_ms",
                    "library_bwd_ms"),
        train_entry("flash_bwd_dkv", "flash_bwd.cu", "287",
                    ["dk_max_abs_err", "dv_max_abs_err"], "flash_bwd_dkv_ms",
                    "plain_bwd_ms", "library_bwd_ms"),
    ]}
    print(json.dumps(summary), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
