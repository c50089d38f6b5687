#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # what the card check runs
    python3 chip_smoke.py --profile   # also: torch.profiler over one
                                      # decode block and one admission
                                      # per KV layout, over one train
                                      # step (CUDA events per phase),
                                      # and the CTR chunk's kernels

1. Builds every kernel of the serving and training paths from the
   sources in this checkout (``edl_tpu_torch/ops/csrc/*.cu``, one nvcc
   per source, all at once, sm_90a).
2. Kernel phase: the flash-attention forward kernel against its plain
   PyTorch version (``flash_attention_ref``) on the card, bf16, B=1,
   H=32, KV=8, d=128 (Llama-3-8B's attention), T in {8, 128, 1024,
   1536, 2048}, causal and not; d=64 at T=1024, causal and not,
   where the lse variant is held to its plain version too, so every
   instantiation of the forward template is checked; and the decode
   ladder's prefills (phase 8a), B in {1, 8, 32} at T=512, H=16, KV=8,
   d=128, causal (the flagship's attention). Tolerance:
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
   non-causal (H=16, KV=8), H=32 KV=8 at T=1024, the ladder rungs'
   attention at the first batch of each ladder, B=16 T=2048 and B=4
   T=8192 H=16 KV=8 causal (the plain versions, host-bound at T=8192,
   take seconds; each shape prints them as ``plain_check_s``; a rung
   that steps down to a smaller batch has that shape checked after the
   ladder, phase 8); and d=64 at B=2 T=1024 H=16 KV=8 causal, so every
   instantiation of the three training kernels is checked (the
   non-causal d=64 backward by ``tests/test_torch_cuda.py``). Tolerances: the
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
3a. int8_products phase: ``ops/int8_matmul`` (``torch._int_mm``, no
   TPU kernel) at the flagship's seven projection shapes with M = 16 x
   2048 (K x N 2048x2048, 2048x1024, 2048x6144, 6144x2048): the
   forward, dgrad and wgrad of ``int8_matmul`` on the card against the
   same op sequence on the CPU for 512 output rows (forward, dgrad) and
   a 256-square block of wgrad, each a set of whole quantization
   slices. q, s and the int32 accumulators must be equal, the outputs
   within one rounding of the scale products (2^-8 relative in bf16,
   2^-22 in f32). Device ms of ``_int_mm``, the activation quantizer,
   bf16 ``torch.mm`` at the same shape (a yardstick), the op's forward
   and forward + backward beside bf16's, and the int8 bound (FLOPs over
   1979 TOPS, the H100 SXM's dense int8 spec; the summary row says
   whether the card's name is that card's).
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
5a. int8_serving phase: the slice's weights quantized on the card
   (``quantize_params_int8``), served with the slice's requests through
   the contiguous engine and the paged one (block 16). Checks: the int8
   tree (each projection and lm_head a record of int8 q8 in its
   weight's shape and f32 s8, the embedding and norms dense, its bytes
   <= 0.55 of the dense tree's), every request done, zero recoveries,
   flash launches == prefills x 32 (contiguous; none paged), no
   ``int8_matmul`` call, and the teacher-forced margin <= 0.1 row std
   against the quantized model's dense forward. Prints tokens/s beside
   the slice's float run.
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
7. Remat-policies phase: the same flagship, params and batch [4, 2048]
   under each remat policy ("full", "attn", "mlp", "dots"): one
   ``value_and_grad`` counted by a dispatch mode, then the best of 3
   uncounted ones (seconds, peak memory). Checks: ``flash_fwd_lse``
   launches (and ``edl_tpu_torch::flash_fwd`` ops) of 16 under "attn"
   (the flash op's outputs are saved, the recompute runs none) and 32
   under the others; the weight products (``aten.mm``) the backward
   recomputes: 6 a layer under "full" and "attn", 4 under "mlp" (w1 and
   w3 saved), 0 under "dots"; loss within 1e-6 relative and every
   gradient leaf within 1e-5 of its largest entry of "full"'s (the same
   ops on the same card: equal is expected; the largest difference is
   printed).
8. Train-ladder phase: bench.py:_llama_measure on the port. First three
   ``adafactor(1e-3)`` steps of a small f32 Llama (d256/L2, dense
   attention, batch [2, 64]) on the card and on the CPU: losses, params
   and the ``v_row`` / ``v_col`` / ``v`` statistics within 1e-4 of each
   leaf's largest entry. Then the flagship (full remat) with
   ``adafactor(1e-3)`` through ``make_train_multistep`` (2 steps a
   call): T=2048 at batch 16, 8, 4 or 2 (4 calls a loop) and T=8192 at
   batch 4, 2 or 1 (2 calls a loop), each the first batch that fits (a
   rung steps down only on ``torch.cuda.OutOfMemoryError``), one warm-up
   call, best of 2 loops (bench.py: 3). Prints tokens/s/chip, MFU
   (T=2048) and long MFU (T=8192) (``train_flops_per_token`` over 989
   TF/s), the batch,
   the state's GiB (``state_nbytes``) and every loss. Checks: finite
   losses that fall; per step 32 ``flash_fwd_lse``, 16 of each backward
   sweep and no primal forward. Then bench.py's int8 rungs
   (bench.py:205-212): the same config with ``int8_mxu``, the same
   ladders and loops: ``int8_mfu`` and
   ``int8_long_mfu`` over the bf16 peak, and ``int8_train_speedup`` /
   ``int8_long_speedup`` over the bf16 rung, -1 when the batches differ.
   Checks as the bf16 rungs', and per step 2 x 7 x 16 ``int8_matmul``
   forward calls (the forward and its recompute) and 7 x 16 backward
   calls.
8a. decode_ladder phase: bench.py's ``_llama_decode_bench``: the
   flagship's decode config (remat off) with bf16 params, greedy
   ``generate`` at (B, prompt) (1, 512), (8, 512), (32, 512), the
   decode rate by differencing 64 and 192 new tokens (one warm-up and
   one timed run a length: bench.py's reps cut), ``decode_pct_peak_bw`` =
   ``decode_step_bytes`` over the step over 3.35 TB/s; then the
   weight-only int8 rungs at B 1 and 8 on ``quantize_params_int8``'s
   tree (roofline against its own bytes) and ``decode_int8_b1_speedup``
   / ``decode_int8_speedup``. ``generate`` gets the config with
   ``int8_mxu`` on and must drop it. Checks: the int8 tree (as in 5a),
   no ``int8_matmul`` call, 16 primal flash launches a generate (its
   prefill) and no other, and at B 8 every int8 token within 0.1 row
   std of the quantized model's dense forward.
9. CTR phase: bench.py's headline (bench.py:1119-1230) on the port: the
   Criteo-shaped CTR model (vocab 2^20, emb 16, MLP 400-400-400,
   random weights from a seeded generator on the card), batch 16384 of
   ``synthetic_batch`` (4 raw batches cycled into 12-step chunks),
   ``adam(1e-3)``, bf16 compute, through ``stack_batches`` and
   ``make_train_multistep``: 2 warm-up chunks, then 3 loops of 240 steps
   (examples/s: best, median, spread). Then the reshard stalls, each the
   minimum of 2 runs: ``device_reshard`` (the fast path), and
   ``staged_reshard`` with f32 and int8 moment staging; the f32 run's
   rate gives ``host_stage_bw_gbs`` and ``stall_model_8b_1host_s`` as
   bench.py derives them. Checks: finite losses that fall over the run;
   on the trained state, f32 staging bit-identical to ``snapshot`` +
   ``restore``, int8 staging with params exact and moments within 1/127
   of their row's absmax, and the params one step after the int8-staged
   state within the bound those moment errors allow Adam's update
   around the same step from the unstaged state; one f32 step at vocab
   8192, batch 256 on the card against the same step on the CPU within
   1e-4 in loss and every param, and Adam's first moment after it
   ((1 - b1) * grad) within 1e-4 of each leaf's largest entry; no flash
   launch. It prints one chunk's
   device-busy share and launches a step (``torch.profiler``), and with
   ``--profile`` its top kernels and their families.

Prints one JSON line per phase, then ``{"kernels": [...]}`` (each
kernel's device ms, its bound, TF/s and bound share at its main-path
shape, and its launches on the main path; the three training kernels
three times, at B4 T2048 with the train phase's launches and at each
ladder rung's shape (the batch that fit) with that rung's launches,
each with its launches on every training path, the int8 rungs' too;
the primal forward four times, at B1 T1024 H32 with the slice's
launches and at each decode rung's prefill shape with that rung's bf16
and int8 launches, each with its launches on the slice, the int8
serving runs and every decode rung), then the
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

# the card's dense bf16 and HBM peaks: set in main() from the port's one
# peak table (edl_tpu_torch/obs/costmodel.py detect_peak; H100 SXM 989
# TF/s and 3.35 TB/s), which raises on a card it does not name
PEAK_BF16_FLOPS = PEAK_HBM_BYTES = None
TEACHER_EPS = 0.1  # chosen logit within EPS x row std of the row max
# primal forward: (B, T, H, KV, causal, head dim); Llama-3-8B's
# attention (the slice's prefills) at d=128, and d=64 so that every
# instantiation of the template is checked; the decode ladder's
# prefills are DECODE_SHAPES, below
KERNEL_SHAPES = ([(1, t, 32, 8, c, 128) for t in (8, 128, 1024, 1536, 2048)
                  for c in (True, False)]
                 + [(1, 1024, 32, 8, True, 64), (1, 1024, 32, 8, False, 64)])
SLICE_MAIN = (1, 1024, 32, 8, True, 128)  # the slice's largest prefill
# training kernels: (B, T, H, KV, causal, head dim); the first is the
# main shape (the flagship's attention at B4 T2048, the train phase's),
# the last two the ladder's rungs' attention at the first batch of each
# ladder (B16 T2048; B4 T8192, where the plain versions, ~2000 block
# pairs of small launches each, are host-bound); the one before them
# holds the d=64 instantiations of all three. A rung that steps down
# has its own batch's shape checked after the ladder.
TRAIN_MAIN = (4, 2048, 16, 8, True, 128)
TRAIN_SHAPES = [TRAIN_MAIN, (4, 100, 16, 8, True, 128),
                (4, 128, 16, 8, True, 128), (4, 1024, 16, 8, True, 128),
                (4, 1024, 16, 8, False, 128), (1, 1024, 32, 8, True, 128),
                (2, 1024, 16, 8, True, 64), (16, 2048, 16, 8, True, 128),
                (4, 8192, 16, 8, True, 128)]
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
# ctr phase: bench.py's CTR headline (bench.py:45-56, 1119-1230) as it is
CTR = {"vocab": 2 ** 20, "batch": 16384, "raw_batches": 4, "chunk": 12,
       "warmup": 2, "measure": 240, "loops": 3}
# one f32 step on the card against the same step on the CPU (small size):
# loss and params within CTR_CPU_ATOL; Adam's first moment after the step,
# (1 - b1) * grad, within CTR_CPU_GRAD_RTOL of each leaf's largest entry
# (both sum in f32 in different orders; a bf16 gradient is off by 2^-9)
CTR_SMALL = {"vocab": 8192, "batch": 256}
CTR_CPU_ATOL = 1e-4
CTR_CPU_GRAD_RTOL = 1e-4
# remat_policies phase: per layer, the weight products (aten.mm) the
# backward recomputes, reckoned from the layer's graph (models/llama.py
# _remat_policy: wq wk wv wo w1 w3 under "full" and "attn", w1 and w3
# saved under "mlp", every product saved under "dots"; the w2 product is
# never recomputed), and the flash_fwd_lse launches of a step (forward,
# plus the recompute unless "attn" saved the flash op's outputs)
REMAT_POLICIES = ("full", "attn", "mlp", "dots")
REMAT_RECOMPUTED_MM = {"full": 6, "attn": 6, "mlp": 4, "dots": 0}
REMAT_LSE_PER_LAYER = {"full": 2, "attn": 1, "mlp": 2, "dots": 2}
# every policy runs the same ops on the same inputs, so loss and
# gradients are expected equal to "full"'s; the bound admits only f32
# summation order (the embedding gradient's scatter-add)
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_OF_MAX = 1e-5
# train_ladder phase: bench.py:_llama_measure on the port (bench.py:
# 95-260): (T, batch ladder, multistep calls a loop), 2 steps a call.
# bench.py takes the best of 3 loops; here the best of 2, bf16 and int8
# rungs alike, to fit the script's time (an int8 loop is ~22 s)
LADDER_RUNGS = ((2048, (16, 8, 4, 2), 4), (8192, (4, 2, 1), 2))
LADDER_STEPS = 2
LADDER_LOOPS = 2
# three adafactor(1e-3) steps of a small f32 Llama (dense attention) on
# the card against the CPU: losses, params and second-moment statistics
# within AF_CPU_OF_MAX of each leaf's largest entry (f32 on both sides,
# sums in other orders; the unfactored update ~ lr * sign(grad) makes a
# params-only check blind to the gradient's size)
AF_SMALL = {"vocab": 1024, "d_model": 256, "n_layers": 2, "n_heads": 4,
            "n_kv_heads": 2, "d_ff": 512}
AF_SMALL_BATCH = (2, 64)
AF_CPU_OF_MAX = 1e-4
# int8_products phase: the int8 products of the flagship's seven
# projections at the int8 ladder rung's M (B16 x T2048): (K, N) of
# wq/wo, wk/wv, w1/w3 and w2. The CPU holds I8_ROWS output rows of the
# forward and dgrad and an I8_COLS-square block of wgrad (each a slice
# of whole quantization slices), since its int8 products over the
# whole M take minutes; the quantizers' q and s and the int32
# accumulators must be equal, the outputs within one rounding of the
# scale products.
I8_M = 16 * 2048
I8_SHAPES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))
I8_ROWS = 512
I8_COLS = 256
I8_BF16_REL = 2 ** -8  # one bf16 rounding (forward, dgrad)
I8_F32_REL = 2 ** -22  # one f32 rounding (wgrad)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8, the spec figure
I8_PER_LAYER = 7  # int8 products a layer: wq wk wv wo w1 w3 w2
# decode_ladder phase: bench.py _llama_decode_bench (bench.py:539-679):
# (batch, prompt, max_new), the headline batch, and the int8 tree's
# bytes over the bf16 tree's (predicted 0.537). Cut to fit the script's
# time: bench.py times each generation length best of 5 reps at b=1
# and 3 otherwise, each after a warm-up of that length; here one
# warm-up a rung (the short length) and one timed run a length. With
# bench.py's counts the new phases took ~210 s more (decode 11-19 ms a
# step, an int8 B16 T2048 step 2.2 s; H100 80GB HBM3, 700 W).
DECODE_LADDER = ((1, 512, 128), (8, 512, 128), (32, 512, 128))
DECODE_HEADLINE = 8
INT8_TREE_MOST = 0.55
# each decode rung's prefill: the flagship's attention (as TRAIN_MAIN's)
# at the rung's batch and prompt, held to its plain version in the
# kernel phase
DECODE_SHAPES = tuple((b, t0) + TRAIN_MAIN[2:] for b, t0, _ in DECODE_LADDER)


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
    """The primal forward against its plain version at KERNEL_SHAPES and
    DECODE_SHAPES (:func:`primal_kernel_row`); returns the rows by
    shape."""
    return {shape: primal_kernel_row(shape, card)
            for shape in (*KERNEL_SHAPES, *DECODE_SHAPES)}


def primal_kernel_row(shape, card):
    """The primal forward kernel at one shape (B, T, H, KV, causal, d):
    held against its plain version (and at d=64 the lse variant too),
    then timed beside the plain version, SDPA and the bound. Prints and
    returns the row."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops.bench_flash import device_ms

    b, t, h, kv, causal, d = shape
    where = f"B={b} T={t} H={h} KV={kv} causal={causal} d={d}"
    gen = torch.Generator(device="cuda").manual_seed(b * t + causal + d)
    q, k, v = (
        torch.randn(b, t, n, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
        for n in (h, kv, kv)
    )
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    blk = _plain_block(t)
    want_out, want_lse = fa.flash_attention_lse_ref(q, k, v, causal, blk,
                                                    blk)
    err = _check_out(got, want_out, f"flash_fwd at {where}")
    row = {"phase": "kernel", "kernel": "flash_fwd", "B": b, "T": t,
           "H": h, "KV": kv, "causal": causal, "d": d, "max_abs_err": err}
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
    kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal), 20)
    bound_ms, bound_by, flops = _bound(b, t, h, kv, d, causal)
    row.update({
        "tol": "2e-2 + 2^-7*|plain|", "kernel_ms": kernel_ms,
        "kernel_call_ms": _time_ms(
            lambda: fa.flash_attention(q, k, v, causal), 20),
        "ref_ms": _time_ms(lambda: fa.flash_attention_ref(
            q, k, v, causal, blk, blk), 2, 1),
        "library_ms": device_ms(lib, 20),
        "bound_us": bound_ms * 1e3, "bound_ms": bound_ms,
        "bound_by": bound_by, "flops": flops,
        "tflops": flops / kernel_ms / 1e9,
        "card": card,
    })
    print(json.dumps(row), flush=True)
    return row


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
    return {shape: train_kernel_row(shape, card) for shape in TRAIN_SHAPES}


def train_kernel_row(shape, card):
    """The lse forward, dQ and dK/dV kernels at one training shape (B, T,
    H, KV, causal, d): held against their plain versions, then timed
    beside them, SDPA and the bound. Prints and returns the row."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops.bench_flash import device_ms

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
    t_plain = time.perf_counter()
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
    plain_check_s = time.perf_counter() - t_plain

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
        "plain_bwd_ms": plain_bwd_ms, "plain_check_s": plain_check_s,
        "library_fwd_ms": lib_fwd_ms,
        "library_bwd_ms": lib_bwd_ms,
        "bound_ms": {n: v[0] for n, v in bounds.items()},
        "bound_by": {n: v[1] for n, v in bounds.items()},
        "flops": {n: v[2] for n, v in bounds.items()},
        "card": card,
    }
    print(json.dumps(row), flush=True)
    return row


def _slice_requests(vocab):
    """The slice phase's prompts (lengths in the buckets 8..1024) and
    new tokens a request."""
    rng = np.random.RandomState(0)
    lens = [5, 12, 30, 60, 100, 250, 500, 1000]
    return [rng.randint(0, vocab, n).tolist() for n in lens], 32


def slice_phase(card):
    """Returns the flash launches of the run, the model's (params, cfg),
    which the serving-modes and int8_serving phases reuse, and the
    run's tokens/s."""
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
    prompts, max_new = _slice_requests(cfg.vocab)
    lens = [len(p) for p in prompts]

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
    return launches, params, cfg, row["tokens_per_s"]


OBS_FAULT_PLAN = "serve.dispatch:raise@n=2;serve.drain:raise@n=5"
OBS_EFF_MAX = 1.05  # every efficiency gauge in (0, OBS_EFF_MAX]
OBS_LEDGER_RTOL = 0.02  # ledger kv + slot_state vs the allocator's growth


def _obs_serve(params, cfg, metrics, prefix, plan=None):
    """The slice's feed (8 requests, half after the first step) on a
    fresh engine of the slice's shape; returns (engine, {i: tokens},
    fault counts)."""
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.utils import faults

    eng = ContinuousBatchingEngine(params, cfg, max_slots=8, max_len=2048,
                                   horizon=8, metrics=metrics, device="cuda")
    prompts, max_new = _slice_requests(cfg.vocab)
    if plan:
        faults.arm(plan, seed=0)
    try:
        for i in range(4):
            eng.submit(f"{prefix}{i}", prompts[i], max_new)
        eng.step()
        for i in range(4, 8):
            eng.submit(f"{prefix}{i}", prompts[i], max_new)
        res = eng.run()
        counts = faults.counts()
    finally:
        faults.disarm()
    for i in range(8):
        r = res[f"{prefix}{i}"]
        if r.outcome != "done" or len(r.tokens) != max_new:
            raise AssertionError(f"obs {prefix}{i}: outcome {r.outcome}, "
                                 f"{len(r.tokens)} tokens")
    return eng, {i: res[f"{prefix}{i}"].tokens for i in range(8)}, counts


def obs_phase(card, params, cfg, slice_tps):
    """The engine's observability on the slice's model (Llama-3-8B, 32
    layers, bf16, flash; 8 slots x 2048, horizon 8): warm an engine on a
    private registry with the slice's requests, ``mark_warm``, then
    replay them on a fresh engine publishing into the default registry
    behind the HTTP exporter, and a third time under a fault plan.
    Gates: zero ``obs.recompile`` in the replay; ``edl_mfu`` and
    ``edl_bw_util_ratio`` for prefill and decode in (0, 1.05]; the
    ledger's ``params`` equal to the tree's bytes and its ``kv`` +
    ``slot_state`` within 2% of ``torch.cuda.memory_allocated``'s growth
    across an engine's construction; the replay's tokens equal the warm
    run's; both faults fire, and the faulted run's tokens keep the
    slice's teacher-forced margin (each request's first divergence from
    the replay is printed: bf16 recovery is not bit-exact); the scrape
    of ``/metrics``
    parses and declares every core family, ``/trace`` holds the
    ``serving.*`` spans and ``/events?rid=`` that request's events.
    Returns the replay's flash launches."""
    import torch

    from edl_tpu_torch import obs
    from edl_tpu_torch.obs import compilewatch, costmodel, memledger
    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs import metrics as om
    from edl_tpu_torch.obs import profile
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics
    from edl_tpu_torch.utils import tracing
    from edl_tpu_torch.utils.tree import leaves

    t_phase = time.perf_counter()
    rec = flight.reset_default_recorder()
    tracing.tracer().clear()
    reg = om.default_registry()
    ledger = memledger.default_ledger()
    # warm: every program key of the feed meets its first call here (or
    # met it in the slice phase)
    warm, warm_tokens, _ = _obs_serve(params, cfg, ServingMetrics(
        registry=om.MetricsRegistry()), "w")
    del warm
    compilewatch.mark_warm()
    # the ledger against the allocator, across one engine's construction
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    probe = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=2048, horizon=8,
        metrics=ServingMetrics(registry=om.MetricsRegistry()),
        device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - alloc0
    owned = {c: ledger.owner_total(probe._ledger_owner, c)
             for c in ("params", "kv", "slot_state")}
    del probe
    tree_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    if owned["params"] != tree_bytes:
        raise AssertionError(f"ledger params {owned['params']} != the "
                             f"tree's {tree_bytes} bytes")
    held = owned["kv"] + owned["slot_state"]
    if abs(grown - held) > OBS_LEDGER_RTOL * held:
        raise AssertionError(
            f"ledger kv + slot_state {held} vs the allocator's growth "
            f"{grown} across construction (> {OBS_LEDGER_RTOL:.0%})")
    listener = obs.bridge_tracer()
    exporter = obs.start_exporter(port=0)
    try:
        rec0 = rec.counts().get("obs.recompile", 0)
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, want, _ = _obs_serve(params, cfg, ServingMetrics(registry=reg),
                                  "o")
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        launches = fa.launch_counts()["flash_fwd"]
        prefills = eng.metrics.dispatches["prefill"]
        recompiles = rec.counts().get("obs.recompile", 0) - rec0
        if recompiles:
            raise AssertionError(f"{recompiles} obs.recompile events in the "
                                 "warm replay")
        if want != warm_tokens:  # the engine is deterministic run to run
            raise AssertionError("the replay's tokens differ from the warm "
                                 "run's")
        if launches != prefills * cfg.n_layers:
            raise AssertionError(f"replay flash launches {launches} != "
                                 f"{prefills} prefills x {cfg.n_layers}")
        gauges = {}
        for metric in ("edl_mfu", "edl_bw_util_ratio"):
            for phase in ("prefill", "decode"):
                v = reg.get(metric).value(phase=phase)
                gauges[f"{metric}{{{phase}}}"] = v
                if not 0.0 < v <= OBS_EFF_MAX:
                    raise AssertionError(f"{metric}{{phase={phase}}} = {v} "
                                         f"outside (0, {OBS_EFF_MAX}]")
        step_bytes = costmodel.decode_step_bytes(
            cfg, eng._cost.param_bytes, 8, 2048)
        slice_share = slice_tps / 8 * step_bytes / PEAK_HBM_BYTES
        crosscheck = ledger.crosscheck()
        # the scrape, while the replay engine still holds its entries
        text = obs.scrape(exporter.url)
        fams = om.parse_prometheus_text(text)
        typed = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")}
        core = {f.name for f in om.ensure_core_series(
            om.MetricsRegistry()).families()}
        if not core <= typed or not fams:
            raise AssertionError(f"/metrics lacks {sorted(core - typed)}")
        report = profile.report_from_fams(fams, source=exporter.url)
        doc = json.loads(obs.scrape(exporter.url, "/trace"))
        span_counts = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e["name"].startswith("serving."):
                span_counts[e["name"]] = span_counts.get(e["name"], 0) + 1
        for name in ("serving.dispatch", "serving.drain", "serving.prefill"):
            if not span_counts.get(name):
                raise AssertionError(f"/trace has no {name} span")
        recs = [json.loads(x) for x in
                obs.scrape(exporter.url, "/events?rid=o3").splitlines()]
        kinds = [r["kind"] for r in recs]
        if (any(r["corr"].get("rid") != "o3" for r in recs)
                or kinds[:1] != ["serve.submit"]
                or kinds[-1:] != ["serve.finish"]):
            raise AssertionError(f"/events?rid=o3 gave {kinds}")
        del eng
    finally:
        exporter.stop()
        tracing.tracer().remove_listener(listener)
    # the fault plan: recovery re-prefills from prompt + generated
    fault_eng, got, counts = _obs_serve(params, cfg, ServingMetrics(
        registry=om.MetricsRegistry()), "o", plan=OBS_FAULT_PLAN)
    recoveries = fault_eng.recoveries
    del fault_eng
    if counts != {"serve.dispatch": 1, "serve.drain": 1} or not recoveries:
        raise AssertionError(f"fault plan fired {counts}, {recoveries} "
                             "recoveries")
    # a recovery re-prefills in one pass what the decode steps built one
    # position at a time; bf16 rounds the two differently, so after a
    # recovery a near-tie may resolve the other way. Each request's first
    # divergence is recorded, and the faulted tokens are held to the
    # slice's bf16 criterion: every chosen token within TEACHER_EPS row
    # std of its row's maximum on the dense forward over its own prefix
    # (exact identity is held in f32: the card test
    # test_cuda_fault_plan_recovery_gives_the_same_tokens, and the CPU
    # tests against the JAX engine)
    diverged = {i: next(j for j, (a, b) in enumerate(zip(got[i], want[i]))
                        if a != b) for i in range(8) if got[i] != want[i]}
    prompts = _slice_requests(cfg.vocab)[0]
    fault_margin = max(_teacher_margin(params, cfg, prompts[i], got[i],
                                       "cuda") for i in range(8))
    if fault_margin > TEACHER_EPS:
        raise AssertionError(f"faulted run's teacher-forced margin "
                             f"{fault_margin:.4f} row std > {TEACHER_EPS}")
    cs = reg.get("edl_compile_seconds")
    compiles = {}
    for (program,), _ in reg.get("edl_compiles_total").samples():
        st = cs.stats(program=program)
        compiles[program] = {"programs": st["count"], "seconds": st["sum"]}
    print("# " + profile.render_report(report).replace("\n", "\n# "),
          flush=True)
    row = {
        "phase": "obs", "model": "llama3_8b", "layers": cfg.n_layers,
        "requests": 8, "replay_s": replay_s,
        "replay_tokens_per_s": 8 * _slice_requests(cfg.vocab)[1] / replay_s,
        "recompiles_after_warm": recompiles, "compiles": compiles,
        "efficiency": gauges, "efficiency_max": OBS_EFF_MAX,
        "slice_decode_bw_share": slice_share,
        "decode_step_bytes": step_bytes,
        "ledger": {**owned, "tree_bytes": tree_bytes,
                   "alloc_growth_bytes": grown,
                   "held_over_growth_minus_1": held / grown - 1.0},
        "crosscheck": crosscheck, "fault_plan": OBS_FAULT_PLAN,
        "faults": counts, "recoveries": recoveries,
        "replay_equals_warm": True,
        "faulted_tokens_equal": not diverged,
        "faulted_first_divergence": diverged,
        "faulted_teacher_forced_worst_margin_std": fault_margin,
        "teacher_forced_eps_std": TEACHER_EPS, "flash_launches": launches,
        "prefills": prefills, "trace_spans": span_counts,
        "scrape_families": len(typed), "events_o3": kinds,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    print(json.dumps(row), flush=True)
    return launches


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
    order: the run's ``serve.preempt`` flight events)."""
    import torch

    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    rec = flight.default_recorder()
    seen = rec.events()
    seq0 = seen[-1].seq if seen else 0
    n0 = rec.counts().get("serve.preempt", 0)
    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=SM_MAX_LEN, horizon=8,
        block_size=SM_BLOCK, kv_quant=kv_quant,
        metrics=ServingMetrics(registry=MetricsRegistry()), device=device,
        **kw)
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
    preempted = [e.corr["rid"] for e in rec.events(kind="serve.preempt")
                 if e.seq > seq0]
    if len(preempted) != rec.counts().get("serve.preempt", 0) - n0:
        raise AssertionError("the flight ring dropped serve.preempt events")
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


def _counter():
    """A TorchDispatchMode that counts the flash forward ops
    (``edl_tpu_torch::flash_fwd``, one ``flash_fwd_lse`` launch each on
    the card) and the weight products that run with grad on, or (under
    ``int8_mxu``) every ``edl_tpu_torch::int8_matmul`` op, whose
    autograd runs its forward with grad off: under a backward, those
    are the remat's recompute (the backward's own products run with
    grad off and none is an int8_matmul op)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import edl_tpu_torch.ops.int8_matmul  # noqa: F401 (registers the op)

    mm = torch.ops.aten.mm.default
    i8 = torch.ops.edl_tpu_torch.int8_matmul.default
    flash = torch.ops.edl_tpu_torch.flash_fwd.default

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flash_fwd = self.mm_grad_on = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == flash:
                self.flash_fwd += 1
            elif func == i8 or (func == mm and torch.is_grad_enabled()):
                self.mm_grad_on += 1
            return func(*args, **(kwargs or {}))

    return Counter()


def _remat_step(params, cfg, batch):
    """One ``value_and_grad`` of the Llama loss under ``cfg``, counted:
    returns (loss, grads in leaf order, {"flash_fwd_ops": the flash
    forward ops of the step, "recomputed_mm": the weight products its
    backward recomputed})."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    fwd, bwd = _counter(), _counter()
    with fwd:
        loss = llama.make_loss_fn(cfg)(params, batch)
    ps = [p for p in trainer.leaves(params) if p.requires_grad]
    with bwd:
        grads = list(torch.autograd.grad(loss, ps))
    return loss.detach(), grads, {"flash_fwd_ops": fwd.flash_fwd
                                  + bwd.flash_fwd,
                                  "recomputed_mm": bwd.mm_grad_on}


def _remat_check(policy, n_layers, counts, lse_launches, loss, grads,
                 ref_loss, ref_grads):
    """The remat_policies gates for one policy: the flash forward ops,
    the ``flash_fwd_lse`` launches and the recomputed weight products
    equal the reckoned counts; loss and every gradient leaf equal
    "full"'s (``ref_*``) within REMAT_LOSS_RTOL and REMAT_GRAD_OF_MAX of
    the leaf's largest entry. Raises; returns the differences."""
    lse = REMAT_LSE_PER_LAYER[policy] * n_layers
    want = {"flash_fwd_ops": lse, "flash_fwd_lse_launches": lse,
            "recomputed_mm": REMAT_RECOMPUTED_MM[policy] * n_layers}
    got = {**counts, "flash_fwd_lse_launches": lse_launches}
    if got != want:
        raise AssertionError(f"remat {policy!r}: counts {got}, want {want}")
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst = diff = 0.0
    for g, r in zip(grads, ref_grads, strict=True):
        d = float((g - r).abs().max())
        diff = max(diff, d)
        worst = max(worst, d / max(float(r.abs().max()), 1e-30))
    if not (loss_rel <= REMAT_LOSS_RTOL and worst <= REMAT_GRAD_OF_MAX):
        raise AssertionError(
            f"remat {policy!r} vs 'full': loss rel diff {loss_rel} (limit "
            f"{REMAT_LOSS_RTOL}), worst gradient leaf {worst} of its max "
            f"(limit {REMAT_GRAD_OF_MAX})")
    return {"counts": got, "loss_rel_diff_vs_full": loss_rel,
            "grad_worst_of_leaf_max_vs_full": worst,
            "grad_max_abs_diff_vs_full": diff}


def remat_policies_phase(card):
    """The flagship (full width and depth) at B4 T2048, the same params
    and batch under each remat policy: one counted ``value_and_grad``
    (the gates, :func:`_remat_check`), then the best of 3 uncounted
    ones for the step time and the peak memory. Returns the
    ``flash_fwd_lse`` launches of each policy's step."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.train import trainer

    cfg0 = _flagship_train_config()
    b, t = 4, 2048
    batch = {"tokens": torch.from_numpy(llama.synthetic_tokens(
        np.random.RandomState(0), b, t, cfg0.vocab)["tokens"]).cuda()}
    params = trainer.trainable(
        llama.init_params(cfg0, seed=0, device="cuda", dtype=torch.float32))
    vg = trainer.value_and_grad
    vg(llama.make_loss_fn(cfg0))(params, batch)  # warm-up (allocator, cuBLAS)
    ref = None
    launches = {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        fa.reset_launches()
        loss, grads, counts = _remat_step(params, cfg, batch)
        torch.cuda.synchronize()
        lse = fa.launch_counts()["flash_fwd_lse"]
        launches[policy] = lse
        if ref is None:
            ref = (loss, grads)
        gates = _remat_check(policy, cfg.n_layers, counts, lse, loss, grads,
                             *ref)
        del grads
        loss_fn = llama.make_loss_fn(cfg)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = vg(loss_fn)(params, batch)
            torch.cuda.synchronize()
            step_s = min(step_s, time.perf_counter() - t0)
            del out
        print(json.dumps({
            "phase": "remat_policies", "policy": policy,
            "model": "flagship_train (bench.py:69)", "layers": cfg.n_layers,
            "batch": b, "seq": t, "loss": float(loss),
            "recomputed_mm_per_layer": REMAT_RECOMPUTED_MM[policy],
            "flash_fwd_lse_per_layer": REMAT_LSE_PER_LAYER[policy], **gates,
            "loss_rtol": REMAT_LOSS_RTOL, "grad_of_max": REMAT_GRAD_OF_MAX,
            "value_and_grad_s": step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_above_start_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9,
            "card": card,
        }), flush=True)
    del ref, params
    return launches


def _adafactor_small_run(device):
    """Three ``adafactor(1e-3)`` steps of a small f32 Llama (AF_SMALL,
    dense attention) on ``device``, from the same params and batches on
    every device: returns (losses, state)."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.train import trainer

    cfg = llama.LlamaConfig(**AF_SMALL, dtype=torch.float32)
    params = llama.init_params(cfg, seed=2, device="cpu")
    params = trainer.replace_leaves(
        params, [p.to(device) for p in trainer.leaves(params)])
    rng = np.random.RandomState(2)
    tx = trainer.adafactor(1e-3)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
    losses = []
    for _ in range(3):
        nb = llama.synthetic_tokens(rng, *AF_SMALL_BATCH, cfg.vocab)
        state, m = step(state, trainer.global_batch(nb, device=device))
        losses.append(float(m["loss"]))
    return losses, state


def _adafactor_agreement(cpu, card):
    """Two :func:`_adafactor_small_run` results: losses, params and the
    second-moment statistics (``v_row``, ``v_col``, ``v``) within
    AF_CPU_OF_MAX of each leaf's largest entry (the losses: of the
    loss). Raises; returns the worst ratio and the statistics' count."""
    from edl_tpu_torch.train import trainer

    (lc, sc), (ld, sd) = cpu, card

    def keyed(st):
        out = {f"p{i}": p.detach().cpu()
               for i, p in enumerate(trainer.leaves(st.params))}
        out.update({f"o{i}/{n}": t.cpu()
                    for i, n, t, _ in trainer.optimizer_tensors(st)
                    if n != "step"})
        return out

    a, b = keyed(sc), keyed(sd)
    if a.keys() != b.keys():
        raise AssertionError(f"adafactor states differ in keys: "
                             f"{sorted(a.keys() ^ b.keys())}")
    worst = max(abs(x - y) / abs(x) for x, y in zip(lc, ld, strict=True))
    for k in a:
        den = max(float(a[k].abs().max()), 1e-30)
        worst = max(worst, float((a[k] - b[k]).abs().max()) / den)
    if not worst <= AF_CPU_OF_MAX:
        raise AssertionError(f"adafactor steps on the card vs the CPU: off "
                             f"by {worst} of a leaf's largest entry (limit "
                             f"{AF_CPU_OF_MAX})")
    return worst, sum(k.startswith("o") for k in a)


def _ladder_check(losses, counts, n_layers, steps, int8_calls=None,
                  int8=False):
    """A ladder rung's gates: finite losses that fall from the first step
    to the last, and per step 2L ``flash_fwd_lse`` (the forward and the
    full remat's recompute), L of each backward sweep and no primal
    forward launch; with ``int8_calls`` (the ``int8_matmul`` op's
    forward and backward calls), per step 2 x 7L forward calls (7 a
    layer in the forward and again in its recompute) and 7L backward
    calls on an ``int8`` rung, none on a bf16 one. Raises."""
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ladder loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ladder loss did not fall: {losses}")
    want = {"flash_fwd": 0, "flash_fwd_lse": 2 * n_layers,
            "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
    if counts != {k: steps * v for k, v in want.items()}:
        raise AssertionError(f"ladder launches over {steps} steps {counts}, "
                             f"want {want} a step")
    if int8_calls is not None:
        per = I8_PER_LAYER * n_layers if int8 else 0
        want = {"fwd": 2 * per, "bwd": per}
        if int8_calls != {k: steps * v for k, v in want.items()}:
            raise AssertionError(f"ladder int8_matmul calls over {steps} "
                                 f"steps {int8_calls}, want {want} a step")


def _ladder_rung(cfg, t, ladder, lreps, rng):
    """bench.py:_llama_measure on the port: adafactor(1e-3) through
    ``make_train_multistep`` (LADDER_STEPS steps a call), one warm-up
    call, then the best of LADDER_LOOPS loops of ``lreps`` calls, at the
    first batch of ``ladder`` that fits. A rung steps down only when the
    card runs out of memory; any other failure raises."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.train import trainer

    tx = trainer.adafactor(1e-3)
    tried = []
    for per_chip in ladder:
        try:
            state = trainer.TrainState.create(llama.init_params(
                cfg, seed=1, device="cuda", dtype=torch.float32), tx)
            toks = trainer.stack_batches(
                [llama.synthetic_tokens(rng, per_chip, t, cfg.vocab)
                 for _ in range(LADDER_STEPS)], device="cuda")
            multi = trainer.make_train_multistep(llama.make_loss_fn(cfg), tx)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            im.reset_calls()
            t0 = time.perf_counter()
            state, m = multi(state, toks)
            losses = [m["losses"]]
            float(m["loss"])  # warm-up fence
            first_s = time.perf_counter() - t0
            rate = 0.0
            for _ in range(LADDER_LOOPS):
                t0 = time.perf_counter()
                for _ in range(lreps):
                    state, m = multi(state, toks)
                    losses.append(m["losses"])
                float(m["loss"])
                rate = max(rate, lreps * LADDER_STEPS * per_chip * t
                           / (time.perf_counter() - t0))
        except torch.cuda.OutOfMemoryError as e:
            if per_chip == ladder[-1]:
                raise
            tried.append({"batch": per_chip, "error": str(e)[:160]})
        else:
            steps = LADDER_STEPS * (1 + LADDER_LOOPS * lreps)
            counts = fa.launch_counts()
            calls = dict(im.calls)
            losses = [float(x) for x in torch.cat(losses)]
            _ladder_check(losses, counts, cfg.n_layers, steps, calls,
                          cfg.int8_mxu)
            return {"T": t, "batch": per_chip, "out_of_memory": tried,
                    "tokens_per_s_per_chip": rate, "steps": steps,
                    "first_call_s": first_s, "losses": losses,
                    "launches": counts, "int8_matmul_calls": calls,
                    "state_gb": ckpt.state_nbytes(state) / 2 ** 30,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        finally:
            state = toks = multi = m = None
            torch.cuda.empty_cache()
        print(f"# train_ladder: batch {per_chip} at T={t} ran out of "
              f"memory, stepping down", flush=True)
    raise AssertionError("unreachable: the last rung returns or raises")


def train_ladder_phase(card):
    """bench.py's flagship ladder (``_llama_flagship_bench``) on the
    port: three small adafactor steps on the card against the CPU
    (:func:`_adafactor_agreement`), then the bf16 rungs at T=2048 and
    T=8192 (:func:`_ladder_rung`), tokens/s/chip and MFU of each, then
    the int8 rungs (bench.py:205-212: the same config with
    ``int8_mxu``, the same ladders): their tokens/s/chip, ``int8_mfu``
    and ``int8_long_mfu`` over the bf16 peak, as bench.py publishes
    them, and ``int8_train_speedup`` / ``int8_long_speedup`` over the
    bf16 rung, or -1 when the two settled on different batches
    (bench.py:227-247). Returns each rung's batch and launches by
    (T, "bf16" or "int8")."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama

    worst, n_stats = _adafactor_agreement(_adafactor_small_run("cpu"),
                                          _adafactor_small_run("cuda"))
    cfg = _flagship_train_config()
    rng = np.random.RandomState(0)
    rows = {}
    for kind, rcfg in (("bf16", cfg),
                       ("int8", dataclasses.replace(cfg, int8_mxu=True))):
        for i, (t, ladder, lreps) in enumerate(LADDER_RUNGS):
            r = _ladder_rung(rcfg, t, ladder, lreps, rng)
            fpt = llama.train_flops_per_token(cfg, t)
            rows[t, kind] = r
            rate = r["tokens_per_s_per_chip"]
            mfu = ("long_mfu" if i else "mfu")
            extra = {mfu: rate * fpt / PEAK_BF16_FLOPS}
            if kind == "int8":
                base = rows[t, "bf16"]
                speedup = ("int8_long_speedup" if i
                           else "int8_train_speedup")
                extra = {
                    "int8_tokens_per_sec_per_chip": rate,
                    f"int8_{mfu}": rate * fpt / PEAK_BF16_FLOPS,
                    speedup: (rate / base["tokens_per_s_per_chip"]
                              if r["batch"] == base["batch"] else -1.0),
                    "bf16_batch": base["batch"]}
            print(json.dumps({
                "phase": "train_ladder", "kind": kind,
                "model": "flagship_train (bench.py:69)",
                "int8_mxu": rcfg.int8_mxu,
                "optimizer": "adafactor(1e-3)", "remat": "full",
                "ladder": ladder, "steps_per_call": LADDER_STEPS,
                "calls_per_loop": lreps, "loops": LADDER_LOOPS, **r,
                "train_flops_per_token": fpt, **extra,
                "small_steps_vs_cpu_worst_of_leaf_max": worst,
                "small_steps_statistics": n_stats,
                "small_steps_of_max": AF_CPU_OF_MAX, "card": card,
            }), flush=True)
            torch.cuda.empty_cache()
    return {key: (r["batch"], r["launches"]) for key, r in rows.items()}


def _int8_product_row(k, n, m, device, card):
    """One int8 product shape [m, k] x [k, n]: ``int8_matmul``'s
    forward, dgrad and wgrad on ``device`` held against the same op
    sequence on the CPU (I8_ROWS rows of the forward and dgrad, an
    I8_COLS block of wgrad), then timed beside bf16 ``torch.mm``.
    Raises on a disagreement; prints and returns the row."""
    import torch

    from edl_tpu_torch.ops import int8_matmul as im

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(k + n)
    a = torch.randn(m, k, generator=gen, device=device).to(bf16)
    w = torch.randn(k, n, generator=gen, device=device) * k ** -0.5
    g = torch.randn(m, n, generator=gen, device=device).to(bf16)
    a.requires_grad_()
    w.requires_grad_()
    y = im.int8_matmul(a, w)
    da, dw = torch.autograd.grad(y, (a, w), g)
    a, w = a.detach(), w.detach()
    where = f"M{m} K{k} N{n}"

    def cpu(x):
        return x.detach().cpu()

    def equal(name, got, want):
        if not torch.equal(cpu(got), want):
            raise AssertionError(f"int8 {name} at {where}: the card's != "
                                 f"the CPU's")

    def close(name, got, want, rel):
        diff = (cpu(got).float() - want.float()).abs()
        if not bool((diff <= rel * want.float().abs()).all()):
            raise AssertionError(f"int8 {name} at {where}: max abs err "
                                 f"{float(diff.max())} past {rel} relative")
        return float(diff.max())

    r, c, q = I8_ROWS, I8_COLS, im.absmax_quant
    errs = {}
    with torch.no_grad():
        # forward: rows of a (per-row scales) by every column of w
        qa, sa = q(a, 1)
        qw, sw = q(w, 0)
        qa_c, sa_c = q(cpu(a[:r]), 1)
        qw_c, sw_c = q(cpu(w), 0)
        for name, got, want in (("qa", qa[:r], qa_c), ("sa", sa[:r], sa_c),
                                ("qw", qw, qw_c), ("sw", sw, sw_c)):
            equal(name, got, want)
        acc_c = im._dot8(qa_c, qw_c)
        equal("forward int32", im._dot8(qa, im._k_inner(qw))[:r], acc_c)
        errs["forward"] = close("forward", y[:r], im._scaled(
            acc_c, sa_c, sw_c).to(bf16), I8_BF16_REL)
        del qa, sa
        # dgrad: rows of g (per-row scales) by every row of w
        qg, sg = q(g, 1)
        qwn, swn = q(w, 1)
        qg_c, sg_c = q(cpu(g[:r]), 1)
        qwn_c, swn_c = q(cpu(w), 1)
        for name, got, want in (("qg", qg[:r], qg_c), ("sg", sg[:r], sg_c),
                                ("qwn", qwn, qwn_c), ("swn", swn, swn_c)):
            equal(name, got, want)
        acc_c = im._dot8(qg_c, qwn_c.t())
        equal("dgrad int32", im._dot8(qg, qwn.t())[:r], acc_c)
        errs["dgrad"] = close("dgrad", da[:r], im._scaled(
            acc_c, sg_c, swn_c.t()).to(bf16), I8_BF16_REL)
        del qg, sg
        # wgrad: columns of a by columns of g, each over the whole M
        qam, sam = q(a, 0)
        qgm, sgm = q(g, 0)
        qam_c, sam_c = q(cpu(a[:, :c]), 0)
        qgm_c, sgm_c = q(cpu(g[:, :c]), 0)
        for name, got, want in (("qam", qam[:, :c], qam_c),
                                ("sam", sam[:, :c], sam_c),
                                ("qgm", qgm[:, :c], qgm_c),
                                ("sgm", sgm[:, :c], sgm_c)):
            equal(name, got, want)
        acc_c = im._dot8(qam_c.t(), qgm_c)
        equal("wgrad int32", im._dot8(qam.t().contiguous(),
                                      im._k_inner(qgm))[:c, :c], acc_c)
        errs["wgrad"] = close("wgrad", dw[:c, :c], im._scaled(
            acc_c, sam_c.t(), sgm_c), I8_F32_REL)
        del qam, qgm, y, da, dw
        row = {"phase": "int8_products", "M": m, "K": k, "N": n,
               "max_abs_err": errs, "card": card}
        if device == "cuda":
            row.update(_int8_product_times(a, w, g, qw))
    print(json.dumps(row), flush=True)
    return row


def _int8_product_times(a, w, g, qw):
    """Device ms of the int8 product (``_int_mm``, the forward's
    layout), the activation quantizer, bf16 ``torch.mm`` at the same
    shape (a yardstick), and the op's forward and forward + backward
    beside bf16's three products; the int8 bound."""
    import torch

    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.ops.bench_flash import device_ms

    (m, k), n = a.shape, w.shape[1]
    qa, _ = im.absmax_quant(a, 1)
    qwk = im._k_inner(qw)
    wb = w.to(torch.bfloat16)
    ops = 2.0 * m * k * n
    op_ms = ops / PEAK_INT8_OPS * 1e3
    byte_ms = (m * k + k * n + 4.0 * m * n) / PEAK_HBM_BYTES * 1e3
    ai, wi = a.detach().requires_grad_(), w.detach().requires_grad_()
    ab, wbg = a.detach().requires_grad_(), wb.detach().requires_grad_()

    def i8_step():
        torch.autograd.grad(im.int8_matmul(ai, wi), (ai, wi), g)

    def bf16_step():
        torch.autograd.grad(ab @ wbg, (ab, wbg), g)

    with torch.enable_grad():
        step_ms = {"int8_fwd_bwd_ms": device_ms(i8_step, 3),
                   "bf16_fwd_bwd_ms": device_ms(bf16_step, 3)}
    return {
        "int_mm_ms": device_ms(lambda: im._dot8(qa, qwk), 10),
        "quantizer_ms": device_ms(lambda: im.absmax_quant(a, 1), 10),
        "bf16_mm_ms": device_ms(lambda: a @ wb, 10),
        "int8_fwd_ms": device_ms(lambda: im.int8_matmul(a, w), 10),
        **step_ms,
        "int8_bound_ms": max(op_ms, byte_ms),
        "int8_bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "int8_peak_tops": PEAK_INT8_OPS / 1e12,
    }


def int8_products_phase(card):
    """The flagship's int8 products at the int8 ladder rung's M, each
    shape held against the CPU (:func:`_int8_product_row`) and timed.
    The int8 peak is the H100 SXM's spec figure: the row says whether
    the card's name is that card's."""
    import torch

    for k, n in I8_SHAPES:
        _int8_product_row(k, n, I8_M, "cuda", card)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({
        "phase": "int8_products_summary", "card": card,
        "int8_peak_tops": PEAK_INT8_OPS / 1e12,
        "peak_is_this_cards": "H100" in name and "HBM3" in name,
    }), flush=True)


def _int8_tree_check(qparams, params):
    """The weight-only int8 tree: each of the seven projection weights
    and ``lm_head`` a record of int8 ``q8`` in its weight's shape and
    f32 ``s8`` of its output columns; the embedding and norms dense
    and unchanged; the tree's bytes at most INT8_TREE_MOST of the
    dense tree's. Raises; returns (int8 bytes, dense bytes)."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.utils.tree import leaves

    recs = {f"layers/{k}": (qparams["layers"][k], params["layers"][k])
            for k in llama._INT8_WEIGHTS}
    recs["lm_head"] = (qparams["lm_head"], params["lm_head"])
    for name, (rec, w) in recs.items():
        if not (isinstance(rec, dict) and set(rec) == {"q8", "s8"}):
            raise AssertionError(f"int8 tree: {name} is not a q8/s8 record")
        if (rec["q8"].dtype != torch.int8 or rec["q8"].shape != w.shape
                or rec["s8"].dtype != torch.float32
                or rec["s8"].shape != w.shape[:-2] + w.shape[-1:]):
            raise AssertionError(
                f"int8 tree: {name} q8 {rec['q8'].dtype} "
                f"{tuple(rec['q8'].shape)}, s8 {rec['s8'].dtype} "
                f"{tuple(rec['s8'].shape)} for a {tuple(w.shape)} weight")
    for name in ("embed", "ln_f", "layers/ln1", "layers/ln2"):
        parts = name.split("/")
        got, want = qparams, params
        for p in parts:
            got, want = got[p], want[p]
        if got is not want:
            raise AssertionError(f"int8 tree: {name} is not the dense leaf")
    q_bytes = sum(x.nbytes for x in leaves(qparams))
    d_bytes = sum(x.nbytes for x in leaves(params))
    if q_bytes > INT8_TREE_MOST * d_bytes:
        raise AssertionError(f"int8 tree: {q_bytes} bytes, "
                             f"{q_bytes / d_bytes:.4f} of the dense tree's "
                             f"> {INT8_TREE_MOST}")
    return q_bytes, d_bytes


def _generate_timed(params, prompt, cfg, n):
    """One ``generate`` of ``n`` new tokens, fenced by reading a token:
    (seconds, tokens)."""
    from edl_tpu_torch.models import llama

    t1 = time.perf_counter()
    toks = llama.generate(params, prompt, cfg, max_new=n)
    int(toks[0, -1])
    return time.perf_counter() - t1, toks


def _measure_decode(params, cfg, b, t0, max_new, device):
    """bench.py ``measure_decode`` (bench.py:489-536) on the port: the
    decode rate by differencing two generation lengths (max_new/2 and
    3 max_new/2), one run each after one warm-up generate of the short
    length (bench.py's reps cut: see DECODE_LADDER). Returns
    (prefill s or -1, s a token or None, prompt, the long run's
    tokens). Holds that ``generate`` ran no ``int8_matmul``: ``cfg``
    may carry int8_mxu, which generate must drop."""
    import torch

    from edl_tpu_torch.ops import int8_matmul as im

    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (b, t0))).to(device)
    short, long_ = max_new // 2, max_new + max_new // 2
    im.reset_calls()
    _generate_timed(params, prompt, cfg, short)  # warm-up
    t_short, _ = _generate_timed(params, prompt, cfg, short)
    t_long, toks = _generate_timed(params, prompt, cfg, long_)
    if any(im.calls.values()):
        raise AssertionError(f"generate ran int8_matmul {im.calls}: "
                             f"int8_mxu was left on")
    if t_long <= t_short * 1.02:
        return -1.0, None, prompt, toks
    per_tok = (t_long - t_short) / (long_ - short)
    prefill_s = t_short - short * per_tok
    return (prefill_s if prefill_s >= 0 else -1.0), per_tok, prompt, toks


def decode_ladder_phase(card):
    """bench.py ``_llama_decode_bench`` on the port: the flagship's
    decode config (``flagship_decode_config``: the train config with
    remat off) with bf16 params from a seeded generator, greedy
    ``generate`` over DECODE_LADDER, ``decode_pct_peak_bw`` =
    ``decode_step_bytes`` over the step time over 3.35 TB/s; then the
    weight-only int8 rungs (b=1 and the headline b=8) on
    ``quantize_params_int8``'s tree, their roofline against that
    tree's own bytes, and their speedups. ``generate`` is handed the
    int8 training rung's config (int8_mxu on, as a job trained on the
    int8 path hands it to serving): it must drop the flag. Gates: the
    int8 tree (:func:`_int8_tree_check`), no ``int8_matmul`` call in
    any generate, and at b=8 every greedy int8 token within
    TEACHER_EPS row std of the quantized model's dense forward, and at
    every rung one primal flash launch a layer a generate (its prefill)
    and no other flash launch. Returns the flash launches by (tree,
    batch)."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.utils.tree import leaves

    cfg = dataclasses.replace(_flagship_train_config(), remat=False)
    gen_cfg = dataclasses.replace(cfg, int8_mxu=True)
    params = llama.init_params(cfg, seed=2, device="cuda",
                               dtype=torch.bfloat16)
    param_bytes = sum(x.nbytes for x in leaves(params))
    out, rungs, launches = {}, {}, {}

    def rung(tree, tree_bytes, b, t0, max_new, weights):
        fa.reset_launches()
        prefill_s, per_tok, prompt, toks = _measure_decode(
            tree, gen_cfg, b, t0, max_new, "cuda")
        counts = fa.launch_counts()
        want = {**dict.fromkeys(fa.KERNELS, 0),
                "flash_fwd": 3 * cfg.n_layers}  # three generates
        if counts != want:
            raise AssertionError(f"decode_ladder {weights} b={b}: flash "
                                 f"launches {counts}, want {want}")
        launches[weights, b] = counts["flash_fwd"]
        s_pad = t0 + max_new + max_new // 2  # the long run's cache
        step_bytes = costmodel.decode_step_bytes(cfg, tree_bytes, b, s_pad)
        ok = per_tok is not None
        return {"b": b, "t0": t0, "new": [max_new // 2,
                                         max_new + max_new // 2],
                "prefill_s": prefill_s,
                "per_token_ms": per_tok * 1e3 if ok else -1.0,
                "decode_tokens_per_sec": b / per_tok if ok else -1.0,
                "step_bytes": step_bytes,
                "bound_ms": step_bytes / PEAK_HBM_BYTES * 1e3,
                "decode_pct_peak_bw": (step_bytes / per_tok / PEAK_HBM_BYTES
                                       if ok else -1.0)}, prompt, toks

    for b, t0, max_new in DECODE_LADDER:
        r, _, _ = rung(params, param_bytes, b, t0, max_new, "bfloat16")
        rungs[b] = r
        print(json.dumps({"phase": "decode_ladder", "weights": "bfloat16",
                          **r, "card": card}), flush=True)
    head = rungs[DECODE_HEADLINE]
    out.update({"prefill_s": head["prefill_s"],
                "decode_tokens_per_sec": head["decode_tokens_per_sec"],
                "decode_pct_peak_bw": head["decode_pct_peak_bw"]})

    qparams = llama.quantize_params_int8(params)
    q_bytes, _ = _int8_tree_check(qparams, params)
    del params
    worst = 0.0
    for b, t0, max_new in DECODE_LADDER:
        if b not in (1, DECODE_HEADLINE):
            continue
        r, prompt, toks = rung(qparams, q_bytes, b, t0, max_new, "int8")
        suffix = "" if b == DECODE_HEADLINE else "_b1"
        base = rungs[b]["decode_tokens_per_sec"]
        rate = r["decode_tokens_per_sec"]
        out.update({
            f"decode_int8{suffix}_tokens_per_sec": rate,
            f"decode_int8{suffix}_pct_peak_bw": r["decode_pct_peak_bw"],
            f"decode_int8{suffix}_speedup": (rate / base if rate > 0
                                             and base > 0 else -1.0)})
        if b == DECODE_HEADLINE:
            for i in range(b):
                worst = max(worst, _teacher_margin(
                    qparams, cfg, prompt[i].tolist(), toks[i].tolist(),
                    "cuda"))
        print(json.dumps({"phase": "decode_ladder", "weights": "int8",
                          **r, "card": card}), flush=True)
    if worst > TEACHER_EPS:
        raise AssertionError(f"decode_ladder int8 b={DECODE_HEADLINE}: "
                             f"teacher-forced margin {worst:.4f} row std > "
                             f"{TEACHER_EPS}")
    print(json.dumps({
        "phase": "decode_ladder_summary",
        "model": "flagship_decode (bench.py:87)", "layers": cfg.n_layers,
        "headline_batch": DECODE_HEADLINE, **out,
        "param_bytes": param_bytes, "int8_param_bytes": q_bytes,
        "int8_tree_ratio": q_bytes / param_bytes,
        "int8_tree_most": INT8_TREE_MOST,
        "int8_teacher_forced_worst_margin_std": worst,
        "teacher_forced_eps_std": TEACHER_EPS,
        "flash_launches": {f"{w} b{b}": n for (w, b), n in launches.items()},
        "card": card}), flush=True)
    return launches


def int8_serving_phase(card, params, cfg, float_tps):
    """The slice's model and weights quantized on the card
    (``quantize_params_int8``), served through the contiguous and the
    paged (block SM_BLOCK) engine with the slice's requests (8 slots x
    2048, horizon 8). Gates: the int8 tree, every request done, zero
    recoveries, flash launches == prefills x layers on the contiguous
    engine (none on the paged one, as in the reference), no
    ``int8_matmul`` call, and every token within TEACHER_EPS row std of
    the quantized model's dense forward. Prints tokens/s beside the
    slice's float run (``float_tps``). Returns the flash launches by
    layout."""
    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.ops import int8_matmul as im
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    t0 = time.perf_counter()
    qparams = llama.quantize_params_int8(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    q_bytes, d_bytes = _int8_tree_check(qparams, params)
    prompts, max_new = _slice_requests(cfg.vocab)
    launches = {}
    for layout, kw in (("contiguous", {}), ("paged", {"block_size":
                                                      SM_BLOCK})):
        metrics = ServingMetrics(registry=MetricsRegistry())
        eng = ContinuousBatchingEngine(
            qparams, cfg, max_slots=8, max_len=2048, horizon=8,
            metrics=metrics, device="cuda", **kw)
        eng.submit("warmup", prompts[0], 2)
        eng.run()
        prefills0 = metrics.dispatches["prefill"]
        fa.reset_launches()
        im.reset_calls()
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
        prefills = metrics.dispatches["prefill"] - prefills0
        want = prefills * cfg.n_layers if layout == "contiguous" else 0
        if counts != {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd": want}:
            raise AssertionError(f"int8 {layout}: launches {counts}, want "
                                 f"{want} flash_fwd ({prefills} prefills)")
        if eng.recoveries or any(im.calls.values()):
            raise AssertionError(f"int8 {layout}: {eng.recoveries} "
                                 f"recoveries, int8_matmul {im.calls}")
        for i in range(8):
            r = res[f"r{i}"]
            if r.outcome != "done" or len(r.tokens) != max_new:
                raise AssertionError(f"int8 {layout} r{i}: outcome "
                                     f"{r.outcome}, {len(r.tokens)} tokens")
        worst = max(_teacher_margin(qparams, cfg, prompts[i],
                                    res[f"r{i}"].tokens, "cuda")
                    for i in range(8))
        if worst > TEACHER_EPS:
            raise AssertionError(f"int8 {layout}: teacher-forced margin "
                                 f"{worst:.4f} row std > {TEACHER_EPS}")
        launches[layout] = counts["flash_fwd"]
        print(json.dumps({
            "phase": "int8_serving", "layout": layout, "model": "llama3_8b",
            "layers": cfg.n_layers, "block_size": kw.get("block_size", 0),
            "requests": 8, "max_new": max_new, "prefills": prefills,
            "flash_launches": counts["flash_fwd"], "wall_s": wall,
            "tokens_per_s": 8 * max_new / wall,
            "float_tokens_per_s": float_tps,
            "block_mean_s": _block_mean(metrics),
            "teacher_forced_worst_margin_std": worst,
            "teacher_forced_eps_std": TEACHER_EPS,
            "quantize_s": quantize_s, "int8_param_bytes": q_bytes,
            "param_bytes": d_bytes, "int8_tree_ratio": q_bytes / d_bytes,
            "card": card}), flush=True)
        del eng
    return launches


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


def _ctr_gates_reshard(state, step, batch, ckpt, trainer, device):
    """The reshard gates: f32 staging bit-identical to snapshot +
    restore; int8 staging keeps params exact and moments within 1/127 of
    their row's absmax; one step from the int8-staged state moves every
    param within what those moment errors can move Adam's update
    (:func:`_ctr_resume_check`) of the same step from the unstaged state.
    Returns the worst moment error (in row absmax), the resumed step's
    check, and the share of live second moments (first moment nonzero)
    that staged to 0."""
    import torch

    def keyed(st):
        ps = trainer.leaves(st.params)
        out = {f"p{i}": p for i, p in enumerate(ps)}
        out.update({f"o{i}/{n}": t
                    for i, n, t, _ in trainer.optimizer_tensors(st)})
        return out

    staged = keyed(ckpt.staged_reshard(state, stage="f32", device=device))
    ref = keyed(ckpt.restore(ckpt.snapshot(state), device=device))
    if staged.keys() != ref.keys() or not all(
            staged[k].dtype == ref[k].dtype and torch.equal(staged[k], ref[k])
            for k in ref):
        raise AssertionError("f32 staged reshard differs from snapshot + "
                             "restore")
    del staged, ref
    q8 = ckpt.staged_reshard(state, stage="int8", device=device)
    before, after = keyed(state), keyed(q8)
    worst = 0.0
    for k, x in before.items():
        y = after[k]
        if k.startswith("p") or x.numel() < 4096 or x.dim() == 0:
            if not torch.equal(x, y):
                raise AssertionError(f"int8 staging changed {k}")
            continue
        den = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
        worst = max(worst, float(((x - y).abs() / den).max()))
    if worst > 1 / 127 + 1e-6:
        raise AssertionError(f"int8-staged moments off by {worst} of their "
                             f"row absmax > 1/127")
    # second moments staged to 0 under a live first moment: their next
    # update is exp_avg / eps (ROADMAP Queue C)
    live = zeroed = 0
    for k, v in after.items():
        if k.endswith("/exp_avg_sq") and v.numel() >= 4096:
            m = before[k[:-len("_sq")]] != 0
            live += int(m.sum())
            zeroed += int((m & (v == 0)).sum())
    del before, after
    plain = ckpt.restore(ckpt.snapshot(state), device=device)
    q8, m8 = step(q8, batch)
    plain, mf = step(plain, batch)
    resumed = _ctr_resume_check(state, q8, plain, trainer)
    resumed["losses_int8_vs_unstaged"] = [float(m8["loss"]),
                                          float(mf["loss"])]
    return worst, resumed, zeroed / max(live, 1)


def _ctr_resume_check(state, staged, plain, trainer):
    """Params after one Adam step from ``staged`` (``state`` staged
    through int8: params exact, moments within 1/127 of their row's
    absmax) against the same step from an unstaged copy ``plain``.

    Adam moves a param by lr/bc1 * m / D, D = sqrt(v/bc2) + eps, with
    m, v the moments after the step. With e_m, e_v the staging bound
    (1/127 of the row absmax of ``state``'s moments; 0 for leaves staged
    exactly) and g~, g the two steps' gradients (the table's f32
    ``index_add_`` may sum in another order):
      |m~ - m| <= dm = b1 e_m + (1 - b1) |g~ - g|
      |v~ - v| <= dv = b2 e_v + (1 - b2) |g~^2 - g^2|
      |D~ - D| <= dD = min(sqrt(dv / bc2),
                           (dv / bc2) / (sqrt(v / bc2) + sqrt(v_lo / bc2)))
      |p~ - p| <= lr / bc1 * (dm + |m| dD / D) / D_lo
    where v_lo = max(v - dv, 0), D_lo = sqrt(v_lo / bc2) + eps <= D~,
    and m, v, D are the unstaged step's. The first moment enters the
    update linearly; a second moment that staged to 0 (ROADMAP Queue C)
    leaves D_lo near eps there, so the bound is loose on those entries
    and tight where v is near its row's absmax. f32 rounding adds 2^-22
    of each term of m and v and of |p|, and 2^-21 of the update. Raises
    where a param exceeds bound + rounding; returns the worst ratio and
    the largest difference."""
    import torch

    group = plain.opt_state.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    r = 2.0 ** -22
    worst = diff = 0.0
    for p0, pu, ps in zip(trainer.leaves(state.params),
                          trainer.leaves(plain.params),
                          trainer.leaves(staged.params)):
        st0, stu = state.opt_state.state[p0], plain.opt_state.state[pu]
        t = float(stu["step"])
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        m0, v0 = st0["exp_avg"].double(), st0["exp_avg_sq"].double()
        g, gs = pu.grad.double(), ps.grad.double()
        m, v = stu["exp_avg"].double(), stu["exp_avg_sq"].double()
        if m0.numel() >= 4096:
            e_m = m0.abs().amax(dim=-1, keepdim=True) / 127
            e_v = v0.abs().amax(dim=-1, keepdim=True) / 127
        else:
            e_m = e_v = 0.0
        dm = (b1 * e_m + (1 - b1) * (gs - g).abs()
              + r * (b1 * m0.abs() + (1 - b1) * g.abs()))
        dv = (b2 * e_v + (1 - b2) * (gs * gs - g * g).abs()
              + r * (b2 * v0 + (1 - b2) * g * g))
        v_lo = (v - dv).clamp_min(0)
        den = (v / bc2).sqrt() + (v_lo / bc2).sqrt()
        d_d = torch.minimum((dv / bc2).sqrt(),
                            torch.where(den > 0, dv / bc2 / den,
                                        float("inf")))
        big_d, d_lo = (v / bc2).sqrt() + eps, (v_lo / bc2).sqrt() + eps
        bound = (lr / bc1 * (dm + m.abs() * d_d / big_d) / d_lo
                 + 2 * r * lr / bc1 * m.abs() / d_lo
                 + r * pu.detach().double().abs())
        got = (ps.detach().double() - pu.detach().double()).abs()
        worst = max(worst, float((got / bound).max()))
        diff = max(diff, float(got.max()))
    if not worst <= 1.0:
        raise AssertionError(f"params one step after int8 staging: "
                             f"{worst} of the bound the staged moments "
                             f"allow")
    return {"param_worst_of_bound": worst, "param_max_abs_diff": diff}


def _ctr_small_step_agrees():
    """One f32 CTR step at CTR_SMALL on the card against the same step of
    the port on the CPU: loss and every param within CTR_CPU_ATOL, and
    every leaf's first moment after the step ((1 - b1) * its gradient:
    a one-step Adam update is about lr * sign(grad), so the params alone
    hardly see the gradient's size) within CTR_CPU_GRAD_RTOL of the
    leaf's largest entry. Returns the worst differences."""
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.train import trainer

    gen = torch.Generator().manual_seed(1)
    host = ctr.init_params(gen, vocab=CTR_SMALL["vocab"], device="cpu")
    nb = ctr.synthetic_batch(np.random.RandomState(1), CTR_SMALL["batch"],
                             vocab=CTR_SMALL["vocab"])
    out = []
    for dev in ("cpu", "cuda"):
        tx = trainer.adam(1e-3)
        params = trainer.replace_leaves(
            host, [p.to(dev, copy=True) for p in trainer.leaves(host)])
        st = trainer.TrainState.create(params, tx)
        st, m = trainer.make_train_step(ctr.make_loss_fn(), tx)(
            st, trainer.global_batch(nb, device=dev))
        out.append((float(m["loss"]),
                    [p.detach().cpu() for p in trainer.leaves(st.params)],
                    [t.cpu() for _, n, t, _ in trainer.optimizer_tensors(st)
                     if n == "exp_avg"]))
    (lc, pc, mc), (ld, pd, md) = out
    worst = max([abs(lc - ld)] + [float((a - b).abs().max())
                                  for a, b in zip(pc, pd)])
    grad_rel = max(float((a - b).abs().max() / a.abs().max().clamp_min(
        1e-30)) for a, b in zip(mc, md))
    if not (worst <= CTR_CPU_ATOL and grad_rel <= CTR_CPU_GRAD_RTOL):
        raise AssertionError(
            f"CTR step on the card vs the CPU: loss/params off by {worst} "
            f"(limit {CTR_CPU_ATOL}), first moments by {grad_rel} of their "
            f"leaf's largest entry (limit {CTR_CPU_GRAD_RTOL})")
    return worst, grad_rel


def ctr_phase(card, profile: bool):
    """bench.py's CTR headline on the port (bench.py:1119-1230): the
    Criteo-shaped model (vocab 2^20, emb 16, MLP 400-400-400) at batch
    16384, adam(1e-3), bf16 compute, 12 steps a chunk over 4 raw batches
    cycled; 2 warm-up chunks, then 3 loops of 240 steps (best, median,
    spread); then the reshard stalls, each the minimum of 2 runs (the
    device fast path, host staging in f32 and in int8) and the models
    derived from them; then the gates."""
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime import elastic
    from edl_tpu_torch.train import trainer

    c = CTR
    device = "cuda"

    def fence(st):
        return float(st.params["out"]["b"].detach().sum())  # a scalar fetch

    gen = torch.Generator(device=device).manual_seed(0)
    params = ctr.init_params(gen, vocab=c["vocab"], device=device)
    tx = trainer.adam(1e-3)
    state = trainer.TrainState.create(params, tx)
    rng = np.random.RandomState(0)
    raw = [ctr.synthetic_batch(rng, c["batch"], vocab=c["vocab"])
           for _ in range(c["raw_batches"])]
    stacked = trainer.stack_batches(
        [raw[i % len(raw)] for i in range(c["chunk"])], device=device)
    loss_fn = ctr.make_loss_fn(torch.bfloat16)
    multi = trainer.make_train_multistep(loss_fn, tx)
    fa.reset_launches()

    t0 = time.perf_counter()
    state, m = multi(state, stacked)
    first_loss = float(m["losses"][0])  # fence: first chunk
    compile_s = time.perf_counter() - t0
    for _ in range(c["warmup"]):
        state, m = multi(state, stacked)
    float(m["loss"])
    chunks = c["measure"] // c["chunk"]
    rates, loop_s = [], []
    for _ in range(c["loops"]):
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, m = multi(state, stacked)
        float(m["loss"])  # fence once a loop: chunks stay pipelined
        dt = time.perf_counter() - t0
        loop_s.append(dt)
        rates.append(c["batch"] * chunks * c["chunk"] / dt)
    final_loss = float(m["loss"])
    rates = np.asarray(rates)
    if not all(math.isfinite(x) for x in (first_loss, final_loss)):
        raise AssertionError(f"non-finite CTR loss: {first_loss}, "
                             f"{final_loss}")
    if not final_loss < first_loss:
        raise AssertionError(f"CTR loss did not fall: {first_loss} -> "
                             f"{final_loss}")

    kernels, calls = _device_kernels(_profiled(
        lambda: multi(state, stacked)))
    dev_ms = sum(kernels.values())
    chunk_ms = min(loop_s) / chunks * 1e3
    busy = {"chunk_device_ms": dev_ms, "chunk_host_ms": chunk_ms,
            "chunk_device_busy_share": dev_ms / chunk_ms,
            "launches_per_step": calls / c["chunk"]}
    if profile:
        busy["chunk_top_kernels_ms"] = _top(kernels, 12, 70)
        fams = {}
        for name, ms in kernels.items():
            fam = _ctr_family(name)
            fams[fam] = fams.get(fam, 0.0) + ms
        busy["chunk_by_family_ms"] = dict(
            sorted(fams.items(), key=lambda kv: -kv[1]))

    # the gates run on the trained state, before the stall runs stage it
    # (a state already staged through int8 re-quantizes onto itself)
    step = trainer.make_train_step(loss_fn, tx)
    worst_q8, resumed, nu_zeroed = _ctr_gates_reshard(
        state, step, trainer.global_batch(raw[0], device=device), ckpt,
        trainer, device)
    stall_fast = stall_f32 = stall_int8 = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        state = elastic.device_reshard(state, device=device)
        fence(state)
        stall_fast = min(stall_fast, time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        state = ckpt.staged_reshard(state, stage="f32", device=device)
        fence(state)
        stall_f32 = min(stall_f32, time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        state = ckpt.staged_reshard(state, stage="int8", device=device)
        fence(state)
        stall_int8 = min(stall_int8, time.perf_counter() - t0)
    state_b = ckpt.state_nbytes(state)
    moment_b = ckpt.state_nbytes(state.opt_state)
    host_bw = state_b / stall_f32  # one host: the f32 run's raw rate
    model_8b = ckpt.host_fallback_stall_model(
        17 * (1 << 30), hosts_after=1, host_bw_bytes_s=host_bw,
        moment_bytes=1 << 30, stage="int8")

    small_err, small_grad_rel = _ctr_small_step_agrees()
    counts = fa.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the CTR path launched flash kernels: {counts}")
    row = {
        "phase": "ctr", "model": "ctr (bench.py:1119)", "vocab": c["vocab"],
        "emb": ctr.DEFAULT_EMBEDDING, "mlp": list(ctr.MLP_DIMS),
        "batch": c["batch"], "chunk": c["chunk"], "optimizer": "adam(1e-3)",
        "compute": "bfloat16",
        "ctr_examples_per_sec_per_chip": float(rates.max()),
        "ctr_median": float(np.median(rates)),
        "ctr_spread_pct": float(100 * (rates.max() - rates.min())
                                / rates.max()),
        "loop_rates": rates.tolist(), "compile_s": compile_s,
        "first_loss": first_loss, "final_loss": final_loss,
        "train_flops_per_example": costmodel.ctr_train_flops_per_example(),
        "ctr_state_mb": state_b / 2 ** 20, "ctr_moment_mb": moment_b / 2 ** 20,
        "reshard_stall_s": stall_fast,
        "reshard_stall_host_f32_s": stall_f32,
        "reshard_stall_host_fallback_s": stall_int8,
        "reshard_stage": "int8",
        "host_stage_bw_gbs": host_bw / 2 ** 30,
        "stall_model_8b_1host_s": model_8b,
        "int8_moment_worst_of_row_absmax": worst_q8,
        "int8_resumed_step": resumed,
        "int8_nu_zeroed_share": nu_zeroed,
        "small_step_vs_cpu_worst": small_err, "small_step_atol": CTR_CPU_ATOL,
        "small_step_grad_vs_cpu_of_leaf_max": small_grad_rel,
        "small_step_grad_rtol": CTR_CPU_GRAD_RTOL,
        "flash_launches": counts, **busy, "card": card,
    }
    print(json.dumps(row), flush=True)
    return row


def _ctr_family(name):
    n = name.lower()
    for keys, fam in (
            (("gemm", "nvjet", "xmma", "cutlass", "splitk"), "matmul (MLP)"),
            (("multi_tensor", "adam"), "adam"),
            (("indexfunc", "index_add", "scatter"),
             "embedding backward (index_add)"),
            (("index_select", "indexselect", "gather"), "embedding forward"),
            (("copy", "cast", "convert"), "cast/copy (table, params)"),
            (("reduce",), "reduction"),
            (("fill",), "fill (zero grads)")):
        if any(k in n for k in keys):
            return fam
    return "elementwise/other"


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
    from edl_tpu_torch.obs import costmodel
    from edl_tpu_torch.ops import _build
    from edl_tpu_torch.ops import flash_attention as fa

    global PEAK_BF16_FLOPS, PEAK_HBM_BYTES
    peak = costmodel.detect_peak("cuda")
    PEAK_BF16_FLOPS, PEAK_HBM_BYTES = peak.flops, peak.hbm_bytes_s
    card = _smi()
    print(f"# card {card}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"# peak {peak.kind}: {PEAK_BF16_FLOPS / 1e12:g} TF/s bf16, "
          f"{PEAK_HBM_BYTES / 1e12:g} TB/s", flush=True)
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

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernel", kernel_phase, card)
    train_rows = timed("train_kernels", train_kernel_phase, card)
    timed("int8_products", int8_products_phase, card)
    launches, params, cfg, float_tps = timed("slice", slice_phase, card)
    obs_launches = timed("obs", obs_phase, card, params, cfg, float_tps)
    timed("serving_modes", serving_modes_phase, card, params, cfg)
    if profile:
        _profile_serving(card, params, cfg)
    int8_serve = timed("int8_serving", int8_serving_phase, card, params,
                       cfg, float_tps)
    del params
    torch.cuda.empty_cache()
    train_counts = timed("train", train_phase, card, profile)
    remat_lse = timed("remat_policies", remat_policies_phase, card)
    ladder_runs = timed("train_ladder", train_ladder_phase, card)
    # each rung's attention, at the batch that fit, held to its plain
    # versions (TRAIN_SHAPES holds each ladder's first batch)
    ladder_shapes = {key: (b, key[0]) + TRAIN_MAIN[2:]
                     for key, (b, _) in ladder_runs.items()}
    for shape in ladder_shapes.values():
        if shape not in train_rows:
            train_rows[shape] = train_kernel_row(shape, card)
    torch.cuda.empty_cache()
    decode_launches = timed("decode_ladder", decode_ladder_phase, card)
    timed("ctr", ctr_phase, card, profile)
    print(json.dumps({"phase": "seconds", **seconds,
                      "total": time.perf_counter() - t0}), flush=True)

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

    def shape_name(b, t, h, kv, causal, d):
        return (f"B{b} T{t} H{h} KV{kv} d{d} "
                f"{'causal' if causal else 'full'} bf16")

    # each training kernel three times: at the flagship's B4 T2048
    # (launches: the train phase's 5 steps) and at each ladder rung's
    # shape (launches: that rung's run); launches of every training path
    # beside them
    by_path = {"train (adamw, full remat, 5 steps)": train_counts,
               **{f"train_ladder {kind} T{t}": c
                  for (t, kind), (_, c) in ladder_runs.items()}}
    remat = {f"remat_policies {p} (1 step)": n for p, n in remat_lse.items()}
    trainers = []
    for shape, launched in ((TRAIN_MAIN, train_counts),
                            *((ladder_shapes[key], c)
                              for key, (_, c) in ladder_runs.items()
                              if key[1] == "bf16")):
        tr = train_rows[shape]
        for name, source, replaces, errs, ms, plain, library in (
                # with_lse=True: the fwd rule _flash_fwd (:363) of the
                # same kernel
                ("flash_fwd_lse", "flash_fwd.cu", "100", ["lse_max_abs_err"],
                 "flash_fwd_lse_ms", "plain_fwd_lse_ms", "library_fwd_ms"),
                # the plain backward and SDPA's backward each compute dq,
                # dk and dv in one call: their times stand beside both
                ("flash_bwd_dq", "flash_bwd.cu", "226", ["dq_max_abs_err"],
                 "flash_bwd_dq_ms", "plain_bwd_ms", "library_bwd_ms"),
                ("flash_bwd_dkv", "flash_bwd.cu", "287",
                 ["dk_max_abs_err", "dv_max_abs_err"], "flash_bwd_dkv_ms",
                 "plain_bwd_ms", "library_bwd_ms")):
            err = max(r[e] for r in list(train_rows.values())
                      + list(rows.values()) for e in errs if e in r)
            e = entry(name, source, replaces, launched[name], err, tr[ms],
                      tr[plain], (tr["bound_ms"][name], tr["bound_by"][name],
                                  tr["flops"][name]),
                      tr[library], shape_name(*shape))
            e["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
            if name == "flash_fwd_lse":
                e["launches_by_path"].update(remat)
            trainers.append(e)

    # the primal forward: at the slice's largest prefill (the
    # 1000-token prompt's bucket; launches: the slice's requests) and at
    # each decode rung's prefill shape (launches: that rung's bf16 and
    # int8 generates); launches of every serving path beside them
    primal_paths = {
        "slice (bf16)": launches,
        "obs (bf16, warm replay)": obs_launches,
        **{f"int8_serving {k}": n for k, n in int8_serve.items()},
        **{f"decode_ladder {w} b{b}": n
           for (w, b), n in decode_launches.items()}}
    primals = []
    for shape in (SLICE_MAIN, *DECODE_SHAPES):
        r = rows[shape]
        launched = (launches if shape == SLICE_MAIN else
                    sum(n for (_, b), n in decode_launches.items()
                        if b == shape[0]))
        err = (max(rows[k]["max_abs_err"] for k in KERNEL_SHAPES)
               if shape == SLICE_MAIN else r["max_abs_err"])
        e = entry("flash_fwd", "flash_fwd.cu", "100", launched, err,
                  r["kernel_ms"], r["ref_ms"],
                  (r["bound_ms"], r["bound_by"], r["flops"]),
                  r["library_ms"], shape_name(*shape))
        e["launches_by_path"] = primal_paths
        primals.append(e)
    summary = {"kernels": [*primals, *trainers]}
    print(json.dumps(summary), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
