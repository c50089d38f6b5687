#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds every kernel of the serving path from the sources in this
   checkout (``edl_tpu_torch/ops/csrc/*.cu``, nvcc, sm_90a).
2. Kernel phase: the flash-attention forward kernel against its plain
   PyTorch version (``flash_attention_ref``) on the card, bf16, B=1,
   H=32, KV=8, d=128 (Llama-3-8B's attention), T in {8, 128, 1024,
   1536, 2048}, causal and not. Tolerance: |kernel - plain| <=
   2e-2 + 2^-7 * |plain| elementwise — both round the output to bf16
   (one ulp is 2^-8 relative) and sum in different orders; the plain
   version runs on the kernel's 64 x 64 tiles so P is rounded against
   the same running maxima. Times (CUDA events, after warm-up, inputs
   left warm in L2 as a prefill leaves them) for the kernel, the plain
   version and ``scaled_dot_product_attention`` as a yardstick only.
3. Slice phase: Llama-3-8B at full width and depth, bf16,
   ``use_flash=True``, random weights from a seeded generator on the
   card, served through ``ContinuousBatchingEngine`` (8 slots x 2048
   positions, horizon 8): eight requests with prompts in the buckets
   8..1024, 32 new tokens each, half of them submitted after the first
   step. Checks: every outcome ``done``, zero recoveries, flash launches
   == prefills x 32 layers, and teacher-forced agreement — a dense
   forward over prompt + generated puts every chosen token within
   0.1 x (row std) of its row's maximum logit.

Prints one JSON line per phase, then ``{"kernels": [...]}``, then the
card's name and power limit, then ``{"ok": true, "device": ...}`` as
the last line. Any failure raises (non-zero exit); without CUDA it
exits 1 before printing any result. Needs one card.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TEACHER_EPS = 0.1  # chosen logit within EPS x row std of the row max
KERNEL_SHAPES = [(t, c) for t in (8, 128, 1024, 1536, 2048) for c in (True, False)]


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


def _bound(b, t, h, kv, d, causal):
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * d * h * b * pairs
    nbytes = 2.0 * (2 * b * t * h * d + 2 * b * t * kv * d)
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    b_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")


def kernel_phase(card):
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa

    rows = {}
    for t, causal in KERNEL_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(t + causal)
        q, k, v = (
            torch.randn(1, t, n, 128, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            for n in (32, 8, 8)
        )
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal, 64, 64)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        tol_ok = bool((diff <= 2e-2 + 2 ** -7 * want.float().abs()).all())
        if not (torch.isfinite(got.float()).all() and tol_ok):
            raise AssertionError(f"flash kernel disagrees at T={t} "
                                 f"causal={causal}: max abs err {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        kernel_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal), 20)
        ref_ms = _time_ms(
            lambda: fa.flash_attention_ref(q, k, v, causal, 64, 64), 3, 1)
        library_ms = _time_ms(lib, 20)
        bound_ms, bound_by = _bound(1, t, 32, 8, 128, causal)
        row = {
            "phase": "kernel", "kernel": "flash_fwd", "T": t,
            "causal": causal, "max_abs_err": err,
            "tol": "2e-2 + 2^-7*|plain|", "kernel_ms": kernel_ms,
            "ref_ms": ref_ms, "library_ms": library_ms,
            "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "card": card,
        }
        print(json.dumps(row), flush=True)
        rows[(t, causal)] = row
    return rows


def slice_phase(card):
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
    fa.launches = 0
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
    launches = fa.launches
    prefills = metrics.dispatches["prefill"] - prefills0

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
    return launches


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

    t0 = time.perf_counter()
    _build.build("flash_fwd")
    fa._kernel()
    print(json.dumps({"phase": "build", "kernels": ["flash_fwd"],
                      "build_s": time.perf_counter() - t0}), flush=True)

    rows = kernel_phase(card)
    launches = slice_phase(card)

    # the main path's largest prefill: the 1000-token prompt's bucket
    main = rows[(1024, True)]
    summary = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "edl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "edl_tpu/ops/flash_attention.py:100",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main["kernel_ms"],
        "plain_ms": main["ref_ms"],
        "bound_ms": main["bound_us"] / 1e3,
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": "B1 T1024 H32 KV8 d128 causal bf16",
    }]}
    print(json.dumps(summary), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
