"""Time the flash-attention kernels, forward and backward, of one or more
checkouts on one card, for comparing a kernel change with its parent in
one call.

    python -m edl_tpu_torch.ops.bench_flash [CHECKOUT ...]

Each CHECKOUT (default: the working directory) is a directory that holds
an ``edl_tpu_torch`` package; each runs in its own process, which builds
that package's kernels and prints one JSON line: for every shape, each
kernel's device time a call (:func:`device_ms`: 50 calls queued behind
a sleep kernel, timed with CUDA events, host overhead excluded;
``chip_smoke.py`` times its kernels the same way) and TF/s (FLOPs a
live pair a query head: 4·d for the forward, 6·d for dQ, 8·d for
dK/dV), and ``scaled_dot_product_attention``'s device time as the
yardstick (for the backward shapes, its ``backward``: dq, dk and dv in
one call). Give the checkouts in turns (parent, change, change, parent)
to see the spread. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# name: (B, T, H, KV, d, causal, kind): "lse" the lse forward, "fwd" the
# primal forward, "bwd" the dQ and dK/dV sweeps. The first three are the
# main path's shapes (training's lse forward and backward, the serving
# slice's prefill)
SHAPES = {
    "lse_B4_T2048_H16_KV8_causal": (4, 2048, 16, 8, 128, True, "lse"),
    "bwd_B4_T2048_H16_KV8_causal": (4, 2048, 16, 8, 128, True, "bwd"),
    "fwd_B1_T1024_H32_KV8_causal": (1, 1024, 32, 8, 128, True, "fwd"),
    "fwd_B1_T2048_H32_KV8_causal": (1, 2048, 32, 8, 128, True, "fwd"),
    "lse_B4_T2048_H16_KV8_full": (4, 2048, 16, 8, 128, False, "lse"),
    "bwd_B4_T2048_H16_KV8_full": (4, 2048, 16, 8, 128, False, "bwd"),
    "fwd_B1_T1024_H32_KV8_causal_d64": (1, 1024, 32, 8, 64, True, "fwd"),
}


def device_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time a call of ``fn``: CUDA events around ``iters`` calls
    that the host has queued behind a sleep kernel, so the card runs them
    back to back without waiting on the host. The host's launch overhead
    is not in it; the card's own gap between two queued kernels is."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # the host's time to queue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the stream for twice the host's queueing time (cycles at up to
    # 2 GHz), so every call is queued before the card reaches the first
    torch.cuda._sleep(int((2.0 * host_s * iters + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_here() -> dict:
    """Times of the package this process imported."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.ops import flash_attention as fa

    res = {"checkout": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(fa.__file__)))),
        "card": torch.cuda.get_device_name(0)}
    for name, (b, t, h, kv, d, causal, kind) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(b, t, h, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, t, kv, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = d * h * b * pairs  # a FLOP a live pair, d wide
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        if kind == "bwd":
            do = torch.randn(b, t, h, d, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
            out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
            delta = fa._delta(out, do).contiguous()
            dq_ms = device_ms(lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, causal))
            dkv_ms = device_ms(lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, causal))
            lib_out = sdpa()
            dot = do.transpose(1, 2)
            res[name] = {
                "dq_ms": dq_ms, "dq_tflops": 6.0 * flops / dq_ms / 1e9,
                "dkv_ms": dkv_ms, "dkv_tflops": 8.0 * flops / dkv_ms / 1e9,
                "sdpa_bwd_ms": device_ms(lambda: torch.autograd.grad(
                    lib_out, (qt, kt, vt), dot, retain_graph=True))}
            continue
        call = (fa.flash_attention_lse_cuda if kind == "lse"
                else fa.flash_attention_cuda)
        with torch.no_grad():
            ms = device_ms(lambda: call(q, k, v, causal))
            res[name] = {"ms": ms, "tflops": 4.0 * flops / ms / 1e9,
                         "sdpa_ms": device_ms(sdpa)}
    return res


def main(argv) -> int:
    if argv and argv[0] == "--here":
        print(json.dumps(run_here()), flush=True)
        return 0
    for checkout in argv or [os.getcwd()]:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
        # this file runs as a script, so a checkout without it (a parent)
        # is timed all the same; its package comes from PYTHONPATH
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--here"], env=env,
                            cwd=os.path.abspath(checkout)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
