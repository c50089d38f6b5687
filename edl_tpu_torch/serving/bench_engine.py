"""Time the serving engine of one or more checkouts on one card, for
comparing an engine change (its host work a decode block) with its
parent in one call.

    python -m edl_tpu_torch.serving.bench_engine [--runs N] CHECKOUT...

Each CHECKOUT is a directory that holds an ``edl_tpu_torch`` package.
Every run is its own process with that checkout first on the path: it
builds the checkout's flash forward kernel, makes Llama-3-8B (32
layers, full width, bf16, ``use_flash``, random weights from seed 0) on
the card and serves ``chip_smoke.py``'s slice feed through
``ContinuousBatchingEngine`` (8 slots x 2048 positions, horizon 8): a
warm-up request, then ``REPS`` times the eight requests (prompts of 5
to 1000 tokens, 32 new each, half of them submitted after the first
step). Per rep it prints tokens/s over the rep's wall time and the host
milliseconds a decode block: the mean wall time of the engine's
``_dispatch_block`` (queueing the block's kernels; the card runs behind
it) and of ``_drain_one`` (waiting for the oldest block and replaying
its tokens into the host bookkeeping). An engine with the observability
hooks also gets ``hooks_us_per_block``: the host microseconds of one
decode block's hook calls, timed alone over many repeats (the dispatch
and drain spans, the ``serve.block`` event, both fault checks, the
efficiency observation and a step's ledger update). The runs alternate
between the checkouts (A B, B A, A B, ...) so that a drift of the card
or host between runs does not favour one; the last line is a summary by
checkout. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPS = 2  # measured reps a run, after the warm-up request
SLICE_LENS = (5, 12, 30, 60, 100, 250, 500, 1000)  # chip_smoke's slice
SLICE_NEW = 32


def _slice_requests(vocab):
    import numpy as np

    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in SLICE_LENS]


def run_here() -> dict:
    """One run of the package this process imported."""
    import dataclasses

    import torch

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.ops import _build
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.metrics import ServingMetrics

    _build.build_all(["flash_fwd"])
    fa._kernel("flash_fwd_bf16")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), use_flash=True)
    params = llama.init_params(cfg, seed=0, device="cuda")
    eng = ContinuousBatchingEngine(
        params, cfg, max_slots=8, max_len=2048, horizon=8,
        metrics=ServingMetrics(registry=MetricsRegistry()), device="cuda",
    )
    spent = {"_dispatch_block": [], "_drain_one": []}

    def timed(name):
        fn = getattr(eng, name)

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name].append(time.perf_counter() - t)

        setattr(eng, name, run)

    for name in spent:
        timed(name)
    prompts = _slice_requests(cfg.vocab)
    eng.submit("warmup", prompts[0], 2)
    eng.run()
    reps = []
    for rep in range(REPS):
        for v in spent.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(4):
            eng.submit(f"{rep}r{i}", prompts[i], SLICE_NEW)
        eng.step()
        for i in range(4, 8):
            eng.submit(f"{rep}r{i}", prompts[i], SLICE_NEW)
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = sum(len(res[f"{rep}r{i}"].tokens) for i in range(8))
        if toks != 8 * SLICE_NEW or eng.recoveries:
            raise AssertionError(f"rep {rep}: {toks} tokens, "
                                 f"{eng.recoveries} recoveries")
        d, r = spent["_dispatch_block"], spent["_drain_one"]
        reps.append({
            "tokens_per_s": toks / wall, "wall_s": wall, "blocks": len(d),
            "dispatch_ms": 1e3 * sum(d) / len(d),
            "drain_ms": 1e3 * sum(r) / len(r),
        })
    out = {"checkout": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(fa.__file__)))),
        "card": torch.cuda.get_device_name(0), "reps": reps}
    if hasattr(eng, "_eff"):
        out["hooks_us_per_block"] = _hooks_us(eng)
    return out


def _hooks_us(eng, n: int = 5000) -> float:
    """Host microseconds of one decode block's hook calls, as the engine
    makes them, repeated ``n`` times."""
    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.utils import faults, tracing

    t = time.perf_counter()
    for _ in range(n):
        rids = [f"r{i}" for i in range(eng.max_slots)]
        with tracing.span("serving.dispatch", horizon=eng.horizon,
                          rids=rids):
            pass
        flight.emit("serve.block", active=eng.max_slots,
                    horizon=eng.horizon)
        faults.fault_point("serve.dispatch")
        with tracing.span("serving.drain", rids=rids):
            faults.fault_point("serve.drain")
        eng._eff.observe("decode", eng._block_cost, 0.25)
        eng._ledger.set_kv_usage(eng._ledger_owner, 1000,
                                 eng.max_slots * eng.max_len)
    return (time.perf_counter() - t) / n * 1e6


def main(argv) -> int:
    if argv and argv[0] == "--here":
        print(json.dumps(run_here()), flush=True)
        return 0
    runs = 3
    if argv[:1] == ["--runs"]:
        runs, argv = int(argv[1]), argv[2:]
    checkouts = [os.path.abspath(c) for c in argv or [os.getcwd()]]
    by = {c: [] for c in checkouts}
    for i in range(runs):
        for c in (checkouts if i % 2 == 0 else checkouts[::-1]):
            env = dict(os.environ, PYTHONPATH=c)
            # run as a script, so a checkout without this file (a parent)
            # is timed all the same; its package comes from PYTHONPATH
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--here"],
                env=env, cwd=c, capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stderr)
                return out.returncode
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec["run"] = i
            print(json.dumps(rec), flush=True)
            by[c].append(rec["reps"])
    print(json.dumps({"summary": {
        c: {key: [[r[key] for r in reps] for reps in runs_]
            for key in ("tokens_per_s", "dispatch_ms", "drain_ms")}
        for c, runs_ in by.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
