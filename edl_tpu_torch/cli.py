"""``python -m edl_tpu_torch serve`` — the port of ``edl serve``
(``edl_tpu/cli/main.py``): the contiguous and paged KV caches, the
prefix cache, chunked prefill, quantized KV, speculative decoding and
weight-only int8 params (``--int8``).

Reads the same JSONL request feed and the same export directory as the
reference verb and prints the same per-request JSON records on stdout
(submit order): ``id``, ``tokens``, ``outcome``, ``ttft_s``,
``tokens_per_s``, or ``outcome: rejected:<reason>`` with ``error``. The
final serving metrics snapshot goes to stderr as one JSON line. Runs on
CUDA unless ``--device cpu``. ``--metrics-port P`` serves ``/metrics``,
``/trace``, ``/events`` and ``/healthz`` on loopback while serving (0 =
ephemeral; the bound URL prints on stderr as ``# metrics endpoint
URL/metrics``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# flags of the reference verb whose serving paths are not ported yet
_NOT_PORTED_FLAGS = {
    "mesh": ("--mesh", ""),
}


def _read_serve_requests(
    path: str, default_max_new: int, default_eos, default_deadline_s=None
):
    """Parse the JSONL request feed (``-`` = stdin): one object per
    line, ``{"prompt": [ids], "id"?, "max_new"?, "eos"?, "deadline_s"?,
    "tenant"?, "slo_class"?}``. Returns a list of dicts or raises
    ValueError — parsed BEFORE the export loads."""
    if path == "-":
        lines = sys.stdin.read().splitlines()
    else:
        with open(path) as f:
            lines = f.read().splitlines()
    out = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"line {i + 1}: not JSON ({e})")
        if not isinstance(obj, dict) or "prompt" not in obj:
            raise ValueError(f'line {i + 1}: need an object with "prompt"')
        prompt = obj["prompt"]
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt
        ):
            raise ValueError(f"line {i + 1}: prompt must be a list of ints")
        eos = obj.get("eos", default_eos)
        dl = obj.get("deadline_s", default_deadline_s)
        tenant = obj.get("tenant")
        slo_class = obj.get("slo_class")
        out.append(
            {
                "id": str(obj.get("id", f"req-{i + 1}")),
                "prompt": prompt,
                "max_new": int(obj.get("max_new", default_max_new)),
                "eos": None if eos is None or int(eos) < 0 else int(eos),
                "deadline_s": (
                    None if dl is None or float(dl) <= 0 else float(dl)
                ),
                "tenant": None if tenant is None else str(tenant),
                "slo_class": None if slo_class is None else str(slo_class),
            }
        )
    if not out:
        raise ValueError("no requests in the feed")
    return out


def _load_llama_serving(export_dir: str, device: str, int8: bool = False):
    """(params, cfg) of a published llama export held in ``cfg.dtype``
    on ``device``, or (None, errmsg). ``int8`` quantizes the weights as
    stored (the reference quantizes the loaded export) into the
    weight-only records on the device, then casts the dense leaves."""
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.runtime.export import export_status, load_export

    doc = export_status(export_dir)
    if doc is None:
        return None, f"no published export under {export_dir}"
    model = doc.get("model") or {}
    if model.get("family") != "llama":
        return None, (
            f"export has no llama architecture record "
            f"(model={model or None}); re-export with model_meta "
            f"(LlamaConfig.to_meta())"
        )
    try:
        cfg = llama.LlamaConfig.from_meta(model)
    except ValueError as e:
        return None, str(e)
    if not int8:
        params, _ = load_export(export_dir, device=device, dtype=cfg.dtype)
        return params, cfg
    params, _ = load_export(export_dir, device=device)
    params = llama.quantize_params_int8(params)
    params["embed"] = params["embed"].to(cfg.dtype)
    params["ln_f"] = params["ln_f"].to(cfg.dtype)
    for k in ("ln1", "ln2"):
        params["layers"][k] = params["layers"][k].to(cfg.dtype)
    return params, cfg


def run_serve(args) -> int:
    """Continuous-batching serving from a published export."""
    if args.int8 and args.mesh:
        # the reference's check (its int8 records carry no pspecs)
        print("--int8 and --mesh are mutually exclusive", file=sys.stderr)
        return 1
    for attr, (flag, off) in _NOT_PORTED_FLAGS.items():
        if getattr(args, attr) != off:
            print(f"{flag} is not ported yet (ROADMAP Queue A)",
                  file=sys.stderr)
            return 1
    if args.temperature < 0:
        print(f"temperature must be >= 0, got {args.temperature}",
              file=sys.stderr)
        return 1
    if args.max_slots < 1:
        print(f"--max-slots must be >= 1, got {args.max_slots}",
              file=sys.stderr)
        return 1
    if args.max_len < 2:
        print(f"--max-len must be >= 2, got {args.max_len}", file=sys.stderr)
        return 1
    if args.horizon < 1:
        print(f"--horizon must be >= 1, got {args.horizon}", file=sys.stderr)
        return 1
    if args.max_recoveries < 0:
        print(f"--max-recoveries must be >= 0, got {args.max_recoveries}",
              file=sys.stderr)
        return 1
    if args.block_size < 0:
        print(f"--block-size must be >= 0, got {args.block_size}",
              file=sys.stderr)
        return 1
    if args.block_size and args.max_len % args.block_size != 0:
        print(f"--max-len {args.max_len} must be a multiple of "
              f"--block-size {args.block_size}", file=sys.stderr)
        return 1
    if (args.prefix_cache or args.prefill_chunk) and not args.block_size:
        print("--prefix-cache/--prefill-chunk require --block-size > 0",
              file=sys.stderr)
        return 1
    if args.kv_quant != "off" and not args.block_size:
        print("--kv-quant requires the paged KV cache (--block-size > 0)",
              file=sys.stderr)
        return 1
    if args.spec_k < 0:
        print(f"--spec-k must be >= 0, got {args.spec_k}", file=sys.stderr)
        return 1
    if args.spec_k > 0 and args.temperature > 0:
        print("--spec-k > 0 requires greedy decoding (temperature 0), "
              f"got --temperature {args.temperature}", file=sys.stderr)
        return 1
    if args.spec_ngram < 1:
        print(f"--spec-ngram must be >= 1, got {args.spec_ngram}",
              file=sys.stderr)
        return 1
    try:
        requests = _read_serve_requests(
            args.requests, args.max_new,
            None if args.eos < 0 else args.eos,
            None if args.deadline_s <= 0 else args.deadline_s,
        )
    except (OSError, ValueError) as e:
        print(f"bad request feed: {e}", file=sys.stderr)
        return 1
    from edl_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    params, cfg_or_err = _load_llama_serving(args.export_dir, device,
                                             args.int8)
    if params is None:
        print(cfg_or_err, file=sys.stderr)
        return 1
    cfg = cfg_or_err

    from edl_tpu_torch.serving import (
        AdmissionError,
        InterleavePolicy,
        RequestQueue,
        ServingMetrics,
    )
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine

    queue = RequestQueue(
        max_total_len=args.max_len,
        max_depth=args.max_queue,
        max_prompt_len=args.max_prompt,
        max_new_cap=args.max_new_cap,
    )
    metrics = ServingMetrics()
    engine = ContinuousBatchingEngine(
        params, cfg,
        max_slots=args.max_slots,
        max_len=args.max_len,
        horizon=args.horizon,
        queue=queue,
        metrics=metrics,
        policy=InterleavePolicy(prefills_per_step=args.prefills_per_step),
        temperature=args.temperature,
        seed=args.seed,
        max_recoveries=args.max_recoveries,
        block_size=args.block_size,
        pool_blocks=args.pool_blocks or None,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk,
        kv_quant=args.kv_quant,
        spec_k=args.spec_k,
        spec_ngram=args.spec_ngram,
        spec_min_accept=args.spec_min_accept,
        device=device,
    )
    exporter = None
    if args.metrics_port is not None:
        # the obs endpoint: /metrics (Prometheus text incl. the TTFT/ITL
        # histograms this engine records), /trace (the engine's dispatch
        # / drain / prefill spans), /events, /healthz
        from edl_tpu_torch import obs

        obs.bridge_tracer()
        exporter = obs.start_exporter(port=args.metrics_port)
        print(f"# metrics endpoint {exporter.url}/metrics", file=sys.stderr,
              flush=True)
    rejected = {}
    for r in requests:
        try:
            engine.submit(r["id"], r["prompt"], r["max_new"], r["eos"],
                          deadline_s=r["deadline_s"],
                          tenant=r["tenant"], slo_class=r["slo_class"])
        except AdmissionError as e:
            rejected[r["id"]] = e
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        if args.metrics_every and steps % args.metrics_every == 0:
            print("# serving " + json.dumps(metrics.snapshot()),
                  file=sys.stderr, flush=True)
    for r in requests:
        rid = r["id"]
        if rid in rejected:
            e = rejected[rid]
            rec = {"id": rid, "outcome": f"rejected:{e.reason}",
                   "error": str(e)}
        else:
            res = engine.results[rid]
            stats = metrics.request_stats(rid)
            rec = {
                "id": rid,
                "tokens": res.tokens,
                "outcome": res.outcome,
                "ttft_s": round(stats["ttft_s"], 6),
                "tokens_per_s": round(stats["tokens_per_s"], 3),
            }
        print(json.dumps(rec))
    print("# serving " + json.dumps(metrics.snapshot()), file=sys.stderr)
    if exporter is not None:
        exporter.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch",
        description="PyTorch/CUDA port of the edl serving path",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser(
        "serve",
        help="continuous-batching serving from a published llama export "
        "(JSONL requests in, JSONL completions out, metrics on stderr)",
    )
    sv.add_argument("export_dir")
    sv.add_argument("--requests", default="-",
                    help='JSONL request feed ("-" = stdin)')
    sv.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sv.add_argument("--max-slots", type=int, default=8)
    sv.add_argument("--max-len", type=int, default=256)
    sv.add_argument("--horizon", type=int, default=1)
    sv.add_argument("--max-queue", type=int, default=64)
    sv.add_argument("--max-prompt", type=int, default=0)
    sv.add_argument("--max-new-cap", type=int, default=0)
    sv.add_argument("--max-new", type=int, default=16)
    sv.add_argument("--deadline-s", type=float, default=0.0)
    sv.add_argument("--max-recoveries", type=int, default=2)
    sv.add_argument("--eos", type=int, default=-1)
    sv.add_argument("--prefills-per-step", type=int, default=1)
    sv.add_argument("--temperature", type=float, default=0.0)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--metrics-every", type=int, default=0)
    sv.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose /metrics (Prometheus: TTFT/ITL histograms, "
        "dispatch counters, queue gauge), /trace (chrome-trace JSON), "
        "/events and /healthz on this port while serving (0 = "
        "ephemeral; the bound URL prints on stderr)",
    )
    sv.add_argument(
        "--block-size", type=int, default=0,
        help="paged KV cache: tokens per KV block (0 = contiguous "
        "per-slot cache; must divide --max-len)",
    )
    sv.add_argument(
        "--pool-blocks", type=int, default=0,
        help="paged KV cache: physical blocks in the pool incl. the "
        "scratch block (0 = max-slots * max-len/block-size + 1)",
    )
    sv.add_argument(
        "--prefix-cache", action="store_true",
        help="paged KV cache: share full prompt-prefix blocks between "
        "requests (refcounted; copy-on-write at divergence)",
    )
    sv.add_argument(
        "--prefill-chunk", type=int, default=0,
        help="paged KV cache: prefill long prompts in chunks of at most "
        "this many tokens between decode blocks (0 = one dispatch)",
    )
    sv.add_argument(
        "--kv-quant", choices=("off", "int8", "int4"), default="off",
        help="paged KV cache: store K/V as int8 (or packed int4) with "
        "per-block-per-head f32 scales; requires --block-size > 0",
    )
    sv.add_argument(
        "--spec-k", type=int, default=0,
        help="speculative decoding: n-gram draft tokens verified per "
        "decode dispatch (0 = off); requires --temperature 0",
    )
    sv.add_argument(
        "--spec-ngram", type=int, default=3,
        help="longest suffix n-gram the prompt-lookup drafter matches",
    )
    sv.add_argument(
        "--spec-min-accept", type=float, default=0.0,
        help="per-request acceptance floor below which a request stops "
        "drafting after warm-up (0 = always draft)",
    )
    sv.add_argument(
        "--int8", action="store_true",
        help="weight-only int8: quantize the projection weights and "
        "lm_head per output column on load (halves the weight bytes a "
        "decode step streams)",
    )
    # the reference verb's flag for a serving path not ported yet:
    # accepted so a reference command line fails with a clear message
    sv.add_argument("--mesh", default="")
    sv.set_defaults(fn=run_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
