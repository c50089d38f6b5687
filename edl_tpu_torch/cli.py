"""``python -m edl_tpu_torch serve``, ``predict``, ``loadgen`` and
``fleet`` — the ports of the reference's verbs (``edl_tpu/cli/main.py``).

``serve``: the contiguous and paged KV caches, the prefix cache, chunked
prefill, quantized KV, speculative decoding and weight-only int8 params
(``--int8``). ``--mesh`` is not ported yet.

``predict``: scores an ``.npz`` of rows against a published export of
any ported family (ctr, resnet, bert, llama) and prints the reference
verb's summary line (``predicted N rows (family=F, step=S) metric=v
...``); ``--out`` writes the per-row outputs to an ``.npz``. Not ported
yet: ``--mesh``, ``--data-dir`` and the moe family, each exit 1 with
"not ported yet".

``loadgen``: a seeded arrival-process workload (``serving/loadgen.py``)
replayed on the wall clock against the engine, scored as goodput under
SLO (``obs/slo.py``); ``--workload-only`` writes the workload without a
device, ``--json`` prints the report as one object, ``--tsdb-dir``
records the metric history that ``--metrics-port`` serves on
``/history``. ``--mesh`` is not ported yet.

``fleet``: N replica subprocesses (``python -m edl_tpu_torch fleet
--replica``) behind the router (``serving/{replica,router,fleet}.py``):
the demo routes ``--requests`` through them, ``--swap`` rolls the
weight generation mid-traffic, and the report line carries ``ok`` and
the READY floor ``min_ready``. ``--warm-from p2p`` is not ported yet.

``serve`` reads the same JSONL request feed and the same export directory as the
reference verb and prints the same per-request JSON records on stdout
(submit order): ``id``, ``tokens``, ``outcome``, ``ttft_s``,
``tokens_per_s``, or ``outcome: rejected:<reason>`` with ``error``. The
final serving metrics snapshot goes to stderr as one JSON line. Every
verb that serves runs on CUDA unless ``--device cpu`` (``fleet``: its
replicas). ``--metrics-port P`` serves ``/metrics``, ``/trace``,
``/events`` and ``/healthz`` on loopback while serving (0 = ephemeral;
the bound URL prints on stderr as ``# metrics endpoint URL/metrics``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
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


def run_predict(args) -> int:
    """Score a batch of rows against a published export — the serving
    consumer for every family. Family dispatch, input decoding and the
    chunked forwards live in runtime/predict.py; this verb is argument
    plumbing, with the reference verb's messages and return codes."""
    import numpy as np

    from edl_tpu_torch.runtime.predict import (load_params_for_predict,
                                               load_rows, predict_batch)
    from edl_tpu_torch.utils.device import resolve_device

    if args.mesh:
        print("--mesh is not ported yet (ROADMAP Queue A)", file=sys.stderr)
        return 1
    try:
        rows = load_rows(args.input, args.data_dir, n_rows=args.rows)
    except (ValueError, FileNotFoundError) as e:
        print(f"bad input: {e}", file=sys.stderr)
        return 1
    except NotImplementedError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        device = resolve_device(args.device)
        params, doc = load_params_for_predict(args.export_dir, device=device)
    except (FileNotFoundError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"predict failed: {e}", file=sys.stderr)
        return 1
    try:
        out = predict_batch(params, doc, rows)
    except (ValueError, NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 1
    family = (doc.get("model") or {}).get("family")
    arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
    metrics = {k: v for k, v in out.items() if not isinstance(v, np.ndarray)}
    n = len(next(iter(arrays.values()))) if arrays else 0
    summary = " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items()))
    print(
        f"predicted {n} rows (family={family}, step={doc['step']})"
        + (f" {summary}" if summary else "")
    )
    if args.out:
        np.savez(args.out, **arrays)
        print(f"outputs -> {args.out}")
    else:
        for k, v in sorted(arrays.items()):
            head = np.asarray(v).reshape(len(v), -1)[:8, 0]
            print(f"{k}[:8] = {head.tolist()}")
    return 0


def _check_loadgen_scrape(exporter) -> None:
    """The exposition contract of the dryrun loadgen lane: after the
    load the scraped /metrics must show the latency DECOMPOSITION
    histograms non-zero (queue wait / prefill / block) plus TPOT and
    the live SLO burn gauges."""
    from edl_tpu_torch import obs

    text = obs.scrape(exporter.url)
    fams = obs.parse_prometheus_text(text)

    def total(series):
        return sum(v for _, v in fams.get(series, ()))

    for series in (
        "edl_serving_queue_wait_seconds_count",
        "edl_serving_prefill_seconds_count",
        "edl_serving_block_seconds_count",
        "edl_serving_tpot_seconds_count",
    ):
        assert total(series) > 0, f"{series} has no observations"
    classes = [
        labels.get("slo_class")
        for labels, _ in fams.get("edl_slo_ttft_ok_ratio", ())
        if labels.get("slo_class")
    ]
    assert classes, "no per-class edl_slo_ttft_ok_ratio gauges published"
    assert total("edl_slo_ttft_ok_ratio") > 0, (
        "TTFT SLO attainment is zero for every class — the dryrun "
        "deadlines should be attainable on CPU"
    )
    out_n = sum(
        v for labels, v in fams.get("edl_serving_outcomes_total", ())
        if labels.get("tenant")
    )
    assert out_n > 0, "outcome counter carries no tenant labels"
    print(
        f"loadgen scrape OK: decomposition histograms non-zero, "
        f"slo classes {sorted(set(classes))}",
        file=sys.stderr,
    )


def run_loadgen(args) -> int:
    """Generate a seeded arrival-process workload (serving/loadgen.py)
    and replay it wall-clock against a live continuous-batching engine,
    then report GOODPUT-UNDER-SLO (obs/slo.py): per-class TTFT/ITL
    attainment, goodput req/s, shed/timeout accounting, and the
    per-phase (queue-wait / prefill / decode) p50/p95/p99 breakdown.
    ``--dryrun`` serves a tiny randomly-initialized model (no export
    needed); ``--workload-only`` generates and writes the workload
    without touching a device (the same-seed byte-identity check)."""
    # argv-only validation first (same contract as run_serve)
    for attr, (flag, off) in _NOT_PORTED_FLAGS.items():
        if getattr(args, attr) != off:
            print(f"{flag} is not ported yet (ROADMAP Queue A)",
                  file=sys.stderr)
            return 1
    if args.speed <= 0:
        print(f"--speed must be > 0, got {args.speed}", file=sys.stderr)
        return 1
    if args.requests < 0:
        print(f"--requests must be >= 0, got {args.requests}", file=sys.stderr)
        return 1
    if args.horizon < 1:
        print(f"--horizon must be >= 1, got {args.horizon}", file=sys.stderr)
        return 1
    if args.ttft_slo <= 0 or args.itl_slo <= 0:
        print("--ttft-slo/--itl-slo must be > 0", file=sys.stderr)
        return 1
    if not 0.0 <= args.shared_prefix <= 1.0:
        print(f"--shared-prefix must be in [0, 1], got "
              f"{args.shared_prefix}", file=sys.stderr)
        return 1
    if args.shared_prefix_len < 1:
        print(f"--shared-prefix-len must be >= 1, got "
              f"{args.shared_prefix_len}", file=sys.stderr)
        return 1
    if not 0.0 <= args.repetition <= 1.0:
        print(f"--repetition must be in [0, 1], got {args.repetition}",
              file=sys.stderr)
        return 1
    if args.repetition_len < 1:
        print(f"--repetition-len must be >= 1, got {args.repetition_len}",
              file=sys.stderr)
        return 1
    if args.spec_k < 0:
        print(f"--spec-k must be >= 0, got {args.spec_k}", file=sys.stderr)
        return 1
    if args.block_size < 0:
        print(f"--block-size must be >= 0, got {args.block_size}",
              file=sys.stderr)
        return 1
    if args.kv_quant != "off" and not args.block_size:
        print("--kv-quant requires the paged KV cache (--block-size > 0)",
              file=sys.stderr)
        return 1
    if not (args.dryrun or args.workload_only or args.export_dir):
        print("error: need an EXPORT_DIR, --dryrun, or --workload-only",
              file=sys.stderr)
        return 1

    from edl_tpu_torch.obs import slo
    from edl_tpu_torch.serving import loadgen

    auto_small = args.dryrun or args.workload_only
    n_requests = args.requests or (16 if auto_small else 64)
    rate = args.rate or (12.0 if auto_small else 4.0)
    classes = slo.default_classes(args.ttft_slo, args.itl_slo)

    params = cfg = device = None
    if not args.workload_only:
        from edl_tpu_torch.utils.device import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 1
    if args.dryrun:
        from edl_tpu_torch.models import llama

        cfg = llama.LlamaConfig.tiny(vocab=args.vocab)
        params = llama.init_params(cfg, seed=1, device=device)
    elif not args.workload_only:
        params, cfg_or_err = _load_llama_serving(
            args.export_dir, device, args.int8
        )
        if params is None:
            print(cfg_or_err, file=sys.stderr)
            return 1
        cfg = cfg_or_err

    spec = loadgen.WorkloadSpec(
        seed=args.seed,
        n_requests=n_requests,
        rate_rps=rate,
        arrival=args.arrival,
        burst_factor=args.burst_factor,
        burst_dwell_s=args.burst_dwell_s,
        vocab=cfg.vocab if cfg is not None else args.vocab,
        shared_prefix_frac=args.shared_prefix,
        shared_prefix_len=args.shared_prefix_len,
        repetition_frac=args.repetition,
        repetition_len=args.repetition_len,
        classes=classes,
    )
    try:
        reqs = loadgen.build(spec)
    except ValueError as e:
        print(f"bad workload spec: {e}", file=sys.stderr)
        return 1
    if args.workload_out:
        with open(args.workload_out, "w") as f:
            f.write(loadgen.workload_jsonl(reqs))
        print(
            f"# workload -> {args.workload_out} ({len(reqs)} requests)",
            file=sys.stderr,
        )
    if args.workload_only:
        print(json.dumps({
            "requests": len(reqs), "seed": spec.seed,
            "arrival": spec.arrival, "rate_rps": spec.rate_rps,
            "span_s": round(reqs[-1].arrive_s, 6) if reqs else 0.0,
        }))
        return 0

    slots = args.slots or (4 if args.dryrun else 8)
    max_len = args.max_len or (96 if args.dryrun else 256)
    if args.block_size and max_len % args.block_size != 0:
        print(f"max length {max_len} must be a multiple of --block-size "
              f"{args.block_size}", file=sys.stderr)
        return 1
    need = loadgen.max_total_len(reqs)
    if need > max_len:
        print(
            f"# NOTE: longest request needs {need} tokens > --max-len "
            f"{max_len}; oversize requests will shed at admission",
            file=sys.stderr,
        )

    from edl_tpu_torch.obs.metrics import MetricsRegistry
    from edl_tpu_torch.serving import AdmissionError, ServingMetrics
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine

    tsdb_db = None
    if args.tsdb_dir:
        from edl_tpu_torch.obs.tsdb import TSDB

        tsdb_db = TSDB(args.tsdb_dir)
        print(f"# metric history -> {args.tsdb_dir}", file=sys.stderr)
    exporter = None
    if args.metrics_port is not None:
        from edl_tpu_torch import obs

        obs.bridge_tracer()
        exporter = obs.start_exporter(port=args.metrics_port,
                                      history=tsdb_db)
        print(f"# metrics endpoint {exporter.url}/metrics", file=sys.stderr,
              flush=True)

    def make_engine(metrics):
        return ContinuousBatchingEngine(
            params, cfg, max_slots=slots, max_len=max_len,
            horizon=args.horizon, metrics=metrics, spec_k=args.spec_k,
            block_size=args.block_size, kv_quant=args.kv_quant,
            device=device,
        )

    if not args.no_warmup:
        # one throwaway pass over the workload (kernel loads, the
        # workload's prefill buckets, allocator growth) so the measured
        # replay holds serving time. The warm engine records into a
        # PRIVATE registry: its traffic must not pollute /metrics.
        warm = make_engine(ServingMetrics(registry=MetricsRegistry()))
        for r in reqs:
            try:
                warm.submit(r.rid, r.prompt, r.max_new)
            except AdmissionError:
                pass
        warm.run()
        del warm
        from edl_tpu_torch.obs import compilewatch
        from edl_tpu_torch.ops import flash_attention

        compilewatch.mark_warm()
        # nor its kernel launches: edl_kernel_launches counts the
        # measured replay's
        flash_attention.reset_launches()

    metrics = ServingMetrics()
    engine = make_engine(metrics)
    cmap = spec.class_map()
    t0 = time.monotonic()

    def refresh_gauges():
        # live burn-rate view: the exporter's SLO gauges track the run
        # as it happens. --slo-window scopes attainment to requests that
        # finished in the trailing window, so the gauges RECOVER once a
        # latency incident ends. Nothing is published/recorded before
        # the first finished request: "no traffic yet" must read as no
        # data, not as 0% attainment.
        now_m = time.monotonic()
        since = now_m - args.slo_window if args.slo_window > 0 else None
        recs = slo.request_records(metrics, since_s=since)
        if not recs:
            return
        wall = min(args.slo_window, now_m - t0) if since else now_m - t0
        slo.update_gauges(slo.compute_goodput(recs, cmap, wall))
        if tsdb_db is not None:
            from edl_tpu_torch.obs.metrics import default_registry

            tsdb_db.append(default_registry().snapshot())

    res = loadgen.replay(
        engine, reqs, speed=args.speed,
        on_tick=(refresh_gauges
                 if (exporter is not None or tsdb_db is not None)
                 else None),
    )
    report = slo.compute_goodput(
        slo.request_records(metrics), cmap, res["wall_s"]
    )
    report["steps"] = res["steps"]
    # total emitted tokens (quantization must not change termination)
    report["tokens_out"] = metrics.snapshot().get("tokens_out", 0.0)
    report["workload"] = {
        "seed": spec.seed, "arrival": spec.arrival,
        "rate_rps": spec.rate_rps, "requests": len(reqs),
        "speed": args.speed,
        "block_size": args.block_size, "kv_quant": args.kv_quant,
    }
    if args.spec_k > 0:
        # acceptance rate and tokens landed per decode-phase dispatch
        snap = metrics.snapshot()
        decode_d = snap["dispatches_verify"] + snap["dispatches_decode"]
        report["spec"] = {
            "spec_k": args.spec_k,
            "drafted": snap["spec_drafted"],
            "accepted": snap["spec_accepted"],
            "acceptance_rate": snap["spec_acceptance_rate"],
            "dispatches_verify": snap["dispatches_verify"],
            "tokens_per_decode_dispatch": (
                snap["tokens_out"] / decode_d if decode_d else 0.0
            ),
        }
    slo.update_gauges(report)
    if tsdb_db is not None:
        tsdb_db.flush()  # close open downsample buckets for readers
    if args.dryrun and exporter is not None:
        try:
            _check_loadgen_scrape(exporter)
        except AssertionError as e:
            print(f"LOADGEN SCRAPE FAIL: {e}", file=sys.stderr)
            exporter.stop()
            return 1
    if exporter is not None:
        exporter.stop()
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(slo.render_report(report))
    return 0


def _run_fleet_replica(args) -> int:
    """Internal replica mode: one serving engine behind the replica HTTP
    surface, port published through ``--port-file`` so the supervisor
    can find the ephemeral bind. This is the subprocess the supervisor
    launches — a user never runs it by hand."""
    import os
    import signal
    import threading

    # wall-clock stamps of the boot's stages, printed once the replica
    # serves (what a replica's start-up spends its time on)
    boot = {"main": time.time()}
    import torch

    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.serving.replica import ReplicaServer
    from edl_tpu_torch.serving.scheduler import RequestQueue
    from edl_tpu_torch.utils.device import resolve_device

    boot["imports"] = time.time()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    torch.empty(0, device=device)  # the device's context
    boot["device"] = time.time()
    if args.dryrun:
        from edl_tpu_torch.models import llama

        cfg = llama.LlamaConfig.tiny(vocab=args.vocab)
        params = llama.init_params(cfg, seed=args.seed, device=device)
    else:
        params, cfg_or_err = _load_llama_serving(args.export_dir, device)
        if params is None:
            print(cfg_or_err, file=sys.stderr)
            return 1
        cfg = cfg_or_err
    boot["params"] = time.time()

    queue = RequestQueue(
        max_total_len=args.max_len,
        max_depth=args.max_queue,
        max_new_cap=args.max_new_cap,
    )
    engine = ContinuousBatchingEngine(
        params, cfg,
        max_slots=args.slots,
        max_len=args.max_len,
        horizon=args.horizon,
        queue=queue,
        block_size=args.block_size,
        device=device,
    )
    boot["engine"] = time.time()
    srv = ReplicaServer(engine, port=args.port, generation=args.generation)
    srv.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "port": srv.port, "pid": os.getpid(),
                "replica_id": args.replica_id,
                "generation": args.generation,
            }, f)
        os.replace(tmp, args.port_file)  # atomic: the supervisor never
        # reads a half-written port doc
    boot["bound"] = time.time()
    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
    signal.signal(signal.SIGINT, lambda *_: stop_evt.set())
    print(f"# replica {args.replica_id} serving {srv.url} "
          f"gen={args.generation} device={device}", file=sys.stderr,
          flush=True)
    print(f"# replica {args.replica_id} boot {json.dumps(boot)}",
          file=sys.stderr, flush=True)
    stop_evt.wait()
    srv.stop()
    return 0


def run_fleet(args) -> int:
    """Elastic serving fleet: N engine replicas as supervised
    subprocesses behind the fault-tolerant router (serving/fleet.py).
    The default mode boots a fleet (``--dryrun``: a tiny random model;
    else ``--export-dir``), routes traffic through it (optionally
    rolling the weight generation mid-traffic with ``--swap``), and
    reports per-outcome counts plus the READY floor. ``--replica`` is
    the internal per-process entrypoint the supervisor spawns."""
    if args.warm_from is not None:
        print("--warm-from p2p is not ported yet (ROADMAP Queue A item 6)",
              file=sys.stderr)
        return 1
    if args.replica:
        if args.slots < 1 or args.max_len < 2 or args.horizon < 1:
            print("bad --slots/--max-len/--horizon", file=sys.stderr)
            return 1
        if not args.dryrun and not args.export_dir:
            print("error: --replica needs --dryrun or --export-dir",
                  file=sys.stderr)
            return 1
        return _run_fleet_replica(args)

    # demo mode
    if args.replicas < 1:
        print(f"--replicas must be >= 1, got {args.replicas}",
              file=sys.stderr)
        return 1
    if args.requests < 1:
        print(f"--requests must be >= 1, got {args.requests}",
              file=sys.stderr)
        return 1
    import random as _random
    import shutil
    import tempfile
    import threading

    from edl_tpu_torch.serving.fleet import (ReplicaSpec, ReplicaSupervisor,
                                             ServingFleet)
    from edl_tpu_torch.serving.router import (HttpTransport, ReplicaTable,
                                              Router)
    from edl_tpu_torch.serving.scheduler import Request

    workdir = args.workdir or tempfile.mkdtemp(prefix="edl-fleet-")
    own_workdir = args.workdir is None
    spec = ReplicaSpec(
        workdir=workdir, vocab=args.vocab, slots=args.slots,
        max_len=args.max_len, horizon=args.horizon, seed=args.seed,
        export_dir=None if args.dryrun else args.export_dir,
        device=args.device,
    )
    table = ReplicaTable()
    sup = ReplicaSupervisor(table, spec)
    router = Router(table, transport=HttpTransport(), seed=args.seed)
    fleet = ServingFleet(sup, router)

    exporter = None
    if args.metrics_port is not None:
        from edl_tpu_torch import obs

        exporter = obs.start_exporter(port=args.metrics_port)
        print(f"# metrics endpoint {exporter.url}/metrics",
              file=sys.stderr)

    rng = _random.Random(args.seed)
    rc = 0
    try:
        print(f"# booting {args.replicas} replicas "
              f"(workdir {workdir})", file=sys.stderr, flush=True)
        try:
            fleet.start(args.replicas)
        except (RuntimeError, TimeoutError) as e:
            # no fallback: a replica that cannot serve on its device
            # fails the fleet
            print(f"fleet failed to start: {e}", file=sys.stderr)
            return 1
        results = {}
        lock = threading.Lock()

        def _one(i: int) -> None:
            prompt = [rng.randrange(1, args.vocab)
                      for _ in range(4 + i % 5)]
            req = Request(rid=f"q{i}", prompt=prompt,
                          max_new=args.max_new)
            res = fleet.generate(req, session=f"s{i % 4}")
            with lock:
                results[req.rid] = res

        threads = [threading.Thread(target=_one, args=(i,))
                   for i in range(args.requests)]
        for t in threads:
            t.start()
        if args.swap:
            fleet.rolling_swap()
        for t in threads:
            t.join()
        outcomes: dict = {}
        for res in results.values():
            outcomes[res.outcome] = outcomes.get(res.outcome, 0) + 1
        report = {
            "replicas": args.replicas,
            "requests": args.requests,
            "results": len(results),
            "outcomes": outcomes,
            "failovers": sum(r.failovers for r in results.values()),
            "min_ready": sup.min_ready_observed,
            "swapped": bool(args.swap),
        }
        ok = (len(results) == args.requests
              and all(r.outcome in ("done", "eos")
                      for r in results.values()))
        report["ok"] = ok
        print(json.dumps(report, sort_keys=True))
        rc = 0 if ok else 1
    finally:
        fleet.stop()
        if exporter is not None:
            exporter.stop()
        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    return rc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch",
        description="PyTorch/CUDA port of the edl serving verbs",
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

    lg = sub.add_parser(
        "loadgen",
        help="replay a seeded arrival-process workload (Poisson / "
        "Markov-modulated bursts, heavy-tailed lengths, multi-tenant "
        "SLO classes) against the serving engine and report "
        "goodput-under-SLO with a queue-wait/prefill/decode breakdown",
    )
    lg.add_argument(
        "export_dir", nargs="?", default=None,
        help="published llama export to serve (omit with --dryrun / "
        "--workload-only)",
    )
    lg.add_argument(
        "--dryrun", action="store_true",
        help="serve a tiny randomly-initialized model instead of an "
        "export — the CI lane (with --metrics-port it self-scrapes "
        "and hard-asserts the decomposition histograms + SLO gauges)",
    )
    lg.add_argument(
        "--workload-only", action="store_true",
        help="generate + write the workload and exit without touching "
        "a device (the same-seed byte-identity check)",
    )
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument(
        "--requests", type=int, default=0,
        help="workload size (0 = auto: 16 dryrun, 64 export)",
    )
    lg.add_argument(
        "--rate", type=float, default=0.0,
        help="mean arrival rate, req/s (0 = auto: 12 dryrun, 4 export)",
    )
    lg.add_argument(
        "--arrival", choices=["poisson", "burst", "fixed"],
        default="burst",
        help="arrival process (burst = 2-state Markov-modulated "
        "Poisson: calm vs burst-factor x rate)",
    )
    lg.add_argument("--burst-factor", type=float, default=4.0)
    lg.add_argument(
        "--burst-dwell-s", type=float, default=1.0,
        help="mean dwell per burst/calm state",
    )
    lg.add_argument(
        "--speed", type=float, default=1.0,
        help="replay-time multiplier (2.0 submits the same workload "
        "twice as fast — overload knob)",
    )
    lg.add_argument(
        "--ttft-slo", type=float, default=1.0,
        help="interactive-class TTFT deadline, seconds (batch class "
        "gets 8x)",
    )
    lg.add_argument(
        "--itl-slo", type=float, default=0.25,
        help="interactive-class per-token (TPOT) deadline, seconds "
        "(batch class gets 4x)",
    )
    lg.add_argument(
        "--vocab", type=int, default=512,
        help="token-id space for --dryrun/--workload-only (exports "
        "use the model's)",
    )
    lg.add_argument(
        "--shared-prefix", type=float, default=0.0,
        help="fraction of requests whose prompt starts with their "
        "tenant's fixed system-prompt template — the workload shape "
        "a prefix-cached paged engine (`serve --prefix-cache`) "
        "exists for (0 = off, byte-identical to pre-knob workloads)",
    )
    lg.add_argument(
        "--shared-prefix-len", type=int, default=12,
        help="tokens in each tenant's shared system-prompt template",
    )
    lg.add_argument(
        "--repetition", type=float, default=0.0,
        help="fraction of requests whose prompt is a short pattern "
        "tiled to length — structured/templated traffic the "
        "speculative n-gram drafter (`serve --spec-k`) can "
        "predict (0 = off, byte-identical to pre-knob workloads)",
    )
    lg.add_argument(
        "--repetition-len", type=int, default=4,
        help="pattern period for --repetition prompts",
    )
    lg.add_argument(
        "--spec-k", type=int, default=0,
        help="serve the replay speculatively: draft tokens verified "
        "per decode dispatch, as in `serve --spec-k` (0 = off). "
        "The JSON report grows a `spec` section with drafted/accepted "
        "counts and accepted-tokens-per-dispatch",
    )
    lg.add_argument(
        "--slots", type=int, default=0,
        help="KV decode slots (0 = auto: 4 dryrun, 8 export)",
    )
    lg.add_argument(
        "--max-len", type=int, default=0,
        help="tokens per KV slot (0 = auto: 96 dryrun, 256 export)",
    )
    lg.add_argument(
        "--block-size", type=int, default=0,
        help="paged KV cache for the replay engine, as in `serve "
        "--block-size` (0 = contiguous; must divide the max length)",
    )
    lg.add_argument(
        "--kv-quant", choices=("off", "int8", "int4"), default="off",
        help="quantized paged KV for the replay engine, as in `serve "
        "--kv-quant`. Requires --block-size > 0",
    )
    lg.add_argument("--horizon", type=int, default=4)
    lg.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    lg.add_argument(
        "--no-warmup", action="store_true",
        help="skip the compile-warmup pass (first requests then pay "
        "jit compiles inside their measured prefill phase)",
    )
    lg.add_argument(
        "--workload-out", default=None,
        help="also write the generated workload as JSONL here "
        "(byte-identical across same-seed runs)",
    )
    lg.add_argument(
        "--json", action="store_true",
        help="print the goodput report as one JSON object (CI)",
    )
    lg.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose /metrics during the run with LIVE SLO burn "
        "gauges (edl_slo_ttft_ok_ratio{slo_class}) refreshed every "
        "few engine steps (0 = ephemeral)",
    )
    lg.add_argument(
        "--slo-window", type=float, default=0.0,
        help="compute the live SLO burn gauges over requests that "
        "finished within this trailing window (seconds) instead of "
        "cumulatively; 0 = whole-run attainment. Windowed gauges "
        "recover after an incident clears — which is what burn-rate "
        "alert *resolve* needs",
    )
    lg.add_argument(
        "--tsdb-dir", default=None,
        help="record registry snapshots into this metric-history "
        "directory on the gauge-refresh cadence (obs/tsdb.py); "
        "served on /history when --metrics-port is set",
    )
    lg.add_argument("--mesh", default="", help="as in `serve` (not ported yet)")
    lg.add_argument("--int8", action="store_true", help="as in `serve`")
    lg.set_defaults(fn=run_loadgen)

    fl = sub.add_parser(
        "fleet",
        help="elastic serving fleet: N supervised engine replicas "
        "behind the fault-tolerant router — replica death fails "
        "mid-stream requests over token-identically, scale-down "
        "drains before evicting, weight swaps roll one replica at "
        "a time",
    )
    fl.add_argument(
        "--replicas", type=int, default=3,
        help="fleet size for the demo mode",
    )
    fl.add_argument(
        "--requests", type=int, default=12,
        help="demo traffic: requests routed through the fleet",
    )
    fl.add_argument(
        "--max-new", type=int, default=12,
        help="token budget per demo request",
    )
    fl.add_argument(
        "--swap", action="store_true",
        help="roll the weight generation mid-traffic (one replica "
        "at a time, READY count never below N-1)",
    )
    fl.add_argument(
        "--dryrun", action="store_true",
        help="replicas serve a tiny randomly-initialized model "
        "(identical across replicas — the CI lane)",
    )
    fl.add_argument(
        "--export-dir", default=None,
        help="published llama export each replica serves "
        "(alternative to --dryrun)",
    )
    fl.add_argument("--vocab", type=int, default=256,
                    help="dryrun model vocab")
    fl.add_argument("--slots", type=int, default=4,
                    help="KV decode slots per replica")
    fl.add_argument("--max-len", type=int, default=96,
                    help="tokens per KV slot per replica")
    fl.add_argument("--horizon", type=int, default=4,
                    help="fused decode horizon per replica")
    fl.add_argument("--max-queue", type=int, default=64,
                    help="admission queue depth per replica")
    fl.add_argument("--max-new-cap", type=int, default=0,
                    help="per-request token budget cap (0 = off)")
    fl.add_argument("--block-size", type=int, default=0,
                    help="paged KV block size per replica (0 = off)")
    fl.add_argument("--seed", type=int, default=1)
    fl.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="the replicas' device (a replica that cannot reach it exits)",
    )
    fl.add_argument(
        "--workdir", default=None,
        help="port files + replica logs live here (default: a "
        "temp dir, removed on exit)",
    )
    fl.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose the supervisor/router /metrics on this port "
        "(0 = ephemeral)",
    )
    # internal replica mode (spawned by the supervisor)
    fl.add_argument("--replica", action="store_true",
                    help=argparse.SUPPRESS)
    fl.add_argument("--replica-id", default="r?",
                    help=argparse.SUPPRESS)
    fl.add_argument("--port-file", default=None, help=argparse.SUPPRESS)
    fl.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    fl.add_argument("--generation", type=int, default=0,
                    help=argparse.SUPPRESS)
    # p2p warm-start (set on the spawn path by ReplicaSpec when the
    # elasticity plane pushes weights instead of cold-loading)
    fl.add_argument("--warm-from", choices=("p2p",), default=None,
                    help=argparse.SUPPRESS)
    fl.add_argument("--warm-addr", default=None, help=argparse.SUPPRESS)
    fl.set_defaults(fn=run_fleet)

    pr = sub.add_parser(
        "predict",
        help="score a batch of rows against a published export "
        "(families ctr/resnet/bert/llama)",
    )
    pr.add_argument("export_dir")
    pr.add_argument(
        "--input", default=None,
        help=".npz of input rows (family keys: ctr dense/sparse[/label], "
        "resnet images[/label], bert/llama tokens)",
    )
    pr.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    pr.add_argument(
        "--rows", type=int, default=256,
        help="row count when reading --data-dir",
    )
    pr.add_argument(
        "--out", default=None,
        help="write per-row outputs to this .npz (default: summary only)",
    )
    # the reference verb's flags for paths not ported yet: accepted so
    # a reference command line fails with a clear message
    pr.add_argument("--data-dir", default=None)
    pr.add_argument("--mesh", default="")
    pr.set_defaults(fn=run_predict)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
