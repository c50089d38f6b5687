"""``python -m edl_tpu_torch VERB`` — the ports of the reference's verbs
(``edl_tpu/cli/main.py``): ``serve``, ``generate``, ``predict``,
``loadgen``, ``fleet`` and ``elasticity``, and the operator verbs
``top``, ``watch``, ``postmortem``, ``trace``, ``profile``,
``export-status`` and ``job-status``.

``serve``: the contiguous and paged KV caches, the prefix cache, chunked
prefill, quantized KV, speculative decoding and weight-only int8 params
(``--int8``). ``--mesh`` is not ported yet.

``predict``: scores an ``.npz`` of rows (``--input``) or the head of a
shards-dir dataset (``--data-dir``) against a published export of any
ported family (ctr, resnet, bert, llama, moe) and prints the reference
verb's summary line (``predicted N rows (family=F, step=S) metric=v
...``); ``--out`` writes the per-row outputs to an ``.npz``. Not ported
yet: ``--mesh``, which exits 1 with "not ported yet".

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
the READY floor ``min_ready``. ``--warm-from p2p --warm-addr HOST:PORT``
warm-starts each replica from a peer's shard server
(``elasticity/weightpush.py``): it pulls the params and the
``__config__`` architecture document, and any failure exits the replica
non-zero — never a cold init. (The reference's demo mode ignores the
two flags; the port's passes them to every replica.)

``elasticity``: the train⇄serve chip-elasticity rehearsal — a scripted
diurnal load curve through the real lease broker and handover
controller (fake clock, fake sides), in process or against a running
``edl-coordinator`` (``--coordinator HOST:PORT``); ``--json`` prints the
reference verb's document.

``generate``: decodes ``--max-new`` tokens after ``--prompt`` from a
published llama export and prints them comma-separated; ``--int8``
serves the weight-only int8 records; greedy tokens are the reference's,
sampled ones come from a ``torch.Generator`` seeded with ``--seed``.
``--mesh`` is not ported yet (ROADMAP item 2f, of item 2b's second
half: sharded loading).

The operator verbs read telemetry and import neither torch nor jax
(``export-status`` loads the export module, which imports torch):
``top`` paints an endpoint's ``/metrics``; ``watch`` evaluates the alert
rules (``obs/alerts.py``) over a live endpoint or a recorded metric
history and exits with its count of active pages; ``postmortem``
rebuilds timelines and incidents from a flight-recorder dump or a live
``/events``; ``trace`` prints the critical path of a step, reshard epoch
or request from a trace document or a live ``/trace`` (the coordinator's
is the fleet merge); ``profile SOURCE`` renders the roofline report of
an endpoint or a ``BENCH_r*.json`` (``--dryrun`` trains a tiny llama
through ``ElasticTrainer`` and serves it, then asserts the efficiency
telemetry; on the card unless ``--device cpu``); ``export-status``
shows and fetches the latest export; ``job-status`` reads a running
job's progress and queue from its coordinator.

The control-plane verbs import neither torch nor jax: ``controller``
runs the control loop (job store sync, the fake cluster's reconcile,
the autoscaler's tick with the native planner unless
``--no-native-scheduler``, the job updaters) over a synthetic fleet of
``--hosts`` × ``--chips-per-host`` and publishes each job's status into
the store; ``--metrics-port`` serves the fleet census. ``--kube`` (with
``--kube-url`` or the in-cluster service account) runs the same loop
against a Kubernetes API server (``cluster/kube.py``): TrainingJobs come
from the CRD, child resources are real Jobs, Deployments and Services,
and each job's status goes to the CRD's status subresource.
``submit``, ``delete``, ``list``, ``status``, ``monitor`` and
``validate`` read and write the job store (``cli_store.py``, the
reference's on-disk format) with the reference's printed lines,
``--json`` records and exit codes.

The project's own checkers (``analysis/``) import neither torch nor jax
at ``check``: ``check [PATHS]`` runs the static rules over the
``edl_tpu_torch`` package (``--baseline
edl_tpu_torch/analysis/baseline.json`` holds the triaged findings);
``schedcheck [HARNESS...]`` explores seeded thread interleavings of the
port's concurrent classes under the deterministic scheduler and labels
the static lockset-race sites. Both keep the reference verbs' flags,
printed lines, ``--json`` documents and exit codes (0 / 1 / 2).

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

from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("cli")

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
        print("--mesh is not ported yet (ROADMAP Queue A item 2f)",
              file=sys.stderr)
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
    if args.warm_from == "p2p":
        # pull live weights + the architecture doc from a peer shard
        # server (the elasticity handover path). Loud on any failure: a
        # cold init would serve DIFFERENT weights than the fleet
        # believes it has
        from edl_tpu_torch.elasticity import weightpush
        from edl_tpu_torch.models import llama
        from edl_tpu_torch.utils.tree import leaves, replace_leaves

        t0 = time.perf_counter()
        try:
            params, cfg_doc, _step = weightpush.fetch_params(args.warm_addr)
        except (ConnectionError, OSError, ValueError) as e:
            print(f"p2p warm-start from {args.warm_addr} failed: {e}",
                  file=sys.stderr)
            return 1
        if cfg_doc is None:
            print("p2p warm-start: peer served no __config__ doc",
                  file=sys.stderr)
            return 1
        try:
            cfg = llama.LlamaConfig.from_meta(cfg_doc)
        except (KeyError, TypeError, ValueError) as e:
            print(f"p2p warm-start: the peer's __config__ doc is no llama "
                  f"architecture: {e!r}", file=sys.stderr)
            return 1
        fetch_s = time.perf_counter() - t0
        params = replace_leaves(params, [t.to(device)
                                         for t in leaves(params)])
        boot["fetched"] = boot["device"] + fetch_s
        print(f"# replica {args.replica_id} warm from {args.warm_addr} "
              f"({fetch_s:.3f}s)", file=sys.stderr, flush=True)
    elif args.dryrun:
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
    else ``--export-dir``; ``--warm-from p2p``: pulled from a peer),
    routes traffic through it (optionally rolling the weight generation
    mid-traffic with ``--swap``), and reports per-outcome counts plus
    the READY floor. ``--replica`` is the internal per-process
    entrypoint the supervisor spawns."""
    if args.warm_from == "p2p" and not args.warm_addr:
        print("error: --warm-from p2p needs --warm-addr", file=sys.stderr)
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
        device=args.device, warm_from=args.warm_from,
        warm_addr=args.warm_addr,
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
        description="PyTorch/CUDA port of the edl verbs",
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

    el = sub.add_parser(
        "elasticity",
        help="train<->serve chip elasticity rehearsal: drive a "
        "scripted diurnal load curve through the real lease broker "
        "+ handover controller (fake clock, fake sides — pure "
        "policy, no devices) and print the handover ledger",
    )
    el.add_argument(
        "--chips", type=int, default=8,
        help="total chip inventory in the broker pool",
    )
    el.add_argument(
        "--train-chips", type=int, default=6,
        help="chips the trainer holds at bootstrap",
    )
    el.add_argument(
        "--replicas", type=int, default=1,
        help="serving replicas at bootstrap",
    )
    el.add_argument(
        "--chips-per-replica", type=int, default=2,
        help="chips one serving replica occupies",
    )
    el.add_argument(
        "--hours", type=int, default=48,
        help="simulated hours to run (one controller tick per hour)",
    )
    el.add_argument(
        "--cooldown-s", type=float, default=0.0,
        help="handover cooldown through the shared ScaleGate "
        "(simulated seconds; 1 tick = 3600)",
    )
    el.add_argument(
        "--coordinator", default="",
        help="HOST:PORT of a running edl-coordinator: run the policy "
        "loop against the distributed (WAL-persisted, epoch-fenced) "
        "lease broker instead of the in-process one",
    )
    el.add_argument("--json", action="store_true",
                    help="machine-readable ledger")
    el.set_defaults(fn=run_elasticity)
    _add_operator_parsers(sub)
    _add_control_parsers(sub)
    _add_analysis_parsers(sub)
    return p


def run_elasticity(args) -> int:
    """Policy rehearsal for the train⇄serve elasticity plane: a
    scripted diurnal load curve driven through the REAL
    ChipLeaseBroker + ElasticityController + shared ScaleGate, with a
    fake clock and fake side ports — no devices, no subprocesses, so
    an operator can see exactly when and why chips would move before
    pointing the controller at a live fleet. One tick per simulated
    hour. (chip_smoke.py's ``p2p`` phase runs the same controller over
    a live warm-started fleet.)

    ``--coordinator HOST:PORT`` swaps the in-process broker for the
    coordinator-fronted :class:`DistributedChipBroker` — same policy
    loop, but every lease transition is WAL-persisted by the remote
    ``edl-coordinator`` and survives its restart."""
    from edl_tpu_torch.elasticity.broker import ChipLeaseBroker, LeaseError
    from edl_tpu_torch.elasticity.controller import (
        ElasticityController,
        ServePort,
        TrainPort,
    )

    if args.train_chips + args.replicas * args.chips_per_replica > args.chips:
        print(
            f"error: bootstrap wants "
            f"{args.train_chips + args.replicas * args.chips_per_replica} "
            f"chips, pool holds {args.chips}",
            file=sys.stderr,
        )
        return 1

    clock = {"t": 0.0}
    state = {"train_chips": args.train_chips, "replicas": args.replicas,
             "offered": 0.0}

    def offered_load(hour: int) -> float:
        # the diurnal curve: quiet nights, a hard day plateau, shoulders
        h = hour % 24
        if 10 <= h <= 17:
            return 6.0
        if h in (8, 9, 18, 19):
            return 2.0
        return 0.25

    if args.coordinator:
        from edl_tpu_torch.elasticity.distbroker import DistributedChipBroker
        from edl_tpu_torch.runtime.coordinator import CoordinatorClient

        host, _, port = args.coordinator.rpartition(":")
        if not host or not port.isdigit():
            print(f"error: --coordinator wants HOST:PORT, got "
                  f"{args.coordinator!r}", file=sys.stderr)
            return 1
        try:
            broker = DistributedChipBroker(
                CoordinatorClient(host, int(port)), args.chips,
                clock=lambda: clock["t"],
            )
        except (LeaseError, OSError) as e:
            print(f"error: coordinator {args.coordinator}: {e}",
                  file=sys.stderr)
            return 1
    else:
        broker = ChipLeaseBroker(args.chips, clock=lambda: clock["t"])
    train = TrainPort(
        chips=lambda: state["train_chips"],
        apply_chips=lambda n: state.update(train_chips=n),
        min_chips=args.chips_per_replica,
    )

    def _add_replica() -> float:
        state["replicas"] += 1
        return 0.0

    def _remove_replica() -> None:
        state["replicas"] -= 1

    serve = ServePort(
        replicas=lambda: state["replicas"],
        load=lambda: state["offered"] / max(state["replicas"], 1),
        slo_breached=lambda: False,
        add_replica=_add_replica,
        remove_replica=_remove_replica,
        min_replicas=1,
    )
    ctl = ElasticityController(
        broker, train, serve,
        chips_per_replica=args.chips_per_replica,
        cooldown_s=args.cooldown_s,
        clock=lambda: clock["t"],
    )
    ctl.bootstrap()

    rows = []
    for hour in range(args.hours):
        clock["t"] = hour * 3600.0
        state["offered"] = offered_load(hour)
        action = ctl.tick()
        if not broker.check_conservation():
            print(f"LEASE CONSERVATION VIOLATED at hour {hour}",
                  file=sys.stderr)
            return 1
        rows.append({
            "hour": hour,
            "offered": state["offered"],
            "action": action,
            "train_chips": state["train_chips"],
            "replicas": state["replicas"],
            "free": broker.free_chips,
            "epoch": broker.epoch,
        })

    if args.json:
        print(json.dumps({
            "rows": rows,
            "handovers": [h.__dict__ for h in ctl.ledger],
            "epoch": broker.epoch,
            "conserved": broker.check_conservation(),
        }, sort_keys=True))
        return 0
    print(f"{'hour':>4} {'offered':>7} {'action':<9} {'train':>5} "
          f"{'replicas':>8} {'free':>4} {'epoch':>5}")
    for r in rows:
        if r["action"] is None and r["hour"] % 6:
            continue  # quiet hours: print a sample, not 48 idle rows
        print(f"{r['hour']:>4} {r['offered']:>7.2f} "
              f"{r['action'] or '-':<9} {r['train_chips']:>5} "
              f"{r['replicas']:>8} {r['free']:>4} {r['epoch']:>5}")
    print(f"# {len(ctl.ledger)} handovers over {args.hours}h; "
          f"final epoch {broker.epoch}; conservation "
          f"{'OK' if broker.check_conservation() else 'VIOLATED'}")
    return 0


# -- the operator verbs ------------------------------------------------------
# top, watch, postmortem, trace, job-status and profile SOURCE import
# neither torch nor jax: telemetry analysis needs no device


def run_top(args) -> int:
    """Live one-screen view of any telemetry endpoint (a serving
    process's --metrics-port, a worker's EDL_METRICS_PORT, or the
    coordinator's fleet aggregation) — scrape /metrics, summarize the
    headline series, repeat."""
    from edl_tpu_torch.obs.top import top_once

    i = 0
    while True:
        try:
            print(top_once(args.endpoint, timeout_s=args.timeout), flush=True)
        except OSError as e:
            print(f"scrape failed for {args.endpoint}: {e}", file=sys.stderr)
            return 1
        i += 1
        if args.polls is not None and i >= args.polls:
            return 0
        time.sleep(args.interval)


def _watch_line(tr: dict) -> str:
    detail = " ".join(
        f"{k}={v:.6g}"
        for k, v in sorted(tr.items())
        if k not in ("transition", "rule", "severity", "t")
        and isinstance(v, (int, float))
    )
    return (f"[{tr['t']:.3f}] {tr['transition'].upper():7s} "
            f"{tr['rule']} severity={tr['severity']} {detail}").rstrip()


def run_watch(args) -> int:
    """Evaluate alert rules over metric history: tail a live exporter
    (scrape /metrics on a cadence, record into a local tsdb, evaluate)
    or replay a recorded tsdb directory (deterministic). Rules come
    from --rules JSON or the shipped defaults (obs/alerts.py
    DEFAULT_RULES); --time-scale shrinks every window so production
    burn-rate rules run against seconds-long replays. Transitions print
    as they happen (and emit alert.fire / alert.resolve flight-recorder
    events); the exit code is the number of PAGES still active at exit
    (capped at 100), 2 on bad rules or a failed scrape."""
    import os

    from edl_tpu_torch import obs
    from edl_tpu_torch.obs import alerts as obs_alerts
    from edl_tpu_torch.obs import events as obs_events
    from edl_tpu_torch.obs.tsdb import TSDB, snapshot_from_prometheus_text

    try:
        doc = obs_alerts.load_rules_doc(args.rules)
        engine = obs_alerts.engine_from_doc(
            doc, time_scale=args.time_scale,
            registry=obs.default_registry(),
        )
    except (OSError, ValueError) as e:
        print(f"bad rules: {e}", file=sys.stderr)
        return 2

    src = args.source
    transitions: list = []

    def _saw(trs) -> None:
        for tr in trs:
            transitions.append(tr)
            if not args.json:
                print(_watch_line(tr), flush=True)

    if os.path.isdir(src):
        db = TSDB(src)
        seen_t: Optional[float] = None

        def pass_once() -> None:
            nonlocal seen_t
            new = [t for t in db.raw_times()
                   if seen_t is None or t > seen_t]
            for t in new:
                _saw(engine.evaluate(db, t))
            if new:
                seen_t = new[-1]
    else:
        import tempfile

        url = src if src.startswith("http") else f"http://{src}"
        db = TSDB(args.record or tempfile.mkdtemp(prefix="edl-watch-"))

        def pass_once() -> None:
            text = obs.scrape(url)
            now = time.time()
            db.append(snapshot_from_prometheus_text(text), t=now)
            _saw(engine.evaluate(db, now))

    polls = 1 if args.once else args.polls
    i = 0
    while True:
        try:
            pass_once()
        except OSError as e:
            print(f"scrape failed for {src}: {e}", file=sys.stderr)
            return 2
        i += 1
        if polls is not None and i >= polls:
            break
        time.sleep(args.interval)

    if args.events_out:
        recs = obs_events.default_recorder().records()
        with open(args.events_out, "w") as f:
            for r in recs:
                f.write(json.dumps(r, default=str,
                                   separators=(",", ":")) + "\n")
        print(f"# events -> {args.events_out} ({len(recs)} events)",
              file=sys.stderr)

    summary = {
        "rules": sorted(r.name for r in engine.rules),
        "time_scale": engine.time_scale,
        "transitions": transitions,
        "active": engine.active(),
        "pages": engine.pages(),
        "fired_total": engine.to_block()["fired_total"],
    }
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        act = (", ".join(f"{a['rule']}({a['severity']})"
                         for a in summary["active"]) or "none")
        print(f"WATCH {len(summary['rules'])} rules  "
              f"fired={summary['fired_total']}  active: {act}")
    return min(engine.pages(), 100)


def run_postmortem(args) -> int:
    """Reconstruct timelines and incidents from a flight-recorder dump
    (obs/events.py JSONL — a recorder dump, a crash-dump black box from
    EDL_BLACKBOX_DIR, or a live exporter's /events URL) and optionally
    enforce the contracts: --assert-recovered proves every injected
    serving fault chained into a recorded recovery (fault -> recover ->
    re-prefill -> finish per affected rid); --assert-no-incidents
    proves a fault-free run's timeline is clean."""
    from edl_tpu_torch.obs import postmortem as pm

    try:
        evs = pm.load_events(args.source)
    except (OSError, ValueError) as e:
        print(f"cannot load events from {args.source!r}: {e}",
              file=sys.stderr)
        return 2
    print(pm.render_report(evs, rid=args.rid, window_s=args.window))
    problems = []
    if args.assert_recovered:
        problems += pm.verify_recovered(evs, site_prefix=args.sites)
    if args.assert_no_incidents:
        problems += pm.verify_no_incidents(evs)
    if problems:
        for p in problems:
            print(f"POSTMORTEM FAIL: {p}", file=sys.stderr)
        return 1
    if args.assert_recovered or args.assert_no_incidents:
        print("postmortem assertions OK")
    return 0


def run_trace(args) -> int:
    """Fetch or load a (merged fleet) trace and print the critical path
    of a step, reshard epoch or served request — the longest causal
    chain of spans with per-hop durations and gaps
    (obs/disttrace.critical_path). ``source`` is a chrome-trace JSON
    path or an exporter URL / host:port (scrapes /trace — against a
    coordinator that is the offset-corrected fleet merge)."""
    import os

    from edl_tpu_torch.obs import disttrace

    src = args.source
    try:
        if os.path.exists(src):
            with open(src) as f:
                doc = json.load(f)
        else:
            from edl_tpu_torch.obs.exporter import scrape

            doc = json.loads(scrape(src, "/trace", timeout_s=args.timeout))
    except (OSError, ValueError) as e:
        print(f"cannot load trace from {src!r}: {e}", file=sys.stderr)
        return 2
    n_spans = sum(1 for e in doc.get("traceEvents", ()) if e.get("ph") == "X")
    workers = doc.get("workers") or []
    flows = doc.get("flow_links", 0)
    print(
        f"trace: {n_spans} spans"
        + (f" from {len(workers)} processes ({', '.join(workers)})"
           if workers else "")
        + (f", {flows} flow links" if flows else "")
    )
    hops = disttrace.critical_path(
        doc, rid=args.rid, step=args.step,
        reshard_epoch=args.reshard_epoch, trace_id=args.trace_id,
    )
    if args.json:
        print(json.dumps({"hops": hops, "spans": n_spans,
                          "workers": workers, "flow_links": flows}))
    else:
        print(disttrace.render_critical_path(hops))
    if args.assert_critical_path and not hops:
        print("TRACE FAIL: empty critical path for the given filter",
              file=sys.stderr)
        return 1
    return 0


def run_profile(args) -> int:
    """Roofline report (achieved vs peak per phase + the HBM ledger +
    compile activity) from a live ``/metrics`` endpoint or a committed
    ``BENCH_r*.json`` round, or ``--dryrun``: a tiny train window
    through ``ElasticTrainer`` and a serving workload, self-scraped, with
    the reference's hard assertions (exit 1 when one fails, or when no
    card is there and ``--device cpu`` was not given)."""
    from edl_tpu_torch.obs import profile as prof

    if args.dryrun:
        try:
            report = prof.run_dryrun(
                metrics_port=args.metrics_port, steps=args.steps,
                device=args.device,
            )
        except (AssertionError, RuntimeError) as e:
            print(f"PROFILE DRYRUN FAIL: {e}", file=sys.stderr)
            return 1
    elif args.source:
        try:
            report = prof.report_for_source(args.source, timeout_s=args.timeout)
        except (OSError, ValueError, KeyError) as e:
            print(
                f"cannot profile {args.source!r}: {e}", file=sys.stderr
            )
            return 2
    else:
        print(
            "error: need a SOURCE (endpoint or BENCH_r*.json) or --dryrun",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(prof.render_report(report))
    return 0


def run_export_status(args) -> int:
    """Inspect (and optionally fetch) the latest servable export — the
    consumer side of the export contract."""
    import math
    import os

    from edl_tpu_torch.runtime.export import export_status

    doc = export_status(args.export_dir)
    if doc is None:
        print(f"no published export under {args.export_dir}", file=sys.stderr)
        return 1
    n_params = sum(math.prod(s) if s else 1 for s in doc["shapes"].values())
    print(
        f"step={doc['step']} dtype={doc['dtype']} "
        f"leaves={len(doc['shapes'])} params={n_params} "
        f"dir={doc['_dir']} source={doc['source']}"
    )
    if args.fetch:
        import shutil

        os.makedirs(args.fetch, exist_ok=True)
        # the GC (keep=2) may delete doc["_dir"] while we copy if two
        # newer exports publish in between — retry against the re-read
        # latest pointer instead of dying mid-fetch
        for attempt in range(5):
            try:
                for f in ("params.npz", "manifest.json"):
                    shutil.copy2(os.path.join(doc["_dir"], f), args.fetch)
                break
            except FileNotFoundError:
                newer = export_status(args.export_dir)
                if newer is None or newer["_dir"] == doc["_dir"] or attempt == 4:
                    print(
                        f"export {doc['_dir']} vanished mid-fetch",
                        file=sys.stderr,
                    )
                    return 1
                doc = newer
        print(f"fetched -> {args.fetch} (step={doc['step']})")
    return 0


def run_job_status(args) -> int:
    """Operator view into a RUNNING process-runtime job: the live
    training metrics the workers publish in their job coordinator's KV
    (progress, phase, loss curve endpoints, reshard count, held-out
    eval_metric, last restore source, slice layout, queue accounting)."""
    from edl_tpu_torch.runtime.coordinator import CoordinatorClient

    host, _, port = args.coordinator.rpartition(":")
    try:
        cl = CoordinatorClient(host or "127.0.0.1", int(port), 5.0,
                               reconnect_window_s=0.0)
    except (OSError, ValueError) as e:
        print(f"cannot reach coordinator {args.coordinator}: {e}",
              file=sys.stderr)
        return 1
    try:
        k = lambda key: cl.kv_get(f"{args.job}/{key}")  # noqa: E731
        members = cl.members()
        rows = [
            ("phase", k("phase") or "running"),
            ("progress", k("progress") or "0"),
            ("workers", ",".join(m.name for m in members) or "-"),
            ("reshards", k("reshards") or "0"),
            ("loss", f"{k('loss_first') or '?'} -> {k('loss_last') or '?'}"),
            ("ckpt_step", k("ckpt_step") or "-"),
            ("eval_metric", k("eval_metric") or "-"),
            ("restore_last", k("restore_last") or "-"),
            ("mesh_slices", k("mesh_slices") or "-"),
        ]
        # an uninitialized queue answers with zeros; a mid-read
        # coordinator death raises and takes the error path below
        q = cl.queue_stats()
        rows.append((
            "queue",
            f"todo={q.get('todo')} leased={q.get('leased')} "
            f"done={q.get('done')} dead={q.get('dead')}",
        ))
        for name, val in rows:
            print(f"{name:14s} {val}")
        return 0
    except (ConnectionError, OSError, ValueError) as e:
        # the coordinator died mid-read (reconnect window 0: fail fast)
        print(f"coordinator failed mid-read: {e}", file=sys.stderr)
        return 1
    finally:
        cl.close()


def run_generate(args) -> int:
    """Decode from a published llama export — the one-shot serving
    consumer (the export's manifest carries the architecture record;
    ``llama.generate``'s KV-cache decode does the rest), on CUDA unless
    ``--device cpu``. ``--int8`` serves the weight-only int8 records.
    Greedy tokens are the reference's; sampling draws from a
    ``torch.Generator`` seeded with ``--seed``, deterministic per seed
    but not the reference's ``jax.random`` draws. ``--mesh`` is not
    ported yet (ROADMAP item 2f, of item 2b's second half)."""
    # argv-only validation FIRST: a pure flag mistake must not cost a
    # multi-GB export load + quantization before it is reported
    if args.temperature <= 0 and (args.top_k or args.top_p < 1.0):
        print(
            "--top-k/--top-p require --temperature > 0 "
            "(greedy decoding ignores them)",
            file=sys.stderr,
        )
        return 1
    if args.top_k < 0:
        print(f"top_k must be >= 0, got {args.top_k}", file=sys.stderr)
        return 1
    if not 0.0 < args.top_p <= 1.0:
        print(f"top_p must be in (0, 1], got {args.top_p}", file=sys.stderr)
        return 1
    if args.mesh:
        print("--int8 and --mesh are mutually exclusive" if args.int8 else
              "--mesh is not ported yet (ROADMAP item 2f, of item 2b's "
              "second half: sharded loading)", file=sys.stderr)
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
    import torch

    from edl_tpu_torch.models import llama

    try:
        ids = [int(t) for t in args.prompt.split(",")]
    except ValueError:
        print(
            f"--prompt must be comma-separated integers, got {args.prompt!r}",
            file=sys.stderr,
        )
        return 1
    if not ids or args.max_new < 1:
        print("need a non-empty prompt and --max-new >= 1", file=sys.stderr)
        return 1
    if min(ids) < 0 or max(ids) >= cfg.vocab:
        print(f"prompt tokens outside [0, {cfg.vocab})", file=sys.stderr)
        return 1
    prompt = torch.tensor([ids], dtype=torch.int32, device=device)
    try:
        toks = llama.generate(
            params,
            prompt,
            cfg,
            max_new=args.max_new,
            temperature=args.temperature,
            generator=(
                torch.Generator(device=device).manual_seed(args.seed)
                if args.temperature > 0
                else None
            ),
            top_k=args.top_k,
            top_p=args.top_p,
        )
    except ValueError as e:  # bad top_k/top_p bounds
        print(str(e), file=sys.stderr)
        return 1
    print(",".join(str(int(t)) for t in toks[0].tolist()))
    return 0


def _add_operator_parsers(sub) -> None:
    """The parsers of the operator verbs, with the reference's flags."""
    tp = sub.add_parser(
        "top",
        help="live one-screen view of a telemetry endpoint "
        "(scrapes /metrics: TTFT percentiles, step-time breakdown, "
        "reshard stalls, queue depth)",
    )
    tp.add_argument(
        "endpoint",
        help="host:port or URL of an exporter (`serve --metrics-port`, "
        "a worker's EDL_METRICS_PORT, or the coordinator's "
        "--metrics-port fleet aggregation)",
    )
    tp.add_argument("--interval", type=float, default=2.0)
    tp.add_argument("--polls", type=int, default=None, help="stop after N polls")
    tp.add_argument("--timeout", type=float, default=5.0)
    tp.set_defaults(fn=run_top)

    w = sub.add_parser(
        "watch",
        help="alerting watchdog: evaluate threshold / burn-rate / "
        "anomaly rules over metric history (tail a live exporter or "
        "replay a recorded tsdb dir); exit code = active pages",
    )
    w.add_argument(
        "source",
        help="host:port or URL of an exporter (tailed: each poll "
        "scrapes /metrics and records it), or a tsdb history "
        "directory (replayed deterministically)",
    )
    w.add_argument(
        "--rules", default=None,
        help="rules JSON; default: the shipped burn-rate + watchdog "
        "rules (obs/alerts.py)",
    )
    w.add_argument(
        "--time-scale", type=float, default=None,
        help="multiply every rule window (e.g. 0.01 turns the 5m/1h "
        "fast-burn pair into 3s/36s for a replay); default: the rules "
        "doc's own time_scale",
    )
    w.add_argument("--interval", type=float, default=2.0)
    w.add_argument("--polls", type=int, default=None,
                   help="stop after N polls (default: forever)")
    w.add_argument(
        "--once", action="store_true",
        help="single pass: one scrape, or one full replay of a "
        "recorded dir, then exit",
    )
    w.add_argument(
        "--json", action="store_true",
        help="suppress per-transition lines; print one JSON summary "
        "(rules, transitions, active, pages) at exit",
    )
    w.add_argument(
        "--record", default=None,
        help="when tailing a live endpoint, record scrapes into this "
        "tsdb dir (default: a temp dir)",
    )
    w.add_argument(
        "--events-out", default=None,
        help="write the watcher's flight-recorder JSONL (the "
        "alert.fire/alert.resolve timeline) here for "
        "`postmortem --sites alert.`",
    )
    w.set_defaults(fn=run_watch)

    pmn = sub.add_parser(
        "postmortem",
        help="analyze a flight-recorder dump (or a live /events URL): "
        "per-request timelines, incident summary, fault->recovery "
        "chains; assertions for fault runs",
    )
    pmn.add_argument(
        "source",
        help="events JSONL path (a recorder dump or an EDL_BLACKBOX_DIR "
        "crash dump) or an exporter URL / host:port (scrapes /events)",
    )
    pmn.add_argument(
        "--rid", default=None,
        help="render only this request's timeline",
    )
    pmn.add_argument(
        "--window", type=float, default=5.0,
        help="seconds of follow-on events attached to each injected "
        "fault in the incident summary",
    )
    pmn.add_argument(
        "--sites", default="serve.",
        help="site prefix --assert-recovered checks (default: the "
        "serving fault points)",
    )
    pmn.add_argument(
        "--assert-recovered", action="store_true",
        help="exit 1 unless every injected fault at --sites is "
        "followed by a recorded recovery whose requests re-prefilled "
        "and finished (a dump with no such faults also fails)",
    )
    pmn.add_argument(
        "--assert-no-incidents", action="store_true",
        help="exit 1 if the timeline shows any injected fault, "
        "recovery, error event, timeout, failure, or heartbeat "
        "degradation",
    )
    pmn.set_defaults(fn=run_postmortem)

    trc = sub.add_parser(
        "trace",
        help="fetch/load a (merged fleet) trace and print the "
        "critical path of a step, reshard epoch, or request",
    )
    trc.add_argument(
        "source",
        help="chrome-trace JSON path or an exporter URL / host:port "
        "(scrapes /trace; a coordinator endpoint serves the "
        "offset-corrected fleet merge)",
    )
    trc.add_argument(
        "--rid", default=None,
        help="critical path of this served request (matches span "
        "rid/rids attrs — the same correlation key as /events?rid=)",
    )
    trc.add_argument(
        "--step", type=int, default=None,
        help="critical path of this training step",
    )
    trc.add_argument(
        "--reshard-epoch", type=int, default=None,
        help="critical path of this reshard (selects the derived "
        "reshard trace root)",
    )
    trc.add_argument(
        "--trace-id", default=None, help="select one trace explicitly",
    )
    trc.add_argument("--json", action="store_true",
                     help="machine-readable hops")
    trc.add_argument("--timeout", type=float, default=5.0)
    trc.add_argument(
        "--assert-critical-path", action="store_true",
        help="exit 1 when the filter selects no spans",
    )
    trc.set_defaults(fn=run_trace)

    pf = sub.add_parser(
        "profile",
        help="roofline report: achieved vs peak per phase (edl_mfu / "
        "edl_bw_util_ratio), the HBM memory ledger, and compile "
        "telemetry — from a live /metrics endpoint or a BENCH_r*.json",
    )
    pf.add_argument(
        "source", nargs="?", default=None,
        help="exporter host:port / URL, or a BENCH_r*.json path "
        "(omit with --dryrun)",
    )
    pf.add_argument(
        "--dryrun", action="store_true",
        help="train a tiny llama through ElasticTrainer, serve it, and "
        "assert the efficiency telemetry",
    )
    pf.add_argument(
        "--device", default=None,
        help="with --dryrun: cpu, or a CUDA device (default the card)",
    )
    pf.add_argument(
        "--metrics-port", type=int, default=None,
        help="with --dryrun: expose /metrics during the run",
    )
    pf.add_argument(
        "--steps", type=int, default=4,
        help="dryrun train-window steps",
    )
    pf.add_argument("--timeout", type=float, default=5.0)
    pf.add_argument(
        "--json", action="store_true",
        help="print the report as one JSON object",
    )
    pf.set_defaults(fn=run_profile)

    ex = sub.add_parser(
        "export-status",
        help="show (and optionally fetch) the latest servable export",
    )
    ex.add_argument("export_dir")
    ex.add_argument(
        "--fetch", default=None, help="copy the latest export to this dir"
    )
    ex.set_defaults(fn=run_export_status)

    js = sub.add_parser(
        "job-status",
        help="live metrics of a running process-runtime job from its "
        "coordinator KV (progress, eval_metric, reshards, slices, queue)",
    )
    js.add_argument("job", help="job name (the KV key prefix)")
    js.add_argument(
        "--coordinator", required=True, help="job coordinator host:port"
    )
    js.set_defaults(fn=run_job_status)

    g = sub.add_parser(
        "generate", help="decode tokens from a published llama export"
    )
    g.add_argument("export_dir")
    g.add_argument(
        "--prompt", required=True, help="comma-separated token ids"
    )
    g.add_argument("--max-new", type=int, default=16)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument(
        "--top-k", type=int, default=0,
        help="sample from the k most likely tokens (0 = no truncation)",
    )
    g.add_argument(
        "--top-p", type=float, default=1.0,
        help="nucleus sampling: smallest token set with probability "
        "mass >= p (1.0 = off); composes with --top-k",
    )
    g.add_argument(
        "--mesh", default="",
        help="not ported yet (ROADMAP item 2f): exits 1",
    )
    g.add_argument(
        "--int8", action="store_true",
        help="weight-only int8 decode: quantize the export's matmul "
        "weights (per-output-column absmax) before serving — halves "
        "the weight-bandwidth bill of small-batch decode",
    )
    g.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    g.set_defaults(fn=run_generate)


# -- the control-plane verbs -------------------------------------------------
# controller, submit, delete, list, status, monitor and validate import
# neither torch nor jax: the control plane needs no device


def _start_fleet_exporter(args, cluster):
    """The controller's telemetry endpoint (``--metrics-port``): each
    scrape of /metrics samples the live cluster through the collector
    that ``monitor`` uses and re-exposes the census as gauges
    (``obs.fleet.registry_from_sample``). Returns the exporter or
    None."""
    if getattr(args, "metrics_port", None) is None:
        return None
    from edl_tpu_torch import obs
    from edl_tpu_torch.monitor.collector import ClusterSource

    src = ClusterSource(cluster)
    exp = obs.start_exporter(
        lambda: obs.registry_from_sample(src.sample()), port=args.metrics_port
    )
    log.info("fleet metrics endpoint up", url=exp.url)
    return exp


def _slice_policy(args):
    """The ``--slice-policy`` choice as the Autoscaler takes it ("auto"
    stays a string; the names resolve to the callables)."""
    from edl_tpu_torch.cluster import topology

    name = getattr(args, "slice_policy", "flexible")
    return "auto" if name == "auto" else topology.POLICIES[name]


def _build_cluster(args):
    from edl_tpu_torch.cluster.fake import FakeCluster, FakeHost

    hosts = [
        FakeHost(
            name=f"host{i}",
            cpu_milli=args.host_cpu_milli,
            mem_mega=args.host_mem_mega,
            chips=args.chips_per_host,
        )
        for i in range(args.hosts)
    ]
    return FakeCluster(hosts=hosts)


def _job_status_record(cluster, job) -> dict:
    total, running, pending = cluster.job_pods(job)
    st = job.status
    return {
        "name": job.name,
        "namespace": job.namespace,
        "phase": str(st.phase.value),
        "reason": st.reason,
        "parallelism": st.parallelism,
        "total": total,
        "running": running,
        "pending": pending,
        "reshard_count": st.reshard_count,
        "last_reshard_stall_s": st.last_reshard_stall_s,
        "reshard_fallbacks": st.reshard_fallbacks,
        "min_replicas": job.spec.worker.min_replicas,
        "max_replicas": job.spec.worker.max_replicas,
        "chips_per_worker": job.chips_per_worker(),
    }


def run_controller_kube(args) -> int:
    """In-cluster daemon: source TrainingJobs from the CRD
    (deploy/crd.yaml), drive real child resources through the
    Kubernetes API, publish status to the CRD status subresource —
    the deployment mode of the reference controller
    (reference: cmd/edl/edl.go:31-50 in-cluster config path)."""
    from edl_tpu_torch.cluster.kube import KubeApi, KubeCluster, KubeJobSource
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.scheduler.autoscaler import Autoscaler

    api = KubeApi(args.kube_url) if args.kube_url else KubeApi.from_env()
    cluster = KubeCluster(api, worker_image=args.worker_image)
    controller = Controller(
        cluster,
        autoscaler=Autoscaler(
            cluster,
            max_load_desired=args.max_load_desired,
            slice_policy=_slice_policy(args),
            use_native=not args.no_native_scheduler,
        ),
    )
    source = KubeJobSource(cluster, args.namespace)
    exporter = _start_fleet_exporter(args, cluster)
    log.info(
        "controller started (kube mode)",
        api=api.base_url,
        namespace=args.namespace or "<all>",
        max_load_desired=args.max_load_desired,
    )

    published: dict = {}  # last status pushed per job (dirty check)

    def _status_key(job):
        st = job.status
        return (
            st.phase.value, st.reason, st.parallelism, st.reshard_count,
            st.last_reshard_stall_s, st.worker.state.value,
            st.worker.replicas, st.worker.ready_replicas,
            st.worker.succeeded, st.worker.failed, st.master.state.value,
            st.master.ready_replicas,
        )

    i = 0
    while args.iterations is None or i < args.iterations:
        # informer-poll analog (reference: WatchTrainingJobs
        # pkg/controller.go:79-108); a transient API error must not kill
        # the daemon — retry next tick
        try:
            source.poll(
                controller.on_add, controller.on_update, controller.on_delete
            )
        except Exception as e:
            log.error("trainingjob poll failed", error=str(e))
        try:
            controller.autoscaler.tick()
            controller.step()
        except Exception as e:
            log.error("control tick failed", error=str(e))
        for u in list(controller.updaters.values()):
            key = _status_key(u.job)
            if published.get(u.job.qualified_name) == key:
                continue  # unchanged: don't spam the status subresource
            try:
                cluster.update_training_job_status(u.job)
                published[u.job.qualified_name] = key
            except Exception as e:
                log.error(
                    "status update failed",
                    job=u.job.qualified_name,
                    error=str(e),
                )
        published = {
            name: v for name, v in published.items()
            if name in controller.updaters
        }
        i += 1
        if args.iterations is not None and i >= args.iterations:
            break
        time.sleep(args.tick_s)
    if exporter is not None:
        exporter.stop()
    return 0


def run_controller(args) -> int:
    """The daemon main loop (reference: Controller.Run
    pkg/controller.go:64-76 + the autoscaler 5 s ticker
    pkg/autoscaler.go:451-485), run synchronously per tick: sync desired
    state from the store, let the fake pod controller reconcile,
    autoscale, step the updaters, publish observed state back to the
    store. ``--kube`` / ``--kube-url`` run the in-cluster loop
    (``run_controller_kube``)."""
    from edl_tpu_torch.api.parser import JobParser
    from edl_tpu_torch.cli_store import JobStore
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.scheduler.autoscaler import Autoscaler

    if args.kube or args.kube_url:
        return run_controller_kube(args)
    if not args.store:
        print(
            "error: --store is required (or pass --kube for in-cluster mode)",
            file=sys.stderr,
        )
        return 2
    store = JobStore(args.store)
    cluster = _build_cluster(args)
    controller = Controller(
        cluster,
        autoscaler=Autoscaler(
            cluster,
            max_load_desired=args.max_load_desired,
            slice_policy=_slice_policy(args),
            use_native=not args.no_native_scheduler,
        ),
    )
    parser = JobParser()
    known = set()
    exporter = _start_fleet_exporter(args, cluster)

    log.info(
        "controller started",
        store=args.store,
        hosts=args.hosts,
        chips_per_host=args.chips_per_host,
        max_load_desired=args.max_load_desired,
    )

    i = 0
    while args.iterations is None or i < args.iterations:
        # 1. desired-state sync (the informer-watch analog)
        desired = set(store.list_keys())
        for ns, name in sorted(desired - known):
            job = store.load(ns, name)
            if job is None:
                continue
            try:
                parser.validate(job)
            except ValueError as e:
                log.error("rejecting job", job=name, err=str(e))
                store.write_status(
                    ns, name, {"name": name, "namespace": ns,
                               "phase": "failed", "reason": f"validation: {e}"}
                )
                known.add((ns, name))
                continue
            cluster.submit_job(job)
            known.add((ns, name))
        for ns, name in sorted(known - desired):
            try:
                cluster.delete_job(ns, name)
            except KeyError:
                pass
            store.clear_status(ns, name)
            known.discard((ns, name))

        # 2. advance the world + control loops
        cluster.reconcile()
        controller.autoscaler.tick()
        controller.step()

        # 3. publish observed state (and clear statuses orphaned by jobs
        # deleted while the daemon was down)
        for ns, name in set(store.list_statuses()) - desired:
            store.clear_status(ns, name)
        for job in cluster.list_jobs():
            store.write_status(job.namespace, job.name,
                               _job_status_record(cluster, job))
        r = cluster.inquiry_resource()
        store.write_cluster(
            {
                "ts": time.time(),
                "chip_total": r.chip_total,
                "chip_request": r.chip_request,
                "cpu_total_milli": r.cpu_total_milli,
                "cpu_request_milli": r.cpu_request_milli,
                "mem_total_mega": r.mem_total_mega,
                "mem_request_mega": r.mem_request_mega,
            }
        )

        i += 1
        if args.iterations is not None and i >= args.iterations:
            break
        time.sleep(args.tick_s)
    if exporter is not None:
        exporter.stop()
    return 0


def run_submit(args) -> int:
    from edl_tpu_torch.api.job import TrainingJob
    from edl_tpu_torch.api.parser import JobParser
    from edl_tpu_torch.cli_store import JobStore

    job = TrainingJob.from_yaml_file(args.manifest)
    if args.name:
        job.name = args.name
    JobParser().validate(job)  # reject before spooling, like admission
    store = JobStore(args.store)
    store.submit(job)
    print(f"trainingjob {job.namespace}/{job.name} submitted")
    return 0


def run_delete(args) -> int:
    from edl_tpu_torch.cli_store import JobStore

    store = JobStore(args.store)
    if store.delete(args.namespace, args.name):
        print(f"trainingjob {args.namespace}/{args.name} deleted")
        return 0
    print(f"trainingjob {args.namespace}/{args.name} not found",
          file=sys.stderr)
    return 1


def run_list(args) -> int:
    from edl_tpu_torch.cli_store import JobStore

    store = JobStore(args.store)
    statuses = store.list_statuses()
    rows = [("NAMESPACE", "NAME", "PHASE", "WORKERS", "TARGET", "RANGE",
             "RESHARDS")]
    for ns, name in store.list_keys():
        st = statuses.get((ns, name), {})
        job = store.load(ns, name)
        rng = (
            f"{job.spec.worker.min_replicas}-{job.spec.worker.max_replicas}"
            if job
            else "?"
        )
        rows.append(
            (
                ns,
                name,
                st.get("phase", "none"),
                str(st.get("running", 0)),
                str(st.get("parallelism", 0)),
                rng,
                str(st.get("reshard_count", 0)),
            )
        )
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip())
    return 0


def run_status(args) -> int:
    from edl_tpu_torch.cli_store import JobStore

    store = JobStore(args.store)
    st = store.read_status(args.namespace, args.name)
    if st is None:
        print(f"no status for {args.namespace}/{args.name}", file=sys.stderr)
        return 1
    print(json.dumps(st, indent=2))
    return 0


def run_monitor(args) -> int:
    from edl_tpu_torch.cli_store import JobStore
    from edl_tpu_torch.monitor.collector import Collector, StoreSource

    store = JobStore(args.store)
    alerts_source = None
    if getattr(args, "tsdb", None):
        # each poll evaluates the alert rules over the history dir and
        # the sample carries the alerts block inline
        from edl_tpu_torch.obs import alerts as obs_alerts
        from edl_tpu_torch.obs.tsdb import TSDB

        try:
            engine = obs_alerts.engine_from_doc(
                obs_alerts.load_rules_doc(args.rules),
                time_scale=args.time_scale,
            )
        except (OSError, ValueError) as e:
            print(f"bad rules: {e}", file=sys.stderr)
            return 2
        db = TSDB(args.tsdb)

        def alerts_source() -> dict:
            engine.evaluate(db, time.time())
            return engine.to_block()

    Collector(
        StoreSource(store),
        interval_s=args.interval,
        jsonl=getattr(args, "json", False),
        alerts_source=alerts_source,
    ).run(n_polls=args.polls)
    return 0


def run_validate(args) -> int:
    from edl_tpu_torch.api.job import TrainingJob
    from edl_tpu_torch.api.parser import JobParser

    try:
        job = TrainingJob.from_yaml_file(args.manifest)
        JobParser().validate(job)
    except ValueError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(
        f"valid: {job.namespace}/{job.name} "
        f"workers={job.spec.worker.min_replicas}-"
        f"{job.spec.worker.max_replicas} "
        f"chips_per_worker={job.chips_per_worker()} elastic={job.elastic()}"
    )
    return 0


def _add_store(p: argparse.ArgumentParser) -> None:
    p.add_argument("--store", required=True, help="job store (spool) directory")


def _add_control_parsers(sub) -> None:
    """The parsers of the control-plane verbs, with the reference's
    flags."""
    c = sub.add_parser("controller", help="run the controller daemon")
    c.add_argument(
        "--store",
        default=None,
        help="job store (spool) directory for the synthetic-fleet mode",
    )
    c.add_argument(
        "--kube",
        action="store_true",
        help="in-cluster mode: source TrainingJobs from the CRD and drive "
        "real child resources via the Kubernetes API (cluster/kube.py)",
    )
    c.add_argument(
        "--kube-url",
        default=None,
        help="API server URL (default: in-cluster service account, "
        "or $EDL_KUBE_URL)",
    )
    c.add_argument(
        "--namespace",
        default="",
        help="kube mode: restrict the TrainingJob watch to one namespace",
    )
    c.add_argument(
        "--worker-image",
        default="edl-tpu/worker:latest",
        help="kube mode: image for worker/coordinator pods when a job "
        "spec omits one",
    )
    c.add_argument(
        "--max-load-desired",
        type=float,
        default=0.97,
        help="keep cluster load under this fraction "
        "(reference: -max_load_desired cmd/edl/edl.go:19)",
    )
    c.add_argument("--hosts", type=int, default=4,
                   help="synthetic fleet: host count")
    c.add_argument("--chips-per-host", type=int, default=8)
    c.add_argument("--host-cpu-milli", type=int, default=96_000)
    c.add_argument("--host-mem-mega", type=int, default=393_216)
    c.add_argument(
        "--tick-s",
        type=float,
        default=5.0,
        help="control period (reference: pkg/autoscaler.go:31)",
    )
    c.add_argument(
        "--iterations", type=int, default=None,
        help="stop after N ticks (testing)"
    )
    c.add_argument(
        "--no-native-scheduler",
        action="store_true",
        help="plan in Python instead of the C++ core (native/scheduler)",
    )
    c.add_argument(
        "--slice-policy",
        choices=["flexible", "pow2", "auto"],
        default="flexible",
        help="slice-shape legality: flexible (reference parity), pow2, "
        "or auto (per job from spec.accelerator_type: catalog-capped "
        "pow2 with ICI-contiguous placement for TPU families)",
    )
    c.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="expose the fleet census as Prometheus text on this port "
        "(0 = ephemeral): chip/CPU utilization, per-job workers/"
        "reshards/stall — the scrapeable twin of `monitor`",
    )
    c.set_defaults(fn=run_controller)

    s = sub.add_parser("submit", help="submit a TrainingJob manifest")
    s.add_argument("manifest")
    s.add_argument("--name", default=None, help="override metadata.name")
    _add_store(s)
    s.set_defaults(fn=run_submit)

    d = sub.add_parser("delete", help="delete a submitted job")
    d.add_argument("name")
    d.add_argument("--namespace", default="default")
    _add_store(d)
    d.set_defaults(fn=run_delete)

    ls = sub.add_parser("list", help="list jobs and their observed state")
    _add_store(ls)
    ls.set_defaults(fn=run_list)

    st = sub.add_parser("status", help="print one job's observed status")
    st.add_argument("name")
    st.add_argument("--namespace", default="default")
    _add_store(st)
    st.set_defaults(fn=run_status)

    m = sub.add_parser("monitor",
                       help="poll and print fleet state (collector)")
    _add_store(m)
    m.add_argument("--interval", type=float, default=10.0)
    m.add_argument("--polls", type=int, default=None,
                   help="stop after N polls")
    m.add_argument(
        "--json",
        action="store_true",
        help="emit one JSON object per poll (JSONL) instead of the "
        "text table",
    )
    m.add_argument(
        "--tsdb", default=None,
        help="metric-history directory to evaluate alert rules over "
        "each poll; every sample then carries an `alerts` block",
    )
    m.add_argument(
        "--rules", default=None,
        help="alert rules JSON for --tsdb (default: the shipped rules, "
        "obs/alerts.py)",
    )
    m.add_argument(
        "--time-scale", type=float, default=None,
        help="window scale for --rules (see `watch`)",
    )
    m.set_defaults(fn=run_monitor)

    v = sub.add_parser("validate", help="parse + validate a manifest")
    v.add_argument("manifest")
    v.set_defaults(fn=run_validate)


# -- the project's own checkers ----------------------------------------------
# check imports neither torch nor jax: the analyzer is stdlib ast only


def run_check(args) -> int:
    """Project-invariant static analysis (edl_tpu_torch/analysis/): the
    rules — donation-safety, kv-block, lockset-race, recompile-hazard,
    silent-failure, telemetry-conventions — over the given paths
    (default: the edl_tpu_torch package this file is in). Device-free:
    pure stdlib-ast work. Exit 0 iff no non-baselined findings;
    --write-baseline freezes the current findings as the new baseline
    after a triage."""
    import os

    from edl_tpu_torch import analysis

    paths = args.paths or [os.path.dirname(os.path.abspath(__file__))]
    root = args.root or os.path.dirname(os.path.abspath(paths[0]))
    try:
        report = analysis.run_check(
            paths,
            rules=args.rule or None,
            baseline=args.baseline,
            root=root,
        )
    except (ValueError, OSError) as e:
        print(f"edl check: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        analysis.write_baseline(
            args.write_baseline, report.findings + report.baselined
        )
        print(
            f"baseline written: {args.write_baseline} "
            f"({len(report.findings) + len(report.baselined)} findings)"
        )
        return 0
    if args.json:
        print(analysis.render_json(report))
    else:
        print(analysis.render_text(report, verbose=args.verbose))
    return 1 if report.failed else 0


def run_schedcheck(args) -> int:
    """Dynamic concurrency verification (edl_tpu_torch/analysis/sched.py):
    run the subsystem harnesses under the deterministic scheduler,
    exploring seeded interleavings with the vector-clock happens-before
    detector on, and label the static lockset-race sites CONFIRMED /
    UNWITNESSED from the evidence. Exit 0 iff every harness met its
    expectation (clean harnesses race-free, mutation corpus reproduced)
    and no guarded site REGRESSED."""
    import logging as pylog
    import os

    from edl_tpu_torch.analysis import harnesses as H
    from edl_tpu_torch.analysis import sched as S

    if args.list:
        for n, h in H.HARNESSES.items():
            tag = " [mutation]" if h.mutation else ""
            print(f"{n}{tag}: {h.description}")
        return 0
    names = args.harness or [
        n for n, h in H.HARNESSES.items()
        if not (args.no_mutations and h.mutation)
    ]
    unknown = sorted(set(names) - set(H.HARNESSES))
    if unknown:
        print(
            f"edl schedcheck: unknown harness(es) {unknown}; "
            f"have {sorted(H.HARNESSES)}",
            file=sys.stderr,
        )
        return 2

    # import the harnessed modules and warm shared singletons BEFORE the
    # shim goes up (their locks must be real), and silence
    # harness-internal warn/error logs — races are reported through the
    # explorer, not the log stream
    H.warm_globals()
    prev_disable = pylog.root.manager.disable
    pylog.disable(pylog.ERROR)
    results: dict = {}
    records = []
    ok = True
    t0 = time.monotonic()
    try:
        for n in names:
            h = H.HARNESSES[n]
            res = S.explore(
                h.fn,
                n,
                schedules=args.budget or h.schedules,
                seed=args.seed,
                max_ops=args.max_ops or h.max_ops,
                trace_dir=args.trace_dir,
            )
            results[n] = res
            missing = [
                k for k in h.expect_keys if not H._evidence_matches(res, k)
            ]
            if h.expect_evidence:
                good = res.evidence and not missing
            else:
                good = not res.evidence
            ok = ok and good
            rec = res.to_record()
            rec["expected_evidence"] = h.expect_evidence
            rec["missing_keys"] = missing
            rec["ok"] = good
            records.append(rec)
            if args.json:
                continue
            status = "OK  " if good else "FAIL"
            line = (
                f"[{status}] {n}: {res.schedules} schedules, "
                f"{res.distinct_traces} distinct "
                f"({res.equivalent_pruned} equivalent pruned), "
                f"{len(res.races)} race(s)"
            )
            if res.failure is not None:
                line += f", failure={res.failure['kind']}"
            print(line + f" [{res.elapsed_s:.2f}s]")
            if missing:
                print(f"    expected evidence NOT found for: {missing}")
            for r in res.races:
                print(f"    race: {r['message']}")
                print(
                    f"      repro: seed {r['seed']} (schedule "
                    f"#{r['schedule']} of --seed {args.seed}), forced "
                    f"prefix {len(r.get('forced_prefix', []))} choice(s)"
                )
                sched_ops = r.get("minimal_schedule", [])
                if sched_ops:
                    print(
                        f"      minimal schedule (op window, "
                        f"{len(sched_ops)} ops):"
                    )
                for t in sched_ops:
                    loc = f" @ {t['loc']}" if t.get("loc") else ""
                    print(
                        f"        {t['i']:>5} {t['task']:<18} "
                        f"{t['op']:<12} {t['obj']}{loc}"
                    )
            if res.failure is not None:
                fl = res.failure
                print(f"    failure: {fl['kind']}: {fl['detail']}")
                print(
                    f"      repro: seed {fl['seed']} (schedule "
                    f"#{fl['schedule']} of --seed {args.seed})"
                )
    finally:
        pylog.disable(prev_disable)

    vs = H.verdicts(results)
    regressed = [v for v in vs if v["verdict"] == "REGRESSED"]
    ok = ok and not regressed
    elapsed = time.monotonic() - t0
    if args.json:
        print(
            json.dumps(
                {
                    "seed": args.seed,
                    "harnesses": records,
                    "verdicts": vs,
                    "elapsed_s": round(elapsed, 3),
                    "ok": ok,
                },
                indent=2,
            )
        )
    else:
        print("-- static lockset-race sites: dynamic verdicts --")
        for v in vs:
            print(f"  {v['verdict']:<12} {v['site']}")
            print(f"      {v['detail']}")
        n_ok = sum(1 for r in records if r["ok"])
        print(
            f"edl schedcheck: {n_ok}/{len(records)} harnesses ok, "
            f"{len(regressed)} regressed verdict(s) "
            f"[{elapsed:.1f}s, seed {args.seed}]"
        )
        if args.trace_dir:
            print(f"repro traces: {os.path.abspath(args.trace_dir)}/*.jsonl")
    return 0 if ok else 1


def _add_analysis_parsers(sub) -> None:
    """The parsers of ``check`` and ``schedcheck``, with the reference's
    flags."""
    ck = sub.add_parser(
        "check",
        help="project-invariant static analysis (donation safety, "
        "lockset races, recompile hazards, silent failures, telemetry "
        "conventions)",
    )
    ck.add_argument(
        "paths", nargs="*",
        help="files/dirs to analyze (default: the edl_tpu_torch package)",
    )
    ck.add_argument(
        "--rule", action="append", default=[],
        help="run only this rule id (repeatable; default: all)",
    )
    ck.add_argument(
        "--baseline", default=None,
        help="baseline JSON: findings covered there do not fail the run "
        "(the package's: edl_tpu_torch/analysis/baseline.json)",
    )
    ck.add_argument(
        "--write-baseline", default=None, metavar="PATH",
        help="triage workflow: write the current findings (incl. "
        "currently-baselined ones) as the new baseline and exit 0",
    )
    ck.add_argument("--json", action="store_true", help="machine-readable report")
    ck.add_argument(
        "--verbose", action="store_true",
        help="also list baselined findings",
    )
    ck.add_argument(
        "--root", default=None,
        help="repo root anchoring relative paths and the tests//scripts/ "
        "reference corpus (default: parent of the first path)",
    )
    ck.set_defaults(fn=run_check)

    sc = sub.add_parser(
        "schedcheck",
        help="dynamic concurrency verification: explore seeded thread "
        "interleavings of the subsystem harnesses under a vector-clock "
        "happens-before detector; label static lockset-race sites "
        "CONFIRMED/UNWITNESSED",
    )
    sc.add_argument(
        "harness", nargs="*",
        help="harness names to run (default: all; see --list)",
    )
    sc.add_argument(
        "--list", action="store_true",
        help="list available harnesses and exit",
    )
    sc.add_argument(
        "--budget", type=int, default=None, metavar="N",
        help="schedules to explore per harness (default: each "
        "harness's own budget)",
    )
    sc.add_argument(
        "--seed", type=int, default=0,
        help="base exploration seed (child schedule k runs at seed "
        "seed*10007+k; same seed => identical schedules)",
    )
    sc.add_argument(
        "--max-ops", type=int, default=None,
        help="per-schedule op cap before the run is cut off "
        "(default: each harness's own cap)",
    )
    sc.add_argument(
        "--trace-dir", default=None, metavar="DIR",
        help="dump per-harness flight-recorder JSONL (summary + each "
        "race with repro seed, forced prefix, and minimal schedule)",
    )
    sc.add_argument(
        "--no-mutations", action="store_true",
        help="skip the mutation corpus (run only the guarded harnesses)",
    )
    sc.add_argument("--json", action="store_true", help="machine-readable report")
    sc.set_defaults(fn=run_schedcheck)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
