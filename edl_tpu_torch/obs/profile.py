"""`edl profile` — roofline reports from live telemetry or bench JSON:
the report side of ``edl_tpu/obs/profile.py``.

Renders where each phase sits against the card's peak (the roofline:
MFU for compute-bound phases, bandwidth utilization for memory-bound
ones) plus the HBM balance sheet and compile activity, from either

* a live ``/metrics`` endpoint (any exporter publishing the
  ``edl_mfu{phase}`` / ``edl_bw_util_ratio{phase}`` /
  ``edl_hbm_bytes{category}`` / ``edl_compile_seconds{program}``
  families — e.g. ``serve --metrics-port``), or
* a bench JSON file (the offline twin: train MFU rungs, the decode
  bandwidth ladder, prefill latency).

Report structure (the ``--json`` object)::

    {"source": ..., "peak": {...},
     "phases": {phase: {"mfu": x?, "bw_util": x?}},
     "hbm_bytes": {category: bytes}, "kv_occupancy_ratio": x,
     "compiles": {program: {"count": n, "total_s": s}},
     "recompiles_after_warmup": n}

The reference's ``--dryrun`` lane (:func:`run_dryrun`) trains through
``runtime/elastic.ElasticTrainer`` and renders the live registry.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.obs.metrics import parse_prometheus_text

_Fams = Dict[str, List[Tuple[Dict[str, str], float]]]


def _by_label(fams: _Fams, name: str, label: str) -> Dict[str, float]:
    return {
        labels[label]: v
        for labels, v in fams.get(name, ())
        if labels.get(label)
    }


def report_from_fams(fams: _Fams, source: str = "") -> dict:
    """Build the roofline report from parsed Prometheus families."""
    phases: Dict[str, dict] = {}
    for ph, v in _by_label(fams, "edl_mfu", "phase").items():
        phases.setdefault(ph, {})["mfu"] = v
    for ph, v in _by_label(fams, "edl_bw_util_ratio", "phase").items():
        phases.setdefault(ph, {})["bw_util"] = v
    hbm = {
        c: v
        for c, v in _by_label(fams, "edl_hbm_bytes", "category").items()
        if v
    }
    compiles: Dict[str, dict] = {}
    for pg, n in _by_label(fams, "edl_compile_seconds_count", "program").items():
        if n:
            compiles[pg] = {"count": n}
    for pg, s in _by_label(fams, "edl_compile_seconds_sum", "program").items():
        if pg in compiles:
            compiles[pg]["total_s"] = s
    occ = sum(v for _, v in fams.get("edl_kv_occupancy_ratio", ()))
    recompiles = sum(
        v
        for labels, v in fams.get("edl_events_total", ())
        if labels.get("kind") == "obs.recompile"
    )
    return {
        "source": source,
        "peak": None,  # live gauges are already ratios; peak is implicit
        "phases": phases,
        "hbm_bytes": hbm,
        "kv_occupancy_ratio": occ,
        "compiles": compiles,
        "recompiles_after_warmup": recompiles,
    }


def report_from_endpoint(endpoint: str, timeout_s: float = 5.0) -> dict:
    from edl_tpu_torch.obs.exporter import scrape

    text = scrape(endpoint, "/metrics", timeout_s=timeout_s)
    return report_from_fams(parse_prometheus_text(text), source=endpoint)


def report_from_bench(path: str) -> dict:
    """The offline twin: map a bench JSON round's published figures
    onto roofline rows (train MFU rungs; the decode bandwidth ladder
    whose pct-of-peak the shared cost model computed; prefill)."""
    with open(path) as f:
        doc = json.load(f)
    doc = doc.get("parsed", doc)  # a wrapped record or a bare bench line
    phases: Dict[str, dict] = {}
    for key, phase in (
        ("mfu", "train"),
        ("int8_mfu", "train_int8"),
        ("long_mfu", "train_long"),
        ("int8_long_mfu", "train_int8_long"),
    ):
        v = doc.get(key)
        if v is not None and v > 0:
            phases[phase] = {"mfu": v}
    for rung in doc.get("decode_ladder", []):
        if rung.get("decode_pct_peak_bw", -1) > 0:
            phases[f"decode_b{rung['b']}"] = {
                "bw_util": rung["decode_pct_peak_bw"],
                "tokens_per_s": rung.get("decode_tokens_per_sec"),
            }
    for key, phase in (
        ("decode_int8_pct_peak_bw", "decode_int8"),
        ("decode_int8_b1_pct_peak_bw", "decode_int8_b1"),
    ):
        v = doc.get(key)
        if v is not None and v > 0:
            phases[phase] = {"bw_util": v}
    if doc.get("prefill_s", -1) > 0:
        phases["prefill"] = {"seconds": doc["prefill_s"]}
    peak = None
    if doc.get("peak_tflops"):
        peak = {"tflops": doc["peak_tflops"]}
    hbm = {}
    if doc.get("flagship_state_gb"):
        hbm["train_state"] = doc["flagship_state_gb"] * (1 << 30)
    return {
        "source": path,
        "peak": peak,
        "phases": phases,
        "hbm_bytes": hbm,
        "kv_occupancy_ratio": 0.0,
        "compiles": (
            {"bench.ctr_multistep": {"count": 1, "total_s": doc["compile_s"]}}
            if doc.get("compile_s")
            else {}
        ),
        "recompiles_after_warmup": 0,
    }


def render_report(report: dict) -> str:
    lines = [f"EDL ROOFLINE  {report.get('source', '')}"]
    peak = report.get("peak")
    if peak and peak.get("tflops"):
        lines.append(f"peak: {peak['tflops']:.1f} TFLOP/s (bf16, spec)")
    phases = report.get("phases", {})
    if phases:
        lines.append(f"{'phase':<16} {'mfu':>8} {'bw_util':>8} {'notes':>14}")
        for ph in sorted(phases):
            row = phases[ph]
            mfu = row.get("mfu")
            bw = row.get("bw_util")
            notes = ""
            if row.get("tokens_per_s"):
                notes = f"{row['tokens_per_s']:.0f} tok/s"
            elif row.get("seconds"):
                notes = f"{row['seconds'] * 1e3:.1f} ms"
            lines.append(
                f"{ph:<16} "
                f"{(f'{mfu:.1%}' if mfu is not None else '-'):>8} "
                f"{(f'{bw:.1%}' if bw is not None else '-'):>8} "
                f"{notes:>14}"
            )
    else:
        lines.append("(no efficiency telemetry published yet)")
    hbm = report.get("hbm_bytes") or {}
    if hbm:
        occ = report.get("kv_occupancy_ratio") or 0.0
        lines.append(
            "hbm: "
            + "  ".join(
                f"{c}={v / (1 << 30):.3f}G" for c, v in sorted(hbm.items())
            )
            + (f"  (kv {occ:.1%} occupied)" if occ else "")
        )
    compiles = report.get("compiles") or {}
    if compiles:
        lines.append(
            "compiles: "
            + "  ".join(
                f"{p}×{int(c['count'])}"
                + (
                    f" ({c['total_s']:.2f}s)"
                    if c.get("total_s") is not None
                    else ""
                )
                for p, c in sorted(compiles.items())
            )
        )
    n = report.get("recompiles_after_warmup", 0)
    lines.append(
        f"recompiles after warmup: {int(n)}"
        + ("  <-- steady-state compile, investigate" if n else " (clean)")
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the dryrun lane


def run_dryrun(metrics_port: Optional[int] = None, steps: int = 4,
               device=None) -> dict:
    """The reference's self-contained efficiency exercise: a short
    ``ElasticTrainer`` window (a pool of one: this process) with the
    analytic per-example cost, then a warmed serving workload, then
    hard assertions over the process's own telemetry. Runs on the card
    unless ``device`` names the CPU. Returns the report; raises
    AssertionError when an acceptance series is missing or zero, or the
    steady-state loop recompiled."""
    import numpy as np

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.obs import compilewatch
    from edl_tpu_torch.obs import costmodel as cm
    from edl_tpu_torch.obs import events as flight
    from edl_tpu_torch.obs import memledger
    from edl_tpu_torch.obs import metrics as om
    from edl_tpu_torch.runtime.elastic import ElasticTrainer
    from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from edl_tpu_torch.train.trainer import adam
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    exporter = None
    if metrics_port is not None:
        from edl_tpu_torch.obs.exporter import start_exporter

        exporter = start_exporter(port=metrics_port)
        print(f"# metrics endpoint {exporter.url}/metrics")

    cfg = llama.LlamaConfig.tiny(vocab=128)
    seq = 32

    # -- train window through the elastic trainer ----------------------
    trainer = ElasticTrainer(
        llama.make_loss_fn(cfg),
        adam(1e-3),  # real moments: the ledger's "opt" category
        chips_per_worker=1,
        per_chip_batch=2,
        flops_per_example=seq * cm.train_flops_per_token(cfg, seq),
        hbm_bytes_per_example=cm.train_step_bytes(cfg, seq) / 2,
        device=dev,
    )
    rng = np.random.RandomState(0)
    trainer.start(llama.init_params(cfg, seed=0, device=dev), 1)

    def data_fn(batch):
        return llama.synthetic_tokens(rng, batch, seq, cfg.vocab)

    trainer.train_steps(data_fn, steps)

    # -- serving: warm pass, then the steady-state loop ----------------
    def workload(eng):
        for i in range(4):
            eng.submit(f"p{i}", [1 + i, 2, 3], 10)
        eng.run()

    params = {k: v for k, v in trainer.merged_state.params.items()}
    warm = ContinuousBatchingEngine(params, cfg, max_slots=2, max_len=32,
                                    horizon=4, device=dev)
    workload(warm)
    del warm
    compilewatch.mark_warm()

    def recompiles():
        return sum(1 for r in flight.default_recorder().records()
                   if r.get("kind") == "obs.recompile")

    rec_before = recompiles()
    eng = ContinuousBatchingEngine(params, cfg, max_slots=2, max_len=32,
                                   horizon=4, device=dev)
    # hold a mid-flight view so kv occupancy is non-zero at scrape time
    for i in range(3):
        eng.submit(f"s{i}", [3 + i, 1], 12)
    for _ in range(3):
        eng.step()

    # -- self-scrape + hard assertions ---------------------------------
    if exporter is not None:
        from edl_tpu_torch.obs.exporter import scrape

        text = scrape(exporter.url)
    else:
        text = om.default_registry().render()
    fams = parse_prometheus_text(text)
    report = report_from_fams(
        fams, source=exporter.url if exporter else "in-process")

    def val(name, **match):
        return sum(v for labels, v in fams.get(name, ())
                   if all(labels.get(k) == mv for k, mv in match.items()))

    for phase in ("train", "decode", "prefill"):
        assert val("edl_mfu", phase=phase) > 0, (
            f"edl_mfu{{phase={phase}}} is zero — the efficiency meter "
            "never fired")
    assert val("edl_bw_util_ratio", phase="decode") > 0, (
        "edl_bw_util_ratio{phase=decode} is zero")
    assert val("edl_hbm_bytes", category="kv") > 0, (
        "edl_hbm_bytes{category=kv} is zero — the KV cache never "
        "registered on the memory ledger")
    for cat in ("params", "opt"):
        assert val("edl_hbm_bytes", category=cat) > 0, (
            f"edl_hbm_bytes{{category={cat}}} is zero")
    assert val("edl_kv_occupancy_ratio") > 0, "kv occupancy gauge is zero"
    assert val("edl_compile_seconds_count") > 0, (
        "edl_compile_seconds has no observations")
    rec_after = recompiles()
    assert rec_after == rec_before == 0, (
        f"obs.recompile fired {rec_after} time(s) on the steady-state "
        "serving loop")
    eng.run()
    xc = memledger.default_ledger().crosscheck()
    if xc is not None:
        report["crosscheck"] = xc
    if exporter is not None:
        exporter.stop()
    print(f"profile dryrun OK: mfu train/decode/prefill non-zero, "
          f"kv={val('edl_hbm_bytes', category='kv'):.0f}B on ledger, "
          f"{int(val('edl_compiles_total'))} compiles, 0 recompiles "
          "after warmup")
    return report


def is_bench_file(source: str) -> bool:
    return os.path.exists(source) and source.endswith(".json")


def report_for_source(source: str, timeout_s: float = 5.0) -> dict:
    if is_bench_file(source):
        return report_from_bench(source)
    return report_from_endpoint(source, timeout_s=timeout_s)
