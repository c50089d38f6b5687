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
``ElasticTrainer``, which is not ported yet; it raises until then.
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


def run_dryrun(metrics_port: Optional[int] = None, steps: int = 4) -> dict:
    """The reference's self-contained efficiency exercise: a short
    ``ElasticTrainer`` window, then a warmed serving workload and hard
    assertions over the process's own telemetry. ``ElasticTrainer`` is
    not ported yet (ROADMAP Queue A item 2b), so this raises."""
    raise NotImplementedError(
        "profile --dryrun trains through ElasticTrainer, which is not "
        "ported yet (ROADMAP Queue A item 2b)"
    )


def is_bench_file(source: str) -> bool:
    return os.path.exists(source) and source.endswith(".json")


def report_for_source(source: str, timeout_s: float = 5.0) -> dict:
    if is_bench_file(source):
        return report_from_bench(source)
    return report_from_endpoint(source, timeout_s=timeout_s)
