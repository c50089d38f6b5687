"""``top`` — one-screen live view of any telemetry endpoint: the port's
copy of ``edl_tpu/obs/top.py``.

Scrapes ``/metrics`` (+ ``/healthz``) from an exporter — a serving
process, a training worker, or the coordinator's fleet aggregation —
and renders the headline series: training step-time breakdown,
serving TTFT/ITL percentiles and queue, reshard stalls, checkpoint
I/O. Works against any Prometheus endpoint that uses the edl metric
catalog (``obs/metrics.py``); series carrying a ``worker`` label
(the aggregated fleet view) are summed/percentiled across workers.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from edl_tpu_torch.obs.exporter import scrape
from edl_tpu_torch.obs.metrics import parse_prometheus_text, percentile_from_buckets

_Fams = Dict[str, List[Tuple[Dict[str, str], float]]]


def _total(fams: _Fams, name: str, **match: str) -> float:
    out = 0.0
    for labels, v in fams.get(name, ()):
        if all(labels.get(k) == val for k, val in match.items()):
            out += v
    return out


def _pctls(fams: _Fams, name: str, qs=(0.5, 0.95, 0.99)) -> List[float]:
    pairs = fams.get(name + "_bucket", [])
    return [percentile_from_buckets(pairs, q) for q in qs]


def _ms(v: float) -> str:
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def summarize(fams: _Fams) -> List[str]:
    """Render the parsed families into the one-screen text block."""
    lines: List[str] = []

    steps = _total(fams, "edl_train_steps_total")
    if steps or fams.get("edl_train_step_seconds_count"):
        sp = _pctls(fams, "edl_train_step_seconds")
        dw = _pctls(fams, "edl_train_data_wait_seconds", (0.5,))
        hb = _pctls(fams, "edl_train_host_block_seconds", (0.5,))
        eps = _total(fams, "edl_train_examples_per_sec")
        loss = _total(fams, "edl_train_loss")
        lines.append(
            f"TRAIN    steps={steps:.0f} "
            f"step p50/p95/p99={_ms(sp[0])}/{_ms(sp[1])}/{_ms(sp[2])} "
            f"data_wait p50={_ms(dw[0])} host_block p50={_ms(hb[0])}"
        )
        lines.append(
            f"         rows/s={eps:.1f} loss={loss:.6g} "
            f"examples={_total(fams, 'edl_train_examples_total'):.0f}"
        )

    tokens = _total(fams, "edl_serving_tokens_total")
    ttft_n = _total(fams, "edl_serving_ttft_seconds_count")
    if tokens or ttft_n:
        tp = _pctls(fams, "edl_serving_ttft_seconds")
        ip = _pctls(fams, "edl_serving_itl_seconds", (0.5,))
        op = _pctls(fams, "edl_serving_tpot_seconds", (0.5,))
        disp = _total(fams, "edl_serving_dispatch_total")
        lines.append(
            f"SERVING  ttft p50/p95/p99={_ms(tp[0])}/{_ms(tp[1])}/{_ms(tp[2])} "
            f"itl p50={_ms(ip[0])} tpot p50={_ms(op[0])} tokens={tokens:.0f}"
        )
        lines.append(
            f"         queue={_total(fams, 'edl_serving_queue_depth'):.0f} "
            f"active_slots={_total(fams, 'edl_serving_active_slots'):.0f} "
            f"dispatches={disp:.0f}"
            + (f" disp/tok={disp / tokens:.3f}" if tokens else "")
        )
        # speculation strip, only when the engine actually drafted:
        # live acceptance rate + how many tokens each verify dispatch
        # is landing (the figure --spec-k exists to raise)
        drafted = _total(fams, "edl_serving_spec_drafted_total")
        if drafted:
            accepted = _total(fams, "edl_serving_spec_accepted_total")
            vdisp = _total(fams, "edl_serving_dispatch_total",
                           kind="verify")
            lines.append(
                f"         spec accept={accepted / drafted:.1%} "
                f"drafted={drafted:.0f} accepted={accepted:.0f}"
                + (f" tok/verify={(accepted + vdisp) / vdisp:.2f}"
                   if vdisp else "")
            )
        # the TTFT decomposition, when the engine exports it: where
        # the waiting actually happened (queue vs prefill vs block)
        if _total(fams, "edl_serving_queue_wait_seconds_count"):
            qw = _pctls(fams, "edl_serving_queue_wait_seconds", (0.5, 0.99))
            pf = _pctls(fams, "edl_serving_prefill_seconds", (0.5, 0.99))
            bl = _pctls(fams, "edl_serving_block_seconds", (0.5, 0.99))
            lines.append(
                f"         phases p50/p99: queue_wait={_ms(qw[0])}/{_ms(qw[1])} "
                f"prefill={_ms(pf[0])}/{_ms(pf[1])} block={_ms(bl[0])}/{_ms(bl[1])}"
            )

    # SLO burn strip (obs/slo.py gauges; live during a loadgen run) —
    # shown whenever any class has published an attainment ratio
    slo_pairs = [
        (labels.get("slo_class", "?"), v)
        for labels, v in fams.get("edl_slo_ttft_ok_ratio", ())
        if labels.get("slo_class")
    ]
    if slo_pairs:
        itl_by_cls = {
            labels.get("slo_class"): v
            for labels, v in fams.get("edl_slo_itl_ok_ratio", ())
        }
        parts = [
            f"{cls}: ttft_ok={v:.1%} itl_ok={itl_by_cls.get(cls, 0.0):.1%}"
            for cls, v in sorted(slo_pairs)
        ]
        lines.append(
            "SLO      " + "  ".join(parts)
            + f"  goodput={_total(fams, 'edl_slo_goodput_rps'):.2f}/s"
            f" ({_total(fams, 'edl_slo_goodput_fraction'):.1%} of offered)"
        )

    # hardware-efficiency strip (obs/costmodel.py + obs/memledger.py):
    # live roofline position per phase + the HBM balance sheet — shown
    # whenever any process has published efficiency telemetry
    mfu_by_phase = {
        labels.get("phase"): v
        for labels, v in fams.get("edl_mfu", ())
        if labels.get("phase")
    }
    bw_by_phase = {
        labels.get("phase"): v
        for labels, v in fams.get("edl_bw_util_ratio", ())
        if labels.get("phase")
    }
    hbm = {
        labels.get("category"): v
        for labels, v in fams.get("edl_hbm_bytes", ())
        if labels.get("category") and v
    }
    if any(mfu_by_phase.values()) or any(bw_by_phase.values()) or hbm:
        parts = [
            f"{ph}: mfu={mfu_by_phase.get(ph, 0.0):.1%}"
            f" bw={bw_by_phase.get(ph, 0.0):.1%}"
            for ph in sorted(set(mfu_by_phase) | set(bw_by_phase))
            if mfu_by_phase.get(ph) or bw_by_phase.get(ph)
        ]
        # 8-char label like every other strip: keeps the 9-column data
        # alignment
        lines.append("ROOFLINE " + "  ".join(parts))
        if hbm:
            gb = lambda v: f"{v / (1 << 30):.2f}G"  # noqa: E731
            occ = _total(fams, "edl_kv_occupancy_ratio")
            compiles = _total(fams, "edl_compiles_total")
            kv_bpt = _total(fams, "edl_kv_bytes_per_token")
            lines.append(
                "         hbm: "
                + " ".join(f"{c}={gb(v)}" for c, v in sorted(hbm.items()))
                + (f"  kv_used={occ:.1%}" if occ else "")
                + (f"  kv_B/tok={kv_bpt:.2f}" if kv_bpt else "")
                + (f"  compiles={compiles:.0f}" if compiles else "")
            )

    nre = _total(fams, "edl_reshard_total")
    if nre:
        rp = _pctls(fams, "edl_reshard_stall_seconds")
        host = _total(fams, "edl_reshard_total", path="host")
        lines.append(
            f"RESHARD  count={nre:.0f} "
            f"stall p50/p95/p99={rp[0]:.2f}/{rp[1]:.2f}/{rp[2]:.2f}s "
            f"host_fallbacks={host:.0f}"
        )

    saves = _total(fams, "edl_checkpoint_save_seconds_count")
    if saves:
        sp = _pctls(fams, "edl_checkpoint_save_seconds", (0.5,))
        lines.append(
            f"CKPT     saves={saves:.0f} save p50={sp[0]:.3f}s "
            f"bytes={_total(fams, 'edl_checkpoint_bytes_total'):.0f}"
        )

    # alerts strip (obs/alerts.py gauges, published by whichever
    # process runs an AlertEngine — ``watch``, the coordinator, a
    # monitor) — shown only while something fires or has fired, same
    # quiet-fleet policy as INCIDENT below
    pages = _total(fams, "edl_alerts_active", severity="page")
    warns = _total(fams, "edl_alerts_active", severity="warn")
    fired = _total(fams, "edl_alerts_fired_total")
    if pages or warns or fired:
        by_rule = " ".join(
            f"{labels.get('rule')}={v:.0f}"
            for labels, v in sorted(
                fams.get("edl_alerts_fired_total", ()),
                key=lambda p: p[0].get("rule", ""),
            )
            if v
        )
        lines.append(
            f"ALERTS   pages={pages:.0f} warns={warns:.0f} "
            f"fired={fired:.0f}" + (f"  [{by_rule}]" if by_rule else "")
        )

    # incident strip: fleet health (sourced from the flight-recorder
    # counters + the robustness series) without opening any dumps —
    # shown only when something is actually wrong/noteworthy
    recov = _total(fams, "edl_serving_recoveries_total")
    injected = _total(fams, "edl_faults_injected_total")
    hb = _total(fams, "edl_worker_heartbeat_degraded")
    ev_dropped = _total(fams, "edl_events_dropped_total")
    log_errors = _total(fams, "edl_events_total", kind="log.error")
    if recov or injected or hb or ev_dropped or log_errors:
        lines.append(
            f"INCIDENT recoveries={recov:.0f} faults_injected={injected:.0f} "
            f"hb_degraded={hb:.0f} log_errors={log_errors:.0f} "
            f"dropped_events={ev_dropped:.0f}"
        )

    workers = _total(fams, "edl_fleet_reporting_workers")
    if workers:
        lines.append(f"FLEET    reporting_workers={workers:.0f}")
    # serving fleet strip (router + replica supervisor gauges)
    rep_up = _total(fams, "edl_fleet_replica_up")
    routed = _total(fams, "edl_fleet_requests_total")
    if rep_up or routed:
        lines.append(
            f"FLEET    replicas_up={rep_up:.0f} "
            f"qdepth={_total(fams, 'edl_fleet_replica_queue_depth'):.0f} "
            f"inflight={_total(fams, 'edl_fleet_replica_inflight'):.0f} "
            f"routed={routed:.0f} "
            f"failovers={_total(fams, 'edl_fleet_failovers_total'):.0f} "
            f"requeues={_total(fams, 'edl_fleet_requeues_total'):.0f}"
        )
    chip_total = _total(fams, "edl_fleet_chip_total")
    if chip_total:
        lines.append(
            f"FLEET    chips={_total(fams, 'edl_fleet_chip_request'):.0f}"
            f"/{chip_total:.0f} "
            f"cpu={_total(fams, 'edl_fleet_cpu_util_pct'):.1f}% "
            f"jobs={_total(fams, 'edl_fleet_jobs', state='submitted'):.0f}"
        )
    # chip-lease strip (elasticity broker gauges): who holds the
    # inventory right now, and how busy the handover plane has been
    if "edl_lease_chips_free" in fams:
        lines.append(
            f"LEASES   train={_total(fams, 'edl_lease_chips', side='train'):.0f} "
            f"serve={_total(fams, 'edl_lease_chips', side='serve'):.0f} "
            f"free={_total(fams, 'edl_lease_chips_free'):.0f} "
            f"recalling={_total(fams, 'edl_leases', state='RECALLING'):.0f} "
            f"epoch={_total(fams, 'edl_lease_epoch'):.0f} "
            f"handovers={_total(fams, 'edl_lease_handovers_total'):.0f}"
        )

    if not lines:
        lines.append("(no edl series observed yet)")
    return lines


def top_once(endpoint: str, timeout_s: float = 5.0) -> str:
    """One scrape, rendered. ``endpoint`` is host:port or a URL."""
    text = scrape(endpoint, "/metrics", timeout_s=timeout_s)
    header = endpoint
    try:
        hz = json.loads(scrape(endpoint, "/healthz", timeout_s=timeout_s))
        header = f"{endpoint}  up {hz.get('uptime_s', 0):.0f}s pid {hz.get('pid', '?')}"
    except (OSError, ValueError):
        # /healthz is optional: a plain Prometheus target has none, and
        # the header then names the endpoint alone
        pass
    body = summarize(parse_prometheus_text(text))
    return "\n".join([f"EDL TOP  {header}"] + body)
