"""Cluster monitor — the user-facing observability surface.

Port of the reference's demo monitor (reference:
example/fit_a_line/collector.py:51-226), which polls the cluster every
10 s and prints SUBMITTED-JOBS / PENDING-JOBS / RUNNING-TRAINERS /
CPU-UTILS. Here the census adds TPU-chip utilization (the metric that
matters on a chip-exclusive fleet) and reshard observability
(count + last stall seconds — the BASELINE.md north-star metric).

Two sources:
  * ClusterSource — in-process, reads a live Cluster backend (and its
    jobs' statuses), for tests and single-process demos;
  * StoreSource  — cross-process, reads the JobStore status records the
    controller daemon writes (the collector's kubectl-config analog).

The port of ``edl_tpu/monitor/collector.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("monitor")


@dataclass
class MonitorSample:
    """One poll of the fleet (reference: collector.py main loop :215-226)."""

    ts: float = 0.0
    submitted_jobs: List[str] = field(default_factory=list)
    pending_jobs: List[str] = field(default_factory=list)
    running_workers: Dict[str, int] = field(default_factory=dict)
    parallelism: Dict[str, int] = field(default_factory=dict)
    phases: Dict[str, str] = field(default_factory=dict)
    reshards: Dict[str, int] = field(default_factory=dict)
    last_stall_s: Dict[str, float] = field(default_factory=dict)
    # host-staged (slow-path) reshards — alarm signal, see
    # doc/reshard_stall.md
    reshard_fallbacks: Dict[str, int] = field(default_factory=dict)
    cpu_total_milli: int = 0
    cpu_request_milli: int = 0
    chip_total: int = 0
    chip_request: int = 0
    # serving-engine load (ServingSource / ServingMetrics.snapshot) —
    # empty for training-fleet samples. Same plumbing as training load
    # so an autoscaler can consume either.
    serving: Dict[str, float] = field(default_factory=dict)
    # hardware-efficiency gauges (obs/costmodel.py efficiency_snapshot:
    # mfu_<phase>, bw_util_<phase>, hbm_bytes_<category>,
    # kv_occupancy_ratio) — empty until a process publishes them. Rides
    # to_record(), so `edl monitor --json` consumers see the roofline.
    efficiency: Dict[str, float] = field(default_factory=dict)
    # alert-engine state (obs/alerts.py AlertEngine.to_block():
    # active/fired_total/last_transition) — populated when the monitor
    # was given an evaluation source (`edl monitor --tsdb`). Rides
    # to_record(), so `edl monitor --json` consumers see active pages.
    alerts: Dict[str, object] = field(default_factory=dict)

    @property
    def cpu_util(self) -> float:
        """reference: cpu_utils collector.py:156-171."""
        if self.cpu_total_milli <= 0:
            return 0.0
        return 100.0 * self.cpu_request_milli / self.cpu_total_milli

    @property
    def chip_util(self) -> float:
        if self.chip_total <= 0:
            return 0.0
        return 100.0 * self.chip_request / self.chip_total

    def render(self) -> str:
        """Text block in the reference collector's table style. A
        serving-only sample (ServingSource: no fleet census at all)
        renders just its SERVING block."""
        if self.serving and not (
            self.submitted_jobs or self.chip_total or self.cpu_total_milli
        ):
            return "\n".join(
                self._serving_lines()
                + (self._efficiency_lines() if self.efficiency else [])
                + self._alert_lines()
            )
        lines = [
            f"SUBMITTED-JOBS: {len(self.submitted_jobs)}",
            f"PENDING-JOBS: {len(self.pending_jobs)}"
            + (f" ({', '.join(self.pending_jobs)})" if self.pending_jobs else ""),
            "RUNNING-TRAINERS:",
        ]
        for name in self.submitted_jobs:
            n = self.running_workers.get(name, 0)
            extras = []
            if name in self.parallelism:
                extras.append(f"target={self.parallelism[name]}")
            if name in self.phases:
                extras.append(f"phase={self.phases[name]}")
            if self.reshards.get(name):
                extras.append(
                    f"reshards={self.reshards[name]}"
                    f" last_stall={self.last_stall_s.get(name, 0.0):.2f}s"
                )
                if self.reshard_fallbacks.get(name):
                    extras.append(
                        f"host_fallbacks={self.reshard_fallbacks[name]}"
                    )
            suffix = (" [" + " ".join(extras) + "]") if extras else ""
            lines.append(f"  {name}: {n}{suffix}")
        lines.append(f"CPU-UTILS: {self.cpu_util:.2f}%")
        lines.append(
            f"CHIP-UTILS: {self.chip_util:.2f}% "
            f"({self.chip_request}/{self.chip_total})"
        )
        if self.serving:
            lines.extend(self._serving_lines())
        if self.efficiency:
            lines.extend(self._efficiency_lines())
        lines.extend(self._alert_lines())
        return "\n".join(lines)

    def _alert_lines(self) -> List[str]:
        """ALERTS strip — only when the engine reports firing rules, in
        the `edl top` INCIDENT-strip style (quiet fleets stay quiet)."""
        active = (self.alerts or {}).get("active") or []
        if not active:
            return []
        parts = []
        for a in active:
            detail = " ".join(
                f"{k}={v:.4g}" for k, v in sorted(a.items())
                if k not in ("rule", "severity", "since")
                and isinstance(v, (int, float))
            )
            parts.append(
                f"{a.get('rule')}[{a.get('severity')}]"
                + (f" {detail}" if detail else "")
            )
        return ["ALERTS: " + "  ".join(parts)]

    def _efficiency_lines(self) -> List[str]:
        e = self.efficiency
        phases = sorted(
            k[len("mfu_"):] for k in e if k.startswith("mfu_")
        )
        parts = [
            f"{ph}: mfu={e.get(f'mfu_{ph}', 0.0):.1%}"
            f" bw={e.get(f'bw_util_{ph}', 0.0):.1%}"
            for ph in phases
        ]
        hbm = {
            k[len("hbm_bytes_"):]: v
            for k, v in e.items()
            if k.startswith("hbm_bytes_") and v
        }
        line = "EFFICIENCY: " + "  ".join(parts) if parts else "EFFICIENCY:"
        if hbm:
            line += "  hbm " + " ".join(
                f"{c}={v / (1 << 30):.2f}G" for c, v in sorted(hbm.items())
            )
        if e.get("kv_occupancy_ratio"):
            line += f"  kv_used={e['kv_occupancy_ratio']:.1%}"
        return [line]

    def _serving_lines(self) -> List[str]:
        s = self.serving
        lines = [
            "SERVING: "
            f"queue={s.get('queue_depth', 0):.0f} "
            f"active={s.get('active_slots', 0):.0f}"
            f"/{s.get('max_slots', 0):.0f} "
            f"occupancy={100.0 * s.get('slot_occupancy', 0.0):.1f}% "
            f"ttft_avg={s.get('ttft_avg_s', 0.0):.3f}s "
            f"tokens/s={s.get('agg_tokens_per_s', 0.0):.1f}",
            "  requests: "
            f"submitted={s.get('submitted', 0):.0f} "
            f"admitted={s.get('admitted', 0):.0f} "
            f"rejected={s.get('rejected', 0):.0f} "
            f"completed={s.get('completed', 0):.0f} "
            f"tokens={s.get('tokens_out', 0):.0f}",
        ]
        # histogram-backed latency percentiles (serving/metrics.py);
        # absent on snapshots from engines predating them
        if "ttft_p50_s" in s:
            lines.append(
                "  latency: ttft p50/p95/p99="
                f"{s.get('ttft_p50_s', 0.0):.3f}/"
                f"{s.get('ttft_p95_s', 0.0):.3f}/"
                f"{s.get('ttft_p99_s', 0.0):.3f}s "
                "itl p50/p95/p99="
                f"{s.get('itl_p50_s', 0.0) * 1e3:.1f}/"
                f"{s.get('itl_p95_s', 0.0) * 1e3:.1f}/"
                f"{s.get('itl_p99_s', 0.0) * 1e3:.1f}ms"
            )
        # the latency decomposition + TPOT (serving/metrics.py):
        # absent on snapshots from engines predating them
        if "queue_wait_p50_s" in s:
            lines.append(
                "  phases: queue_wait p50/p99="
                f"{s.get('queue_wait_p50_s', 0.0) * 1e3:.1f}/"
                f"{s.get('queue_wait_p99_s', 0.0) * 1e3:.1f}ms "
                "prefill p50/p99="
                f"{s.get('prefill_p50_s', 0.0) * 1e3:.1f}/"
                f"{s.get('prefill_p99_s', 0.0) * 1e3:.1f}ms "
                "tpot p50="
                f"{s.get('tpot_p50_s', 0.0) * 1e3:.1f}ms"
            )
        return lines

    def to_record(self) -> Dict:
        """JSON-able machine-readable twin of :meth:`render` — what
        ``edl monitor --json`` emits as JSONL for scripts and the
        future autoscaler to tail. Field names match the dataclass,
        plus the derived utilization percentages."""
        rec = dataclasses.asdict(self)
        rec["cpu_util"] = self.cpu_util
        rec["chip_util"] = self.chip_util
        return rec


class ClusterSource:
    """Sample a live Cluster backend in-process."""

    def __init__(self, cluster):
        self.cluster = cluster

    def sample(self) -> MonitorSample:
        s = MonitorSample(ts=time.time())
        r = self.cluster.inquiry_resource()
        s.cpu_total_milli = r.cpu_total_milli
        s.cpu_request_milli = r.cpu_request_milli
        s.chip_total = r.chip_total
        s.chip_request = r.chip_request
        for job in self.cluster.list_jobs():
            s.submitted_jobs.append(job.name)
            total, running, pending = self.cluster.job_pods(job)
            s.running_workers[job.name] = running
            # reference: get_pending_jobs collector.py:194-213 — a job is
            # pending while it has waiting pods and nothing running yet.
            if pending > 0 and running == 0:
                s.pending_jobs.append(job.name)
            s.parallelism[job.name] = job.status.parallelism
            s.phases[job.name] = str(job.status.phase.value)
            s.reshards[job.name] = job.status.reshard_count
            s.last_stall_s[job.name] = job.status.last_reshard_stall_s
            s.reshard_fallbacks[job.name] = job.status.reshard_fallbacks
        return s


class StoreSource:
    """Sample the JobStore statuses a controller daemon writes."""

    def __init__(self, store):
        self.store = store

    def sample(self) -> MonitorSample:
        s = MonitorSample(ts=time.time())
        census = self.store.read_cluster() or {}
        s.cpu_total_milli = census.get("cpu_total_milli", 0)
        s.cpu_request_milli = census.get("cpu_request_milli", 0)
        s.chip_total = census.get("chip_total", 0)
        s.chip_request = census.get("chip_request", 0)
        statuses = self.store.list_statuses()
        for ns, name in self.store.list_keys():
            s.submitted_jobs.append(name)
            st = statuses.get((ns, name), {})
            running = st.get("running", 0)
            s.running_workers[name] = running
            if st.get("pending", 0) > 0 and running == 0:
                s.pending_jobs.append(name)
            s.parallelism[name] = st.get("parallelism", 0)
            s.phases[name] = st.get("phase", "none")
            s.reshards[name] = st.get("reshard_count", 0)
            s.last_stall_s[name] = st.get("last_reshard_stall_s", 0.0)
            s.reshard_fallbacks[name] = st.get("reshard_fallbacks", 0)
        return s


class ServingSource:
    """Sample a serving engine's :class:`~edl_tpu_torch.serving.metrics.
    ServingMetrics` — serving load through the SAME collector plumbing
    as training load, so the autoscaler can later consume either. Takes
    the metrics object itself (or any zero-arg callable returning a
    snapshot dict), keeping this module jax-free."""

    def __init__(self, metrics):
        self._snapshot = (
            metrics if callable(metrics) else metrics.snapshot
        )
        # the engine's efficiency gauges live in the same registry its
        # ServingMetrics records into; callables fall back to the
        # process default
        self._registry = getattr(metrics, "registry", None)

    def sample(self) -> MonitorSample:
        from edl_tpu_torch.obs.costmodel import efficiency_snapshot

        s = MonitorSample(ts=time.time())
        s.serving = dict(self._snapshot())
        s.efficiency = efficiency_snapshot(self._registry)
        return s


class Collector:
    """Poll a source and print samples (reference: Collector
    collector.py:51 + the 10 s main loop :215-226). ``jsonl=True``
    swaps the human table for one JSON object per poll
    (:meth:`MonitorSample.to_record`) — the machine-readable twin."""

    def __init__(
        self, source, interval_s: float = 10.0, out=None, jsonl: bool = False,
        alerts_source=None,
    ):
        self.source = source
        self.interval_s = interval_s
        self.out = out
        self.jsonl = jsonl
        # zero-arg callable returning an AlertEngine.to_block() dict
        # (obs/alerts.py) — evaluated once per poll so the alerts block
        # is as fresh as the census it rides with
        self.alerts_source = alerts_source
        self.samples: List[MonitorSample] = []

    def poll(self) -> MonitorSample:
        s = self.source.sample()
        if self.alerts_source is not None:
            s.alerts = self.alerts_source()
        self.samples.append(s)
        return s

    def run(self, n_polls: Optional[int] = None) -> None:
        import sys

        out = self.out or sys.stdout
        i = 0
        while n_polls is None or i < n_polls:
            s = self.poll()
            if self.jsonl:
                print(json.dumps(s.to_record()), file=out, flush=True)
            else:
                print(
                    time.strftime("---- %H:%M:%S", time.localtime(s.ts)),
                    file=out,
                )
                print(s.render(), file=out, flush=True)
            i += 1
            if n_polls is not None and i >= n_polls:
                break
            time.sleep(self.interval_s)
