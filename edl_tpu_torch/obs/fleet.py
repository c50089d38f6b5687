"""Fleet-wide telemetry plumbing — the port's copy of
``edl_tpu/obs/fleet.py``: worker push, coordinator aggregation, tracer
bridging and monitor-sample exposition.

Every elastic worker (runtime/worker_main.py) starts a
:class:`MetricsPusher` that pushes a JSON snapshot of its process
registry, its flight-recorder window and its span window into the job
coordinator's KV (``{job}/metrics/{worker}`` and siblings) on a fixed
cadence; the coordinator process (runtime/coordinator_main.py
``--metrics-port``) re-exposes the union on ``/metrics`` with every
series labeled by worker (:func:`collect_fleet`), the worker-labeled
event log on ``/events`` (:func:`collect_fleet_events`) and the
offset-corrected fleet trace on ``/trace`` (:func:`collect_fleet_trace`);
:func:`straggler_pass` derives the skew and barrier-wait gauges.

Push for the worker->coordinator hop (the KV plane already exists),
pull for everything facing operators (Prometheus model). Snapshots are
full-state, so a lost push costs staleness, never correctness, and
aggregation rebuilds from scratch each scrape — no delta protocol.
"""

from __future__ import annotations

import json
import random
import threading
from collections import deque
from typing import Callable, Deque, Dict, Iterable, Optional

from edl_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from edl_tpu_torch.utils import faults
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("obs")

METRICS_KV_PREFIX = "metrics"  # {job}/metrics/{worker} holds snapshot JSON
EVENTS_KV_PREFIX = "events"  # {job}/events/{worker} holds a JSONL window
TRACE_KV_PREFIX = "trace"  # {job}/trace/{worker} holds a span window
CLOCK_KV_PREFIX = "clock"  # {job}/clock/{worker} holds a ClockEstimate


def metrics_key(job: str, worker: str) -> str:
    return f"{job}/{METRICS_KV_PREFIX}/{worker}"


def events_key(job: str, worker: str) -> str:
    return f"{job}/{EVENTS_KV_PREFIX}/{worker}"


def trace_key(job: str, worker: str) -> str:
    return f"{job}/{TRACE_KV_PREFIX}/{worker}"


def clock_key(job: str, worker: str) -> str:
    return f"{job}/{CLOCK_KV_PREFIX}/{worker}"


class MetricsPusher:
    """Daemon thread publishing periodic registry snapshots.

    ``publish(json_str)`` is injected (the worker wires a coordinator
    ``kv_put`` with its own error handling) so this module stays free
    of coordinator imports. A failing publish is logged once per
    streak and retried — telemetry must never take the step loop down.

    Failed pushes back off with jittered exponential delay (reset on
    the first success) instead of retrying every interval at full rate:
    during a coordinator outage EVERY worker's pusher is failing at
    once, and a fixed cadence turns the recovering coordinator's first
    seconds into a synchronized retry stampede. The jitter (±50%)
    decorrelates the fleet; ``backoff_cap_s`` bounds how stale a
    recovered fleet's first snapshot can be. Each failure increments
    ``edl_metrics_push_failures_total``.
    """

    def __init__(
        self,
        publish: Callable[[str], None],
        interval_s: float = 10.0,
        registry: Optional[MetricsRegistry] = None,
        backoff_cap_s: float = 300.0,
        events_publish: Optional[Callable[[str], None]] = None,
        events_window: int = 256,
        recorder=None,
        trace_publish: Optional[Callable[[str], None]] = None,
        trace_window: int = 128,
        tracer=None,
        clock_refresh: Optional[Callable[[], None]] = None,
        tsdb=None,
        crosscheck: Optional[Callable[[], Optional[dict]]] = None,
    ):
        self._publish = publish
        self.interval_s = max(float(interval_s), 0.1)
        self.backoff_cap_s = max(float(backoff_cap_s), self.interval_s)
        self.registry = registry or default_registry()
        # flight-recorder window rides the same cadence/backoff as the
        # metric snapshot (same KV plane, same failure handling): the
        # coordinator's /events shows each worker's recent timeline
        self._events_publish = events_publish
        self.events_window = events_window
        self._recorder = recorder
        # recent tracer-span window on the same cadence: what the
        # coordinator's fleet /trace merges onto one clock axis
        # (obs/disttrace.span_window_json — wall-anchored spans).
        # ``trace_window`` is the floor; a push also carries every span
        # recorded since the push before last, so each worker's window
        # spans two push intervals whatever its span rate, and windows
        # pushed out of phase still overlap (port-only: the reference
        # ships the newest ``trace_window`` only, which a rank recording
        # many spans a step fills in a fraction of an interval)
        self._trace_publish = trace_publish
        self.trace_window = trace_window
        self._tracer = tracer
        self._trace_marks: Deque[int] = deque(maxlen=2)
        # throttled clock re-sample (disttrace.ClockSync.maybe_sample
        # closure): offsets drift, so the estimate refreshes on the
        # push cadence without a dedicated thread
        self._clock_refresh = clock_refresh
        # local metric history (obs/tsdb.py): the SAME snapshot the
        # publish ships is appended on the same cadence — burn-rate
        # windows and `edl watch` come for free, zero new RPCs. A
        # string is taken as a directory path.
        if isinstance(tsdb, str):
            from edl_tpu_torch.obs.tsdb import TSDB

            tsdb = TSDB(tsdb)
        self.tsdb = tsdb
        # ledger-vs-live-arrays crosscheck on the append cadence
        # (memledger satellite): default only when history is on —
        # the result lands in the snapshot as an alertable series
        if crosscheck is None and tsdb is not None:
            crosscheck = _default_crosscheck
        self._crosscheck = crosscheck
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # push_once runs on the pusher thread AND from stop()'s
        # last-gasp call on the owner's thread; the streak/backoff
        # state it shares with next_wait_s is lock-guarded (found by
        # `edl check` lockset-race; pinned by test_obs concurrency test)
        self._state_lock = threading.Lock()
        self._failing = False
        self._fail_streak = 0
        # private PRNG: jitter must not perturb anyone's seeded
        # random.random() stream (determinism elsewhere matters more
        # than jitter quality)
        self._rng = random.Random(id(self) ^ 0xED1)
        self.pushes = 0

    def push_once(self) -> bool:
        try:
            # chaos site: the paths a real outage exercises are the
            # registry serialize + the injected publish
            faults.fault_point("metrics.push")
            if self._crosscheck is not None:
                self._run_crosscheck()
            snap = self.registry.snapshot_json()
            self._publish(snap)
            # push_once can run on the pusher thread AND from stop()'s
            # last-gasp call; the store's open-bucket accumulators are
            # not reentrant, so appends serialize on the same lock as
            # the streak state
            with self._state_lock:
                if self.tsdb is not None:
                    self.tsdb.append(snap)
            if self._events_publish is not None:
                rec = self._recorder
                if rec is None:
                    from edl_tpu_torch.obs import events as _events

                    rec = _events.default_recorder()
                # single-line doc: coordinator KV is a line protocol
                self._events_publish(rec.window_json(self.events_window))
            if self._trace_publish is not None:
                from edl_tpu_torch.obs import disttrace
                from edl_tpu_torch.utils import tracing

                tr = self._tracer or tracing.tracer()
                seq = tr._seq
                # the marks are shared by the pusher thread and stop()'s
                # last-gasp push, like the streak state
                with self._state_lock:
                    since = (self._trace_marks[0] if self._trace_marks
                             else seq)
                self._trace_publish(disttrace.span_window_json(
                    tr, max(self.trace_window, seq - since)))
                with self._state_lock:
                    self._trace_marks.append(seq)
            if self._clock_refresh is not None:
                self._clock_refresh()
            with self._state_lock:
                self.pushes += 1
                self._failing = False
                self._fail_streak = 0
            return True
        except Exception as e:
            with self._state_lock:
                self._fail_streak += 1
                first_of_streak = not self._failing
                self._failing = True
            default_registry().counter(
                "edl_metrics_push_failures_total",
                "metrics snapshot pushes that raised",
            ).inc()
            if first_of_streak:
                log.warn("metrics push failed (will retry)", error=str(e))
            return False

    def _run_crosscheck(self) -> None:
        """Refresh ``edl_hbm_crosscheck_drift_bytes`` from the memory
        ledger on the push/append cadence, so ledger drift is a series
        an alert rule can watch instead of a manual call."""
        try:
            res = self._crosscheck()
        # edl: no-lint[silent-failure] the crosscheck needs live device state; without it there is no reading, never a failed push
        except Exception:
            res = None
        if res is None:
            return
        self.registry.gauge(
            "edl_hbm_crosscheck_drift_bytes",
            "ledger-vs-live-arrays drift from memledger.crosscheck(), "
            "refreshed on the metrics-push/tsdb-append cadence",
        ).set(abs(float(res.get("unaccounted_bytes", 0.0))))

    def next_wait_s(self) -> float:
        """Delay before the next push attempt: the fixed interval while
        healthy; doubling from the interval per consecutive failure,
        capped and jittered ±50%, while failing."""
        with self._state_lock:
            streak = self._fail_streak
        if streak == 0:
            return self.interval_s
        base = min(
            self.interval_s * (2 ** min(streak, 16)),
            self.backoff_cap_s,
        )
        return base * (0.5 + self._rng.random())

    def start(self) -> "MetricsPusher":
        def _run():
            while not self._stop.wait(self.next_wait_s()):
                self.push_once()

        self._thread = threading.Thread(
            target=_run, name="edl-metrics-push", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_push:
            self.push_once()  # last-gasp snapshot so a clean exit is visible
        with self._state_lock:
            if self.tsdb is not None:
                self.tsdb.flush()  # close open buckets for readers


def _default_crosscheck() -> Optional[dict]:
    """The pusher's default ledger probe: the process-wide ledger's
    ``crosscheck()`` (obs/memledger.py), which itself returns None on
    hosts without live device state."""
    from edl_tpu_torch.obs import memledger

    return memledger.default_ledger().crosscheck()


def aggregate_snapshots(
    snaps: Dict[str, str | dict], reg: Optional[MetricsRegistry] = None
) -> MetricsRegistry:
    """Merge per-source snapshot JSONs into one registry, labeling
    every series ``worker=<source>``. Undecodable snapshots are
    skipped (a half-written KV value must not kill the scrape)."""
    reg = reg or MetricsRegistry()
    for worker, raw in sorted(snaps.items()):
        try:
            snap = json.loads(raw) if isinstance(raw, str) else raw
            reg.merge_snapshot(snap, labels={"worker": worker})
        except (ValueError, TypeError) as e:
            log.warn("bad metrics snapshot", worker=worker, error=str(e))
    return reg


def collect_fleet(
    client, job: str, extra_sources: Iterable[str] = (),
    straggler: bool = True,
) -> MetricsRegistry:
    """Coordinator-side aggregation pass: read every live member's
    pushed snapshot (plus well-known non-member sources like the
    epoch's dist_service host) from KV and merge. Rebuilt per scrape —
    counters stay correct because each pass starts from an empty
    registry. With ``straggler`` (default) the merged per-worker
    step-time histograms additionally feed the skew gauges
    (:func:`straggler_pass`)."""
    names = [m.name for m in client.members()]
    names.extend(extra_sources)
    snaps: Dict[str, str] = {}
    for name in names:
        v = client.kv_get(metrics_key(job, name))
        if v:
            snaps[name] = v
    reg = aggregate_snapshots(snaps)
    g = reg.gauge("edl_fleet_reporting_workers", "workers with a pushed metrics snapshot")
    g.set(len(snaps))
    if straggler:
        try:
            straggler_pass(reg, client=client, job=job)
        except Exception as e:  # analysis must never kill the scrape
            log.warn("straggler pass failed", error=str(e))
    return reg


def load_clock_offsets(
    client, job: str, names: Iterable[str]
) -> Dict[str, float]:
    """Per-worker clock offsets (seconds to ADD to a worker's wall
    clock to land on the coordinator axis) from the estimates each
    worker published at its register/heartbeat handshake
    (obs/disttrace.ClockSync). Missing/undecodable -> omitted (treated
    as 0 downstream)."""
    from edl_tpu_torch.obs.disttrace import ClockEstimate

    out: Dict[str, float] = {}
    for name in names:
        raw = client.kv_get(clock_key(job, name))
        if not raw:
            continue
        est = ClockEstimate.from_json(raw)
        if est is not None:
            out[name] = est.offset_s
    return out


def collect_fleet_events(
    client, job: str, extra_sources: Iterable[str] = (),
    apply_clock: bool = True,
) -> list:
    """Coordinator-side fleet log: read every live member's pushed
    flight-recorder window from KV, tag each record with its worker
    (unless the worker already stamped its context), correct each
    record's ``t_wall`` onto the coordinator's clock axis using the
    published per-worker offsets (``apply_clock``), and merge in
    causal order (corrected wall time, then per-process seq).
    Undecodable windows are skipped like bad metric snapshots — a
    half-written KV value must not kill the scrape."""
    from edl_tpu_torch.obs.events import load_jsonl

    names = [m.name for m in client.members()]
    names.extend(extra_sources)
    offsets = load_clock_offsets(client, job, names) if apply_clock else {}
    merged: list = []
    for name in names:
        raw = client.kv_get(events_key(job, name))
        if not raw:
            continue
        try:
            recs = load_jsonl(raw)
        except ValueError:
            continue  # a window with no events yet
        off = offsets.get(name, 0.0)
        for r in recs:
            r.setdefault("corr", {}).setdefault("worker", name)
            if off and "t_wall" in r:
                try:
                    r["t_wall"] = float(r["t_wall"]) + off
                except (TypeError, ValueError):
                    pass
        merged.extend(recs)
    merged.sort(key=lambda r: (r.get("t_wall", 0.0), r.get("seq", 0)))
    return merged


def collect_fleet_trace(
    client, job: str, extra_sources: Iterable[str] = (),
    local_name: str = "coordinator", tracer=None,
) -> dict:
    """The fleet ``/trace`` document: every live member's pushed span
    window ({job}/trace/{worker}), offset-corrected onto the
    coordinator's clock axis and merged into ONE Perfetto doc with a
    per-worker ``pid``, ``process_name`` metadata, and chrome flow
    events linking RPC client→server span pairs
    (obs/disttrace.merge_fleet_trace). The coordinator process's own
    tracer rides along as ``local_name`` (offset 0 — it IS the
    reference clock)."""
    from edl_tpu_torch.obs import disttrace

    names = [m.name for m in client.members()]
    names.extend(extra_sources)
    windows: Dict[str, str] = {}
    for name in names:
        raw = client.kv_get(trace_key(job, name))
        if raw:
            windows[name] = raw
    offsets = load_clock_offsets(client, job, names)
    if local_name:
        windows[local_name] = disttrace.span_window_doc(tracer)
        offsets[local_name] = 0.0
    return disttrace.merge_fleet_trace(windows, offsets)


# ---------------------------------------------------------------------------
# straggler analysis (obs/disttrace primitives -> scrapeable gauges)


# emit straggler.detected once per (worker, rounded skew) — a scrape
# cadence must not flood the flight ring with identical detections
_last_straggler: Optional[tuple] = None
_straggler_lock = threading.Lock()


def straggler_pass(
    reg: MetricsRegistry,
    client=None,
    job: Optional[str] = None,
    threshold: Optional[float] = None,
) -> None:
    """Derive straggler telemetry from a fleet-merged registry (and,
    when a KV client is given, the fleet event log):

    * ``edl_step_skew_ratio`` — slowest worker's step p50 over the
      fleet median (1.0 = even; needs >= 2 reporting workers);
    * ``edl_barrier_wait_seconds{worker}`` — rendezvous-barrier wait
      attributed to the LAST arriver (from offset-corrected
      ``worker.join`` arrivals of the latest epoch);
    * a ``straggler.detected`` flight event naming the slow worker
      when the skew crosses ``threshold`` (EDL_STRAGGLER_RATIO,
      default 1.5)."""
    import os as _os

    from edl_tpu_torch.obs import disttrace

    if threshold is None:
        try:
            threshold = float(_os.environ.get("EDL_STRAGGLER_RATIO", "1.5"))
        except ValueError:
            threshold = 1.5
    fam = reg.get("edl_train_step_seconds")
    p50s: Dict[str, float] = {}
    if fam is not None and "worker" in fam.labelnames:
        wi = list(fam.labelnames).index("worker")
        for key, _s in fam.samples():
            w = key[wi]
            p50s[w] = fam.percentile(
                0.5, **dict(zip(fam.labelnames, key))
            )
    skew, slow, median = disttrace.step_skew(p50s)
    reg.gauge(
        "edl_step_skew_ratio",
        "slowest worker step p50 over the fleet median (1.0 = even)",
    ).set(skew)
    if slow is not None and skew >= threshold:
        global _last_straggler
        sig = (slow, round(skew, 1))
        with _straggler_lock:
            fire, _last_straggler = sig != _last_straggler, sig
        if fire:
            from edl_tpu_torch.obs import events as _events

            _events.emit(
                "straggler.detected", severity="warn", worker=slow,
                skew_ratio=round(skew, 3), fleet_median_s=round(median, 6),
                p50_s=round(p50s[slow], 6),
            )
    if client is not None and job is not None:
        waits = disttrace.barrier_waits_from_events(
            collect_fleet_events(client, job)
        )
        if waits:
            g = reg.gauge(
                "edl_barrier_wait_seconds",
                "rendezvous-barrier wait charged to the last arriver",
                ("worker",),
            )
            for w, wait in sorted(waits.items()):
                g.set(wait, worker=w)


# ---------------------------------------------------------------------------
# tracer -> histogram bridge


def bridge_tracer(
    registry: Optional[MetricsRegistry] = None, tracer=None
) -> Callable:
    """Subscribe a registry to the process tracer: every recorded span
    becomes an ``edl_span_seconds{name=...}`` observation, so span
    timings (serving dispatch / drain / prefill, checkpoint I/O) are
    scrapeable as histograms, not just dumpable as a trace. Returns the
    installed listener (pass to ``Tracer.remove_listener`` to
    detach)."""
    from edl_tpu_torch.utils import tracing

    reg = registry or default_registry()
    tr = tracer or tracing.tracer()
    hist = reg.histogram(
        "edl_span_seconds", "tracer span durations by name", ("name",)
    )

    def _on_span(span) -> None:
        hist.observe(span.dur_s, name=span.name)

    tr.add_listener(_on_span)
    return _on_span


# ---------------------------------------------------------------------------
# MonitorSample -> registry (the controller/StoreSource exposition path)


def registry_from_sample(sample, reg: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Map one monitor sample (the reference's ``MonitorSample`` or any
    object with its fields: ClusterSource, StoreSource, ServingSource)
    onto gauges — the controller daemon re-exposes its census this way;
    the rendered text is the reference's (tests/test_torch_fleet_obs.py)."""
    reg = reg or MetricsRegistry()
    g = reg.gauge
    g("edl_fleet_cpu_total_milli", "cluster CPU capacity (millicores)").set(
        sample.cpu_total_milli
    )
    g("edl_fleet_cpu_request_milli", "cluster CPU requested (millicores)").set(
        sample.cpu_request_milli
    )
    g("edl_fleet_chip_total", "cluster accelerator chips").set(sample.chip_total)
    g("edl_fleet_chip_request", "cluster chips requested").set(sample.chip_request)
    g("edl_fleet_cpu_util_pct", "CPU utilization percent").set(sample.cpu_util)
    g("edl_fleet_chip_util_pct", "chip utilization percent").set(sample.chip_util)
    g("edl_fleet_jobs", "job census", ("state",)).set(
        len(sample.submitted_jobs), state="submitted"
    )
    reg.get("edl_fleet_jobs").set(len(sample.pending_jobs), state="pending")
    workers = g("edl_job_workers", "running workers", ("job",))
    target = g("edl_job_parallelism", "autoscaler target parallelism", ("job",))
    reshards = g("edl_job_reshards", "reshard count (sampled)", ("job",))
    stall = g("edl_job_last_reshard_stall_seconds", "last reshard stall", ("job",))
    fallbacks = g("edl_job_reshard_fallbacks", "host-staged reshards (sampled)", ("job",))
    for name in sample.submitted_jobs:
        workers.set(sample.running_workers.get(name, 0), job=name)
        target.set(sample.parallelism.get(name, 0), job=name)
        reshards.set(sample.reshards.get(name, 0), job=name)
        stall.set(sample.last_stall_s.get(name, 0.0), job=name)
        fallbacks.set(sample.reshard_fallbacks.get(name, 0), job=name)
    if sample.serving:
        sv = g("edl_serving_snapshot", "serving engine snapshot values", ("key",))
        for k, v in sorted(sample.serving.items()):
            sv.set(float(v), key=k)
    return reg
