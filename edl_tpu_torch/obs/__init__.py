"""Unified telemetry of the PyTorch/CUDA port (mirrors ``edl_tpu/obs``):
the metrics registry with Prometheus exposition, the HTTP exporter
(``/metrics``, ``/trace``, ``/events``, ``/history``, ``/healthz``),
the fleet push and the coordinator's aggregation, the flight recorder,
distributed tracing with the fleet trace merge, goodput under SLO, the
compile watch, the analytic cost model with its live efficiency gauges,
the device memory ledger, the on-disk metric history and the alert
engine.

torch-free at import — the CLI imports this before any device work.
"""

from edl_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    ensure_core_series,
    parse_prometheus_text,
    percentile_from_buckets,
    reset_default_registry,
)
from edl_tpu_torch.obs.exporter import (  # noqa: F401
    MetricsExporter,
    scrape,
    start_exporter,
)
from edl_tpu_torch.obs.fleet import (  # noqa: F401
    MetricsPusher,
    aggregate_snapshots,
    bridge_tracer,
    clock_key,
    collect_fleet,
    collect_fleet_events,
    collect_fleet_trace,
    events_key,
    load_clock_offsets,
    metrics_key,
    registry_from_sample,
    straggler_pass,
    trace_key,
)
from edl_tpu_torch.obs import disttrace  # noqa: F401  (distributed tracing)
from edl_tpu_torch.obs.disttrace import (  # noqa: F401
    ClockSync,
    TraceContext,
    critical_path,
    merge_fleet_trace,
)
from edl_tpu_torch.obs import events  # noqa: F401  (flight recorder)
from edl_tpu_torch.obs.events import (  # noqa: F401
    FlightRecorder,
    crash_dump,
    default_recorder,
)
from edl_tpu_torch.obs import slo  # noqa: F401  (goodput-under-SLO)
from edl_tpu_torch.obs.slo import (  # noqa: F401
    SLOClass,
    compute_goodput,
    default_classes,
)
from edl_tpu_torch.obs import compilewatch  # noqa: F401  (compile telemetry)
from edl_tpu_torch.obs import costmodel  # noqa: F401  (roofline cost model)
from edl_tpu_torch.obs.costmodel import (  # noqa: F401
    Cost,
    CostModel,
    DevicePeak,
    EfficiencyMeter,
    detect_peak,
    peak_for_device,
    peak_for_kind,
)
from edl_tpu_torch.obs import memledger  # noqa: F401  (device memory ledger)
from edl_tpu_torch.obs.memledger import (  # noqa: F401
    MemoryLedger,
    default_ledger,
    tree_nbytes,
)
from edl_tpu_torch.obs import tsdb  # noqa: F401  (on-disk metric history)
from edl_tpu_torch.obs.tsdb import (  # noqa: F401
    TSDB,
    series_key,
    snapshot_from_prometheus_text,
)
from edl_tpu_torch.obs import alerts  # noqa: F401  (burn-rate/anomaly alerting)
from edl_tpu_torch.obs.alerts import (  # noqa: F401
    DEFAULT_RULES,
    AlertEngine,
    engine_from_doc,
    load_rules_doc,
)
