"""Unified telemetry of the PyTorch/CUDA port (mirrors ``edl_tpu/obs``):
the metrics registry with Prometheus exposition, the HTTP exporter
(``/metrics``, ``/trace``, ``/events``, ``/healthz``), the flight
recorder, the trace context, the compile watch, the analytic cost model
with its live efficiency gauges, and the device memory ledger.

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
from edl_tpu_torch.obs.fleet import bridge_tracer  # noqa: F401
from edl_tpu_torch.obs import disttrace  # noqa: F401  (trace context)
from edl_tpu_torch.obs.disttrace import TraceContext  # noqa: F401
from edl_tpu_torch.obs import events  # noqa: F401  (flight recorder)
from edl_tpu_torch.obs.events import (  # noqa: F401
    FlightRecorder,
    crash_dump,
    default_recorder,
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
