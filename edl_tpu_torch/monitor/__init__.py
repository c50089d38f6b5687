"""The fleet monitor (the port of ``edl_tpu/monitor``)."""

from edl_tpu_torch.monitor.collector import (
    ClusterSource,
    Collector,
    MonitorSample,
    StoreSource,
)

__all__ = ["ClusterSource", "Collector", "MonitorSample", "StoreSource"]
