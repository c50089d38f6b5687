"""Continuous-batching serving — the port of ``edl_tpu/serving``.

``scheduler`` and ``metrics`` are torch-free and imported eagerly; the
engine pulls in torch and loads on first access.
"""

from edl_tpu_torch.serving.metrics import ServingMetrics
from edl_tpu_torch.serving.scheduler import (
    AdmissionError,
    InterleavePolicy,
    Request,
    RequestQueue,
)

__all__ = [
    "AdmissionError",
    "ContinuousBatchingEngine",
    "InterleavePolicy",
    "Request",
    "RequestQueue",
    "RequestResult",
    "ServingMetrics",
]


def __getattr__(name):
    if name in ("ContinuousBatchingEngine", "RequestResult"):
        from edl_tpu_torch.serving import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
