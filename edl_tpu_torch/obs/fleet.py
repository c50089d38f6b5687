"""The tracer → histogram bridge of ``edl_tpu/obs/fleet.py`` (the port's
copy of ``bridge_tracer``, which ``serve --metrics-port`` installs).

The rest of the reference's fleet module — the metrics push through the
job coordinator, the fleet aggregation, the fleet trace and event
collectors and the straggler pass — belongs with the CLI's backend
switch and the process runtime, and is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

from edl_tpu_torch.obs.metrics import MetricsRegistry, default_registry


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
