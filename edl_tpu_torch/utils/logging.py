"""Structured key-value logging — the port's copy of
``edl_tpu/utils/logging.py`` (``kv_logger`` and ``Timer``).

``kv_logger("serving").info("engine ready", slots=8)`` renders
``msg key=value ...`` lines (values as ``repr``) under the
``edl_tpu_torch`` logger tree; :func:`configure` installs its handler.
Warn and error lines also go to the flight-recorder sink when one is
installed (``obs/events.py`` installs it at import), so they land on
the same event timeline as the decisions around them.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Any

_FORMAT = "%(asctime)s %(levelname)-5s [%(name)s] %(message)s"
_configured = False

# flight-recorder bridge: warn/error lines mirror into the process
# event timeline when a recorder is installed (None = bridge off)
_event_sink = None


def set_event_sink(fn) -> None:
    """Install ``fn(level, logger_name, msg, kv)`` as the warn/error
    mirror, or None to detach."""
    global _event_sink
    _event_sink = fn


def configure(level: str = "info", stream=None) -> None:
    """Install the handler of the ``edl_tpu_torch`` logger tree once
    (a worker process's log; reference flag: -log_level,
    cmd/edl/edl.go:18)."""
    global _configured
    root = logging.getLogger("edl_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not _configured:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
        root.propagate = False
        _configured = True


class KVLogger:
    def __init__(self, name: str):
        self._log = logging.getLogger(f"edl_tpu_torch.{name}")

    @staticmethod
    def _render(msg: str, kv: dict) -> str:
        if not kv:
            return msg
        parts = " ".join(f"{k}={v!r}" for k, v in kv.items())
        return f"{msg} {parts}"

    def debug(self, msg: str, **kv: Any) -> None:
        self._log.debug(self._render(msg, kv))

    def info(self, msg: str, **kv: Any) -> None:
        self._log.info(self._render(msg, kv))

    def warn(self, msg: str, **kv: Any) -> None:
        self._log.warning(self._render(msg, kv))
        if _event_sink is not None:
            _event_sink("warn", self._log.name, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log.error(self._render(msg, kv))
        if _event_sink is not None:
            _event_sink("error", self._log.name, msg, kv)


def kv_logger(name: str) -> KVLogger:
    return KVLogger(name)


class Timer:
    """Context-manager stopwatch (``elapsed`` seconds): the reshard
    stall's clock in ``runtime/elastic.py``."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
