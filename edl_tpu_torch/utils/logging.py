"""Structured key-value logging — the port's copy of
``edl_tpu/utils/logging.py`` (``kv_logger``).

``kv_logger("serving").info("engine ready", slots=8)`` renders
``msg key=value ...`` lines under the ``edl_tpu_torch`` logger tree.
Warn and error lines also go to the flight-recorder sink when one is
installed (``obs/events.py`` installs it at import), so they land on
the same event timeline as the decisions around them.
"""

from __future__ import annotations

import logging
from typing import Any

# flight-recorder bridge: warn/error lines mirror into the process
# event timeline when a recorder is installed (None = bridge off)
_event_sink = None


def set_event_sink(fn) -> None:
    """Install ``fn(level, logger_name, msg, kv)`` as the warn/error
    mirror, or None to detach."""
    global _event_sink
    _event_sink = fn


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
