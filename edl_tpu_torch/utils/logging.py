"""Structured key-value logging — the port's copy of
``edl_tpu/utils/logging.py`` (``kv_logger``).

``kv_logger("serving").info("engine ready", slots=8)`` renders
``msg key=value ...`` lines under the ``edl_tpu_torch`` logger tree.
The reference's flight-recorder sink is not carried over: the port has
no flight recorder yet.
"""

from __future__ import annotations

import logging
from typing import Any


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

    def error(self, msg: str, **kv: Any) -> None:
        self._log.error(self._render(msg, kv))


def kv_logger(name: str) -> KVLogger:
    return KVLogger(name)
