"""The task record of the elastic data queue — the part of
``edl_tpu/runtime/data.py`` that the coordinator client needs. The queue
classes (``ElasticDataQueue``, ``QueueBatcher``) belong to the in-process
coordinator and are not ported yet (ROADMAP Queue A item 9c).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Task:
    """One chunk of work: a half-open range [start, end) of sample
    indices (the RecordIO-chunk analog)."""

    task_id: int
    start: int
    end: int
    epoch: int
    failures: int = 0
