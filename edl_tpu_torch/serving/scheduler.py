"""Request scheduler — the admission-controlled FIFO feeding the
continuous-batching engine.

The reference paper's control plane keeps hardware at target
utilization while MEMBERSHIP changes; in serving, requests are the
elastic membership and this queue is where they join. Admission control
bounds the three resources a slot engine actually has: queue memory
(``max_depth``), KV-cache rows (``max_total_len`` — a prompt plus its
token budget must fit one slot), and per-request decode time
(``max_new_cap``). Rejections are typed (:class:`AdmissionError`) so
the metrics layer can count WHY load was shed, not just that it was.

The PyTorch port's copy of ``edl_tpu/serving/scheduler.py``, unchanged.
torch-free on purpose: the CLI validates and queues requests before
any device work, and tests exercise policy without an engine.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional


@dataclass
class Request:
    """One generation request: prompt token ids plus its decode budget.
    ``eos_id`` stops decode early when emitted (the EOS token is
    included in the output, outcome "eos"). ``deadline_s`` is a RELATIVE
    latency budget from submit: past it, the engine sheds the request
    from the queue (``rejected:timeout``) or evicts its slot between
    blocks (outcome "timeout") — overload degrades by dropping the
    stalest work, never by growing the queue without bound.

    ``tenant`` and ``slo_class`` are attribution labels (None = the
    single-tenant/SLO-less feed): the metrics layer counts terminal
    outcomes under them (``edl_serving_outcomes_total``) and the
    flight-recorder submit/finish events carry them, so a postmortem
    can answer "which tenant got shed" — the label plumbing every
    fairness/priority scheduler upgrade will route decisions by."""

    rid: str
    prompt: List[int]
    max_new: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    submit_s: float = 0.0  # stamped by the queue at admission
    recoveries: int = 0  # engine crash-recovery passes charged while queued
    tenant: Optional[str] = None  # multi-tenant attribution
    slo_class: Optional[str] = None  # SLO class (obs/slo.py)

    def deadline_at(self) -> Optional[float]:
        """Absolute deadline on the queue's clock, or None."""
        if self.deadline_s is None:
            return None
        return self.submit_s + self.deadline_s


class AdmissionError(ValueError):
    """A request the queue refuses. ``reason`` is a stable counter key:
    queue_full | prompt_too_long | budget | bad_request."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


class RequestQueue:
    """FIFO with admission control.

    ``max_total_len`` is the engine's slot length S: a request is only
    admitted when ``len(prompt) + max_new <= S``, so an admitted request
    can ALWAYS run to its budget without overflowing its KV slot — the
    engine never has to truncate mid-flight. ``max_prompt_len`` defaults
    to S - 1 (room for at least one generated token); ``max_new_cap``
    (0 = uncapped) bounds how long one request may hold a slot."""

    def __init__(
        self,
        max_total_len: int,
        max_depth: int = 64,
        max_prompt_len: int = 0,
        max_new_cap: int = 0,
        clock=time.monotonic,
    ):
        if max_total_len < 2:
            raise ValueError(f"max_total_len must be >= 2, got {max_total_len}")
        self.max_total_len = max_total_len
        self.max_depth = max_depth
        self.max_prompt_len = max_prompt_len or (max_total_len - 1)
        self.max_new_cap = max_new_cap
        self.clock = clock
        self._q: Deque[Request] = deque()

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> None:
        """Admit or raise :class:`AdmissionError`."""
        if not req.prompt or req.max_new < 1:
            raise AdmissionError(
                "bad_request",
                f"{req.rid}: need a non-empty prompt and max_new >= 1",
            )
        if len(req.prompt) > self.max_prompt_len:
            raise AdmissionError(
                "prompt_too_long",
                f"{req.rid}: prompt length {len(req.prompt)} exceeds "
                f"max_prompt_len {self.max_prompt_len}",
            )
        if self.max_new_cap and req.max_new > self.max_new_cap:
            raise AdmissionError(
                "budget",
                f"{req.rid}: max_new {req.max_new} exceeds per-request "
                f"cap {self.max_new_cap}",
            )
        if len(req.prompt) + req.max_new > self.max_total_len:
            raise AdmissionError(
                "budget",
                f"{req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds the {self.max_total_len}-token "
                f"KV slot",
            )
        if len(self._q) >= self.max_depth:
            raise AdmissionError(
                "queue_full",
                f"{req.rid}: queue depth {len(self._q)} at max_depth "
                f"{self.max_depth}",
            )
        req.submit_s = self.clock()
        self._q.append(req)

    def pop(self) -> Optional[Request]:
        """Next request for prefill (FIFO), or None when empty."""
        return self._q.popleft() if self._q else None

    def requeue_front(self, req: Request) -> None:
        """Put an already-admitted request back at the HEAD of the
        queue (crash recovery: a request popped for prefill when the
        engine faulted keeps its FIFO position — no re-validation, it
        already passed admission)."""
        self._q.appendleft(req)


@dataclass(frozen=True)
class InterleavePolicy:
    """Prefill/decode interleaving: at most ``prefills_per_step`` queue
    pops are prefilled between consecutive batched decode steps. A
    prefill is a full forward over the prompt — much heavier than one
    decode step — so unbounded admission would starve in-flight
    requests (decode stalls while a burst prefills); 1 is the classic
    continuous-batching choice (Orca-style iteration scheduling), higher
    values drain a deep queue faster at the cost of decode latency
    jitter.

    With a fused decode HORIZON (H steps per dispatched block),
    admission lands on BLOCK boundaries — there is no between-steps
    gap inside a block to prefill into. :meth:`block_budget` is the
    drain-to-admit budget for one boundary: the per-step rate scaled
    by the H steps the block covers, so the admission rate a deployment
    tuned at H=1 carries over unchanged to any horizon (a boundary
    admits what H per-step boundaries would have)."""

    prefills_per_step: int = 1

    def budget(self, free_slots: int, queue_depth: int) -> int:
        return max(0, min(self.prefills_per_step, free_slots, queue_depth))

    def block_budget(
        self, free_slots: int, queue_depth: int, horizon: int
    ) -> int:
        return max(
            0,
            min(
                self.prefills_per_step * max(1, horizon),
                free_slots,
                queue_depth,
            ),
        )
