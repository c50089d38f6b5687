"""Self-drafting speculation: n-gram prompt-lookup drafter + per-slot
acceptance policy for the engine's fused draft–verify path.

The cheapest possible drafter (Saxena 2023, "prompt lookup decoding"):
no draft model, no extra weights in HBM — the draft for a slot is read
straight out of its own ``prompt + generated`` history. If the last
``n`` tokens of the context occurred before, the tokens that FOLLOWED
that earlier occurrence are proposed as the continuation. On
repetitive traffic (structured output, code, retrieval-augmented
prompts that quote their sources) this hits often enough that one
``verify_step_slots`` dispatch commits several tokens per weight pass
— the lever for b=1 decode latency once the weight stream
saturates HBM bandwidth.

The PyTorch port's copy of ``edl_tpu/serving/spec.py``, unchanged in
behaviour. Both pieces are host-side and torch-free: drafting walks a
Python list, and the verify step rejects any wrong guess on device, so a bad
draft costs nothing but the (already-paid-for) extra query lanes.

``SpecPolicy`` is the "knows when to stop" half: per-request
drafted/accepted counters decide whether drafting still beats plain
horizon decode. A request whose measured acceptance rate stays under
``min_accept`` after ``warmup`` drafted tokens stops drafting (its
verify lanes become -1 sentinels → exactly one plain decode step per
dispatch), so non-repetitive traffic degrades to the horizon path
instead of paying verify-width compute for nothing.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def draft_ngram(context: Sequence[int], ngram: int, max_draft: int) -> List[int]:
    """Propose up to ``max_draft`` continuation tokens for ``context``
    by suffix n-gram lookup: find the MOST RECENT earlier occurrence of
    the trailing ``n``-gram (longest n first, down to 1) and return the
    tokens that followed it. Empty when the context has no repeated
    suffix — the caller then skips drafting for this slot.

    Most-recent match wins ties: local repetition (the tail of a
    structured block) predicts better than a distant first occurrence.
    O(len(context) * ngram) per call — host-side list walking, noise
    next to a device dispatch."""
    c = list(context)
    ln = len(c)
    if ln < 2 or max_draft < 1:
        return []
    for n in range(min(ngram, ln - 1), 0, -1):
        suffix = c[ln - n:]
        # scan candidate match-ends right-to-left; the match must end
        # strictly before the context end so it has a continuation
        for end in range(ln - 1, n - 1, -1):
            if c[end - n:end] == suffix:
                return c[end:end + max_draft]
    return []


class SpecPolicy:
    """Per-request draft on/off switch driven by measured acceptance.

    ``observe(rid, drafted, accepted)`` feeds back each drained verify
    block's counts; ``should_draft(rid)`` answers whether the next
    block should draft for that request. Below ``warmup`` drafted
    tokens every request drafts (no data yet); past it, a request
    whose cumulative acceptance rate is under ``min_accept`` is
    disabled — permanently for its lifetime, since a stream that never
    repeated is unlikely to start (and re-probing would pay the verify
    width on every probe). ``min_accept <= 0`` never disables.
    ``forget(rid)`` drops a finished request's counters so the table
    tracks live requests only."""

    def __init__(self, min_accept: float = 0.0, warmup: int = 32):
        self.min_accept = float(min_accept)
        self.warmup = int(warmup)
        self._drafted: Dict[str, int] = {}
        self._accepted: Dict[str, int] = {}

    def observe(self, rid: str, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        self._drafted[rid] = self._drafted.get(rid, 0) + int(drafted)
        self._accepted[rid] = self._accepted.get(rid, 0) + int(accepted)

    def rate(self, rid: str) -> float:
        d = self._drafted.get(rid, 0)
        return self._accepted.get(rid, 0) / d if d > 0 else 1.0

    def should_draft(self, rid: str) -> bool:
        if self.min_accept <= 0:
            return True
        if self._drafted.get(rid, 0) < self.warmup:
            return True
        return self.rate(rid) >= self.min_accept

    def forget(self, rid: str) -> None:
        self._drafted.pop(rid, None)
        self._accepted.pop(rid, None)
