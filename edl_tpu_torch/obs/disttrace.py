"""Distributed tracing — the trace context that tracer spans and
flight-recorder events share: the port's copy of the process-local half
of ``edl_tpu/obs/disttrace.py``.

* **trace context** — ``TraceContext(trace_id, span_id, parent_id)``
  carried in a contextvar. Roots are opened at request boundaries; ids
  for *agreed* roots (a rid, a step number, a reshard epoch) are
  DERIVED deterministically (:func:`derived_trace_id`), so every
  process — and the reference engine — lands on the same ``trace_id``
  for the same request without a network hop, while span ids stay
  random. Tracer spans and flight-recorder events both stamp the
  active context (the hooks installed below), so ``/trace`` and
  ``/events`` agree on the same correlation keys.
* **propagation** — :func:`inject`/:func:`extract` move a context
  through any JSON payload.
* **span windows** — :func:`span_window_doc` / :func:`span_window_json`
  / :func:`load_span_window`: the newest tracer spans on the wall
  clock, the form a worker pushes for a fleet merge.

The fleet half (clock alignment, the fleet merge, the critical path,
straggler and barrier analysis) belongs to the process runtime and is
not ported yet.

THIS MODULE IS THE ONLY SANCTIONED ACCESSOR of the ``trace_id`` /
``span_id`` / ``parent_id`` keys — everything else goes through the
helpers here, so the wire format can evolve in one place.

torch-free, stdlib-only — the CLI and exporters import this.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "TraceContext",
    "TRACE_KEYS",
    "new_id",
    "derived_trace_id",
    "current",
    "root",
    "enter_root",
    "exit_root",
    "ctx_corr",
    "inject",
    "extract",
    "ids_of",
    "without_ids",
    "span_window_doc",
    "span_window_json",
    "load_span_window",
]

# the one place these literals may appear
TRACE_KEYS = ("trace_id", "span_id", "parent_id")


@dataclass(frozen=True)
class TraceContext:
    """One position in a distributed trace: which trace, which span,
    and which span caused it (None at a root)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_id(), self.span_id)


def new_id() -> str:
    """Random 64-bit hex id (span ids, ad-hoc trace roots)."""
    return os.urandom(8).hex()


def derived_trace_id(*parts: Any) -> str:
    """Deterministic trace id from an agreed tuple — e.g.
    ``("step", job, epoch, i)`` or ``("rid", rid)`` — so every process
    opens the SAME trace for the same logical root without exchanging
    ids first."""
    h = hashlib.sha1(":".join(str(p) for p in parts).encode())
    return h.hexdigest()[:16]


_ctx: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "edl_disttrace_ctx", default=None
)


def current() -> Optional[TraceContext]:
    return _ctx.get()


def enter_root(*parts: Any, trace_id: Optional[str] = None):
    """Token-based root entry (for loop bodies where a ``with`` is
    awkward). Deterministic id when ``parts`` are given, random
    otherwise. Pair with :func:`exit_root`."""
    tid = trace_id or (derived_trace_id(*parts) if parts else new_id())
    return _ctx.set(TraceContext(tid, new_id(), None))


def exit_root(token) -> None:
    _ctx.reset(token)


@contextlib.contextmanager
def root(*parts: Any, trace_id: Optional[str] = None):
    """Open a trace root for the duration of the block."""
    token = enter_root(*parts, trace_id=trace_id)
    try:
        yield _ctx.get()
    finally:
        exit_root(token)


# ---------------------------------------------------------------------------
# dict propagation — the only sanctioned read/write of the trace keys


def inject(d: Dict[str, Any], ctx: Optional[TraceContext] = None) -> Dict[str, Any]:
    """Stamp ``d`` with the context's ids (the active one by default);
    returns ``d``. No-op when no context is active."""
    ctx = ctx or _ctx.get()
    if ctx is not None:
        d["trace_id"] = ctx.trace_id
        d["span_id"] = ctx.span_id
        if ctx.parent_id is not None:
            d["parent_id"] = ctx.parent_id
    return d


def extract(d: Dict[str, Any]) -> Optional[TraceContext]:
    """Read a context back out of a dict (``None`` when absent)."""
    tid = d.get("trace_id")
    sid = d.get("span_id")
    if not tid or not sid:
        return None
    return TraceContext(str(tid), str(sid), d.get("parent_id"))


def ids_of(d: Dict[str, Any]) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """(trace_id, span_id, parent_id) of a record's dict, Nones when
    unset — the read helper analysis/CLI code uses instead of
    hand-rolled key access."""
    return (d.get("trace_id"), d.get("span_id"), d.get("parent_id"))


def without_ids(d: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``d`` with the trace keys removed — for renderers
    (postmortem timelines) that must not drown the human view in
    ids."""
    return {k: v for k, v in d.items() if k not in TRACE_KEYS}


def ctx_corr() -> Dict[str, str]:
    """The active context as correlation keys for a flight-recorder
    event (trace + span of the enclosing tracer span). Empty when no
    trace is active — events off any traced path cost one contextvar
    read."""
    ctx = _ctx.get()
    if ctx is None:
        return {}
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


# ---------------------------------------------------------------------------
# span windows — what a worker pushes through coordinator KV


def span_window_doc(tracer=None, last_n: int = 128) -> Dict[str, Any]:
    """The newest ``last_n`` tracer spans as a JSON-able doc with
    WALL-clock start times (``t_wall = tracer.t0_wall + start_s``), so
    windows from different processes can land on one axis once their
    clock offsets are known."""
    if tracer is None:
        from edl_tpu_torch.utils import tracing

        tracer = tracing.tracer()
    spans, dropped = tracer._snapshot()
    spans = spans[-last_n:]
    return {
        "meta": {
            "pid": os.getpid(),
            "dropped": dropped,
            "retained": len(spans),
            "max_seq": max((s.seq for s in spans), default=0),
        },
        "spans": [
            {
                "name": s.name,
                "seq": s.seq,
                "t_wall": tracer.t0_wall + s.start_s,
                "dur_s": s.dur_s,
                "tid": s.thread % 2**31,
                "args": dict(s.attrs),
            }
            for s in spans
        ],
    }


def span_window_json(tracer=None, last_n: int = 128) -> str:
    """Single-line form of :func:`span_window_doc` (coordinator KV is
    a line protocol — the pushed value must not contain newlines)."""
    return json.dumps(span_window_doc(tracer, last_n), default=str,
                      separators=(",", ":"))


def load_span_window(raw: Any) -> Optional[Dict[str, Any]]:
    """Parse a pushed span window; None when undecodable. Torn or
    partial windows degrade to whatever parses: records missing their
    required fields are skipped, never fatal."""
    if isinstance(raw, dict):
        doc = raw
    else:
        try:
            doc = json.loads(raw)
        except (ValueError, TypeError):
            return None
    if not isinstance(doc, dict):
        return None
    spans = []
    for s in doc.get("spans") or []:
        if not isinstance(s, dict):
            continue
        if "name" not in s or "t_wall" not in s:
            continue  # torn record
        try:
            spans.append(
                {
                    "name": str(s["name"]),
                    "seq": int(s.get("seq", 0)),
                    "t_wall": float(s["t_wall"]),
                    "dur_s": float(s.get("dur_s", 0.0)),
                    "tid": int(s.get("tid", 0)),
                    "args": dict(s.get("args") or {}),
                }
            )
        except (ValueError, TypeError):
            continue
    return {"meta": dict(doc.get("meta") or {}), "spans": spans}


# ---------------------------------------------------------------------------
# tracer integration — every span carries the active context, and a
# span body runs inside its own child context (so nested spans and the
# events emitted within parent correctly)


def _span_enter():
    cur = _ctx.get()
    if cur is None:
        return None, None
    child = cur.child()
    token = _ctx.set(child)
    return token, {
        "trace_id": child.trace_id,
        "span_id": child.span_id,
        "parent_id": child.parent_id,
    }


def _span_exit(token) -> None:
    if token is not None:
        _ctx.reset(token)


def _install() -> None:
    from edl_tpu_torch.utils import tracing

    tracing.set_span_context_hooks(_span_enter, _span_exit)


_install()
