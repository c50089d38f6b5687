"""Distributed tracing — cross-process trace propagation, clock
alignment, fleet trace merge and critical-path/straggler analysis: the
port's copy of ``edl_tpu/obs/disttrace.py``.

* **trace context** — ``TraceContext(trace_id, span_id, parent_id)``
  carried in a contextvar. Roots are opened at request/step/reshard
  boundaries; ids for *agreed* roots (a rid, a step number, a reshard
  epoch) are DERIVED deterministically (:func:`derived_trace_id`), so
  every process — and the reference engine — lands on the same
  ``trace_id`` without a network hop, while span ids stay random.
  Tracer spans and flight-recorder events both stamp the active
  context (the hooks installed below), so ``/trace`` and ``/events``
  agree on the same correlation keys.
* **propagation** — :func:`inject`/:func:`extract` move a context
  through any JSON payload; :func:`remote_child` continues a received
  one.
* **span windows** — :func:`span_window_doc` / :func:`span_window_json`
  / :func:`load_span_window`: the newest tracer spans on the wall
  clock, the form a worker pushes for a fleet merge.
* **coordinator-KV propagation** — :func:`publish_ctx` /
  :func:`fetch_ctx` put a context beside a control value (the elastic
  worker's per-step ``go`` decision), :func:`link_attrs` parents a local
  span to it: the client→server pair the fleet merge links.
* **clock alignment** — :class:`ClockSync`: NTP-midpoint offset of this
  process's wall clock against the coordinator's.
* **fleet merge** — :func:`merge_fleet_trace`: per-worker span windows
  plus offsets into one Perfetto document, one ``pid`` per worker,
  timestamps on the coordinator's axis, flow events for every
  cross-process parent/child pair.
* **analysis** — :func:`critical_path` (the longest causal chain of a
  trace, step, reshard epoch or rid) and :func:`step_skew` /
  :func:`barrier_waits`, the straggler primitives ``obs/fleet.py``
  turns into ``edl_step_skew_ratio``, ``edl_barrier_wait_seconds`` and
  ``straggler.detected``.

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
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

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
    "link_attrs",
    "ctx_kv_key",
    "publish_ctx",
    "fetch_ctx",
    "ClockEstimate",
    "ClockSync",
    "span_window_doc",
    "span_window_json",
    "load_span_window",
    "remote_child",
    "merge_fleet_trace",
    "critical_path",
    "render_critical_path",
    "step_skew",
    "barrier_waits",
    "barrier_waits_from_events",
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


@contextlib.contextmanager
def remote_child(ctx: Optional[TraceContext]):
    """Continue a trace received from another process: the block runs
    in a fresh span parented to the REMOTE span (the server half of a
    client→server pair). No-op when ``ctx`` is None."""
    if ctx is None:
        yield None
        return
    token = _ctx.set(ctx.child())
    try:
        yield _ctx.get()
    finally:
        _ctx.reset(token)


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


def link_attrs(remote: TraceContext) -> Dict[str, str]:
    """Span attrs for a LOCAL span caused by a remote one: fresh span
    id, parented to the remote span — the server half of a flow link."""
    return {
        "trace_id": remote.trace_id,
        "span_id": new_id(),
        "parent_id": remote.span_id,
    }


# ---------------------------------------------------------------------------
# coordinator-KV side-key propagation (values are newline-free strings)


def ctx_kv_key(key: str) -> str:
    """The side key carrying the trace context for a control-plane KV
    value at ``key`` (the value formats themselves — ``{i}:{verb}``
    etc. — stay untouched)."""
    return key + "#trace"


def publish_ctx(kv_put: Callable[[str, str], None], key: str,
                tag: str = "", ctx: Optional[TraceContext] = None) -> None:
    """Publish the active context next to the control value at
    ``key``. ``tag`` scopes the context to one decision (e.g. the step
    number) so a reader can reject a stale leftover."""
    ctx = ctx or _ctx.get()
    if ctx is None:
        return
    kv_put(ctx_kv_key(key), f"{tag}:{ctx.trace_id}:{ctx.span_id}")


def fetch_ctx(kv_get: Callable[[str], Optional[str]], key: str,
              tag: str = "") -> Optional[TraceContext]:
    """Read a published context back; None when absent, malformed, or
    tagged for a different decision."""
    try:
        v = kv_get(ctx_kv_key(key))
    # edl: no-lint[silent-failure] best-effort ctx fetch on the step hot path: a missed link costs one flow arrow, and logging per step would be noisier than the loss
    except Exception:
        return None
    if not v:
        return None
    parts = v.split(":")
    if len(parts) != 3 or parts[0] != tag:
        return None
    return TraceContext(parts[1], parts[2], None)


# ---------------------------------------------------------------------------
# clock alignment — NTP midpoint over coordinator round trips


@dataclass
class ClockEstimate:
    """``offset_s`` is what to ADD to this process's wall clock to
    land on the reference (coordinator) axis; ``rtt_s`` is the round
    trip of the winning sample (the estimator's error bound is
    rtt/2)."""

    offset_s: float
    rtt_s: float
    n: int

    def to_json(self) -> str:
        return json.dumps(
            {"offset_s": self.offset_s, "rtt_s": self.rtt_s, "n": self.n},
            separators=(",", ":"),
        )

    @staticmethod
    def from_json(raw: str) -> Optional["ClockEstimate"]:
        try:
            d = json.loads(raw)
            return ClockEstimate(
                float(d["offset_s"]), float(d["rtt_s"]), int(d.get("n", 1))
            )
        except (ValueError, TypeError, KeyError):
            return None


class ClockSync:
    """Per-process wall-clock offset estimator against a reference
    clock reachable only by RPC.

    Each sample brackets one ``remote_time()`` round trip with local
    wall-clock reads: ``offset = t_remote - (t0 + t1) / 2`` (the NTP
    midpoint — exact when the two legs are symmetric, wrong by at most
    rtt/2 otherwise). Jitter filter: keep the MINIMUM-RTT sample, the
    one with the tightest error bound; averaging would let one slow,
    asymmetric round trip poison the estimate.
    """

    def __init__(self, clock: Callable[[], float] = time.time):
        self.clock = clock
        self.last: Optional[ClockEstimate] = None
        self._t_sampled = 0.0

    def sample(self, remote_time: Callable[[], Optional[float]],
               n: int = 5) -> Optional[ClockEstimate]:
        """Take ``n`` round trips; returns (and retains) the best
        estimate, or None when the remote clock is unreachable or the
        op is unsupported (an old coordinator binary)."""
        best: Optional[ClockEstimate] = None
        got = 0
        for _ in range(max(1, n)):
            t0 = self.clock()
            try:
                ts = remote_time()
            # edl: no-lint[silent-failure] a failed round trip just shrinks the sample set; the caller surfaces a fully-failed burst as None
            except Exception:
                continue
            t1 = self.clock()
            if ts is None:
                continue
            got += 1
            est = ClockEstimate(ts - (t0 + t1) / 2.0, t1 - t0, 0)
            if best is None or est.rtt_s < best.rtt_s:
                best = est
        if best is not None:
            best.n = got
            self.last = best
            self._t_sampled = time.monotonic()
        return best

    def maybe_sample(self, remote_time, n: int = 5,
                     min_interval_s: float = 30.0) -> Optional[ClockEstimate]:
        """Throttled re-sample for periodic callers (the metrics-push
        cadence): at most one burst per ``min_interval_s``."""
        if self.last is not None and (
            time.monotonic() - self._t_sampled < min_interval_s
        ):
            return self.last
        return self.sample(remote_time, n=n)


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
# fleet merge — one offset-corrected Perfetto document


def merge_fleet_trace(
    windows: Dict[str, Any],
    offsets: Optional[Dict[str, float]] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Merge per-worker span windows into one chrome-trace document.

    ``windows`` maps worker name -> raw window JSON (or parsed doc);
    ``offsets`` maps worker name -> seconds to ADD to that worker's
    wall clock (ClockSync estimates; missing = 0). Each worker gets a
    synthetic ``pid`` named via ``process_name`` metadata; timestamps
    are offset-corrected and rebased so the earliest span starts at 0;
    chrome flow events (``ph:"s"`` on the client span, ``ph:"f"`` on
    the server span) link every parent→child span pair that crosses a
    process boundary. Undecodable windows are skipped and counted in
    the top-level ``skipped_windows``.
    """
    offsets = offsets or {}
    docs: Dict[str, Dict[str, Any]] = {}
    skipped = 0
    for worker, raw in sorted(windows.items()):
        doc = load_span_window(raw)
        if doc is None:
            skipped += 1
            continue
        docs[worker] = doc

    # corrected wall time per span, then rebase to the earliest
    corrected: List[Tuple[str, int, Dict[str, Any], float]] = []
    for pid, (worker, doc) in enumerate(sorted(docs.items()), start=1):
        off = float(offsets.get(worker, 0.0))
        for s in doc["spans"]:
            corrected.append((worker, pid, s, s["t_wall"] + off))
    base = min((t for *_x, t in corrected), default=0.0)

    events: List[Dict[str, Any]] = []
    for pid, (worker, _doc) in enumerate(sorted(docs.items()), start=1):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": worker},
            }
        )
    by_span_id: Dict[str, Dict[str, Any]] = {}
    for worker, pid, s, t in corrected:
        ev = {
            "name": s["name"],
            "ph": "X",
            "ts": (t - base) * 1e6,
            "dur": s["dur_s"] * 1e6,
            "pid": pid,
            "tid": s["tid"],
            "seq": s["seq"],
            "args": {"worker": worker, **s["args"]},
        }
        events.append(ev)
        sid = ids_of(s["args"])[1]
        if sid:
            by_span_id[sid] = ev

    # flow events: client span -> the server span parented to it,
    # exactly one link per parent/child pair (dedup by child span id)
    flows = 0
    for ev in list(events):
        if ev.get("ph") != "X":
            continue
        _tid, sid, parent = ids_of(ev["args"])
        if not parent or parent not in by_span_id:
            continue
        src = by_span_id[parent]
        # only cross-PROCESS causality gets an arrow: intra-process
        # parent/child pairs are already visible as span nesting
        if src is ev or src["pid"] == ev["pid"]:
            continue
        fid = f"f{flows}"
        flows += 1
        events.append(
            {
                "name": "rpc", "cat": "disttrace", "ph": "s", "id": fid,
                "pid": src["pid"], "tid": src["tid"],
                # bind the arrow tail inside the client span
                "ts": src["ts"] + max(src["dur"] / 2, 0.0),
            }
        )
        events.append(
            {
                "name": "rpc", "cat": "disttrace", "ph": "f", "bp": "e",
                "id": fid, "pid": ev["pid"], "tid": ev["tid"], "ts": ev["ts"],
            }
        )
    doc = {
        "traceEvents": events,
        "base_t_wall": base,
        "workers": sorted(docs),
        "flow_links": flows,
        "skipped_windows": skipped,
    }
    if extra_meta:
        doc.update(extra_meta)
    return doc


# ---------------------------------------------------------------------------
# critical path — the longest causal chain


def _doc_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Normalize a chrome-trace doc's X events (a merged fleet doc or
    a process-local /trace) into span records with seconds units."""
    pid_names = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e.get("pid")] = (e.get("args") or {}).get("name")
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        out.append(
            {
                "name": e.get("name", "?"),
                "t_s": float(e.get("ts", 0.0)) / 1e6,
                "dur_s": float(e.get("dur", 0.0)) / 1e6,
                "worker": args.get("worker")
                or pid_names.get(e.get("pid"))
                or str(e.get("pid", "?")),
                "args": args,
            }
        )
    return out


def _matches(span: Dict[str, Any], rid, step, reshard_epoch, trace_id) -> bool:
    a = span["args"]
    if trace_id is not None and ids_of(a)[0] != trace_id:
        return False
    if rid is not None:
        rids = a.get("rids") or ()
        if a.get("rid") != rid and rid not in rids:
            return False
    if step is not None and a.get("step") != step:
        return False
    if reshard_epoch is not None and a.get("reshard_epoch") != reshard_epoch:
        return False
    return True


def critical_path(
    doc: Dict[str, Any],
    rid: Optional[str] = None,
    step: Optional[int] = None,
    reshard_epoch: Optional[int] = None,
    trace_id: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """The longest causal chain of spans matching the filter, as hops
    ``{name, worker, t_s, dur_s, gap_s}``.

    Selection: explicit ``trace_id``, or the deterministic root id for
    a ``reshard_epoch`` (every process derives the same one), or attr
    match on ``rid``/``rids``/``step``. Chain construction prefers the
    parent-link forest (maximum summed duration root→leaf, the Dapper
    critical path); spans without links fall back to the time-ordered
    sequence — for a single request's sequential hops the two
    coincide."""
    spans = _doc_spans(doc)
    if reshard_epoch is not None and trace_id is None:
        # accept either the derived reshard root id or an explicit attr
        want_tid = derived_trace_id("reshard", reshard_epoch)
        sel = [
            s for s in spans
            if ids_of(s["args"])[0] == want_tid
            or s["args"].get("reshard_epoch") == reshard_epoch
        ]
        if rid is not None or step is not None:
            sel = [s for s in sel if _matches(s, rid, step, None, None)]
    else:
        sel = [
            s for s in spans if _matches(s, rid, step, reshard_epoch, trace_id)
        ]
    if not sel:
        return []

    by_id: Dict[str, Dict[str, Any]] = {}
    children: Dict[str, List[Dict[str, Any]]] = {}
    linked = False
    for s in sel:
        _t, sid, parent = ids_of(s["args"])
        if sid:
            by_id[sid] = s
    for s in sel:
        _t, _sid, parent = ids_of(s["args"])
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
            linked = True

    if linked:
        # longest-total-duration root->leaf chain over the link forest
        memo: Dict[int, Tuple[float, List[Dict[str, Any]]]] = {}

        def best_chain(s) -> Tuple[float, List[Dict[str, Any]]]:
            key = id(s)
            if key in memo:
                return memo[key]
            memo[key] = (s["dur_s"], [s])  # cycle guard
            _t, sid, _p = ids_of(s["args"])
            best = (s["dur_s"], [s])
            for c in children.get(sid or "", ()):
                d, chain = best_chain(c)
                if s["dur_s"] + d > best[0]:
                    best = (s["dur_s"] + d, [s] + chain)
            memo[key] = best
            return best

        roots = [
            s for s in sel
            if not (ids_of(s["args"])[2] and ids_of(s["args"])[2] in by_id)
        ]
        chain = max((best_chain(r) for r in roots), key=lambda x: x[0])[1]
    else:
        chain = sorted(sel, key=lambda s: s["t_s"])

    hops: List[Dict[str, Any]] = []
    prev_end: Optional[float] = None
    for s in chain:
        hops.append(
            {
                "name": s["name"],
                "worker": s["worker"],
                "t_s": s["t_s"],
                "dur_s": s["dur_s"],
                "gap_s": max(s["t_s"] - prev_end, 0.0)
                if prev_end is not None else 0.0,
            }
        )
        prev_end = s["t_s"] + s["dur_s"]
    return hops


def render_critical_path(hops: List[Dict[str, Any]]) -> str:
    if not hops:
        return "(empty critical path: no spans matched the filter)"
    total = sum(h["dur_s"] for h in hops)

    def ms(v: float) -> str:
        return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.3f}s"

    lines = [f"critical path: {len(hops)} hops, {ms(total)} busy"]
    for i, h in enumerate(hops, 1):
        gap = f"  (+{ms(h['gap_s'])} gap)" if h["gap_s"] > 0 else ""
        lines.append(
            f"  {i:>2}. [{h['worker']}] {h['name']:<26} "
            f"t={ms(h['t_s']):>9}  dur={ms(h['dur_s']):>9}{gap}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# straggler analysis primitives


def step_skew(
    per_worker_p50: Dict[str, float]
) -> Tuple[float, Optional[str], float]:
    """(skew_ratio, slowest_worker, fleet_median) from per-worker step
    p50s: skew = slowest p50 / fleet median (1.0 = perfectly even).
    Needs >= 2 reporting workers to mean anything; returns (0, None,
    0) otherwise."""
    vals = {w: v for w, v in per_worker_p50.items() if v > 0}
    if len(vals) < 2:
        return 0.0, None, 0.0
    ordered = sorted(vals.values())
    n = len(ordered)
    median = (
        ordered[n // 2]
        if n % 2
        else (ordered[n // 2 - 1] + ordered[n // 2]) / 2.0
    )
    slow = max(vals, key=lambda w: vals[w])
    return (vals[slow] / median if median > 0 else 0.0), slow, median


def barrier_waits(arrivals: Dict[str, float]) -> Dict[str, float]:
    """Per-worker barrier wait attributed to the LAST arriver: each
    worker waits ``t_last - t_self`` (the straggler itself waits 0).
    ``arrivals`` are offset-corrected wall times of each worker's
    arrival at the same barrier (e.g. its ``worker.join`` for one
    membership epoch)."""
    if not arrivals:
        return {}
    t_last = max(arrivals.values())
    return {w: max(t_last - t, 0.0) for w, t in arrivals.items()}


def barrier_waits_from_events(
    events: Iterable[Dict[str, Any]], kind: str = "worker.join"
) -> Dict[str, float]:
    """Barrier waits for the LATEST epoch with >= 2 arrivals, from a
    (merged, offset-corrected) fleet event log. Arrival = the worker's
    ``worker.join`` for that epoch."""
    by_epoch: Dict[Any, Dict[str, float]] = {}
    for e in events:
        if e.get("kind") != kind:
            continue
        corr = e.get("corr") or {}
        attrs = e.get("attrs") or {}
        w = corr.get("worker")
        ep = attrs.get("epoch", corr.get("reshard_epoch"))
        if w is None or ep is None:
            continue
        # first join per (epoch, worker) wins: re-registration isn't
        # a barrier arrival
        by_epoch.setdefault(ep, {}).setdefault(str(w), float(e.get("t_wall", 0.0)))
    candidates = [
        (ep, arr) for ep, arr in by_epoch.items() if len(arr) >= 2
    ]
    if not candidates:
        return {}
    _ep, arrivals = max(candidates, key=lambda x: max(x[1].values()))
    return barrier_waits(arrivals)


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
