"""``postmortem`` — reconstruct timelines and incidents from a
flight-recorder dump: the port's copy of ``edl_tpu/obs/postmortem.py``.

The recorder (obs/events.py) captures WHAT happened; this module
answers WHY a specific request/job misbehaved, after the fact, from a
dump file, a crash-dump black box, or a live ``/events`` endpoint:

* **per-request timelines** — every event correlated to a ``rid``
  (submit → admit → prefill → … → finish) with inter-event gaps, so a
  9-second TTFT decomposes into "8.7 s queued, 0.3 s prefill";
* **incident summary** — injected faults and what followed each within
  a window, recovery passes and the requests they replayed, timeout
  chains (shed + evicted), reshard stalls, heartbeat degradation,
  mirrored error logs, and ring truncation;
* **CI assertions** — ``--assert-recovered`` proves every injected
  serving fault is followed by a recorded recovery whose affected
  requests were re-prefilled and finished (the chaos lane's
  postmortem verification pass); ``--assert-no-incidents`` proves a
  fault-free lane produced a clean timeline.

Operates on plain event RECORDS (dicts) so a loaded JSONL dump and a
live ``FlightRecorder.records()`` analyze identically. torch-free,
stdlib-only — the CLI imports this at verb dispatch.
"""

from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Any, Dict, List, Optional

__all__ = [
    "load_events",
    "by_rid",
    "incidents",
    "fault_chains",
    "alert_chains",
    "verify_recovered",
    "verify_no_incidents",
    "render_report",
]

# terminal serving outcomes that count as "the request was served"
_SERVED = ("done", "eos")
# event kinds that make a timeline an incident timeline
_INCIDENT_FINISHES = ("timeout", "failed")


def _order(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Causal order: wall time first (multi-process merges), sequence
    number as the intra-process tiebreak."""
    return sorted(
        events,
        key=lambda e: (e.get("t_wall", 0.0), e.get("seq", 0)),
    )


def load_events(source: str) -> List[Dict[str, Any]]:
    """Load events from a JSONL dump path, raw JSONL text, or a live
    exporter URL / ``host:port`` (scrapes ``/events``)."""
    import os

    if source.startswith(("http://", "https://")) or (
        not os.path.exists(source)
        and "\n" not in source
        and ":" in source
        and source.rsplit(":", 1)[-1].isdigit()
    ):
        from urllib.parse import urlparse

        from edl_tpu_torch.obs.exporter import scrape

        # accept both the exporter root and a pasted .../events URL
        # (with or without ?rid=/?kind= filters already applied)
        url = source if source.startswith("http") else f"http://{source}"
        path = urlparse(url).path.rstrip("/")
        text = scrape(source, "" if path.endswith("/events") else "/events")
    else:
        text = source
    from edl_tpu_torch.obs.events import load_jsonl

    return _order(load_jsonl(text))


def by_rid(events: List[Dict[str, Any]]) -> "OrderedDict[str, List[dict]]":
    """Per-request timelines, keyed by rid in first-seen order."""
    out: "OrderedDict[str, List[dict]]" = OrderedDict()
    for e in _order(events):
        rid = (e.get("corr") or {}).get("rid")
        if rid is not None:
            out.setdefault(str(rid), []).append(e)
    return out


def ring_dropped(events: List[Dict[str, Any]]) -> int:
    return max(
        (int((e.get("attrs") or {}).get("_ring_dropped", 0)) for e in events),
        default=0,
    )


# ---------------------------------------------------------------------------
# incidents


def incidents(
    events: List[Dict[str, Any]], window_s: float = 5.0
) -> Dict[str, Any]:
    """Summarize everything abnormal on the timeline. ``window_s``
    bounds the what-followed window attached to each injected fault."""
    evs = _order(events)
    faults: List[Dict[str, Any]] = []
    recoveries: List[Dict[str, Any]] = []
    reshards: List[Dict[str, Any]] = []
    timeouts = {"shed": [], "evicted": []}
    failed: List[str] = []
    degraded: List[Dict[str, Any]] = []
    errors: List[Dict[str, Any]] = []
    for i, e in enumerate(evs):
        kind = e.get("kind", "")
        corr = e.get("corr") or {}
        attrs = e.get("attrs") or {}
        if kind == "fault.injected":
            t = e.get("t_wall", 0.0)
            follow = [
                x for x in evs[i + 1:]
                if x.get("t_wall", t) - t <= window_s
                and x.get("kind") not in ("serve.block",)
            ]
            faults.append({"event": e, "followed": follow[:12]})
        elif kind.endswith(".recover"):
            recoveries.append(e)
        elif kind == "reshard.end":
            reshards.append(e)
        elif kind == "serve.reject" and attrs.get("reason") == "timeout":
            timeouts["shed"].append(corr.get("rid"))
        elif kind == "serve.finish":
            if attrs.get("outcome") == "timeout":
                timeouts["evicted"].append(corr.get("rid"))
            elif attrs.get("outcome") == "failed":
                failed.append(corr.get("rid"))
        elif kind == "worker.heartbeat_degraded":
            degraded.append(e)
        elif e.get("severity") == "error":
            errors.append(e)
    return {
        "faults": faults,
        "recoveries": recoveries,
        "reshards": reshards,
        "timeouts": timeouts,
        "failed": failed,
        "degraded": degraded,
        "errors": errors,
        "ring_dropped": ring_dropped(evs),
    }


def _recover_rids(rec: Dict[str, Any]) -> List[str]:
    attrs = rec.get("attrs") or {}
    rids = [str(r) for r in attrs.get("rids", [])]
    if attrs.get("requeued"):
        rids.append(str(attrs["requeued"]))
    return rids


def fault_chains(
    events: List[Dict[str, Any]], site_prefix: str = "serve."
) -> List[Dict[str, Any]]:
    """For every injected fault at a matching site, the causal chain
    the recovery contract promises: fault → next recovery → per-rid
    re-prefill → terminal finish. Each entry carries ``ok`` plus the
    specific missing links, which is what ``--assert-recovered``
    reports on failure."""
    evs = _order(events)
    chains: List[Dict[str, Any]] = []
    for i, e in enumerate(evs):
        if e.get("kind") != "fault.injected":
            continue
        site = (e.get("corr") or {}).get("site", "")
        if not str(site).startswith(site_prefix):
            continue
        rest = evs[i + 1:]
        rec = next(
            (x for x in rest if str(x.get("kind", "")).endswith(".recover")),
            None,
        )
        chain: Dict[str, Any] = {
            "fault": e,
            "site": site,
            "recover": rec,
            "rids": [],
            "problems": [],
        }
        if rec is None:
            chain["problems"].append(
                f"fault at {site} (seq {e.get('seq')}) has no recovery event"
            )
        else:
            after = [x for x in rest if x.get("seq", 0) > rec.get("seq", 0)
                     or x.get("t_wall", 0) > rec.get("t_wall", 0)]
            for rid in _recover_rids(rec):
                replayed = any(
                    x.get("kind") in ("serve.prefill", "serve.admit")
                    and (x.get("corr") or {}).get("rid") == rid
                    for x in after
                )
                fin = next(
                    (x for x in after
                     if x.get("kind") == "serve.finish"
                     and (x.get("corr") or {}).get("rid") == rid),
                    None,
                )
                outcome = (fin.get("attrs") or {}).get("outcome") if fin else None
                chain["rids"].append(
                    {"rid": rid, "replayed": replayed, "outcome": outcome}
                )
                if not replayed:
                    chain["problems"].append(
                        f"{rid}: no re-prefill after recovery "
                        f"(fault seq {e.get('seq')})"
                    )
                if outcome not in _SERVED:
                    chain["problems"].append(
                        f"{rid}: finished {outcome!r} after recovery, "
                        f"expected one of {_SERVED}"
                    )
        chain["ok"] = not chain["problems"]
        chains.append(chain)
    return chains


def alert_chains(
    events: List[Dict[str, Any]], site_prefix: str = "alert."
) -> List[Dict[str, Any]]:
    """The alert-lifecycle analog of :func:`fault_chains`: every
    ``alert.fire`` whose site (``alert.<rule>``, obs/alerts.py)
    matches the prefix must be followed by an ``alert.resolve`` for
    the SAME site — a page that never resolved is an open incident,
    and the CI fault lane asserts the injected breach both fired and
    cleared."""
    evs = _order(events)
    chains: List[Dict[str, Any]] = []
    for i, e in enumerate(evs):
        if e.get("kind") != "alert.fire":
            continue
        site = str((e.get("corr") or {}).get("site", ""))
        if not site.startswith(site_prefix):
            continue
        res = next(
            (x for x in evs[i + 1:]
             if x.get("kind") == "alert.resolve"
             and str((x.get("corr") or {}).get("site", "")) == site),
            None,
        )
        problems = [] if res is not None else [
            f"alert {site} fired (seq {e.get('seq')}) but never resolved"
        ]
        chains.append({
            "fire": e,
            "site": site,
            "resolve": res,
            "problems": problems,
            "ok": not problems,
        })
    return chains


def verify_recovered(
    events: List[Dict[str, Any]], site_prefix: str = "serve."
) -> List[str]:
    """CI assertion: every injected fault at ``site_prefix*`` is
    followed by a recorded recovery whose affected requests were
    re-prefilled and served, and every fired alert at a matching site
    resolved. Returns problems (empty = pass). A dump with NO matching
    faults or alerts is itself a problem — a chaos lane whose faults
    never fired tested nothing (``--sites alert.`` asserts the alert
    lifecycle the same way)."""
    chains = fault_chains(events, site_prefix)
    achains = alert_chains(events, site_prefix)
    if not chains and not achains:
        return [
            f"no injected faults or fired alerts at sites "
            f"{site_prefix}* in this dump"
        ]
    problems: List[str] = []
    for c in chains:
        problems.extend(c["problems"])
    for c in achains:
        problems.extend(c["problems"])
    return problems


def verify_no_incidents(events: List[Dict[str, Any]]) -> List[str]:
    """CI assertion for the fault-free lane: no injections, no
    recoveries, no error-severity events, no timeout/failed outcomes,
    no heartbeat degradation. Returns problems (empty = pass)."""
    inc = incidents(events)
    problems: List[str] = []
    if inc["faults"]:
        problems.append(f"{len(inc['faults'])} injected fault(s) recorded")
    if inc["recoveries"]:
        problems.append(f"{len(inc['recoveries'])} recovery pass(es) recorded")
    if inc["errors"]:
        first = inc["errors"][0]
        problems.append(
            f"{len(inc['errors'])} error event(s), first: "
            f"{first.get('kind')} {(first.get('attrs') or {}).get('msg', '')}"
        )
    shed, evicted = inc["timeouts"]["shed"], inc["timeouts"]["evicted"]
    if shed or evicted:
        problems.append(
            f"timeouts: {len(shed)} shed, {len(evicted)} evicted"
        )
    if inc["failed"]:
        problems.append(f"requests failed: {inc['failed']}")
    if inc["degraded"]:
        problems.append(
            f"{len(inc['degraded'])} heartbeat-degraded transition(s)"
        )
    return problems


# ---------------------------------------------------------------------------
# rendering


def _fmt_gap(dt: float) -> str:
    return f"+{dt * 1e3:.1f}ms" if dt < 1.0 else f"+{dt:.2f}s"


def _fmt_event(e: Dict[str, Any], t_base: float, prev_t: float) -> str:
    from edl_tpu_torch.obs.disttrace import without_ids

    # trace ids correlate /trace with /events but are noise in a human
    # timeline (the ``trace`` verb gives the span view of the same ids)
    corr = {
        k: v for k, v in without_ids(e.get("corr") or {}).items()
        if k != "rid"
    }
    attrs = e.get("attrs") or {}
    kv = " ".join(
        f"{k}={v}" for k, v in list(corr.items()) + list(attrs.items())
        if not str(k).startswith("_")
    )
    t = e.get("t_wall", t_base)
    gap = f" ({_fmt_gap(t - prev_t)})" if prev_t and t >= prev_t else ""
    sev = e.get("severity", "info")
    mark = "" if sev == "info" else f" [{sev.upper()}]"
    return (
        f"  t{_fmt_gap(t - t_base):>10}  {e.get('kind', '?'):<24}"
        f"{mark} {kv}".rstrip() + gap
    )


def render_timeline(rid: str, evs: List[Dict[str, Any]]) -> List[str]:
    lines = [f"-- request {rid} ({len(evs)} events) --"]
    t_base = evs[0].get("t_wall", 0.0) if evs else 0.0
    prev = 0.0
    for e in evs:
        lines.append(_fmt_event(e, t_base, prev))
        prev = e.get("t_wall", prev)
    return lines


def render_report(
    events: List[Dict[str, Any]],
    rid: Optional[str] = None,
    window_s: float = 5.0,
    max_timelines: int = 8,
) -> str:
    """The human postmortem: incident summary, fault→recovery chains,
    and per-request timelines (all of them for --rid, else the
    incident-affected ones, capped)."""
    evs = _order(events)
    inc = incidents(evs, window_s=window_s)
    chains = fault_chains(evs)
    kinds = Counter(e.get("kind", "?") for e in evs)
    lines: List[str] = []
    span = (
        evs[-1].get("t_wall", 0.0) - evs[0].get("t_wall", 0.0) if evs else 0.0
    )
    lines.append(
        f"flight recorder: {len(evs)} events over {span:.2f}s, "
        f"{len(kinds)} kinds, ring_dropped={inc['ring_dropped']}"
    )
    top = ", ".join(f"{k}={n}" for k, n in kinds.most_common(6))
    lines.append(f"  kinds: {top}")

    lines.append("")
    lines.append("== incidents ==")
    shed, evicted = inc["timeouts"]["shed"], inc["timeouts"]["evicted"]
    lines.append(
        f"faults_injected={len(inc['faults'])} "
        f"recoveries={len(inc['recoveries'])} "
        f"timeouts_shed={len(shed)} timeouts_evicted={len(evicted)} "
        f"failed={len(inc['failed'])} errors={len(inc['errors'])} "
        f"hb_degraded={len(inc['degraded'])} reshards={len(inc['reshards'])}"
    )
    for r in inc["reshards"]:
        a = r.get("attrs") or {}
        lines.append(
            f"  reshard_epoch={(r.get('corr') or {}).get('reshard_epoch')} "
            f"{a.get('from_workers')}->{a.get('to_workers')} "
            f"stall={a.get('stall_s')}s path={a.get('path')}"
        )

    affected: List[str] = []
    if chains:
        lines.append("")
        lines.append("== fault -> recovery chains ==")
        for c in chains:
            f = c["fault"]
            status = "OK" if c["ok"] else "BROKEN"
            rids = ",".join(r["rid"] for r in c["rids"]) or "-"
            lines.append(
                f"[{status}] seq {f.get('seq')} {c['site']} "
                f"(call #{(f.get('attrs') or {}).get('nth', '?')}) -> "
                f"recover -> rids [{rids}]"
            )
            for r in c["rids"]:
                lines.append(
                    f"    {r['rid']}: replayed={r['replayed']} "
                    f"outcome={r['outcome']}"
                )
                if r["rid"] not in affected:
                    affected.append(r["rid"])
            for p in c["problems"]:
                lines.append(f"    !! {p}")

    timelines = by_rid(evs)
    if rid is not None:
        wanted = [rid] if rid in timelines else []
        if not wanted:
            lines.append(f"\n(no events for rid {rid!r})")
    else:
        wanted = [r for r in affected if r in timelines]
        wanted += [
            r for r in timelines
            if r not in wanted and any(
                e.get("kind") == "serve.finish"
                and (e.get("attrs") or {}).get("outcome")
                in _INCIDENT_FINISHES
                for e in timelines[r]
            )
        ]
        wanted = wanted[:max_timelines]
    if wanted:
        lines.append("")
        lines.append("== request timelines ==")
        for r in wanted:
            lines.extend(render_timeline(r, timelines[r]))
    return "\n".join(lines)
