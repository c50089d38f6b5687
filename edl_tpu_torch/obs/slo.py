"""SLO & goodput — the serving metric that should drive scheduling.

Raw tokens/s rewards a server for finishing work nobody is waiting
for; what a multi-tenant deployment actually sells is **goodput under
SLO** — requests whose TTFT and per-token latency landed inside their
class's deadline (DistServe's argument, OSDI '24). This module turns a
run's per-request records (``ServingMetrics.requests`` — submit / pop
/ first-token / finish stamps plus tenant / SLO-class labels) into:

* a **goodput report**: per-class attained-vs-SLO fractions, goodput
  req/s, shed/timeout accounting, and exact per-phase
  (queue-wait / prefill / decode) p50/p95/p99 from the raw records
  (order statistics, not histogram interpolation — a run report can
  afford exactness);
* **live burn-rate gauges** for the exporter
  (``edl_slo_ttft_ok_ratio{class}``, ``edl_slo_itl_ok_ratio{class}``,
  ``edl_slo_goodput_rps``) so a scraper watches attainment decay in
  real time instead of discovering it in the postmortem;
* a text rendering for humans and a JSON-able dict for CI
  (``edl loadgen --json``).

torch-free and engine-free on purpose: the input is duck-typed (any
object with a ``requests`` dict of records carrying the stamp
attributes), so tests drive it with a fake clock and the analyzer can
replay stored runs.

The PyTorch port's copy of ``edl_tpu/obs/slo.py``, unchanged in
behaviour; torch-free, like the reference is jax-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from edl_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "SLOClass",
    "default_classes",
    "classes_by_name",
    "request_records",
    "percentiles",
    "compute_goodput",
    "update_gauges",
    "render_report",
]

# terminal outcomes that count as successfully served (an SLO can only
# be attained by work that finished; timeout/failed/rejected are the
# shed-accounting side of the report)
_SERVED = ("done", "eos")


@dataclass(frozen=True)
class SLOClass:
    """One latency class: a TTFT deadline (submit -> first token) and
    a per-token deadline (user-perceived TPOT — ``(finish - first
    token) / (tokens - 1)`` — so fused-block amortization cannot hide
    decode stalls)."""

    name: str
    ttft_slo_s: float
    itl_slo_s: float


def default_classes(
    ttft_slo_s: float = 1.0, itl_slo_s: float = 0.25
) -> Tuple[SLOClass, ...]:
    """The two-tier default mix: ``interactive`` at the given
    deadlines, ``batch`` at 8x TTFT / 4x ITL (throughput traffic cares
    about finishing, not about the first token)."""
    return (
        SLOClass("interactive", ttft_slo_s, itl_slo_s),
        SLOClass("batch", 8.0 * ttft_slo_s, 4.0 * itl_slo_s),
    )


def classes_by_name(
    classes: Iterable[SLOClass],
) -> Dict[str, SLOClass]:
    return {c.name: c for c in classes}


# ---------------------------------------------------------------------------
# record extraction


def _get(rec: Any, name: str, default=0.0):
    return getattr(rec, name, default)


def request_records(
    metrics: Any, since_s: Optional[float] = None
) -> List[Dict[str, Any]]:
    """Flatten ``ServingMetrics.requests`` into plain per-request
    dicts with the phase decomposition precomputed:

    ``queue_wait_s`` (submit -> pop), ``prefill_s`` (pop -> first
    token), ``decode_s`` (first token -> finish), ``total_s`` (submit
    -> finish), ``ttft_s``, ``tpot_s`` (0.0 when < 2 tokens), plus
    ``tenant`` / ``slo_class`` / ``outcome`` / ``tokens``. The three
    phases sum to ``total_s`` exactly for any finished request — the
    invariant tests/test_loadgen.py pins.

    ``since_s`` (same clock as the metrics object, ``time.monotonic``
    by default) keeps only requests that FINISHED at/after that
    instant — the trailing-window live view burn-rate gauges want,
    where attainment reflects what the system is doing NOW instead of
    averaging in the whole run's history."""
    out: List[Dict[str, Any]] = []
    for rid, rec in metrics.requests.items():
        if since_s is not None and float(_get(rec, "finish_s")) < since_s:
            continue
        has_submit = bool(_get(rec, "has_submit", False))
        has_pop = bool(_get(rec, "has_pop", False))
        submit = float(_get(rec, "submit_s"))
        pop = float(_get(rec, "pop_s"))
        first = float(_get(rec, "first_token_s"))
        finish = float(_get(rec, "finish_s"))
        tokens = int(_get(rec, "tokens", 0))
        r: Dict[str, Any] = {
            "rid": rid,
            "tenant": str(_get(rec, "tenant", "") or ""),
            "slo_class": str(_get(rec, "slo_class", "") or ""),
            "outcome": str(_get(rec, "outcome", "") or ""),
            "tokens": tokens,
            "queue_wait_s": (pop - submit) if (has_submit and has_pop) else 0.0,
            "prefill_s": (first - pop) if (has_pop and first) else 0.0,
            "decode_s": (finish - first) if (first and finish) else 0.0,
            "total_s": (finish - submit) if (has_submit and finish) else 0.0,
            "ttft_s": (first - submit) if (has_submit and first) else 0.0,
            "tpot_s": (
                (finish - first) / (tokens - 1)
                if tokens >= 2 and first and finish
                else 0.0
            ),
        }
        out.append(r)
    return out


def percentiles(
    values: Sequence[float], qs: Sequence[float] = (0.50, 0.95, 0.99)
) -> Dict[str, float]:
    """Exact order-statistic percentiles with linear interpolation
    between neighbors (numpy's default rule, stdlib-only). Empty input
    -> all zeros."""
    out = {f"p{int(q * 100)}": 0.0 for q in qs}
    if not values:
        return out
    vs = sorted(float(v) for v in values)
    n = len(vs)
    for q in qs:
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        out[f"p{int(q * 100)}"] = vs[lo] + frac * (vs[hi] - vs[lo])
    return out


# ---------------------------------------------------------------------------
# the goodput report


def compute_goodput(
    records: List[Dict[str, Any]],
    classes: Mapping[str, SLOClass],
    wall_s: float,
) -> Dict[str, Any]:
    """Goodput-under-SLO over one run's request records.

    A request is **good** when it finished (outcome done/eos), its
    TTFT met its class's ``ttft_slo_s``, and its user-perceived TPOT
    met ``itl_slo_s`` (single-token requests have no TPOT and pass
    that leg). Records whose ``slo_class`` is unknown/unset fall into
    the ``"unclassified"`` bucket with infinite deadlines — goodput
    degenerates to completion there, which is exactly what an
    SLO-less feed means. Attainment fractions are over FINISHED
    requests; ``goodput_fraction`` is over ALL requests (shed and
    timed-out work counts against you — that is the point)."""
    wall_s = max(float(wall_s), 0.0)
    inf = float("inf")

    def _cls(name: str) -> SLOClass:
        c = classes.get(name)
        if c is None:
            return SLOClass(name or "unclassified", inf, inf)
        return c

    per_class: Dict[str, Dict[str, float]] = {}
    per_tenant: Dict[str, Dict[str, float]] = {}
    n_good = n_served = 0
    shed = timeout = failed = 0
    for r in records:
        cname = r["slo_class"] or "unclassified"
        c = _cls(cname)
        cc = per_class.setdefault(
            cname,
            {
                "requests": 0, "served": 0, "good": 0,
                "ttft_ok": 0, "itl_ok": 0,
                "shed": 0, "timeout": 0, "failed": 0,
            },
        )
        tc = per_tenant.setdefault(
            r["tenant"] or "unattributed",
            {"requests": 0, "served": 0, "good": 0, "shed": 0, "timeout": 0},
        )
        cc["requests"] += 1
        tc["requests"] += 1
        outcome = r["outcome"]
        if outcome.startswith("rejected"):
            shed += 1
            cc["shed"] += 1
            tc["shed"] += 1
            continue
        if outcome == "timeout":
            timeout += 1
            cc["timeout"] += 1
            tc["timeout"] += 1
            continue
        if outcome == "failed":
            failed += 1
            cc["failed"] += 1
            continue
        if outcome not in _SERVED:
            continue  # still in flight when the run stopped
        n_served += 1
        cc["served"] += 1
        tc["served"] += 1
        ttft_ok = r["ttft_s"] <= c.ttft_slo_s
        itl_ok = r["tokens"] < 2 or r["tpot_s"] <= c.itl_slo_s
        cc["ttft_ok"] += ttft_ok
        cc["itl_ok"] += itl_ok
        if ttft_ok and itl_ok:
            n_good += 1
            cc["good"] += 1
            tc["good"] += 1

    served = [r for r in records if r["outcome"] in _SERVED]
    phases = {
        name: percentiles([r[name] for r in served])
        for name in ("queue_wait_s", "prefill_s", "decode_s", "ttft_s",
                     "tpot_s", "total_s")
    }
    n = len(records)
    for cname, cc in per_class.items():
        c = _cls(cname)
        srv = cc["served"]
        cc.update(
            ttft_slo_s=c.ttft_slo_s,
            itl_slo_s=c.itl_slo_s,
            ttft_slo_attainment=(cc["ttft_ok"] / srv) if srv else 0.0,
            itl_slo_attainment=(cc["itl_ok"] / srv) if srv else 0.0,
            goodput_rps=(cc["good"] / wall_s) if wall_s > 0 else 0.0,
        )
    tot_ttft_ok = sum(cc["ttft_ok"] for cc in per_class.values())
    tot_itl_ok = sum(cc["itl_ok"] for cc in per_class.values())
    return {
        "wall_s": round(wall_s, 6),
        "requests": n,
        "served": n_served,
        "good": n_good,
        "shed": shed,
        "timeout": timeout,
        "failed": failed,
        "throughput_rps": (n_served / wall_s) if wall_s > 0 else 0.0,
        "goodput_rps": (n_good / wall_s) if wall_s > 0 else 0.0,
        "goodput_fraction": (n_good / n) if n else 0.0,
        "ttft_slo_attainment": (tot_ttft_ok / n_served) if n_served else 0.0,
        "itl_slo_attainment": (tot_itl_ok / n_served) if n_served else 0.0,
        "phases": phases,
        "classes": per_class,
        "tenants": per_tenant,
    }


# ---------------------------------------------------------------------------
# live gauges (the exporter surface)


def update_gauges(
    report: Dict[str, Any],
    registry: Optional[obs_metrics.MetricsRegistry] = None,
) -> None:
    """Publish a report's attainment as live gauges — called on a
    cadence during a load run so ``/metrics`` shows SLO burn while it
    happens. Gauges overwrite, so repeated calls with cumulative
    reports are the natural burn-rate view (1 - ok_ratio is the error
    budget burned so far)."""
    r = registry or obs_metrics.default_registry()
    g_ttft = r.gauge(
        "edl_slo_ttft_ok_ratio",
        "fraction of served requests meeting their class TTFT SLO",
        ("slo_class",),
    )
    g_itl = r.gauge(
        "edl_slo_itl_ok_ratio",
        "fraction of served requests meeting their class per-token SLO",
        ("slo_class",),
    )
    for cname, cc in report.get("classes", {}).items():
        g_ttft.set(cc.get("ttft_slo_attainment", 0.0), slo_class=cname)
        g_itl.set(cc.get("itl_slo_attainment", 0.0), slo_class=cname)
    r.gauge(
        "edl_slo_goodput_rps",
        "requests/s finishing within their class SLOs",
    ).set(report.get("goodput_rps", 0.0))
    r.gauge(
        "edl_slo_goodput_fraction",
        "good requests / all requests (shed and timeouts count against)",
    ).set(report.get("goodput_fraction", 0.0))


# ---------------------------------------------------------------------------
# text rendering


def _pct(v: float) -> str:
    return f"{100.0 * v:.1f}%"


def render_report(report: Dict[str, Any]) -> str:
    """One human-readable block — the `edl loadgen` default output."""
    lines = [
        f"GOODPUT  {report['good']}/{report['requests']} good "
        f"({_pct(report['goodput_fraction'])}) "
        f"goodput={report['goodput_rps']:.2f} req/s "
        f"throughput={report['throughput_rps']:.2f} req/s "
        f"wall={report['wall_s']:.2f}s",
        f"         served={report['served']} shed={report['shed']} "
        f"timeout={report['timeout']} failed={report['failed']} "
        f"ttft_attainment={_pct(report['ttft_slo_attainment'])} "
        f"itl_attainment={_pct(report['itl_slo_attainment'])}",
    ]
    ph = report.get("phases", {})
    if ph:
        lines.append(
            f"{'phase':>12} {'p50':>10} {'p95':>10} {'p99':>10}"
        )
        for name in ("queue_wait_s", "prefill_s", "decode_s", "ttft_s",
                     "tpot_s", "total_s"):
            p = ph.get(name)
            if p is None:
                continue
            lines.append(
                f"{name:>12} {p['p50'] * 1e3:>8.1f}ms "
                f"{p['p95'] * 1e3:>8.1f}ms {p['p99'] * 1e3:>8.1f}ms"
            )
    for cname, cc in sorted(report.get("classes", {}).items()):
        lines.append(
            f"CLASS {cname}: {cc['good']:.0f}/{cc['requests']:.0f} good "
            f"ttft<= {cc.get('ttft_slo_s', 0):.3g}s: "
            f"{_pct(cc.get('ttft_slo_attainment', 0.0))}  "
            f"tpot<= {cc.get('itl_slo_s', 0):.3g}s: "
            f"{_pct(cc.get('itl_slo_attainment', 0.0))}  "
            f"goodput={cc.get('goodput_rps', 0.0):.2f}/s "
            f"shed={cc['shed']:.0f} timeout={cc['timeout']:.0f}"
        )
    for tname, tc in sorted(report.get("tenants", {}).items()):
        lines.append(
            f"TENANT {tname}: {tc['good']:.0f}/{tc['requests']:.0f} good "
            f"shed={tc['shed']:.0f} timeout={tc['timeout']:.0f}"
        )
    return "\n".join(lines)
