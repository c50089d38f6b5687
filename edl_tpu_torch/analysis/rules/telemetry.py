"""telemetry-conventions — the naming scheme every dashboard scrapes.

The obs stack only works fleet-wide because names are conventions:
Prometheus series share the ``edl_`` prefix (one scrape config, no
collisions with cohabiting exporters), a metric name means ONE thing
(same kind, same label schema, same buckets — ``merge_snapshot``
adds bucket counts across workers, which is only exact when every
registrant agrees), flight-recorder kinds are ``site.verb`` (the
postmortem's chain matcher groups on the ``site.`` half), and every
``fault_point`` site is exercised by a chaos plan or test (an
uncovered site is recovery code no CI run has ever pushed through).

Checks (registration sites are any ``.counter("…")`` / ``.gauge`` /
``.histogram`` call with a literal name; dynamic names are skipped,
never guessed):

* metric names match ``edl_[a-z0-9_]+``;
* suffix/kind agreement (the Prometheus grammar dashboards assume):
  counters MUST end ``_total`` and nothing else may; names ending
  ``_ratio`` / ``_fraction`` MUST be gauges (the hardware-efficiency
  families — ``edl_bw_util_ratio``, ``edl_kv_occupancy_ratio``,
  ``edl_slo_goodput_fraction`` — established the convention: a ratio
  that is secretly a counter sums meaninglessly across a fleet merge);
* no same-name registration with a different kind, label schema, or
  bucket ladder anywhere in the project (cross-file, reported at the
  later site);
* literal event kinds in ``emit("…")`` match ``site.verb``
  (``[a-z0-9_]+\\.[a-z0-9_]+``);
* every literal ``fault_point("site")`` site appears somewhere in
  tests/ or scripts/ (a chaos plan, harness, or test);
* the distributed-trace context keys (``trace_id`` / ``span_id`` /
  ``parent_id``) are only read/written through the
  ``obs/disttrace.py`` helpers — a hand-rolled ``d["trace_id"]``,
  ``.get("span_id")`` or ``{"parent_id": …}`` literal anywhere else
  forks the wire format the fleet merge and flow-link matcher depend
  on (inject/extract/ids_of are the sanctioned accessors);
* every ``series`` in a module-level ``DEFAULT_RULES`` literal (the
  built-in alert rules, obs/alerts.py) names a metric some literal
  registration call actually creates — a rule watching a typo'd or
  deleted series silently never fires, which is the worst failure
  mode a watchdog can have;
* emitted event kinds in the ``alert.`` namespace are exactly
  ``alert.fire`` / ``alert.resolve`` — `edl postmortem
  --assert-recovered --sites alert.` chains on that pair, and a
  third spelling (``alert.fired``…) would silently fall out of every
  incident chain.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from edl_tpu_torch.analysis.core import Finding, ModuleCtx, Project, Rule, register
from edl_tpu_torch.analysis.rules._util import dotted

_METRIC_RE = re.compile(r"^edl_[a-z0-9_]+$")
_KIND_RE = re.compile(r"^[a-z0-9_]+\.[a-z0-9_]+$")
_REG_KINDS = {"counter", "gauge", "histogram"}
_EMIT_RECEIVERS = {"events", "flight", "recorder", "rec", "self"}
# trace-context wire keys: owned by obs/disttrace.py (inject/extract/
# ids_of); hand-rolled dict access anywhere else is a finding
_TRACE_KEYS = {"trace_id", "span_id", "parent_id"}
_TRACE_HOME = "obs/disttrace.py"
_DICT_METHODS = {"get", "pop", "setdefault"}
# the flight-recorder kinds the alert engine may emit — postmortem's
# alert_chains pairs exactly these (obs/postmortem.py)
_ALERT_KINDS = {"alert.fire", "alert.resolve"}


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _label_schema(call: ast.Call) -> Optional[Tuple[str, ...]]:
    """Third positional arg / ``labelnames`` kw, when literal."""
    cand = None
    if len(call.args) >= 3:
        cand = call.args[2]
    for k in call.keywords:
        if k.arg in ("labelnames", "labels"):
            cand = k.value
    if cand is None:
        return ()
    if isinstance(cand, (ast.Tuple, ast.List)):
        out = []
        for e in cand.elts:
            s = _const_str(e)
            if s is None:
                return None  # dynamic: skip schema comparison
            out.append(s)
        return tuple(out)
    return None


def _buckets(call: ast.Call) -> Optional[Tuple[float, ...]]:
    for k in call.keywords:
        if k.arg == "buckets":
            if isinstance(k.value, (ast.Tuple, ast.List)):
                out = []
                for e in k.value.elts:
                    if isinstance(e, ast.Constant) and isinstance(
                        e.value, (int, float)
                    ):
                        out.append(float(e.value))
                    else:
                        return None
                return tuple(out)
            return None
    return ()  # registry default ladder


class _Registration:
    __slots__ = ("name", "kind", "labels", "buckets", "path", "line")

    def __init__(self, name, kind, labels, buckets, path, line):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.buckets = buckets
        self.path = path
        self.line = line


class TelemetryConventionsRule(Rule):
    id = "telemetry-conventions"
    description = (
        "metric naming/registration consistency, event-kind format, "
        "and fault-site test coverage"
    )

    def __init__(self):
        self._regs: List[_Registration] = []
        self._fault_sites: List[Tuple[str, str, int]] = []  # (site, path, line)
        # (series, rule_name, path, line) from DEFAULT_RULES literals
        self._alert_series: List[Tuple[str, str, str, int]] = []

    def _trace_key_finding(self, ctx, node, key, how) -> Finding:
        return Finding(
            rule=self.id,
            path=ctx.relpath,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"hand-rolled trace-context key {key!r} ({how}) — "
                "trace_id/span_id/parent_id are only read/written "
                "through the obs/disttrace helpers "
                "(inject/extract/ids_of), so the wire format stays "
                "in one place"
            ),
        )

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        findings: List[Finding] = []
        trace_home = ctx.relpath.replace(os.sep, "/").endswith(_TRACE_HOME)
        for node in ast.walk(ctx.tree):
            if not trace_home:
                # hand-rolled trace-key access outside disttrace.py:
                # subscripts, dict-method string args, dict literals
                if (
                    isinstance(node, ast.Subscript)
                    and (key := _const_str(node.slice)) in _TRACE_KEYS
                ):
                    findings.append(
                        self._trace_key_finding(ctx, node, key, "subscript")
                    )
                elif isinstance(node, ast.Dict):
                    for k in node.keys:
                        if (key := _const_str(k)) in _TRACE_KEYS:
                            findings.append(
                                self._trace_key_finding(
                                    ctx, k, key, "dict literal"
                                )
                            )
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _DICT_METHODS
                    and node.args
                    and (key := _const_str(node.args[0])) in _TRACE_KEYS
                ):
                    findings.append(
                        self._trace_key_finding(
                            ctx, node, key, f".{node.func.attr}()"
                        )
                    )
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "DEFAULT_RULES"
                    for t in node.targets
                )
            ):
                # the built-in alert rules ship as a pure literal
                # precisely so this check can read them statically
                try:
                    doc = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    doc = None
                if isinstance(doc, dict):
                    for rule in doc.get("rules", ()):
                        if isinstance(rule, dict) and isinstance(
                            rule.get("series"), str
                        ):
                            self._alert_series.append((
                                rule["series"],
                                str(rule.get("name", "?")),
                                ctx.relpath,
                                node.lineno,
                            ))
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            d = dotted(func) or ""
            leaf = d.rsplit(".", 1)[-1]

            if (
                isinstance(func, ast.Attribute)
                and leaf in _REG_KINDS
                and node.args
            ):
                name = _const_str(node.args[0])
                if name is None:
                    continue
                if not _METRIC_RE.match(name):
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"metric '{name}' does not follow the "
                                "'edl_<snake_case>' naming convention"
                            ),
                        )
                    )
                suffix_msg = None
                if leaf == "counter" and not name.endswith("_total"):
                    suffix_msg = (
                        f"counter '{name}' must end '_total' "
                        "(Prometheus counter grammar)"
                    )
                elif leaf != "counter" and name.endswith("_total"):
                    suffix_msg = (
                        f"{leaf} '{name}' ends '_total' but is not a "
                        "counter — scrapers will rate() it"
                    )
                elif leaf != "gauge" and (
                    name.endswith("_ratio") or name.endswith("_fraction")
                ):
                    suffix_msg = (
                        f"{leaf} '{name}' ends '_ratio'/'_fraction' but "
                        "is not a gauge — ratios summed across a fleet "
                        "merge are meaningless"
                    )
                if suffix_msg:
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=node.lineno,
                            col=node.col_offset,
                            message=suffix_msg,
                        )
                    )
                self._regs.append(
                    _Registration(
                        name, leaf, _label_schema(node), _buckets(node),
                        ctx.relpath, node.lineno,
                    )
                )

            elif leaf == "emit" and node.args:
                recv = d.rsplit(".", 1)[0] if "." in d else ""
                if isinstance(func, ast.Name) or recv in _EMIT_RECEIVERS:
                    kind = _const_str(node.args[0])
                    if kind is not None and not _KIND_RE.match(kind):
                        findings.append(
                            Finding(
                                rule=self.id,
                                path=ctx.relpath,
                                line=node.lineno,
                                col=node.col_offset,
                                message=(
                                    f"event kind '{kind}' does not follow "
                                    "the 'site.verb' convention the "
                                    "postmortem chain matcher groups on"
                                ),
                            )
                        )
                    elif (
                        kind is not None
                        and kind.startswith("alert.")
                        and kind not in _ALERT_KINDS
                    ):
                        findings.append(
                            Finding(
                                rule=self.id,
                                path=ctx.relpath,
                                line=node.lineno,
                                col=node.col_offset,
                                message=(
                                    f"event kind '{kind}' squats the "
                                    "alert.* namespace — the postmortem "
                                    "incident chainer pairs exactly "
                                    "'alert.fire'/'alert.resolve', so any "
                                    "other spelling falls out of every "
                                    "chain"
                                ),
                            )
                        )

            elif leaf == "fault_point" and node.args:
                site = _const_str(node.args[0])
                if site is not None:
                    self._fault_sites.append((site, ctx.relpath, node.lineno))

        return findings

    def finalize(self, project: Project) -> Iterable[Finding]:
        findings: List[Finding] = []

        first: Dict[str, _Registration] = {}
        for r in sorted(self._regs, key=lambda r: (r.path, r.line)):
            prev = first.setdefault(r.name, r)
            if prev is r:
                continue
            clash = None
            if prev.kind != r.kind:
                clash = f"kind {prev.kind} vs {r.kind}"
            elif (
                prev.labels is not None
                and r.labels is not None
                and prev.labels != r.labels
            ):
                clash = f"labels {prev.labels} vs {r.labels}"
            elif (
                prev.buckets is not None
                and r.buckets is not None
                and prev.buckets != r.buckets
            ):
                clash = "different bucket ladders"
            if clash:
                findings.append(
                    Finding(
                        rule=self.id,
                        path=r.path,
                        line=r.line,
                        col=0,
                        message=(
                            f"metric '{r.name}' re-registered with a "
                            f"conflicting schema ({clash}; first at "
                            f"{prev.path}) — fleet merge_snapshot would "
                            "mix incompatible series"
                        ),
                        severity="error",
                    )
                )

        ref = project.reference_text()
        seen = set()
        for site, path, line in self._fault_sites:
            if site in seen:
                continue
            seen.add(site)
            if site not in ref:
                findings.append(
                    Finding(
                        rule=self.id,
                        path=path,
                        line=line,
                        col=0,
                        message=(
                            f"fault site '{site}' is not referenced by any "
                            "chaos plan or test under tests//scripts/ — "
                            "its recovery path has never been exercised"
                        ),
                    )
                )

        # built-in alert rules must watch series that exist: a rule
        # over an unregistered name silently never fires
        registered = {r.name for r in self._regs}
        if registered:  # partial runs (no obs/ modules) can't judge
            for series, rname, path, line in self._alert_series:
                if series not in registered:
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=path,
                            line=line,
                            col=0,
                            message=(
                                f"alert rule '{rname}' watches series "
                                f"'{series}' which no literal "
                                "counter/gauge/histogram registration "
                                "creates — the rule can never fire"
                            ),
                            severity="error",
                        )
                    )

        # reset per-run state (rule instances are module singletons)
        self._regs = []
        self._fault_sites = []
        self._alert_series = []
        return findings


register(TelemetryConventionsRule())
