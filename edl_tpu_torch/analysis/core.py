"""Analyzer framework — findings, rule registry, suppressions,
baseline, runner.

Design constraints, in order:

* **project-invariant, not general-purpose** — rules encode THIS
  repo's contracts (donation, locksets, jit purity, flight-recorder
  coverage, telemetry names). A rule that needs to know what
  ``fault_point`` or ``donate_argnums`` means belongs here; generic
  pyflakes-style checks do not.
* **two-phase** — every rule sees each module's AST once
  (``check_module``), then gets one ``finalize`` pass over the whole
  project for cross-file invariants (duplicate metric registrations,
  unreferenced fault sites). Parsing each file once and sharing the
  tree keeps the full-package run well under the 30 s budget.
* **suppressable + baselined** — a deliberate violation is silenced
  AT the site with ``# edl: no-lint[rule-id]`` (same line or the line
  above) and a reason in the comment; a legacy violation lives in the
  committed baseline file so CI fails only on NEW findings. Both are
  visible in the report (suppressions are counted, baselined findings
  listed under their key), never silently dropped.

Finding identity for the baseline is ``rule|path|message`` — line
numbers are deliberately NOT part of the key, so unrelated edits above
a baselined finding don't resurrect it; the baseline stores a count
per key so adding a SECOND instance of a baselined pattern still
fails.
"""

from __future__ import annotations

import ast
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "ModuleCtx",
    "Project",
    "Report",
    "Rule",
    "all_rules",
    "load_baseline",
    "register",
    "render_json",
    "render_text",
    "run_check",
    "write_baseline",
]

SEVERITIES = ("info", "warn", "error")

# `# edl: no-lint[rule-a, rule-b]` — the bracket is mandatory: a
# suppression must name what it silences, or a later rule rename
# would turn it into a silent no-op
_SUPPRESS_RE = re.compile(r"#\s*edl:\s*no-lint\[([A-Za-z0-9_,\- ]+)\]")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site. ``message`` must be stable
    under unrelated edits (no line numbers inside it) — it is part of
    the baseline key."""

    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    col: int
    message: str
    severity: str = "warn"

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.message}"

    def to_record(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "severity": self.severity,
        }


class ModuleCtx:
    """One parsed source file: AST + raw lines + suppression map."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of suppressed rule ids on that line
        self.suppressions: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                ids = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppressions[i] = ids

    def suppressed(self, rule_id: str, line: int) -> bool:
        """A finding is suppressed by a no-lint comment on its own
        line or on the line directly above (the conventional place
        when the finding line is already long)."""
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and rule_id in ids:
                return True
        return False


class Project:
    """Everything ``finalize`` passes see: all parsed modules plus the
    repo root (for cross-tree references like chaos plans in scripts/
    and tests/)."""

    def __init__(self, root: str, modules: List[ModuleCtx]):
        self.root = root
        self.modules = modules
        self._ref_text: Optional[str] = None

    def reference_text(self) -> str:
        """Concatenated source of tests/ + scripts/ (lazily read once):
        the corpus a fault site or metric name must be exercised by.
        Used by telemetry-conventions' fault-site coverage check."""
        if self._ref_text is None:
            chunks: List[str] = []
            for sub in ("tests", "scripts"):
                d = os.path.join(self.root, sub)
                if not os.path.isdir(d):
                    continue
                for base, dirs, files in os.walk(d):
                    dirs[:] = [x for x in dirs if x != "__pycache__"]
                    for f in sorted(files):
                        if f.endswith((".py", ".sh", ".json")):
                            p = os.path.join(base, f)
                            try:
                                with open(p, encoding="utf-8") as fh:
                                    chunks.append(fh.read())
                            except OSError:
                                continue
            self._ref_text = "\n".join(chunks)
        return self._ref_text


class Rule:
    """Base class: subclass, set ``id``/``description``, override
    ``check_module`` (per-file) and/or ``finalize`` (cross-file)."""

    id: str = ""
    description: str = ""

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        return ()

    def finalize(self, project: Project) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    """Add a rule instance to the global registry (idempotent by id —
    re-importing the rules package must not duplicate them)."""
    if not rule.id:
        raise ValueError(f"rule {rule!r} has no id")
    _REGISTRY[rule.id] = rule
    return rule


def all_rules() -> Dict[str, Rule]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# baseline


def load_baseline(path: str) -> Dict[str, dict]:
    """{finding-key: {"count": N, "reason": str}}. Accepts the bare
    mapping or the versioned envelope ``write_baseline`` emits."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("findings", doc) if isinstance(doc, dict) else {}
    out: Dict[str, dict] = {}
    for k, v in entries.items():
        if isinstance(v, int):
            v = {"count": v}
        out[k] = {"count": int(v.get("count", 1)), "reason": v.get("reason", "")}
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Snapshot the given findings as the new baseline (the
    ``--write-baseline`` workflow: triage first, then freeze what's
    deliberately left)."""
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    doc = {
        "version": 1,
        "comment": "edl check baseline — CI fails only on findings not "
        "covered here; regenerate with `edl check --write-baseline` "
        "after triaging.",
        "findings": {
            k: {"count": n, "reason": ""} for k, n in sorted(counts.items())
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# runner


@dataclass
class Report:
    """Outcome of one analyzer run."""

    findings: List[Finding] = field(default_factory=list)  # actionable
    baselined: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    files: int = 0
    duration_s: float = 0.0
    errors: List[str] = field(default_factory=list)  # unparseable files
    # per-rule counts — {"rule-id": {"findings": N, "baselined": N,
    # "suppressed": N}} — the machine-readable block the CI phase-0
    # gate log prints so a creeping suppression count is visible
    rule_stats: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def failed(self) -> bool:
        return bool(self.findings or self.errors)

    def _bump(self, rule: str, bucket: str) -> None:
        st = self.rule_stats.setdefault(
            rule, {"findings": 0, "baselined": 0, "suppressed": 0}
        )
        st[bucket] += 1


def _walk_py(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for base, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(base, f))
    return out


def run_check(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[str] = None,
    root: Optional[str] = None,
) -> Report:
    """Run the selected rules over every .py under ``paths``.

    ``baseline`` (a path) filters known findings; ``root`` anchors
    repo-relative paths and the tests/scripts reference corpus
    (default: common parent of ``paths``).
    """
    t0 = time.perf_counter()
    selected = all_rules()
    if rules:
        unknown = sorted(set(rules) - set(selected))
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; have {sorted(selected)}"
            )
        selected = {k: v for k, v in selected.items() if k in rules}

    root = os.path.abspath(root or os.path.commonpath([os.path.abspath(p) for p in paths]))
    if os.path.isfile(root):
        root = os.path.dirname(root)

    report = Report()
    modules: List[ModuleCtx] = []
    for fpath in _walk_py(paths):
        rel = os.path.relpath(os.path.abspath(fpath), root).replace(os.sep, "/")
        try:
            with open(fpath, encoding="utf-8") as f:
                src = f.read()
            modules.append(ModuleCtx(fpath, rel, src))
        except (OSError, SyntaxError, ValueError) as e:
            report.errors.append(f"{rel}: {e}")
    report.files = len(modules)

    project = Project(root, modules)
    raw: List[Finding] = []
    for rule in selected.values():
        for ctx in modules:
            raw.extend(rule.check_module(ctx))
        raw.extend(rule.finalize(project))

    # suppression filter (a suppressed finding is counted, not listed)
    by_rel = {m.relpath: m for m in modules}
    kept: List[Finding] = []
    for f in raw:
        ctx = by_rel.get(f.path)
        if ctx is not None and ctx.suppressed(f.rule, f.line):
            report.suppressed += 1
            report._bump(f.rule, "suppressed")
        else:
            kept.append(f)

    # baseline filter: up to `count` findings per key are expected
    if baseline:
        budget = {k: v["count"] for k, v in load_baseline(baseline).items()}
        for f in sorted(kept, key=lambda x: (x.path, x.line, x.rule)):
            if budget.get(f.key, 0) > 0:
                budget[f.key] -= 1
                report.baselined.append(f)
            else:
                report.findings.append(f)
    else:
        report.findings = sorted(kept, key=lambda x: (x.path, x.line, x.rule))

    report.findings.sort(key=lambda x: (x.path, x.line, x.rule))
    for f in report.findings:
        report._bump(f.rule, "findings")
    for f in report.baselined:
        report._bump(f.rule, "baselined")
    report.duration_s = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# reports


def render_text(report: Report, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in report.findings:
        lines.append(
            f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.severity}: {f.message}"
        )
    for e in report.errors:
        lines.append(f"ERROR: {e}")
    if verbose and report.baselined:
        lines.append("-- baselined (not failing) --")
        for f in report.baselined:
            lines.append(f"{f.path}:{f.line}: [{f.rule}] {f.message}")
    n = len(report.findings)
    lines.append(
        f"edl check: {n} finding{'s' if n != 1 else ''} "
        f"({len(report.baselined)} baselined, {report.suppressed} suppressed) "
        f"in {report.files} files [{report.duration_s:.2f}s]"
    )
    return "\n".join(lines)


def render_json(report: Report) -> str:
    doc = {
        "findings": [f.to_record() for f in report.findings],
        "baselined": [f.to_record() for f in report.baselined],
        "suppressed": report.suppressed,
        "rules": {
            rule: dict(st) for rule, st in sorted(report.rule_stats.items())
        },
        "files": report.files,
        "errors": report.errors,
        "duration_s": round(report.duration_s, 3),
        "ok": not report.failed,
    }
    return json.dumps(doc, indent=2)
