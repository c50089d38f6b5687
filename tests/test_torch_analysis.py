"""Port parity: the static analyzer of ``edl_tpu_torch``
(``analysis/{core,rules/*}.py``) and the ``check`` verb of the port's CLI.

The reference's cases (``tests/test_analysis.py``: each rule's true
positive, clean negative and suppression, the baseline round trip, the
verb, the reference package clean against ``analysis_baseline.json``) run
against the port, each a parametrised case here. Then the port's analyzer
over each package, read as text and never imported, equals the
reference's report finding for finding; ``edl_tpu_torch/`` is clean under
the port's baseline, whose every entry carries a reason; and ``check``
imports neither torch nor jax.
"""

import json
import os
import subprocess
import sys

import pytest

from edl_tpu import analysis as janalysis
from edl_tpu_torch import analysis as tanalysis
from edl_tpu_torch.cli import main as tcli
from tests.port_cases import case_names, port_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "edl_tpu_torch", "analysis", "baseline.json")

CASES = port_cases("test_analysis")


def test_the_reference_file_is_pointed_at_the_port():
    assert CASES.analysis is tanalysis
    assert CASES.cli_main is tcli
    assert len(case_names(CASES)) == 40


@pytest.mark.parametrize("case", case_names(CASES))
def test_reference_analysis_case_on_the_port(case, tmp_path, capsys):
    fn = getattr(CASES, case)
    have = {"tmp_path": tmp_path, "capsys": capsys}
    fn(**{k: have[k] for k in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})


def _records(report):
    return {
        "findings": [f.to_record() for f in report.findings],
        "baselined": [f.to_record() for f in report.baselined],
        "suppressed": report.suppressed, "files": report.files,
        "errors": report.errors, "rules": report.rule_stats,
        "failed": report.failed}


@pytest.mark.parametrize("pkg,baseline", [
    ("edl_tpu", os.path.join(ROOT, "analysis_baseline.json")),
    ("edl_tpu_torch", BASELINE)], ids=["edl_tpu", "edl_tpu_torch"])
def test_report_equals_the_references_finding_for_finding(pkg, baseline):
    """Both analyzers over one package with its baseline (open and
    baselined findings together are every finding not suppressed): rule,
    path, line, column, message and severity of each, the suppressed
    count, the per-rule stats and the JSON report but its seconds."""
    path = os.path.join(ROOT, pkg)
    ref = janalysis.run_check([path], baseline=baseline, root=ROOT)
    port = tanalysis.run_check([path], baseline=baseline, root=ROOT)
    assert _records(port) == _records(ref)
    assert ref.baselined and not ref.findings

    def doc(rep, mod):
        d = json.loads(mod.render_json(rep))
        del d["duration_s"]
        return d

    assert doc(port, tanalysis) == doc(ref, janalysis)


def test_rules_and_registry_are_the_references():
    assert sorted(tanalysis.all_rules()) == sorted(janalysis.all_rules())
    for rid, rule in tanalysis.all_rules().items():
        assert rule.description == janalysis.all_rules()[rid].description


def test_the_port_is_clean_under_its_baseline_and_check_is_device_free(
        tmp_path):
    """``python -m edl_tpu_torch check --baseline
    edl_tpu_torch/analysis/baseline.json`` in a fresh process: exit 0, no
    open finding, no error; every baseline entry is a finding of today's
    tree and carries the reason it is tolerated; and the verb imported
    neither torch nor jax nor the reference."""
    code = ("import json, sys\n"
            "from edl_tpu_torch.cli import main\n"
            f"rc = main(['check', '--baseline', {BASELINE!r}, '--json'])\n"
            "bad = [m for m in ('torch', 'jax', 'edl_tpu') if m in sys.modules]\n"
            "print(json.dumps(bad))\n"
            "sys.exit(rc)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    out = p.stdout.strip().splitlines()
    assert json.loads(out[-1]) == []
    doc = json.loads("\n".join(out[:-1]))
    assert doc["ok"] and doc["findings"] == [] and doc["errors"] == []
    assert doc["files"] > 100
    entries = tanalysis.load_baseline(BASELINE)
    assert entries and all(len(e["reason"]) > 40 for e in entries.values())
    keys = [f"{f['rule']}|{f['path']}|{f['message']}"
            for f in doc["baselined"]]
    assert sorted(set(keys)) == sorted(entries)
    assert sum(e["count"] for e in entries.values()) == len(keys)
    # the tree's deliberate sites carry in-code suppressions, as the
    # reference's do
    assert doc["suppressed"] >= 10


def test_check_verb_exit_codes_on_the_port(capsys):
    """The verb with its defaults (the edl_tpu_torch package, root at the
    repo): 1 without the baseline, the two baselined findings open; 2 on
    an unknown rule."""
    assert tcli(["check", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert not doc["ok"] and {f["path"] for f in doc["findings"]} == {
        "edl_tpu_torch/cluster/kube.py", "edl_tpu_torch/serving/replica.py"}
    assert tcli(["check", "--rule", "bogus"]) == 2
    assert "unknown rule" in capsys.readouterr().err
