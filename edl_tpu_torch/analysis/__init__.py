"""Project-invariant static analysis — ``edl check``.

The codebase rests on invariants no generic linter knows about:
donated-buffer discipline (a buffer passed at a ``donate_argnums``
position is DEAD after the call — reading it is the stale-cache bug
class ``_assert_donated`` only catches at runtime), hand-maintained
lock conventions across 30+ ``threading`` sites, jit purity (host
syncs and per-call re-jits are the silent perf killers behind bench
regressions), the flight-recorder contract (a swallowed exception is
an incident the postmortem can never see), and the telemetry naming
scheme every dashboard scrapes. This package is the compile-time
enforcement of those invariants — the ``go vet`` analog of the
reference control plane's CI, specialized to THIS project.

Layout:

* :mod:`edl_tpu_torch.analysis.core` — finding model, rule registry,
  ``# edl: no-lint[rule-id]`` suppressions, committed-baseline
  workflow, text/JSON reports.
* :mod:`edl_tpu_torch.analysis.rules` — the five project rules
  (donation-safety, lockset-race, recompile-hazard, silent-failure,
  telemetry-conventions).

Everything here is stdlib-``ast`` only — the CLI imports it, so it
must stay importable without JAX devices (same constraint as
cli/main.py).

Usage::

    from edl_tpu_torch import analysis
    report = analysis.run_check(
        ["edl_tpu_torch"], baseline="edl_tpu_torch/analysis/baseline.json")
    print(analysis.render_text(report))

The port of ``edl_tpu/analysis/``, unchanged in behaviour: the same
rules (the donation and recompile rules still look for JAX's
``donate_argnums`` and ``jax.jit`` idioms, so over the port's source they
find nothing, and over the reference's they report what the reference's
own analyzer reports), the same scheduler and happens-before detector;
the schedcheck harnesses drive the port's classes. The port's baseline
is ``baseline.json`` in this package.
"""

from edl_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Report,
    Rule,
    all_rules,
    load_baseline,
    register,
    render_json,
    render_text,
    run_check,
    write_baseline,
)

# importing the rules package registers the five project rules
from edl_tpu_torch.analysis import rules as _rules  # noqa: F401
