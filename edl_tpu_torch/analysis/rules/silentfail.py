"""silent-failure — a swallowed exception is an invisible incident.

The flight recorder exists so that every failure leaves a trace an
``edl postmortem`` can see; a broad ``except`` that neither re-raises
nor emits anything is the exact gap it cannot close. This rule flags
``except``/``except Exception``/``except BaseException`` handlers
whose body does none of:

* re-raise (``raise``, bare or otherwise);
* log through the KV logger (``log.warn``/``error``/``exception`` —
  warn/error mirror onto the flight-recorder timeline via the
  utils/logging sink);
* emit an event or metric (``events.emit``/``flight.emit``/``.inc``/
  ``.observe``/``crash_dump``);
* use the exception object at all — ``errs.append(e)``,
  ``self._recover(e)``, ``last = e``, ``f"...{e}"`` in a 500 body:
  once ``e`` flows somewhere, the handler is propagating or
  reporting, not swallowing;
* exit (``sys.exit``/``os._exit``).

Narrow catches (``except OSError``) are exempt: catching a *specific*
expected failure silently is a stated decision; catching *everything*
silently is a bug magnet (it eats ``InjectedFault`` during chaos runs
too, which is how these were found). Deliberate broad-and-silent
sites — telemetry code that must never raise, best-effort teardown —
carry an in-code suppression naming the reason.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from edl_tpu_torch.analysis.core import Finding, ModuleCtx, Rule, register
from edl_tpu_torch.analysis.rules._util import dotted

_BROAD = {"Exception", "BaseException"}
_LOGGING_ATTRS = {
    "warn", "warning", "error", "exception", "critical", "fatal",
    "inc", "observe", "emit",
}
_EXIT_CALLS = {"sys.exit", "os._exit", "exit"}
_HANDLER_CALLS = {"crash_dump"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Tuple):
        names = [dotted(e) for e in t.elts]
    else:
        names = [dotted(t)]
    return any(n in _BROAD for n in names)


def _handles(handler: ast.ExceptHandler) -> bool:
    """True if the handler visibly surfaces the failure."""
    exc_name = handler.name  # `except Exception as e` -> "e"
    for n in ast.walk(handler):
        if isinstance(n, ast.Raise):
            return True
        if (
            exc_name
            and isinstance(n, ast.Name)
            and n.id == exc_name
            and isinstance(n.ctx, ast.Load)
        ):
            return True  # the exception object flows somewhere
        if isinstance(n, ast.Call):
            d = dotted(n.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if leaf in _LOGGING_ATTRS or d in _EXIT_CALLS or leaf in _HANDLER_CALLS:
                return True
    return False


class SilentFailureRule(Rule):
    id = "silent-failure"
    description = (
        "broad except block that neither re-raises nor emits a "
        "log/metric/event (invisible to the flight recorder)"
    )

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _handles(node):
                continue
            caught = "bare except" if node.type is None else (
                dotted(node.type) if not isinstance(node.type, ast.Tuple)
                else "Exception"
            )
            findings.append(
                Finding(
                    rule=self.id,
                    path=ctx.relpath,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"broad '{caught}' handler swallows the error "
                        "without re-raise, log.warn/error, or a "
                        "metric/event — invisible to the flight recorder "
                        "and to `edl postmortem`"
                    ),
                )
            )
        return findings


register(SilentFailureRule())
