"""recompile-hazard — the silent perf killers behind bench regressions.

Nothing crashes when a hot path quietly retraces or syncs the host;
the tokens/s number just sags. Four hazard classes, all pinned to
patterns this repo actually shipped (and the conventions it grew to
avoid them):

* **per-call jit** — ``jax.jit(fn)`` / ``jax.jit(lambda ...)`` built
  inside a function body creates a fresh wrapper per invocation, so
  every call retraces. The blessed patterns are module scope, a memo
  (``ops/quant.py`` caches per dtype/sharding "per-call jit objects
  would re-trace each reshard"), or a build-once ``self.X``/guarded
  cell (``train/trainer.py``). The rule exempts jit calls under an
  ``if`` (the memo-guard shape) and ones assigned to ``self.X``.
* **host sync inside jit** — ``.item()``, ``float()/int()/bool()`` on
  a traced parameter, ``np.asarray``/``np.array`` of a traced value,
  ``jax.device_get`` inside a jit-decorated function: trace-time
  errors at best, silent constant-folding of a live value at worst.
* **shape-dependent Python branch** — ``if x.shape[...]`` inside a
  jitted function recompiles per shape class (validation branches
  that immediately ``raise`` are exempt: they run at trace time by
  design).
* **unhashable static args** — a call passing a list/dict/set literal
  at a ``static_argnums`` position (or a ``static_argnames`` keyword)
  of a locally-resolvable jitted function: ``TypeError: unhashable``
  at runtime, and a per-value recompile even when hashable-wrapped.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from edl_tpu_torch.analysis.core import Finding, ModuleCtx, Rule, register
from edl_tpu_torch.analysis.rules._util import (
    decorator_is_jitted,
    dotted,
    is_jit_call,
    jit_call_argnums,
    walk_no_nested_functions,
)

_HOST_SYNC_CALLS = {"np.asarray", "np.array", "np.copy", "jax.device_get",
                    "numpy.asarray", "numpy.array"}
_COERCIONS = {"float", "int", "bool", "complex"}


def _literal_strs(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return tuple(out)
    return None


class _StaticSig:
    """static_argnums/argnames of one locally-defined jitted fn."""

    def __init__(self, argnums: Tuple[int, ...], argnames: Tuple[str, ...]):
        self.argnums = argnums
        self.argnames = argnames


def _static_sigs(tree: ast.Module) -> Dict[str, _StaticSig]:
    """name -> static signature, from decorated defs and
    ``f = jax.jit(g, static_argnums=...)`` bindings."""
    sigs: Dict[str, _StaticSig] = {}

    def from_call(call: ast.Call) -> Optional[_StaticSig]:
        nums = jit_call_argnums(call, "static_argnums") or ()
        names: Tuple[str, ...] = ()
        for k in call.keywords:
            if k.arg == "static_argnames":
                names = _literal_strs(k.value) or ()
        if nums or names:
            return _StaticSig(nums, names)
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and is_jit_call(dec):
                    sig = from_call(dec)
                    if sig:
                        sigs[node.name] = sig
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if is_jit_call(node.value):
                sig = from_call(node.value)
                if sig:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            sigs[t.id] = sig
    return sigs


def _is_unhashable_literal(node: ast.AST) -> bool:
    return isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp))


class RecompileHazardRule(Rule):
    id = "recompile-hazard"
    description = (
        "per-call re-jit, host sync or shape branch inside jit, or "
        "unhashable static args (silent recompile/perf hazards)"
    )

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        findings: List[Finding] = []
        sigs = _static_sigs(ctx.tree)

        all_fns = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.FunctionDef)]
        for fn in all_fns:
            findings.extend(self._per_call_jit(ctx, fn))
            if decorator_is_jitted(fn):
                findings.extend(self._inside_jit(ctx, fn))
        findings.extend(self._static_call_sites(ctx, sigs))
        return findings

    # -- hazard 1: fresh jit wrapper per call -------------------------------

    def _per_call_jit(self, ctx: ModuleCtx, fn: ast.FunctionDef) -> List[Finding]:
        out: List[Finding] = []
        # jit calls assigned to self.X are build-once builder state
        self_assigned: Set[int] = set()
        for n in walk_no_nested_functions(fn):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                if any(
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    for t in n.targets
                ):
                    # the jit itself, or a jit nested in a decorator-
                    # style wrapper call (compilewatch.wrap(jax.jit(f),
                    # ...)) — still the build-once builder shape
                    for sub in ast.walk(n.value):
                        if isinstance(sub, ast.Call) and is_jit_call(sub):
                            self_assigned.add(id(sub))

        def visit(node: ast.AST, in_guard: bool) -> None:
            if isinstance(node, ast.Call) and is_jit_call(node):
                # an `if` around the jit is the memo-guard shape
                # (quant.py / trainer.py build-once cells); self.X
                # assignment is the build-once builder shape
                if not in_guard and id(node) not in self_assigned and node.args:
                    out.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"jax.jit built inside '{fn.name}' creates "
                                "a fresh wrapper per call — every "
                                "invocation retraces; hoist to module "
                                "scope or memoize it (the ops/quant.py "
                                "cache pattern)"
                            ),
                        )
                    )
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                     ast.ClassDef),
                ):
                    continue
                visit(child, in_guard or isinstance(node, ast.If))

        for stmt in fn.body:
            if not isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                visit(stmt, False)
        return out

    # -- hazards 2+3: inside a jitted function ------------------------------

    def _inside_jit(self, ctx: ModuleCtx, fn: ast.FunctionDef) -> List[Finding]:
        out: List[Finding] = []
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        params.discard("self")

        def mentions_param(e: ast.AST) -> bool:
            return any(
                isinstance(n, ast.Name) and n.id in params for n in ast.walk(e)
            )

        for n in walk_no_nested_functions(fn):
            if isinstance(n, ast.Call):
                name = dotted(n.func)
                msg = None
                if isinstance(n.func, ast.Attribute) and n.func.attr == "item":
                    msg = ".item() inside jitted"
                elif name in _HOST_SYNC_CALLS and n.args and mentions_param(n.args[0]):
                    msg = f"{name}() on a traced value inside jitted"
                elif (
                    name in _COERCIONS
                    and n.args
                    and mentions_param(n.args[0])
                ):
                    msg = f"{name}() coercion of a traced value inside jitted"
                if msg:
                    out.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=n.lineno,
                            col=n.col_offset,
                            message=(
                                f"{msg} function '{fn.name}' — host sync / "
                                "trace-time constant-folding hazard"
                            ),
                        )
                    )
            elif isinstance(n, ast.If):
                has_shape = any(
                    isinstance(s, ast.Attribute) and s.attr == "shape"
                    for s in ast.walk(n.test)
                )
                only_raises = all(
                    isinstance(s, (ast.Raise, ast.Pass)) for s in n.body
                )
                if has_shape and not only_raises:
                    out.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=n.lineno,
                            col=n.col_offset,
                            message=(
                                "shape-dependent Python branch inside jitted "
                                f"function '{fn.name}' — recompiles per shape "
                                "class; use lax.cond / static args if "
                                "intended"
                            ),
                            severity="info",
                        )
                    )
        return out

    # -- hazard 4: unhashable static args -----------------------------------

    def _static_call_sites(
        self, ctx: ModuleCtx, sigs: Dict[str, _StaticSig]
    ) -> List[Finding]:
        out: List[Finding] = []
        if not sigs:
            return out
        for n in ast.walk(ctx.tree):
            if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)):
                continue
            sig = sigs.get(n.func.id)
            if sig is None:
                continue
            for i in sig.argnums:
                if i < len(n.args) and _is_unhashable_literal(n.args[i]):
                    out.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=n.args[i].lineno,
                            col=n.args[i].col_offset,
                            message=(
                                f"unhashable literal at static_argnums "
                                f"position {i} of '{n.func.id}' — TypeError "
                                "at call time (static args must be hashable)"
                            ),
                            severity="error",
                        )
                    )
            for kw in n.keywords:
                if kw.arg in sig.argnames and _is_unhashable_literal(kw.value):
                    out.append(
                        Finding(
                            rule=self.id,
                            path=ctx.relpath,
                            line=kw.value.lineno,
                            col=kw.value.col_offset,
                            message=(
                                f"unhashable literal for static_argname "
                                f"'{kw.arg}' of '{n.func.id}' — TypeError at "
                                "call time (static args must be hashable)"
                            ),
                            severity="error",
                        )
                    )
        return out


register(RecompileHazardRule())
