"""donation-safety — compile-time form of ``_assert_donated``.

A buffer passed at a ``donate_argnums`` position of a jitted call is
DEAD after the call: XLA reuses its memory for the outputs, and any
later read sees either an error or (worse, on backends that alias
lazily) stale bytes. The serving engine enforces this at runtime via
``ContinuousBatchingEngine._assert_donated`` (engine.py) — this rule
moves the check to compile time, flagging the exact bug pattern the
stale-donated-buffer regression test pins: a variable read after
it was donated, instead of rebound from the call's results.

What counts as a donating callee (all resolved statically, same
module only — unresolvable callees are skipped, never guessed):

* a function decorated ``@partial(jax.jit, donate_argnums=...)`` or
  ``@jax.jit(donate_argnums=...)``, called by name;
* a local ``f = jax.jit(g, donate_argnums=...)`` binding;
* a *program factory*: a module function whose body contains a nested
  def decorated with literal ``donate_argnums`` (the engine's
  ``_block_program``/``_prefill_program`` memo pattern) — both direct
  calls of the factory result and ``self.X = factory(...)`` attributes
  are tracked;
* ``self.X = jax.jit(..., donate_argnums=...)`` attributes.

The dataflow is per-function: donated names (and the bases of
``name[i]`` subscript arguments — the engine passes its device-state
tuple elementwise) are tainted at the call; any later Load before a
rebind is a finding. Branches merge by union, loop bodies run twice so
a read in iteration N+1 of a value donated in iteration N is caught.
Deliberate post-donation probes (``_assert_donated`` itself calls
``.is_deleted()`` on the dead buffers) are suppressed in-code with a
reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from edl_tpu_torch.analysis.core import Finding, ModuleCtx, Rule, register
from edl_tpu_torch.analysis.rules._util import (
    decorator_donate_argnums,
    dotted,
    is_jit_call,
    jit_call_argnums,
    self_attr,
)

_TaintKey = Tuple[str, str]  # ("n", name) | ("a", self-attr)


def _donating_params(
    fn: ast.FunctionDef,
    jitted: Dict[str, Tuple[int, ...]],
    attrs: Dict[str, Tuple[int, ...]],
    offset: int,
) -> Tuple[int, ...]:
    """One-level call summary: which of ``fn``'s positional arguments
    (caller-side indices, ``offset``=1 drops ``self``) are passed
    straight to a donate position of a known jitted call in its body —
    so ``a, b = helper(buf)`` taints ``buf`` in the caller even though
    the ``jax.jit`` call is one frame down.

    Conservative on purpose: a parameter rebound anywhere in the body
    is excluded (the donated value may no longer be the caller's), and
    ``*args`` splats / keyword passing are ignored."""
    params = [a.arg for a in fn.args.args]
    rebound: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in tgts:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name) and isinstance(
                        sub.ctx, ast.Store
                    ):
                        rebound.add(sub.id)
    donated: Set[int] = set()
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        nums: Optional[Tuple[int, ...]] = None
        f = n.func
        if isinstance(f, ast.Name):
            nums = jitted.get(f.id)
        else:
            a = self_attr(f)
            if a is not None:
                nums = attrs.get(a)
        if not nums or any(isinstance(a, ast.Starred) for a in n.args):
            continue
        for i in nums:
            if i >= len(n.args):
                continue
            arg = n.args[i]
            base = arg.value if isinstance(arg, ast.Subscript) else arg
            if (
                isinstance(base, ast.Name)
                and base.id in params
                and base.id not in rebound
            ):
                donated.add(params.index(base.id) - offset)
    return tuple(sorted(i for i in donated if i >= 0))


class _Taint:
    __slots__ = ("line", "callee")

    def __init__(self, line: int, callee: str):
        self.line = line
        self.callee = callee


def _module_donation_maps(tree: ast.Module):
    """(jitted defs by name, factories by name, per-class attr map)."""
    jitted: Dict[str, Tuple[int, ...]] = {}
    factories: Dict[str, Tuple[int, ...]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            nums = decorator_donate_argnums(node)
            if nums:
                jitted[node.name] = nums
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.FunctionDef)
                    and sub is not node
                    and decorator_donate_argnums(sub)
                ):
                    factories[node.name] = decorator_donate_argnums(sub)
                    break

    attr_donate: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs: Dict[str, Tuple[int, ...]] = {}
        for n in ast.walk(cls):
            if not (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)):
                continue
            nums = None
            callee = dotted(n.value.func)
            if callee in factories:
                nums = factories[callee]
            elif is_jit_call(n.value):
                nums = jit_call_argnums(n.value, "donate_argnums")
            if not nums:
                continue
            for t in n.targets:
                a = self_attr(t)
                if a:
                    attrs[a] = nums
        if attrs:
            attr_donate[cls.name] = attrs

    # one-level helper summaries: `def split(buf): a, b = step(buf); ...`
    # donates its caller's argument even though the jit call is inside
    helper_fns: Dict[str, Tuple[int, ...]] = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name not in jitted:
            nums = _donating_params(node, jitted, {}, offset=0)
            if nums:
                helper_fns[node.name] = nums
    helper_methods: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs = attr_donate.get(cls.name, {})
        meths: Dict[str, Tuple[int, ...]] = {}
        for m in cls.body:
            if isinstance(m, ast.FunctionDef) and m.name not in jitted:
                nums = _donating_params(m, jitted, attrs, offset=1)
                if nums:
                    meths[m.name] = nums
        if meths:
            helper_methods[cls.name] = meths
    return jitted, factories, attr_donate, helper_fns, helper_methods


class _FnFlow:
    """Abstract interpretation of one function body: taint = donated,
    Load of tainted = finding, rebind = kill."""

    def __init__(
        self, rule_id, ctx, jitted, factories, attrs,
        helper_fns=None, helper_methods=None,
    ):
        self.rule_id = rule_id
        self.ctx = ctx
        self.jitted = dict(jitted)  # name -> argnums (grows with locals)
        self.factories = factories
        self.attrs = attrs  # self attr -> argnums
        # one-level interprocedural summaries (helper name -> caller-
        # side donated arg indices); see _donating_params
        self.helper_fns = helper_fns or {}
        self.helper_methods = helper_methods or {}
        self.taint: Dict[_TaintKey, _Taint] = {}
        self.findings: List[Finding] = []
        self._seen = set()

    # -- findings -----------------------------------------------------------

    def _flag(self, node: ast.AST, key: _TaintKey, t: _Taint) -> None:
        var = key[1] if key[0] == "n" else f"self.{key[1]}"
        at = (node.lineno, node.col_offset, var)
        if at in self._seen:
            return
        self._seen.add(at)
        self.findings.append(
            Finding(
                rule=self.rule_id,
                path=self.ctx.relpath,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"'{var}' is read after being donated to {t.callee} "
                    "(donate_argnums) — donated buffers are dead after "
                    "dispatch; rebind from the call's results instead"
                ),
                severity="error",
            )
        )

    # -- expression evaluation (reads) --------------------------------------

    def eval(self, node: Optional[ast.AST]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Name):
            t = self.taint.get(("n", node.id))
            if t is not None:
                self._flag(node, ("n", node.id), t)
            return
        if isinstance(node, ast.Attribute):
            a = self_attr(node)
            if a is not None:
                t = self.taint.get(("a", a))
                if t is not None:
                    self._flag(node, ("a", a), t)
                return
            self.eval(node.value)
            return
        if isinstance(node, ast.Call):
            self._eval_call(node)
            return
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # other-time code; reads inside are out of scope
        for child in ast.iter_child_nodes(node):
            self.eval(child)

    def _callee_argnums(self, call: ast.Call) -> Tuple[Optional[Tuple[int, ...]], str]:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in self.jitted:
                return self.jitted[f.id], f.id
            if f.id in self.helper_fns:
                return self.helper_fns[f.id], f.id
            return None, ""
        a = self_attr(f)
        if a is not None:
            if a in self.attrs:
                return self.attrs[a], f"self.{a}"
            if a in self.helper_methods:
                return self.helper_methods[a], f"self.{a}"
        return None, ""

    def _eval_call(self, call: ast.Call) -> None:
        nums, callee = self._callee_argnums(call)
        self.eval(call.func)
        for arg in call.args:
            self.eval(arg)
        for kw in call.keywords:
            self.eval(kw.value)
        if not nums:
            return
        # positional donation only; a *args splat makes positions
        # unknowable, so skip tainting rather than mis-indexing
        if any(isinstance(a, ast.Starred) for a in call.args):
            return
        for i in nums:
            if i >= len(call.args):
                continue
            a = call.args[i]
            key: Optional[_TaintKey] = None
            if isinstance(a, ast.Name):
                key = ("n", a.id)
            else:
                sa = self_attr(a)
                if sa is not None:
                    key = ("a", sa)
                elif isinstance(a, ast.Subscript):
                    if isinstance(a.value, ast.Name):
                        key = ("n", a.value.id)
                    else:
                        sb = self_attr(a.value)
                        if sb is not None:
                            key = ("a", sb)
            if key is not None:
                self.taint[key] = _Taint(call.lineno, callee)

    # -- statement interpretation ------------------------------------------

    def _kill_target(self, t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            self.taint.pop(("n", t.id), None)
            return
        a = self_attr(t)
        if a is not None:
            self.taint.pop(("a", a), None)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._kill_target(e)
            return
        if isinstance(t, ast.Starred):
            self._kill_target(t.value)
            return
        if isinstance(t, ast.Subscript):
            self.eval(t.value)  # container write = read of the base
            self.eval(t.slice)

    def _maybe_local_jit(self, stmt: ast.Assign) -> None:
        """Track `f = jax.jit(g, donate_argnums=...)` and
        `prog = _factory(...)` local bindings."""
        v = stmt.value
        if not isinstance(v, ast.Call):
            return
        nums = None
        if is_jit_call(v):
            nums = jit_call_argnums(v, "donate_argnums")
        else:
            callee = dotted(v.func)
            if callee in self.factories:
                nums = self.factories[callee]
        if not nums:
            return
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                self.jitted[t.id] = nums

    def exec_body(self, body) -> None:
        for stmt in body:
            self.exec_stmt(stmt)

    def _merged(self, *states: Dict[_TaintKey, _Taint]) -> Dict[_TaintKey, _Taint]:
        out: Dict[_TaintKey, _Taint] = {}
        for s in states:
            out.update(s)
        return out

    def exec_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            self.eval(stmt.value)
            for t in stmt.targets:
                self._kill_target(t)
            self._maybe_local_jit(stmt)
        elif isinstance(stmt, ast.AnnAssign):
            self.eval(stmt.value)
            if stmt.value is not None:
                self._kill_target(stmt.target)
        elif isinstance(stmt, ast.AugAssign):
            self.eval(stmt.value)
            self.eval(stmt.target)  # x += 1 reads x
            self._kill_target(stmt.target)
        elif isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
        elif isinstance(stmt, ast.Return):
            self.eval(stmt.value)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._kill_target(t)
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            pre = dict(self.taint)
            self.exec_body(stmt.body)
            after_if = self.taint
            self.taint = dict(pre)
            self.exec_body(stmt.orelse)
            self.taint = self._merged(after_if, self.taint)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.eval(stmt.iter)
            for _ in range(2):  # second pass catches carry-around reads
                self._kill_target(stmt.target)
                self.exec_body(stmt.body)
            self.exec_body(stmt.orelse)
        elif isinstance(stmt, ast.While):
            for _ in range(2):
                self.eval(stmt.test)
                self.exec_body(stmt.body)
            self.exec_body(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self._kill_target(item.optional_vars)
            self.exec_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            pre = dict(self.taint)
            self.exec_body(stmt.body)
            post = dict(self.taint)
            for h in stmt.handlers:
                self.taint = self._merged(pre, post)
                self.exec_body(h.body)
            self.taint = self._merged(post, self.taint)
            self.exec_body(stmt.orelse)
            self.exec_body(stmt.finalbody)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                self.eval(child)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            pass  # nested scopes are analyzed on their own
        # Pass/Break/Continue/Import/Global: nothing to do


class DonationSafetyRule(Rule):
    id = "donation-safety"
    description = (
        "read of a variable after it was passed at a donate_argnums "
        "position of a jitted call (stale donated buffer)"
    )

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        (
            jitted, factories, attr_donate, helper_fns, helper_methods,
        ) = _module_donation_maps(ctx.tree)
        findings: List[Finding] = []

        def analyze(fn: ast.FunctionDef, attrs, meths) -> None:
            flow = _FnFlow(
                self.id, ctx, jitted, factories, attrs, helper_fns, meths
            )
            flow.exec_body(fn.body)
            findings.extend(flow.findings)

        for node in ctx.tree.body:
            if isinstance(node, ast.FunctionDef):
                analyze(node, {}, {})
                for sub in ast.walk(node):
                    if isinstance(sub, ast.FunctionDef) and sub is not node:
                        analyze(sub, {}, {})
            elif isinstance(node, ast.ClassDef):
                attrs = attr_donate.get(node.name, {})
                meths = helper_methods.get(node.name, {})
                for m in node.body:
                    if isinstance(m, ast.FunctionDef):
                        analyze(m, attrs, meths)
                        for sub in ast.walk(m):
                            if isinstance(sub, ast.FunctionDef) and sub is not m:
                                analyze(sub, attrs, meths)
        return findings


register(DonationSafetyRule())
