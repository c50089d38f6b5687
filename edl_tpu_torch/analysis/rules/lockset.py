"""lockset-race — Eraser-style lockset analysis over threaded classes.

Thread safety in this codebase is a hand-maintained convention: a
class spawns a ``threading.Thread``, shares ``self`` state with it,
and guards that state with ``with self._lock`` — or forgets to. This
rule makes the convention checkable.

Per class it determines:

* **lock attributes** — ``self.X = threading.Lock()/RLock()/
  Condition()`` (plus any ``self.*lock*`` attr bound in ``__init__``,
  covering locks passed in by the owner);
* **thread entry points** — methods or nested functions passed as
  ``Thread(target=...)``;
* **contexts** — the *thread* context is the self-call closure of the
  entry points; the *main* context is the closure of the non-entry
  public methods (the API another thread calls). A method reachable
  from both (``MetricsPusher.push_once``: the push loop AND ``stop``'s
  last-gasp push) counts in both.

Every ``self.X`` access is recorded with the set of class locks held
(``with self.L:`` scopes, intraprocedural). An attribute written
outside ``__init__`` is a **candidate race** when:

* (threaded class) it is accessed from both contexts and the
  intersection of the locksets over all its accesses is empty — no
  single lock protects it; or
* (any lock-owning class) its accesses are *mixed* — some guarded by
  a lock, some not. Mixed access is the classic "the author thought
  this needed the lock somewhere" signal (``_Conn.close`` racing
  ``fetch_batch`` was found exactly this way).

Convention: a method named ``*_locked`` is assumed called with the
lock already held (documented in doc/static-analysis.md) — its
accesses count as guarded. ``__init__`` accesses never count: the
object is not yet shared during construction.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from edl_tpu_torch.analysis.core import Finding, ModuleCtx, Rule, register
from edl_tpu_torch.analysis.rules._util import dotted, self_attr

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "Lock",
    "RLock",
    "Condition",
}
_THREAD_CTORS = {"threading.Thread", "Thread"}
# method calls that mutate the receiver container in place
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "popitem",
    "appendleft", "clear", "update", "setdefault", "add", "discard",
    "sort", "reverse", "put", "put_nowait",
}


@dataclass
class _Access:
    attr: str
    unit: str
    line: int
    col: int
    write: bool
    locks: FrozenSet[str]
    in_init: bool


@dataclass
class _Unit:
    """One analyzable code body: a method, or a nested function inside
    a method (named ``parent.<name>``)."""

    name: str
    node: ast.FunctionDef
    in_init: bool
    is_entry: bool = False
    calls: Set[str] = field(default_factory=set)  # self-method names
    accesses: List[_Access] = field(default_factory=list)
    # (callee method name, locks held at the call site) — drives the
    # one-level interprocedural context expansion in _check_class
    call_sites: List[Tuple[str, FrozenSet[str]]] = field(default_factory=list)


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for n in ast.walk(cls):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            if dotted(n.value.func) in _LOCK_CTORS:
                for t in n.targets:
                    a = self_attr(t)
                    if a:
                        locks.add(a)
    init = next(
        (m for m in cls.body if isinstance(m, ast.FunctionDef) and m.name == "__init__"),
        None,
    )
    if init is not None:
        for n in ast.walk(init):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    a = self_attr(t)
                    if a and ("lock" in a.lower() or "mutex" in a.lower()):
                        locks.add(a)
    return locks


def _thread_targets(fn: ast.FunctionDef) -> Tuple[bool, Set[str], Set[str]]:
    """(spawns_thread, self-method targets, local-function targets)
    over one method body."""
    spawns = False
    methods: Set[str] = set()
    locals_: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and dotted(n.func) in _THREAD_CTORS:
            spawns = True
            for kw in n.keywords:
                if kw.arg != "target":
                    continue
                a = self_attr(kw.value)
                if a:
                    methods.add(a)
                elif isinstance(kw.value, ast.Name):
                    locals_.add(kw.value.id)
    return spawns, methods, locals_


class _UnitWalker:
    """Collect self-attr accesses (with held locks) and self-calls in
    one unit body, without descending into nested defs."""

    def __init__(
        self,
        unit: _Unit,
        locks: Set[str],
        method_names: Set[str],
        def_locks: Optional[Dict[int, Tuple[str, ...]]] = None,
        inherited: Tuple[str, ...] = (),
    ):
        self.u = unit
        self.locks = locks
        self.methods = method_names
        # shared across the class's walkers: id(def node) -> locks held
        # at the def site, so nested units can inherit them
        self.def_locks = def_locks if def_locks is not None else {}
        self.held: Tuple[str, ...] = tuple(inherited)
        if unit.name.rsplit(".", 1)[-1].endswith("_locked"):
            # convention: *_locked methods run with the lock held
            self.held = self.held + ("<caller-held>",)

    def _record(self, attr: str, node: ast.AST, write: bool) -> None:
        if attr in self.locks:
            return
        self.u.accesses.append(
            _Access(
                attr=attr,
                unit=self.u.name,
                line=node.lineno,
                col=node.col_offset,
                write=write,
                locks=frozenset(self.held),
                in_init=self.u.in_init,
            )
        )

    def walk_body(self, body) -> None:
        for stmt in body:
            self.walk_stmt(stmt)

    def walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in stmt.items:
                a = self_attr(item.context_expr)
                if a and a in self.locks:
                    acquired.append(a)
                else:
                    self.walk_expr(item.context_expr)
            prev = self.held
            self.held = prev + tuple(acquired)
            self.walk_body(stmt.body)
            self.held = prev
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            # bare self.X.acquire()/release() statements (the
            # acquire-try/finally-release idiom, and RLock re-entry
            # outside a `with`) adjust the lockset linearly: the try
            # body is walked before the finally that releases, so the
            # guarded region comes out right
            f = stmt.value.func
            if isinstance(f, ast.Attribute) and f.attr in ("acquire", "release"):
                base = self_attr(f.value)
                if base is not None and base in self.locks:
                    if f.attr == "acquire":
                        self.held = self.held + (base,)
                    elif base in self.held:
                        i = len(self.held) - 1 - self.held[::-1].index(base)
                        self.held = self.held[:i] + self.held[i + 1:]
                    for a in stmt.value.args:
                        self.walk_expr(a)
                    return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            # nested units are walked separately; remember the lockset
            # at the def site so a closure created under `with self._L`
            # is analyzed as running under it (Thread targets excepted —
            # the new thread starts with nothing held)
            self.def_locks[id(stmt)] = self.held
            return
        if isinstance(stmt, ast.Assign):
            self.walk_expr(stmt.value)
            for t in stmt.targets:
                self.walk_target(t)
            return
        if isinstance(stmt, ast.AugAssign):
            self.walk_expr(stmt.value)
            a = self_attr(stmt.target)
            if a:
                self._record(a, stmt.target, write=True)
            else:
                self.walk_target(stmt.target)
            return
        if isinstance(stmt, ast.AnnAssign):
            self.walk_expr(stmt.value)
            if stmt.value is not None:
                self.walk_target(stmt.target)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self.walk_target(t)
            return
        # generic: walk child statements/expressions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self.walk_stmt(child)
            elif isinstance(child, ast.expr):
                self.walk_expr(child)
            elif isinstance(child, (ast.excepthandler,)):
                self.walk_body(child.body)

    def walk_target(self, t: ast.AST) -> None:
        a = self_attr(t)
        if a:
            self._record(a, t, write=True)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self.walk_target(e)
            return
        if isinstance(t, ast.Starred):
            self.walk_target(t.value)
            return
        if isinstance(t, ast.Subscript):
            a = self_attr(t.value)
            if a:
                self._record(a, t.value, write=True)  # self.d[k] = v
            else:
                self.walk_expr(t.value)
            self.walk_expr(t.slice)
            return
        if isinstance(t, ast.Name):
            return
        self.walk_expr(t)

    def walk_expr(self, e: Optional[ast.AST]) -> None:
        if e is None or isinstance(e, (ast.Lambda,)):
            return
        if isinstance(e, ast.Call):
            f = e.func
            if isinstance(f, ast.Attribute):
                base_attr = self_attr(f.value)
                if base_attr is not None:
                    # self.X.mutator(...) — an in-place write to X
                    self._record(
                        base_attr, f.value, write=f.attr in _MUTATORS
                    )
                elif (
                    isinstance(f.value, ast.Name) and f.value.id == "self"
                ):
                    # self.method(...): a call edge, not a data access
                    if f.attr in self.methods:
                        self.u.calls.add(f.attr)
                        self.u.call_sites.append(
                            (f.attr, frozenset(self.held))
                        )
                    else:
                        self._record(f.attr, f, write=False)
                else:
                    self.walk_expr(f.value)
            else:
                self.walk_expr(f)
            for a in e.args:
                self.walk_expr(a)
            for kw in e.keywords:
                self.walk_expr(kw.value)
            return
        a = self_attr(e)
        if a is not None:
            if a in self.methods:
                return  # bound-method reference (Thread target etc.)
            self._record(a, e, write=False)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self.walk_expr(child)


def _closure(seeds: Set[str], units: Dict[str, _Unit]) -> Set[str]:
    """Self-call closure over unit names (method names resolve to
    method units; nested units are addressed by qualified name)."""
    out = set()
    frontier = [s for s in seeds if s in units]
    while frontier:
        u = frontier.pop()
        if u in out:
            continue
        out.add(u)
        for callee in units[u].calls:
            if callee in units and callee not in out:
                frontier.append(callee)
    return out


class LocksetRaceRule(Rule):
    id = "lockset-race"
    description = (
        "attribute of a threaded class accessed both with and without "
        "its lock (candidate data race)"
    )

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(ctx, node))
        return findings

    def _check_class(self, ctx: ModuleCtx, cls: ast.ClassDef) -> List[Finding]:
        locks = _lock_attrs(cls)
        methods = [m for m in cls.body if isinstance(m, ast.FunctionDef)]
        method_names = {m.name for m in methods}

        units: Dict[str, _Unit] = {}
        spawns_thread = False
        entries: Set[str] = set()
        for m in methods:
            in_init = m.name == "__init__"
            units[m.name] = _Unit(m.name, m, in_init)
            sp, tgt_methods, tgt_locals = _thread_targets(m)
            spawns_thread = spawns_thread or sp
            entries.update(tgt_methods)
            # nested functions are their own units; a nested Thread
            # target is an entry
            for sub in ast.walk(m):
                if isinstance(sub, ast.FunctionDef) and sub is not m:
                    qname = f"{m.name}.{sub.name}"
                    units[qname] = _Unit(qname, sub, in_init)
                    if sub.name in tgt_locals:
                        entries.add(qname)

        if not spawns_thread and not locks:
            return []

        # methods first, nested defs after (stable sort keeps AST
        # pre-order within each group, so a nested def's lockset is
        # recorded before its own nested defs are walked)
        def_locks: Dict[int, Tuple[str, ...]] = {}
        for u in sorted(units.values(), key=lambda x: x.name.count(".")):
            inherited: Tuple[str, ...] = ()
            if "." in u.name and u.name not in entries:
                inherited = def_locks.get(id(u.node), ())
            _UnitWalker(u, locks, method_names, def_locks, inherited).walk_body(
                u.node.body
            )

        thread_units = _closure(entries, units)
        main_seeds = {
            u.name
            for u in units.values()
            if u.name not in entries
            and "." not in u.name  # nested fns aren't externally callable
            and not u.name.startswith("_")
        }
        main_units = _closure(main_seeds, units)

        # one-level interprocedural context: which locksets do callers
        # hold at each self.method() site?
        call_ctxs: Dict[str, Set[FrozenSet[str]]] = {}
        for u in units.values():
            for callee, held in u.call_sites:
                call_ctxs.setdefault(callee, set()).add(held)

        # group accesses by attribute, expanding each unit's accesses
        # over its calling contexts: a private helper invoked only
        # under `with self._lock` inherits that lock; public methods,
        # thread entries, nested closures, and methods with no visible
        # callers keep a bare (empty) context because an outside caller
        # can invoke them with nothing held
        by_attr: Dict[str, List[_Access]] = {}
        for u in units.values():
            ctxs: List[FrozenSet[str]] = []
            bare = (
                "." in u.name  # nested: def-site locks already applied
                or u.name in entries
                or not u.name.startswith("_")
                or u.name not in call_ctxs
            )
            if bare:
                ctxs.append(frozenset())
            for c in sorted(call_ctxs.get(u.name, ()), key=sorted):
                if c not in ctxs:
                    ctxs.append(c)
            seen: Set[Tuple] = set()
            for a in u.accesses:
                for c in ctxs:
                    lks = (a.locks | c) if c else a.locks
                    ident = (a.attr, a.line, a.col, a.write, lks)
                    if ident in seen:
                        continue
                    seen.add(ident)
                    exp = a if lks == a.locks else _Access(
                        attr=a.attr, unit=a.unit, line=a.line, col=a.col,
                        write=a.write, locks=lks, in_init=a.in_init,
                    )
                    by_attr.setdefault(a.attr, []).append(exp)

        findings: List[Finding] = []
        for attr, accesses in sorted(by_attr.items()):
            live = [a for a in accesses if not a.in_init]
            if not live or not any(a.write for a in live):
                continue  # read-only after construction: safe to share
            locksets = [a.locks for a in live]
            common = frozenset.intersection(*locksets)
            unguarded = sorted(
                (a for a in live if not a.locks), key=lambda a: (a.line, a.col)
            )
            ctxs = set()
            for a in live:
                if a.unit in thread_units:
                    ctxs.add("thread")
                if a.unit in main_units:
                    ctxs.add("main")
            if spawns_thread and {"thread", "main"} <= ctxs and not common:
                w = next(a for a in live if a.write)
                r = next((a for a in live if not a.write), w)
                site = unguarded[0] if unguarded else live[0]
                findings.append(
                    Finding(
                        rule=self.id,
                        path=ctx.relpath,
                        line=site.line,
                        col=site.col,
                        message=(
                            f"candidate race on '{cls.name}.{attr}': shared "
                            "between the thread and main contexts with no "
                            f"common lock (written in '{w.unit}', accessed "
                            f"in '{r.unit}')"
                        ),
                    )
                )
            elif locks and unguarded and any(a.locks for a in live):
                g = next(a for a in live if a.locks)
                lock = sorted(g.locks)[0]
                findings.append(
                    Finding(
                        rule=self.id,
                        path=ctx.relpath,
                        line=unguarded[0].line,
                        col=unguarded[0].col,
                        message=(
                            f"mixed locking on '{cls.name}.{attr}': guarded "
                            f"by 'self.{lock}' in '{g.unit}' but accessed "
                            f"without it in '{unguarded[0].unit}'"
                        ),
                    )
                )
        return findings


register(LocksetRaceRule())
