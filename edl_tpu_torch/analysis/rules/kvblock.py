"""kv-block — freed-block-id-reused-while-table-references-it hazard.

The paged KV cache (serving/paged.py + the engine's ``_pg_*`` methods)
indirects every device read/write through per-slot block tables. A
physical block id freed back to the allocator WILL be handed to the
next allocation — so a table entry that still names it afterwards is
the paged twin of a stale donated buffer: the next prefill rewrites
that block and the stale slot silently decodes over another request's
KV rows.

The checkable convention (engine.py follows it in ``_pg_free_slot``
and ``_pg_make_writable``): **any function that frees a block id it
read out of a block table must also rewrite a table entry in that
same function body** — free + table-clear are one bookkeeping step,
never split across helpers where a crash between them (or a caller
forgetting the second half) leaves the dangling reference.

Mechanics, all name-convention based (the analyzer is stdlib-ast and
cannot see types):

* a *table* is any Name or ``self`` attribute whose name contains
  ``table`` or ``tbl`` — plus local aliases bound by subscripting one
  (``tbl = self._tables[i]``);
* a *table-derived id* is a name assigned from a table subscript
  (``bid = tbl[j]``) or bound by iterating a table
  (``for j, bid in enumerate(tbl)``);
* a *free* is a call ``X.free(name)`` whose receiver name contains
  ``alloc``;
* a *table store* is any subscript assignment whose base is a table.

Frees of ids that never came from a table (the prefix cache dropping
its own map entries, refcount-only releases) are not flagged — the
hazard is specifically a table losing its backing block.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from edl_tpu_torch.analysis.core import Finding, ModuleCtx, Rule, register
from edl_tpu_torch.analysis.rules._util import self_attr


def _is_tablish(name: Optional[str]) -> bool:
    if not name:
        return False
    low = name.lower()
    return "table" in low or "tbl" in low


def _base_name(node: ast.AST) -> Optional[str]:
    """The addressable name of a subscript base / call receiver:
    a bare Name or a ``self.X`` attribute."""
    if isinstance(node, ast.Name):
        return node.id
    return self_attr(node)


class _FnScan:
    """One pass over a function body (nested defs excluded — they are
    scanned as their own functions)."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        # names known to alias a block table
        self.tables: Set[str] = set()
        # names known to hold a block id read out of a table
        self.table_ids: Set[str] = set()
        self.has_table_store = False
        self.frees: List[ast.Call] = []  # X.free(<table-derived name>)
        self._walk_body(fn.body)

    def _walk_body(self, body) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value)
            for t in stmt.targets:
                self._bind(t, stmt.value)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter)
            if self._iterates_table(stmt.iter):
                for name in self._target_names(stmt.target):
                    self.table_ids.add(name)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        # generic recursion: statements walk, expressions scan
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._walk_stmt(child)
            elif isinstance(child, ast.expr):
                self._scan_expr(child)
            elif isinstance(child, ast.excepthandler):
                self._walk_body(child.body)

    # -- binding ------------------------------------------------------------

    def _target_names(self, t: ast.AST) -> List[str]:
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, (ast.Tuple, ast.List)):
            out: List[str] = []
            for e in t.elts:
                out.extend(self._target_names(e))
            return out
        if isinstance(t, ast.Starred):
            return self._target_names(t.value)
        return []

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Subscript):
            if _is_tablish(_base_name(target.value)) or (
                isinstance(target.value, ast.Name)
                and target.value.id in self.tables
            ):
                self.has_table_store = True
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, value)  # conservative: same RHS class
            return
        if not isinstance(target, ast.Name):
            return
        if isinstance(value, ast.Subscript):
            base = _base_name(value.value)
            from_table = _is_tablish(base) or (
                isinstance(value.value, ast.Name)
                and value.value.id in self.tables
            )
            if from_table:
                # `tbl = self._tables[i]` → table alias; `bid = tbl[j]`
                # → block id. Disambiguate by the BASE: subscripting a
                # plural `*tables*` container yields a table row,
                # subscripting a single table yields a block id.
                if base is not None and "tables" in base.lower():
                    self.tables.add(target.id)
                else:
                    self.table_ids.add(target.id)
        elif isinstance(value, ast.Name) and (
            value.id in self.tables or _is_tablish(value.id)
        ):
            self.tables.add(target.id)

    def _iterates_table(self, it: ast.AST) -> bool:
        """True for ``for ... in tbl`` / ``enumerate(tbl)``."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "enumerate" and it.args:
            it = it.args[0]
        name = _base_name(it)
        return _is_tablish(name) or (
            isinstance(it, ast.Name) and it.id in self.tables
        )

    # -- reads --------------------------------------------------------------

    def _scan_expr(self, e: Optional[ast.AST]) -> None:
        if e is None or isinstance(e, ast.Lambda):
            return
        if isinstance(e, ast.Call):
            f = e.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "free"
                and "alloc" in (_base_name(f.value) or "").lower()
                and len(e.args) == 1
                and isinstance(e.args[0], ast.Name)
                and e.args[0].id in self.table_ids
            ):
                self.frees.append(e)
            for child in ast.iter_child_nodes(e):
                self._scan_expr(child)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._scan_expr(child)


class KVBlockRule(Rule):
    id = "kv-block"
    description = (
        "a block id read from a KV block table is freed without any "
        "table entry being rewritten in the same function (dangling "
        "table reference over a reallocatable block)"
    )

    def check_module(self, ctx: ModuleCtx) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            scan = _FnScan(node)
            if not scan.frees or scan.has_table_store:
                continue
            for call in scan.frees:
                bid = call.args[0].id  # type: ignore[union-attr]
                findings.append(
                    Finding(
                        rule=self.id,
                        path=ctx.relpath,
                        line=call.lineno,
                        col=call.col_offset,
                        message=(
                            f"block id '{bid}' read from a block table "
                            f"is freed in '{node.name}' but no table "
                            "entry is rewritten there — the table still "
                            "references a block the allocator can hand "
                            "out again; clear the entry in the same "
                            "bookkeeping step"
                        ),
                        severity="error",
                    )
                )
        return findings


register(KVBlockRule())
