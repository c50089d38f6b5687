"""Shared AST helpers for the project rules."""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence, Set, Tuple

JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.pjit"}
PARTIAL_NAMES = {"partial", "functools.partial"}


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def literal_int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
    """Resolve a donate/static argnums literal: int, or tuple/list of
    ints. Anything computed returns None (the rule then skips the
    site rather than guessing)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.append(e.value)
            else:
                return None
        return tuple(out)
    return None


def jit_call_argnums(call: ast.Call, kw: str) -> Optional[Tuple[int, ...]]:
    """``donate_argnums``/``static_argnums`` of a ``jax.jit(...)`` or
    ``partial(jax.jit, ...)`` call, if literal."""
    for k in call.keywords:
        if k.arg == kw:
            return literal_int_tuple(k.value)
    return None


def is_jit_call(call: ast.Call) -> bool:
    name = dotted(call.func)
    if name in JIT_NAMES:
        return True
    # partial(jax.jit, ...)
    if name in PARTIAL_NAMES and call.args:
        return dotted(call.args[0]) in JIT_NAMES
    return False


def decorator_donate_argnums(fn: ast.FunctionDef) -> Optional[Tuple[int, ...]]:
    """donate_argnums from ``@partial(jax.jit, donate_argnums=...)`` /
    ``@jax.jit(donate_argnums=...)`` decorators; None when absent or
    unresolvable."""
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call) and is_jit_call(dec):
            nums = jit_call_argnums(dec, "donate_argnums")
            if nums:
                return nums
    return None


def decorator_is_jitted(fn: ast.FunctionDef) -> bool:
    """True if the function is jitted by decoration, with or without
    options (``@jax.jit`` bare, or ``@partial(jax.jit, ...)``)."""
    for dec in fn.decorator_list:
        if dotted(dec) in JIT_NAMES:
            return True
        if isinstance(dec, ast.Call) and is_jit_call(dec):
            return True
    return False


def walk_no_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested def/lambda
    (their bodies run at another time, under other rules)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(n))


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def call_names(body: Sequence[ast.stmt]) -> Set[str]:
    """Names of all functions called anywhere under the statements."""
    out: Set[str] = set()
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                d = dotted(n.func)
                if d:
                    out.add(d)
    return out
