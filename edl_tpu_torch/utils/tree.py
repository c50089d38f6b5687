"""Nested dict/list trees of tensors — what ``jax.tree_util`` gives the
reference: the leaves in key order, and the same tree with new leaves."""

from __future__ import annotations

from typing import List, Sequence

import torch


def leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a nested dict/list tree, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return []


def replace_leaves(tree, new: Sequence[torch.Tensor]):
    """``tree`` with its tensor leaves (in :func:`leaves` order) replaced
    by ``new``."""
    it = iter(new)

    def rec(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in node}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return node

    return rec(tree)
