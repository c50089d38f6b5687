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
    return _replace(tree, iter(new))


def _replace(node, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``it``, and with it every new leaf, until the garbage
    # collector ran
    if isinstance(node, torch.Tensor):
        return next(it)
    if isinstance(node, dict):
        return {k: _replace(node[k], it) for k in node}
    if isinstance(node, (list, tuple)):
        return [_replace(v, it) for v in node]
    return node
