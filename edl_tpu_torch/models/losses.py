"""Shared loss reducers — the port of ``edl_tpu/models/losses.py``.

``row_mean`` is the one rule for averaging per-row losses against the
elastic runtime's real-row weights: at the ragged tail of a dataset a
worker pads its batch or replays its previous batch to keep shapes
aligned across peers, and those filler rows arrive with
``batch["_w"] == 0`` so they contribute ZERO gradient. Without ``_w``
it is a plain mean.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def row_mean(per_row: torch.Tensor, batch) -> torch.Tensor:
    """Weighted mean of a [B] per-row loss by ``batch["_w"]`` (float
    [B], 1 = real row, 0 = padding/replay), or the plain mean when no
    weights ride the batch. An all-zero weight vector yields loss 0 and
    zero gradients: a harmless no-op step instead of 0/0 NaNs."""
    w = batch.get("_w")
    if w is None:
        return per_row.mean()
    w = torch.as_tensor(w, device=per_row.device).to(per_row.dtype)
    return (per_row * w).sum() / w.sum().clamp_min(1.0)


def sequence_part_mean(ce: torch.Tensor, t_all: int) -> torch.Tensor:
    """This rank's part [B] of each row's mean over the sequence, from
    the per-position losses ``ce`` [B, T / sp] of its positions: their
    sum over the GLOBAL length ``t_all``. The parts of a row's sp ranks
    sum to the row's mean, and :func:`row_mean` is linear in its rows,
    so the ranks' losses (and gradients) sum over sp to the whole
    sequence's (the trainer's sharded step does that sum)."""
    return ce.sum(dim=-1) / t_all


def batch_weight(batch, weight_fn: Optional[Callable[[Any], Any]] = None
                 ) -> torch.Tensor:
    """The denominator a process contributes to :func:`row_mean` over a
    batch split across processes: Σ ``_w``, or the row count without
    weights; ``weight_fn(batch)`` overrides it for a loss that
    normalizes by something else (BERT's masked positions). The data-
    parallel step all-reduces it (train/trainer.py ``_mesh_update``)."""
    if weight_fn is not None:
        return torch.as_tensor(weight_fn(batch)).float()
    w = batch.get("_w")
    if w is None:
        first = next(iter(batch.values()))
        return torch.tensor(float(first.shape[0]))
    return torch.as_tensor(w).float().sum()


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, start, group):
        from edl_tpu_torch.parallel import collectives as coll

        n, v = logits.shape
        m = logits.detach().amax(dim=-1)
        coll.all_reduce(m, group, "max")
        e = torch.exp(logits - m[:, None])
        s = e.sum(dim=-1)
        coll.all_reduce(s, group)
        loc = targets - start
        mine = (loc >= 0) & (loc < v)
        idx = torch.where(mine, loc, torch.zeros_like(loc))
        tl = torch.where(mine, logits.gather(1, idx[:, None])[:, 0],
                         torch.zeros((), dtype=logits.dtype,
                                     device=logits.device))
        coll.all_reduce(tl, group)
        e /= s[:, None]
        ctx.save_for_backward(e, idx, mine)
        return torch.log(s) + m - tl

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p * g[:, None]
        grad.scatter_add_(1, idx[:, None],
                          torch.where(mine, -g, torch.zeros_like(g))[:, None])
        return grad, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor,
                      start: int = 0, group=None) -> torch.Tensor:
    """Per-row cross entropy ``logsumexp − target logit`` [N] of f32
    logits [N, V_local] whose columns are vocab ids ``start ..`` of a
    vocab split over ``group`` (a ``collectives.Group``; None: the whole
    vocab is here). Over a group the max, the exp-sum and the target
    logit are all-reduced, so every rank gets the whole rows' losses, and
    the backward gives each rank its own columns' gradient."""
    if group is None or group.trivial:
        return torch.nn.functional.cross_entropy(logits, targets,
                                                 reduction="none")
    return _VocabParallelCE.apply(logits, targets, start, group)
