"""Shared loss reducers — the port of ``edl_tpu/models/losses.py``.

``row_mean`` is the one rule for averaging per-row losses against the
elastic runtime's real-row weights: at the ragged tail of a dataset a
worker pads its batch or replays its previous batch to keep shapes
aligned across peers, and those filler rows arrive with
``batch["_w"] == 0`` so they contribute ZERO gradient. Without ``_w``
it is a plain mean.
"""

from __future__ import annotations

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
