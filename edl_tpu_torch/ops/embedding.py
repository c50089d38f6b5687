"""Embedding lookup — the port of ``edl_tpu/ops/embedding.py``.

``embedding_lookup(table, ids)`` is ``table[ids]`` with the reference's
semantics: out-of-range ids are clamped to [0, V-1] in BOTH directions
(a stray -1 padding sentinel reads and trains row 0, a too-large id the
last row), and the backward accumulates the table gradient in float32
and returns it in the table's dtype, so a bf16 table gets
``bf16(sum_f32(ct))`` as the reference's ``_plain_grad`` gives it.

The reference's fast backward, ``_blocked_grad`` (sort the ids, then
one-hot block matmuls over narrow vocab windows, with a ``lax.cond``
back to the scatter-add), is a workaround for the TPU's scatter engine,
which adds rows one at a time (~100 ns a row, ~50 ms for a Criteo batch
of 16384 x 26 ids). It is written in lax, not Pallas, and its contract
is exact equality with the plain f32 scatter-add. A GPU adds rows with
atomics at memory speed, so the port meets that contract with the
plain scatter-add itself: one f32 ``index_add_``. The reference's own
fast-path cases (``MIN_FAST_IDS`` lowered so they take
``_blocked_grad``) are held against this op in
``tests/test_torch_ctr.py``.

``sharded_embedding_lookup`` (the table split over a mesh axis) waits
for the mesh slice.
"""

from __future__ import annotations

import torch


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
        ctx.save_for_backward(flat)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        out = torch.index_select(table, 0, flat)
        return out.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (flat,) = ctx.saved_tensors
        grad = torch.zeros(ctx.vocab, ct.shape[-1], dtype=torch.float32,
                           device=ct.device)
        grad.index_add_(0, flat, ct.reshape(flat.shape[0], -1).float())
        return grad.to(ctx.dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: table [V, E]; ids integer of any shape; result
    [*ids.shape, E]. Ids clamp to [0, V-1] in both directions; the
    table's gradient is an f32 scatter-add cast to the table's dtype."""
    return _Lookup.apply(table, ids)


def sharded_embedding_lookup(table, ids, mesh, vocab_axis: str = "tp",
                             ids_pspec=None):
    """The vocab-sharded lookup of the reference; not ported yet."""
    raise NotImplementedError(
        "sharded_embedding_lookup is not ported yet (ROADMAP Queue A 2b): "
        "the port runs on one card; use embedding_lookup"
    )
