"""Ulysses sequence parallelism — the port of ``edl_tpu/parallel/
ulysses.py``: the sequence-sharded q/k/v of the ``sp`` axis are
exchanged with one all-to-all each (``collectives.all_to_all``) so every
rank holds the WHOLE sequence for ``H / sp`` of the heads, attends it
with any single-device attention, and a second all-to-all gives the
output its sequence sharding back.

The local attention follows the reference's two branches: on the card,
for bf16 at a length the flash kernels take (``flash_supported``), the
port's flash op (``ops/flash_attention.attention_auto``: the Hopper
kernels, the TPU branch's counterpart); otherwise the plain f32
attention (``ring_attention.reference_attention``), which the CPU tests
compare. GQA: K/V are exchanged at KV-head width when the KV-head
count divides the axis, and expanded to the query heads first
otherwise; k and v share one exchange. Differentiable: the backward of
each all-to-all is the inverse exchange.
"""

from __future__ import annotations

import torch

from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.parallel.ring_attention import reference_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sp", causal: bool = True
                      ) -> torch.Tensor:
    """Attention over this rank's sequence shards q [B, S/sp, H, d] and
    k, v [B, S/sp, KV, d] (S the global length; H must divide by the
    ``axis`` size). Returns this rank's [B, S/sp, H, d] of the output."""
    group = mesh.group(axis)
    n = group.size
    if q.shape[2] % n:
        raise ValueError(f"n_heads={q.shape[2]} not divisible by {axis}={n}")
    kv_heads = k.shape[2]
    if kv_heads % n and q.shape[2] != kv_heads:
        rep = q.shape[2] // kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out_dtype = q.dtype
    # [B, S/n, H, d] --all-to-all--> [B, S, H/n, d], in the activations'
    # dtype (the f32 upcast comes after the exchange)
    q = coll.all_to_all(q, 2, 1, group)
    kv = coll.all_to_all(torch.stack([k, v]), 3, 2, group)
    k, v = kv[0], kv[1]
    s_global = q.shape[1]
    from edl_tpu_torch.ops.flash_attention import (attention_auto,
                                                   flash_supported)

    if (q.is_cuda and q.dtype == torch.bfloat16
            and flash_supported(s_global)):
        o = attention_auto(q, k, v, causal=causal)
    else:
        if k.shape[2] != q.shape[2]:  # expand the GQA groups
            k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
            v = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)
        o = reference_attention(q.float(), k.float(), v.float(),
                                causal=causal).to(out_dtype)
    # [B, S, H/n, d] --all-to-all--> [B, S/n, H, d]
    return coll.all_to_all(o, 1, 2, group)
