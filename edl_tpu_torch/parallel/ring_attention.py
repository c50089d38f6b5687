"""Ring attention — the port of ``edl_tpu/parallel/ring_attention.py``:
sequence (context) parallelism over the ``sp`` axis of a mesh of
processes (``parallel/mesh.Mesh``).

Each rank holds its ``[B, T / sp, H, d]`` shard of q, k and v. Over
``sp`` steps every rank attends its queries to the K/V block it holds,
then passes that block to its ring neighbour (``collectives.ppermute``),
so after the last step it has seen every block; the softmax is merged
online (running max and sum, :func:`_merge`), so the full score matrix
never exists. The carry is f32, as the reference's (a bf16 carry drifts
over the steps). K/V travel at KV-head width and are expanded to the
query heads only inside the block (:func:`_block_attn`), and k and v
ride one exchange a step.

As in the reference, the blocks are plain tensor products, not a
kernel. Under the causal mask a block from a ring source after this
rank's is empty; the port skips its products (merging an empty block
changes nothing, bit for bit) but still passes it on. The first
(diagonal) block starts the carry: the reference's merge of it into an
empty carry is the block itself, bit for bit.

Differentiable: the backward of each exchange sends the K/V gradients
back around the ring. Every rank must run every exchange's backward, in
the ring's order, so a block this rank skipped still enters the output
with weight zero (its exchange then has a gradient, zero, to pass on).
Under a remat that re-runs the forward in the backward, every rank must
also re-run every exchange: ``models/llama`` turns the checkpoint's
early stop off for the sp layers.
"""

from __future__ import annotations

import math

import torch

from edl_tpu_torch.parallel import collectives as coll


def _block_attn(q, k, v, scale, mask):
    """One blockwise score pass. q [B,t,H,d]; k,v [B,s,KV,d] with H =
    KV·groups; mask [t,s] bool (True = attend) or None (all). Returns
    (o_unnorm [B,t,H,d], m [B,t,H] block max, l [B,t,H] block sum)."""
    h, kv = q.shape[2], k.shape[2]
    if h != kv:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)  # [B,H,t]
    # guard fully-masked rows (none in the blocks computed here)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)  # [B,H,t]
    o = torch.einsum("bhts,bshd->bthd", p, v)
    return o, m.transpose(1, 2), l.transpose(1, 2)


def _merge(o1, m1, l1, o2, m2, l2):
    """Combine two online-softmax partial results."""
    m = torch.maximum(m1, m2)

    def safe(mm):
        return torch.where(torch.isfinite(mm), mm, torch.zeros_like(mm))

    a1 = torch.exp(safe(m1) - safe(m))
    a1 = torch.where(torch.isfinite(m1), a1, torch.zeros_like(a1))
    a2 = torch.exp(safe(m2) - safe(m))
    a2 = torch.where(torch.isfinite(m2), a2, torch.zeros_like(a2))
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return o, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "sp", causal: bool = True
                   ) -> torch.Tensor:
    """Global attention over sequence-sharded q [B, T/sp, H, d] and k, v
    [B, T/sp, KV, d] (this rank's shards, in ring order along T).
    Returns this rank's [B, T/sp, H, d] of the output, in q's dtype.
    The batch dim may be a dp/fsdp shard; only ``axis`` communicates."""
    group = mesh.group(axis)
    n, my = group.size, group.rank
    scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    t = q.shape[1]
    diag = (torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    kv = torch.stack([k, v])  # k and v travel the ring together
    perm = [(j, (j + 1) % n) for j in range(n)]
    o = m = l = None
    skipped = []
    for i in range(n):
        src = (my - i) % n  # the block held now came from ring rank src
        if causal and src > my:  # an empty block adds nothing
            skipped.append(kv)
        else:
            bo, bm, bl = _block_attn(q, kv[0], kv[1], scale,
                                     diag if src == my else None)
            if o is None:
                o, m, l = bo, bm, bl
            else:
                o, m, l = _merge(o, m, l, bo, bm, bl)
        if i < n - 1:
            kv = coll.ppermute(kv, perm, group)
    out = o / l.clamp_min(1e-20)[..., None]
    for x in skipped:  # weight zero: the gradient's way back round the ring
        out = out + x.sum() * 0.0
    return out.to(out_dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Unsharded attention, the correctness oracle for the ring (q, k, v
    [B, T, H, d], the same head count)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v)
