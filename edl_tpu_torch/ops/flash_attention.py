"""Flash attention forward — the port of ``edl_tpu/ops/flash_attention.py``
(the primal, no-gradient half).

On a CUDA tensor :func:`flash_attention` launches the hand-written
Hopper kernel ``csrc/flash_fwd.cu`` (bf16, head dim 64 or 128) or
raises; on a CPU tensor it runs :func:`flash_attention_ref`, the plain
PyTorch blockwise version with the reference kernel's arithmetic. There
is no fallback from one to the other.

Public layout as in the reference: q [B, T, H, d], k/v [B, T, KV, d]
with H % KV == 0 (GQA, K/V never repeated). ``_fit_block`` and
:func:`flash_supported` are the reference's, so the port takes the
kernel on exactly the sequence lengths the reference does.

``launches`` counts kernel launches (plain integer, reset by callers
that want to prove a path went through the kernel).
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
# base-2 softmax: log2(e) is folded into the score scale, so every
# exponential is a bare exp2 (the reference kernel's convention)
LOG2E = math.log2(math.e)

# kernel launches since import (or since a caller reset it)
launches = 0

_HEAD_DIMS = (64, 128)
_fn = None


def _fit_block(block: int, t: int) -> int:
    """Largest power-of-two block <= ``block`` that divides ``t`` (down
    to the 128 minimum) — a seq len divisible by 512 but not 1024
    (T=1536, 2560, ...) steps down instead of losing the kernel."""
    block = min(block, t)
    while block > 128 and t % block:
        block //= 2
    return block


def flash_supported(t: int, block_q: int = 512, block_k: int = 1024) -> bool:
    """True when :func:`flash_attention` accepts sequence length ``t``."""
    bq, bk = _fit_block(block_q, t), _fit_block(block_k, t)
    return t % bq == 0 and t % bk == 0


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch blockwise forward with the reference kernel's
    arithmetic: f32 scores scaled by ``sm_scale * LOG2E``, base-2 online
    softmax with f32 running max/sum/accumulator, kv blocks above the
    diagonal skipped, the mask built only on blocks crossing it, ``p``
    rounded to V's dtype before P·V, and a final division by
    ``max(l, 1e-20)``. Blocks are ``_fit_block``-clamped; T must divide
    them (check with :func:`flash_supported`)."""
    b, t, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    bq, bk = _fit_block(block_q, t), _fit_block(block_k, t)
    if t % bq or t % bk:
        raise ValueError(f"seq len {t} must divide block sizes ({bq},{bk})")
    scale = (1.0 / math.sqrt(d)) * LOG2E
    # [B, KV, G, T, d]: grouped query heads against un-repeated K/V
    qg = q.reshape(b, t, hk, g, d).permute(0, 2, 3, 1, 4).float()
    kf = k.permute(0, 2, 1, 3).float()  # [B, KV, T, d]
    vt = v.permute(0, 2, 1, 3)
    out = torch.empty(b, hk, g, t, d, dtype=q.dtype, device=q.device)
    for qs in range(0, t, bq):
        qb = qg[:, :, :, qs:qs + bq]
        m = torch.full((b, hk, g, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hk, g, bq, d, dtype=torch.float32,
                          device=q.device)
        for ks in range(0, t, bk):
            if causal and ks > qs + bq - 1:
                break  # above the diagonal: contributes nothing
            s = torch.einsum("bkgqd,bksd->bkgqs", qb, kf[:, :, ks:ks + bk])
            s = s * scale
            if causal and ks + bk - 1 > qs:
                rows = torch.arange(qs, qs + bq, device=q.device)[:, None]
                cols = torch.arange(ks, ks + bk, device=q.device)[None, :]
                s = torch.where(rows >= cols, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum(
                "bkgqs,bksd->bkgqd",
                p.to(v.dtype).float(), vt[:, :, ks:ks + bk].float(),
            )
            acc = acc * alpha + pv
            m = m_new
        out[:, :, :, qs:qs + bq] = (acc / l.clamp_min(1e-20)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


def _kernel():
    """The built and bound ``flash_fwd_bf16`` C entry point."""
    global _fn
    if _fn is None:
        from edl_tpu_torch.ops import _build

        fn = _build.load("flash_fwd").flash_fwd_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _check_cuda_operands(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the CUDA kernel takes bfloat16, "
                             f"got {x.dtype}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"{name}: need a 4-D tensor with a "
                             f"contiguous last dimension")
        # 16-byte vector loads: every row start must be 16-byte aligned
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(f"{name}: rows must be 16-byte aligned "
                             f"(strides {x.stride()})")
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Launch ``csrc/flash_fwd.cu`` on the current stream (no sync, no
    allocation inside the kernel); raises on operands it does not take
    or on a refused launch. The kernel tiles 64 x 64 and masks a ragged
    T edge itself."""
    global launches
    _check_cuda_operands(q, k, v)
    b, t, h, d = q.shape
    hk = k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, hk, d,
            *(q.stride(i) for i in range(3)),
            *(k.stride(i) for i in range(3)),
            *(v.stride(i) for i in range(3)),
            *(out.stride(i) for i in range(3)),
            (1.0 / math.sqrt(d)) * LOG2E, int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """q [B, T, H, d], k/v [B, T, KV, d] → [B, T, H, d]. T must divide
    the (clamped) block sizes, as in the reference. CUDA tensors go to
    the Hopper kernel, CPU tensors to :func:`flash_attention_ref`."""
    h, hk = q.shape[2], k.shape[2]
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    t = q.shape[1]
    if not flash_supported(t, block_q, block_k):
        raise ValueError(
            f"seq len {t} must divide block sizes "
            f"({_fit_block(block_q, t)},{_fit_block(block_k, t)})"
        )
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, block_q, block_k)
    raise ValueError(f"no flash attention path for device {q.device}")


def attention_auto(q, k, v, causal: bool = True):
    """flash_attention with the reference's sequence-length-tuned block
    sizes ((1024, 1024) from T=4096 up, else (512, 1024)); the blocks
    shape the CPU path and the dispatch predicate, the CUDA kernel tiles
    on its own."""
    t = q.shape[1]
    bq, bk = (1024, 1024) if t >= 4096 else (512, 1024)
    return flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
