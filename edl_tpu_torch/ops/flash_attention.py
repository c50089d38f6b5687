"""Flash attention, forward and backward — the port of
``edl_tpu/ops/flash_attention.py``.

On CUDA tensors the op runs the hand-written Hopper kernels (bf16, head
dim 64 or 128) or raises:

- ``csrc/flash_fwd.cu`` ``flash_fwd_bf16``: the primal forward (the
  reference's ``_flash``, ``with_lse=False``), taken whenever no input
  needs a gradient — every serving prefill;
- ``csrc/flash_fwd.cu`` ``flash_fwd_lse_bf16``: the forward that also
  writes the base-2 logsumexp (``_flash_fwd``, ``with_lse=True``),
  taken when an input needs a gradient;
- ``csrc/flash_bwd.cu`` ``flash_bwd_dq_bf16`` / ``flash_bwd_dkv_bf16``:
  the dQ and dK/dV sweeps (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).

The training pair is two registered operators, the counterpart of the
reference's ``custom_vjp``: ``torch.ops.edl_tpu_torch.flash_fwd``
(``(out, lse)``) and ``torch.ops.edl_tpu_torch.flash_bwd`` (``(dq, dk,
dv)``), tied by ``register_autograd``. A selective-checkpoint policy
names the forward op to keep its outputs (``models/llama.py``'s
``"attn"`` remat policy).

On CPU tensors every one of them is its plain PyTorch version
(:func:`flash_attention_ref`, :func:`flash_attention_lse_ref`,
:func:`flash_attention_bwd_ref`), blockwise with the reference kernels'
arithmetic. There is no fallback from one to the other.

Public layout as in the reference: q [B, T, H, d], k/v [B, T, KV, d]
with H % KV == 0 (GQA, K/V never repeated); lse is compact f32
[B, H, T] (= [B·H, T]). ``_fit_block`` and :func:`flash_supported` are
the reference's, so the port takes the kernels on exactly the sequence
lengths the reference does.

Launch counters (plain integers, reset by callers that want to prove a
path went through a kernel): ``launches`` (the primal forward),
``lse_launches``, ``dq_launches``, ``dkv_launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

NEG_INF = -1e30
# base-2 softmax: log2(e) is folded into the score scale, so every
# exponential is a bare exp2 (the reference kernel's convention)
LOG2E = math.log2(math.e)

# kernel launches since import (or since a caller reset them)
launches = 0
lse_launches = 0
dq_launches = 0
dkv_launches = 0

KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
_COUNTERS = dict(zip(KERNELS, ("launches", "lse_launches", "dq_launches",
                               "dkv_launches")))

_HEAD_DIMS = (64, 128)
_fns: Dict[str, object] = {}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel, by the names in :data:`KERNELS`."""
    return {name: globals()[var] for name, var in _COUNTERS.items()}


def reset_launches() -> None:
    for var in _COUNTERS.values():
        globals()[var] = 0


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


def _blocks(t: int, block_q: int, block_k: int) -> Tuple[int, int]:
    bq, bk = _fit_block(block_q, t), _fit_block(block_k, t)
    if t % bq or t % bk:
        raise ValueError(f"seq len {t} must divide block sizes ({bq},{bk})")
    return bq, bk


def _grouped(x: torch.Tensor, hk: int) -> torch.Tensor:
    """[B, T, H, d] → [B, KV, G, T, d]: query head h = kv·G + g reads
    KV head h // G."""
    b, t, h, d = x.shape
    return x.reshape(b, t, hk, h // hk, d).permute(0, 2, 3, 1, 4)


def _causal_keep(qs, bq, ks, bk, device):
    rows = torch.arange(qs, qs + bq, device=device)[:, None]
    cols = torch.arange(ks, ks + bk, device=device)[None, :]
    return rows >= cols


def _fwd_ref(q, k, v, causal, block_q, block_k):
    """(out [B, T, H, d], lse [B, H, T] f32) — see
    :func:`flash_attention_lse_ref`."""
    b, t, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    bq, bk = _blocks(t, block_q, block_k)
    scale = (1.0 / math.sqrt(d)) * LOG2E
    qg = _grouped(q, hk).float()
    kf = k.permute(0, 2, 1, 3).float()  # [B, KV, T, d]
    vt = v.permute(0, 2, 1, 3)
    out = torch.empty(b, hk, g, t, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hk, g, t, dtype=torch.float32, device=q.device)
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
                s = torch.where(_causal_keep(qs, bq, ks, bk, q.device), s,
                                NEG_INF)
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
        l = l.clamp_min(1e-20)
        out[:, :, :, qs:qs + bq] = (acc / l).to(q.dtype)
        lse[:, :, :, qs:qs + bq] = (m + torch.log2(l))[..., 0]
    return (out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d),
            lse.reshape(b, h, t))


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
    return _fwd_ref(q, k, v, causal, block_q, block_k)[0]


def flash_attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` plus the per-row base-2 logsumexp
    ``lse = m + log2(max(l, 1e-20))`` (the reference's ``with_lse``
    output, read compact): ``(out [B, T, H, d], lse [B, H, T] f32)``."""
    return _fwd_ref(q, k, v, causal, block_q, block_k)


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO · O) in f32, [B, H, T] — computed outside the
    kernels, as ``_flash_bwd`` computes it in XLA."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch blockwise backward with the reference kernels'
    arithmetic → ``(dq, dk, dv)``, from ``lse`` [B, H, T] (base 2) and
    the upstream gradient ``do``. Per block pair, skipped above the
    diagonal with the forward's predicate: ``p = exp2(s·sm_scale·LOG2E
    − lse)`` masked AFTER the exp2; ``dp = dO·Vᵀ``; ``ds = p·(dp −
    delta)·sm_scale`` (plain ``sm_scale``); ``dq += ds_q·K``, ``dv +=
    p_dOᵀ·dO``, ``dk += ds_qᵀ·Q``, where ``ds_q``/``p_dO`` are rounded to
    q's / dO's dtype, all sums in f32. dq is cast to q's dtype; dk/dv
    are summed over each KV head's query heads in f32, then cast."""
    b, t, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    bq, bk = _blocks(t, block_q, block_k)
    sm_scale = 1.0 / math.sqrt(d)
    scale = sm_scale * LOG2E
    qg, dog = _grouped(q, hk), _grouped(do, hk)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # [B, KV, T, d]
    lse_g = lse.reshape(b, hk, g, t)
    delta = _delta(out, do).reshape(b, hk, g, t)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(b, hk, g, t, d, **f32)
    dk = torch.zeros(b, hk, g, t, d, **f32)  # per query head, then summed
    dv = torch.zeros(b, hk, g, t, d, **f32)
    for qs in range(0, t, bq):
        qb, dob = qg[:, :, :, qs:qs + bq], dog[:, :, :, qs:qs + bq]
        lse_b = lse_g[:, :, :, qs:qs + bq, None]
        delta_b = delta[:, :, :, qs:qs + bq, None]
        for ks in range(0, t, bk):
            if causal and ks > qs + bq - 1:
                break
            kb, vb = kt[:, :, ks:ks + bk], vt[:, :, ks:ks + bk]
            s = torch.einsum("bkgqd,bksd->bkgqs", qb.float(), kb.float())
            p = torch.exp2(s * scale - lse_b)
            if causal and ks + bk - 1 > qs:
                p = torch.where(_causal_keep(qs, bq, ks, bk, q.device), p,
                                0.0)
            dp = torch.einsum("bkgqd,bksd->bkgqs", dob.float(), vb.float())
            ds = p * (dp - delta_b) * sm_scale
            dq[:, :, :, qs:qs + bq] += torch.einsum(
                "bkgqs,bksd->bkgqd", ds.to(k.dtype).float(), kb.float())
            dv[:, :, :, ks:ks + bk] += torch.einsum(
                "bkgqs,bkgqd->bkgsd", p.to(do.dtype).float(), dob.float())
            dk[:, :, :, ks:ks + bk] += torch.einsum(
                "bkgqs,bkgqd->bkgsd", ds.to(q.dtype).float(), qb.float())
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)
    dk = dk.sum(dim=2).permute(0, 2, 1, 3).to(k.dtype)
    dv = dv.sum(dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


# -- the CUDA kernels ----------------------------------------------------------

_PTR, _INT, _LL, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_SIGNATURES = {
    # name: (library, argtypes)
    "flash_fwd_bf16": ("flash_fwd", [_PTR] * 4 + [_INT] * 5 + [_LL] * 12
                       + [_F32, _INT, _PTR]),
    "flash_fwd_lse_bf16": ("flash_fwd", [_PTR] * 5 + [_INT] * 5 + [_LL] * 12
                           + [_F32, _INT, _PTR]),
    "flash_bwd_dq_bf16": ("flash_bwd", [_PTR] * 7 + [_INT] * 5
                          + [_PTR, _F32, _F32, _INT, _PTR]),
    "flash_bwd_dkv_bf16": ("flash_bwd", [_PTR] * 8 + [_INT] * 5
                           + [_PTR, _F32, _F32, _INT, _PTR]),
}


def _kernel(entry: str = "flash_fwd_bf16"):
    """The built and bound C entry point ``entry`` (built at first use)."""
    fn = _fns.get(entry)
    if fn is None:
        from edl_tpu_torch.ops import _build

        lib, argtypes = _SIGNATURES[entry]
        fn = getattr(_build.load(lib), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[entry] = fn
    return fn


def _check_cuda_operands(q, k, v, *more) -> None:
    named = (("q", q), ("k", k), ("v", v)) + tuple(
        (f"operand {i}", x) for i, x in enumerate(more, 3))
    for name, x in named:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the CUDA kernel takes bfloat16, "
                             f"got {x.dtype}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"{name}: need a 4-D tensor with a "
                             f"contiguous last dimension")
        # the kernels' TMA tensor maps: every row start must be 16-byte
        # aligned
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            raise ValueError(f"{name}: rows must be 16-byte aligned "
                             f"(strides {x.stride()})")
    d = q.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for x in more:
        if x.shape != q.shape:
            raise ValueError(f"shape mismatch q {tuple(q.shape)} "
                             f"vs {tuple(x.shape)}")


def _strides(*xs):
    return [s for x in xs for s in x.stride()[:3]]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _fwd_cuda(q, k, v, causal: bool, with_lse: bool):
    _check_cuda_operands(q, k, v)
    b, t, h, d = q.shape
    hk = k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty(b, h, t, dtype=torch.float32, device=q.device)
           if with_lse else None)
    entry = "flash_fwd_lse_bf16" if with_lse else "flash_fwd_bf16"
    fn = _kernel(entry)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, b, t, h, hk, d, *_strides(q, k, v, out),
                (1.0 / math.sqrt(d)) * LOG2E, int(bool(causal)),
                _stream(q.device))
    _raise_on(rc, entry)
    return out, lse


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Launch ``csrc/flash_fwd.cu`` ``flash_fwd_bf16`` on the current
    stream (no sync, no allocation inside the kernel); raises on operands
    it does not take or on a refused launch. The kernel tiles 128 x 128
    (TMA-fed wgmma, one persistent CTA an SM) and masks a ragged T edge
    itself."""
    global launches
    out, _ = _fwd_cuda(q, k, v, causal, with_lse=False)
    launches += 1
    return out


def flash_attention_lse_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_fwd_lse_bf16`` → ``(out, lse [B, H, T] f32)``."""
    global lse_launches
    out, lse = _fwd_cuda(q, k, v, causal, with_lse=True)
    lse_launches += 1
    return out, lse


def _check_rows(x: torch.Tensor, q: torch.Tensor, name: str) -> None:
    b, t, h, _ = q.shape
    if (x.shape != (b, h, t) or x.dtype != torch.float32
            or not x.is_contiguous() or x.device != q.device):
        raise ValueError(f"{name} must be contiguous f32 {(b, h, t)} on "
                         f"{q.device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _bwd_launch(entry, q, k, v, do, lse, delta, outs, causal):
    _check_cuda_operands(q, k, v, do)
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")
    b, t, h, d = q.shape
    st = _strides(q, k, v, do, *outs)
    sm_scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        rc = _kernel(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, t, h, k.shape[2], d, (_LL * len(st))(*st), sm_scale * LOG2E,
            sm_scale, int(bool(causal)), _stream(q.device))
    _raise_on(rc, entry)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """Launch ``flash_bwd_dq_bf16`` → dq in q's dtype (bf16)."""
    global dq_launches
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _bwd_launch("flash_bwd_dq_bf16", q, k, v, do, lse, delta, [dq], causal)
    dq_launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """Launch ``flash_bwd_dkv_bf16`` → (dk, dv) in k/v's dtype, already
    summed over each KV head's query heads inside the kernel."""
    global dkv_launches
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_launch("flash_bwd_dkv_bf16", q, k, v, do, lse, delta, [dk, dv],
                causal)
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """delta = rowsum(dO·O) in f32 (torch), then the dQ and dK/dV
    kernels on the current stream → ``(dq, dk, dv)`` in q/k/v's dtype."""
    _check_cuda_operands(q, k, v, out, do)
    delta = _delta(out, do).contiguous()
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


# -- the differentiable op -----------------------------------------------------


def _device_kind(q: torch.Tensor) -> str:
    if q.is_cuda:
        return "cuda"
    if q.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no flash attention path for device {q.device}")


# The training op as two registered operators in the port's namespace,
# so that the dispatcher, and every mode on it, sees the flash forward
# as one op: a selective-checkpoint policy can name and cache
# ``flash_fwd`` (the reference's ``flash_out`` / ``flash_lse``
# residuals, ``edl_tpu/ops/flash_attention.py:375-376``), and a fake or
# meta tensor gets its shapes from ``register_fake`` without a launch.


@torch.library.custom_op(
    "edl_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int block_q, "
           "int block_k) -> (Tensor, Tensor)")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, block_q: int,
                  block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_flash_fwd``: ``(out [B, T, H, d], lse [B, H,
    T] f32)``. CUDA tensors launch ``flash_fwd_lse_bf16``, CPU tensors
    run :func:`flash_attention_lse_ref` on the same blocks."""
    if _device_kind(q) == "cuda":
        return flash_attention_lse_cuda(q, k, v, causal)
    return flash_attention_lse_ref(q, k, v, causal, block_q, block_k)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, block_q, block_k):
    b, t, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, t), dtype=torch.float32))


@torch.library.custom_op(
    "edl_tpu_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor do, bool causal, int block_q, int block_k) "
           "-> (Tensor, Tensor, Tensor)")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, block_q: int, block_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_flash_bwd``: ``(dq, dk, dv)`` from the
    forward's residuals. CUDA tensors launch the dQ and dK/dV sweeps,
    CPU tensors run :func:`flash_attention_bwd_ref`."""
    if _device_kind(q) == "cuda":
        return flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)
    return flash_attention_bwd_ref(q, k, v, out, lse, do, causal, block_q,
                                   block_k)


@_flash_bwd_op.register_fake
def _(q, k, v, out, lse, do, causal, block_q, block_k):
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, block_q, block_k = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.blocks = causal, (block_q, block_k)
    # lse is a residual, as in the reference's custom_vjp: no gradient
    # flows into it, and none is materialized for it
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _flash_backward(ctx, do, _dlse):
    if do is None:
        return None, None, None, None, None, None
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, out, lse, do.contiguous(),
                               ctx.causal, *ctx.blocks)
    return dq, dk, dv, None, None, None


_flash_fwd_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """q [B, T, H, d], k/v [B, T, KV, d] → [B, T, H, d]. T must divide
    the (clamped) block sizes, as in the reference. Differentiable: when
    grad is on and an input needs it, the forward is the registered op
    ``edl_tpu_torch::flash_fwd`` (the lse forward; its autograd runs
    ``edl_tpu_torch::flash_bwd``, the backward sweeps); otherwise
    it is the primal forward. CUDA tensors go to the Hopper kernels, CPU
    tensors to the plain versions."""
    h, hk = q.shape[2], k.shape[2]
    if h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    t = q.shape[1]
    if not flash_supported(t, block_q, block_k):
        raise ValueError(
            f"seq len {t} must divide block sizes "
            f"({_fit_block(block_q, t)},{_fit_block(block_k, t)})"
        )
    kind = _device_kind(q)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _flash_fwd_op(q, k, v, causal, block_q, block_k)[0]
    if kind == "cuda":
        return flash_attention_cuda(q, k, v, causal)
    return flash_attention_ref(q, k, v, causal, block_q, block_k)


def attention_auto(q, k, v, causal: bool = True):
    """flash_attention with the reference's sequence-length-tuned block
    sizes ((1024, 1024) from T=4096 up, else (512, 1024)); the blocks
    shape the CPU path and the dispatch predicate, the CUDA kernels tile
    on their own."""
    t = q.shape[1]
    bq, bk = (1024, 1024) if t >= 4096 else (512, 1024)
    return flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
