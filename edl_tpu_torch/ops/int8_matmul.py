"""Dynamic int8 matmul — the port of ``edl_tpu/ops/int8_matmul.py``, the
training matmuls on the int8 x int8 -> int32 tensor-core path.

The recipe is the reference's, op for op:

- **symmetric dynamic absmax scales per contraction slice**: each
  operand is quantized along the contraction axis of the product it
  feeds (row-wise for the activations, column-wise for the weights), so
  the scales factor out of the dot and the int32 accumulator is exact
  for the quantized values. The error per element is at most
  slicemax/254.
- **all three training products** run int8: the forward ``a @ w``, and
  in the backward dgrad ``g @ wᵀ`` (scales along N: per row of ``w``)
  and wgrad ``aᵀ @ g`` (scales along M), each with fresh scales.
- **straight-through estimator**: the gradients are those of the exact
  product; the quantizer's staircase is ignored.
- ``wgrad_bf16`` keeps wgrad off the int8 path: bf16-rounded operands,
  an f32 product and result (the reference's
  ``preferred_element_type=f32``). It needs exact f32 products, so on a
  card it raises while TF32 matmuls are allowed.

The int8 product is ``torch._int_mm`` on both devices: cuBLASLt's int8
GEMM on a card, which takes M > 16 and K, N multiples of 8 only and
raises on other shapes (nothing falls back to bf16). The scales
multiply in the reference's order, ``y_i32.float() * (sa * sw)``.

The op is registered, ``torch.ops.edl_tpu_torch.int8_matmul`` (custom_op
+ register_autograd + register_fake), so a selective-checkpoint policy
sees one op and can save its output; its int32 and f32 intermediates
live inside it and are never saved. ``calls`` counts the op's forward
and backward calls (plain integers; reset by callers that want to prove
a path went through it).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# forward and backward calls of the registered op since import (or reset)
calls: Dict[str, int] = {"fwd": 0, "bwd": 0}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def absmax_quant(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Symmetric int8 quantization of ``x`` along ``axis``: q int8 and
    s f32 (keepdim, broadcastable against x), x ~= q * s with |error|
    <= absmax/254 per element. All-zero slices take scale 1 (q = 0).
    ``torch.round`` rounds half to even as ``jnp.round`` does, so q and
    s equal the reference's bit for bit."""
    # max |x| in one pass, exact in x's own dtype; the quotient x / s
    # reads x and computes in f32, as the reference's f32 cast does
    m = torch.linalg.vector_norm(x, math.inf, dim=axis, keepdim=True).float()
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which misses the quotient's last bit
    s = torch.where(m > 0, m / torch.full_like(m, 127.0), 1.0)
    v = x / s
    q = v.round_().clamp_(-127, 127).to(torch.int8)
    return q, s


def _dot8(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]. Both operands should
    hold K innermost (``qa`` row-major, ``qb`` the transpose of a
    row-major [N, K]): cuBLASLt's int8 GEMM is that layout's, and on an
    H100 a row-major ``qb`` took 5x its time. That GEMM takes M > 16
    and K, N multiples of 8 only: on a card other shapes raise."""
    return torch._int_mm(qa, qb)


def _k_inner(q: torch.Tensor) -> torch.Tensor:
    """A row-major [K, N] int8 operand as the transpose of a row-major
    [N, K] copy (one int8 pass)."""
    return q.t().contiguous().t()


def _scaled(y: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor):
    """``y.float() * (sa * sb)``: the scale product, multiplied in place
    by the int32 accumulator (read as f32)."""
    return (sa * sb).mul_(y)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized ``a @ w`` for a [..., K] activation and a [K, N] weight,
    in ``a.dtype``."""
    shape = a.shape
    a2 = a.reshape(-1, shape[-1])
    qa, sa = absmax_quant(a2, 1)  # per activation row
    qw, sw = absmax_quant(w, 0)  # per weight column
    y = _scaled(_dot8(qa, _k_inner(qw)), sa, sw)
    return y.to(a.dtype).reshape(*shape[:-1], w.shape[-1])


def _dgrad(g2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g @ wᵀ``, contracting N: fresh scales along N for both."""
    qg, sg = absmax_quant(g2, 1)  # [M, 1]
    qwn, swn = absmax_quant(w, 1)  # [K, 1], per weight row
    return _scaled(_dot8(qg, qwn.t()), sg, swn.t())


def _wgrad(a2: torch.Tensor, g2: torch.Tensor,
           wgrad_bf16: bool) -> torch.Tensor:
    """``aᵀ @ g``, contracting M: int8 with fresh scales along M, or
    (``wgrad_bf16``) bf16-rounded operands with an f32 product."""
    if wgrad_bf16:
        if a2.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "int8_matmul(wgrad_bf16=True) needs f32 products: set "
                "torch.backends.cuda.matmul.allow_tf32 = False")
        return a2.bfloat16().float().t() @ g2.bfloat16().float()
    qam, sam = absmax_quant(a2, 0)  # [1, K]
    qgm, sgm = absmax_quant(g2, 0)  # [1, N]
    return _scaled(_dot8(qam.t().contiguous(), _k_inner(qgm)), sam.t(),
                   sgm)


@torch.library.custom_op(
    "edl_tpu_torch::int8_matmul", mutates_args=(),
    schema="(Tensor a, Tensor w, bool wgrad_bf16) -> Tensor")
def _int8_matmul_op(a: torch.Tensor, w: torch.Tensor,
                    wgrad_bf16: bool) -> torch.Tensor:
    calls["fwd"] += 1
    return _mm(a, w)


@_int8_matmul_op.register_fake
def _(a, w, wgrad_bf16):
    return a.new_empty((*a.shape[:-1], w.shape[-1]))


def _setup_context(ctx, inputs, output):
    a, w, wgrad_bf16 = inputs
    # the raw operands, as a dense product's autograd saves them
    ctx.save_for_backward(a, w)
    ctx.wgrad_bf16 = wgrad_bf16


def _backward(ctx, g):
    calls["bwd"] += 1
    a, w = ctx.saved_tensors
    a2 = a.reshape(-1, a.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    da = dw = None
    if ctx.needs_input_grad[0]:
        da = _dgrad(g2, w).to(a.dtype).reshape(a.shape)
    if ctx.needs_input_grad[1]:
        dw = _wgrad(a2, g2, ctx.wgrad_bf16).to(w.dtype)
    return da, dw, None


_int8_matmul_op.register_autograd(_backward, setup_context=_setup_context)


def int8_matmul(a: torch.Tensor, w: torch.Tensor,
                wgrad_bf16: bool = False) -> torch.Tensor:
    """``a @ w`` on the int8 path with STE gradients: a [..., K]
    activations, w [K, N] weights; returns [..., N] in ``a.dtype``. The
    weight is quantized as it is given (the f32 master in training, no
    bf16 pre-cast); dw comes back in ``w.dtype``."""
    return _int8_matmul_op(a, w, wgrad_bf16)


def int8_batched_matmul(a: torch.Tensor, w: torch.Tensor,
                        wgrad_bf16: bool = False) -> torch.Tensor:
    """[E, C, K] x [E, K, N] on the int8 path: the reference's vmap of
    :func:`int8_matmul`, as one op per E slice (the same per-slice
    scales and gradients)."""
    return torch.stack([int8_matmul(a[e], w[e], wgrad_bf16)
                        for e in range(a.shape[0])])
