"""Blockwise int8 quantization — the port of ``edl_tpu/ops/quant.py``,
the optimizer-moment compression of the staged reshard.

Blocks are the LAST axis of each leaf (row-wise for matrices): a row's
scale is its absmax / 127, so a value moves by at most 1/254 of its
row's absmax through a quantize / dequantize round trip; scale tensors
are ``shape[:-1]`` f32. ``torch.round`` rounds half to even, as
``jnp.round`` does, so q and the scales equal the reference's bit for
bit. The reference caches one jit program per cast and target sharding
in ``cast_to`` and ``quantize_on_device``; eager PyTorch needs no cache,
so their counterparts are the plain calls ``t.to(dtype)`` and
:func:`quantize_int8` where ``t`` lives (``runtime/checkpoint.py``'s
``staged_reshard``). :func:`dequantize_to` dequantizes on the target
device.
"""

from __future__ import annotations

import torch

from edl_tpu_torch.utils.device import DeviceLike, resolve_device


def quantize_int8(x: torch.Tensor):
    """x f32 [..., D] -> (q int8 [..., D], scale f32 [...])."""
    m = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(m > 0, m / 127.0, 1.0)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def dequantize_int8(q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * s[..., None].to(dtype)


def dequantize_to(q: torch.Tensor, s: torch.Tensor, device: DeviceLike = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize on ``device`` (CUDA unless ``"cpu"`` is named): q and
    the scales move first, so the f32 result is made where it stays."""
    dev = resolve_device(device)
    return dequantize_int8(q.to(dev), s.to(dev), dtype)
