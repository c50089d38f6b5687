"""Mixture-of-Experts layer — the port of ``edl_tpu/parallel/moe.py``:
top-k token routing with a capacity per expert, one card.

The reference writes the dispatch and the combine as dense one-hot
einsums over an ``[N, k, E, C]`` tensor, the form that lets XLA lower
them to all-to-all collectives once the experts are sharded. On one card
that form costs ``2·N·E·C·D`` FLOPs and an ``[N, E, C]`` tensor a layer
for what is a gather (at N 8192, E 8, C 2560: 344 GFLOP and 336 MB in
bf16). The port computes the same function by indices: each kept
(token, choice) pair gets the slot ``e·C + s`` of its expert's queue,
the expert inputs ``[E, C, D]`` are scattered into those slots, the
experts run as batched products, and each pair's output is gathered
back and summed over its k choices.

Where the reference's code decides, the port follows it:

- **Priority.** Pair ``n·k + j`` (token n's j-th choice) is queued in
  that order, so a token's choices are interleaved in token order (the
  comment at ``edl_tpu/parallel/moe.py:80``, "k-th choices after", does
  not describe the code).
- **Ties.** ``jax.lax.top_k`` gives the lower expert index first on
  ties; ``torch.topk`` promises no order, so the choice is a stable
  descending sort. Ties are common: the router's product runs in the
  activation dtype.
- **Drops.** A pair whose slot is C or past it is dropped (a zero
  one-hot row in the reference). The combine weights of the kept pairs
  are still renormalised over all k choices.
- **Determinism.** Every scatter has unique indices, so each element
  of its output is written by one source and its backward is a gather:
  the dispatch writes kept pairs into their slots and each dropped pair
  into a row of its own past the ``E·C`` slots, which is cut off; the
  combine gathers each pair's row (a dropped pair's is a zero row past
  the slots) and sums the k choices in a fixed order over an
  ``[N, k, D]`` view. No ``index_add_``/``scatter_add_`` onto shared
  elements, whose CUDA atomics would vary run to run.

The expert FFN is ReLU (``relu(x @ w_in) @ w_out``), not SwiGLU. With
``int8_mxu`` its two products run through
:func:`~edl_tpu_torch.ops.int8_matmul.int8_batched_matmul` on the f32
masters; the routing stays in full precision.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from edl_tpu_torch.ops.int8_matmul import int8_batched_matmul
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> Dict:
    """Random router and expert weights with the reference's shapes and
    scales, drawn from ``generator`` in the reference's order and placed
    on ``device`` (CUDA unless ``"cpu"`` is named)."""
    dev = resolve_device(device)

    def normal(*shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(device=dev, dtype=dtype)

    return {
        "router": normal(d_model, n_experts, scale=0.02),
        "w_in": normal(n_experts, d_model, d_ff,
                       scale=math.sqrt(2.0 / d_model)),
        "w_out": normal(n_experts, d_ff, d_model,
                        scale=math.sqrt(1.0 / d_ff)),
    }


def moe_pspecs(plan) -> Dict:
    """The reference shards the experts over ``ep`` (and their inner
    width over ``tp``); that needs a mesh, which is not ported yet, so a
    plan that shards anything raises. On one device every leaf is whole
    (``None``)."""
    require_unsharded(plan, None, "moe_pspecs")
    return {"router": None, "w_in": None, "w_out": None}


def capacity(n_tokens: int, k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots an expert: ``ceil(capacity_factor · k · N / E)``, the
    reference's rule, so the function depends on how many tokens one
    call routes."""
    return int(math.ceil(capacity_factor * k * n_tokens / n_experts))


def route(probs: torch.Tensor, k: int, cap: int):
    """Top-k routing of ``probs`` [N, E] (f32) with ``cap`` slots an
    expert → (choice probs [N, k], experts [N, k], slots [N, k], kept
    [N, k] bool). Choices are ordered by probability, the lower expert
    first on ties; pair ``n·k + j`` takes the next free slot of its
    expert in that order, and is kept while its slot is below ``cap``."""
    n, e = probs.shape
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    # [E, N·k], pairs in order along the inner dim: a scan along the
    # outer dim of [N·k, E] took 3 ms a call on an H100 (E columns)
    onehot = F.one_hot(idx.reshape(-1), e).t().contiguous()
    slot = ((onehot.cumsum(1) - onehot) * onehot).sum(0).view(n, k)
    return top, idx, slot, slot < cap


def moe_ffn(
    params: Dict,
    x: torch.Tensor,
    k: int = 2,
    capacity_factor: float = 1.25,
    int8_mxu: bool = False,
    int8_wgrad_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN. x [B, T, D] → (y [B, T, D], aux).

    ``aux`` is the load-balance loss (mean assignment of the first
    choices · mean router probability · E), f32. ``int8_mxu`` runs the
    two expert products on the int8 path, ``int8_wgrad_bf16`` keeps
    their wgrad in bf16 (``LlamaConfig.int8_wgrad_bf16``'s contract)."""
    b, t, d = x.shape
    n = b * t
    e = params["router"].shape[-1]
    cap = capacity(n, k, capacity_factor, e)

    flat = x.reshape(n, d)
    logits = flat @ params["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    top, idx, slot, keep = route(probs, k, cap)

    # every pair's row: its slot, or a row of its own past the E·C slots
    pairs = torch.arange(n * k, device=x.device).view(n, k)
    dest = torch.where(keep, idx * cap + slot, e * cap + pairs).reshape(-1)
    rows = flat.unsqueeze(1).expand(n, k, d).reshape(n * k, d)
    expert_in = flat.new_zeros(e * cap + n * k, d).index_copy(
        0, dest, rows)[:e * cap].view(e, cap, d)

    if int8_mxu:
        h = torch.relu(int8_batched_matmul(expert_in, params["w_in"],
                                           int8_wgrad_bf16))
        expert_out = int8_batched_matmul(h, params["w_out"], int8_wgrad_bf16)
    else:
        h = torch.relu(torch.bmm(expert_in, params["w_in"]))
        expert_out = torch.bmm(h, params["w_out"])

    # renormalised over all k choices, kept or not; a dropped pair
    # gathers a zero row
    weights = (top / top.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype)
    padded = torch.cat([expert_out.reshape(e * cap, d),
                        expert_out.new_zeros(n * k, d)])
    out = padded[dest].view(n, k, d)
    y = (weights.unsqueeze(-1).float() * out.float()).sum(1).to(x.dtype)

    assign_frac = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = (assign_frac * probs.mean(0)).sum() * e
    return y.view(b, t, d), aux
