"""BERT-class bidirectional encoder — the port of
``edl_tpu/models/bert.py``: masked-language-model pretraining.

The reference's construction and tree: stacked ``[L, ...]`` layer
leaves, bf16 activations over f32 params, bidirectional attention (no
mask), learned positional embeddings, pre-norm LayerNorm with bias, a
GELU MLP, and an MLM loss at the masked positions only. The stacked
layers run in a Python loop over the layer index where the reference
scans. Attention is plain PyTorch, as the reference's is plain XLA
(einsum + softmax, not Pallas).

The reference's rounding order, kept step for step in bf16:

- the scores ``q·k`` round to the activation dtype, and the division by
  ``sqrt(head_dim)`` (a NumPy scalar, which JAX promotes to f32) and the
  softmax run in f32; the probabilities round back before ``probs·v``;
- a layer's LayerNorm scale and shift are rounded to the activation
  dtype first, the final LayerNorm's are not;
- GELU is the tanh approximation (``jax.nn.gelu``'s default; torch's
  default is the erf form).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.models.meta import dataclass_from_meta, dataclass_meta
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)

MASK_TOKEN = 0  # convention: id 0 is [MASK]


@dataclass(frozen=True)
class BertConfig:
    vocab: int = 30522
    max_seq: int = 512
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16

    def to_meta(self) -> dict:
        """JSON-safe architecture record for export manifests (the one
        shared rule: models/meta.py)."""
        return dataclass_meta(self, "bert")

    @classmethod
    def from_meta(cls, meta: dict) -> "BertConfig":
        return dataclass_from_meta(cls, meta, "bert")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 256) -> "BertConfig":
        return cls(
            vocab=vocab,
            max_seq=64,
            d_model=64,
            n_layers=2,
            n_heads=4,
            d_ff=128,
            dtype=torch.float32,
        )


def init_params(generator: torch.Generator, cfg: BertConfig,
                device: DeviceLike = None) -> Dict:
    """Random f32 params with the reference's shapes and scales, drawn
    from ``generator`` in the reference's leaf order and placed on
    ``device`` (CUDA unless ``"cpu"`` is named)."""
    dev = resolve_device(device)
    d, h, hd, ff, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                       cfg.n_layers)

    def g(*shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    embed = g(cfg.vocab, d, scale=0.02)
    pos_embed = g(cfg.max_seq, d, scale=0.02)
    wqkv = g(L, d, 3 * h * hd, scale=d ** -0.5)
    wo = g(L, h * hd, d, scale=(h * hd) ** -0.5)
    w_up = g(L, d, ff, scale=d ** -0.5)
    w_down = g(L, ff, d, scale=ff ** -0.5)
    mlm_head = g(d, cfg.vocab, scale=d ** -0.5)
    return {
        "embed": embed,
        "pos_embed": pos_embed,
        "layers": {
            "ln1_g": ones(L, d), "ln1_b": zeros(L, d),
            "wqkv": wqkv, "wo": wo,
            "ln2_g": ones(L, d), "ln2_b": zeros(L, d),
            "w_up": w_up, "b_up": zeros(L, ff),
            "w_down": w_down, "b_down": zeros(L, d),
        },
        "ln_f_g": ones(d),
        "ln_f_b": zeros(d),
        "mlm_head": mlm_head,
    }


def param_pspecs(cfg: BertConfig, plan) -> Dict:
    """The reference's TP x FSDP specs need a mesh, which is not ported
    yet: a plan that shards anything raises. On one device every leaf
    is whole (``None``), in a tree that mirrors :func:`init_params`'."""
    require_unsharded(plan, None, "bert.param_pspecs")
    layers = ("ln1_g", "ln1_b", "wqkv", "wo", "ln2_g", "ln2_b", "w_up",
              "b_up", "w_down", "b_down")
    return {"embed": None, "pos_embed": None,
            "layers": {k: None for k in layers},
            "ln_f_g": None, "ln_f_b": None, "mlm_head": None}


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """f32 LayerNorm (population variance); ``g``/``b`` enter at their
    own values (f32 x bf16 promotes to f32 in the reference)."""
    y = F.layer_norm(x.float(), x.shape[-1:], g.float(), b.float(), eps)
    return y.to(x.dtype)


def _layer(cfg: BertConfig, x: torch.Tensor, lp: Dict) -> torch.Tensor:
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    a = _layernorm(x, lp["ln1_g"].to(dt), lp["ln1_b"].to(dt), cfg.norm_eps)
    qkv = (a @ lp["wqkv"].to(dt)).reshape(b, t, 3, h, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, h * hd)
    x = x + o @ lp["wo"].to(dt)
    m = _layernorm(x, lp["ln2_g"].to(dt), lp["ln2_b"].to(dt), cfg.norm_eps)
    up = F.gelu(m @ lp["w_up"].to(dt) + lp["b_up"].to(dt), approximate="tanh")
    return x + (up @ lp["w_down"].to(dt) + lp["b_down"].to(dt))


def forward(params: Dict, tokens: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """tokens [B, T] int → logits [B, T, vocab] (f32; pre-norm encoder)."""
    t = tokens.shape[1]
    x = (params["embed"][tokens] + params["pos_embed"][None, :t]).to(cfg.dtype)
    layers = params["layers"]
    for i in range(layers["wqkv"].shape[0]):
        x = _layer(cfg, x, {k: v[i] for k, v in layers.items()})
    x = _layernorm(x, params["ln_f_g"], params["ln_f_b"], cfg.norm_eps)
    return (x @ params["mlm_head"].to(cfg.dtype)).float()


def make_loss_fn(cfg: BertConfig):
    """MLM cross entropy at the masked positions.

    batch = {tokens [B,T] (with MASK_TOKEN holes), targets [B,T]
    (original ids), mask [B,T] float (1 at masked positions)}, plus the
    runtime's optional real-row weights ``_w`` [B], which scale each
    row's mask (padded or replayed rows contribute zero)."""

    def loss_fn(params, batch):
        logits = forward(params, batch["tokens"], cfg)
        b, t, v = logits.shape
        ce = F.cross_entropy(logits.reshape(b * t, v),
                             batch["targets"].reshape(b * t).long(),
                             reduction="none").reshape(b, t)
        mask = batch["mask"].float()
        w = batch.get("_w")
        if w is not None:
            mask = mask * torch.as_tensor(w, device=mask.device).float()[:, None]
        return (ce * mask).sum() / mask.sum().clamp_min(1.0)

    return loss_fn


def train_flops_per_token(cfg: BertConfig, seq: int) -> float:
    """Model FLOPs a trained token (forward + backward): 6 x the matmul
    params (``wqkv``, ``wo``, ``w_up``, ``w_down`` of every layer and
    ``mlm_head``; embeddings excluded) plus bidirectional attention, 12
    x L x T x d (the scores and ``probs·v``, each 2 x T x d a token
    forward, times 3)."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    matmul_params = L * (4 * d * d + 2 * d * ff) + d * cfg.vocab
    return 6.0 * matmul_params + 12.0 * L * seq * d


def synthetic_mlm_batch(
    rng: np.random.RandomState, batch: int, seq: int, vocab: int,
    mask_prob: float = 0.15,
) -> Dict[str, np.ndarray]:
    """Position-structured token stream (token id cycles with position)
    so MLM loss is quickly learnable, with ``mask_prob`` of positions
    replaced by MASK_TOKEN (the reference's draws)."""
    pos = np.arange(seq, dtype=np.int32)[None, :]
    targets = np.broadcast_to((pos % (vocab - 1)) + 1, (batch, seq))
    mask = rng.rand(batch, seq) < mask_prob
    tokens = np.where(mask, MASK_TOKEN, targets).astype(np.int32)
    return {
        "tokens": tokens,
        "targets": targets.astype(np.int32),
        "mask": mask.astype(np.float32),
    }
