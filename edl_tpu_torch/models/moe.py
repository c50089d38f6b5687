"""Mixture-of-Experts transformer — the port of ``edl_tpu/models/moe.py``:
a Llama-style decoder whose SwiGLU FFN is a top-k routed expert FFN
(:func:`edl_tpu_torch.parallel.moe.moe_ffn`), on one card.

Attention, RoPE, RMSNorm and the flash op are llama's
(``models/llama.py``): ``use_flash`` reaches the registered flash op
through :meth:`MoEConfig._llama_view`. The load-balance loss is added to
the training loss with coefficient ``aux_coef``. Params are the
reference's scan-stacked tree: per-layer leaves [L, ...], expert weights
[L, E, ...]; training holds them as f32 masters and casts at each use,
as the reference does. The expert dimension's ``ep`` sharding needs a
mesh axis the port's mesh does not run yet (ROADMAP Queue A item 2e).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch.models import llama as _ll
from edl_tpu_torch.models.losses import row_mean
from edl_tpu_torch.models.meta import dataclass_from_meta, dataclass_meta
from edl_tpu_torch.parallel.moe import moe_ffn
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)

# shared synthetic data: the loss-curve contract is the same
synthetic_tokens = _ll.synthetic_tokens


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab: int = 32768
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 2816  # per-expert hidden
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    use_flash: bool = False
    # checkpoint each layer whole (non-reentrant) and recompute it in
    # the backward; training-only
    remat: bool = False
    # the attention projections and the expert products on the int8
    # path (ops/int8_matmul.py), LlamaConfig.int8_mxu's contract;
    # training-only: never rides to_meta
    int8_mxu: bool = False
    # with int8_mxu: their wgrad on bf16-rounded operands, f32 products
    int8_wgrad_bf16: bool = False

    def to_meta(self) -> Dict:
        """JSON-safe architecture record for export manifests (the one
        shared rule, ``models/meta.py``), without the int8 flags."""
        meta = dataclass_meta(self, "moe")
        meta.pop("int8_mxu")  # training-only: never a load contract
        meta.pop("int8_wgrad_bf16")
        return meta

    @classmethod
    def from_meta(cls, meta: Dict) -> "MoEConfig":
        return dataclass_from_meta(cls, meta, "moe")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls, vocab: int = 256) -> "MoEConfig":
        """Test size (the reference's)."""
        return cls(vocab=vocab, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=96, n_experts=4, dtype=torch.float32)

    def _llama_view(self) -> _ll.LlamaConfig:
        """The attention-relevant subset, for reusing llama's blocks."""
        return _ll.LlamaConfig(
            vocab=self.vocab, d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            d_ff=self.d_ff, rope_theta=self.rope_theta,
            norm_eps=self.norm_eps, dtype=self.dtype,
            use_flash=self.use_flash, remat=self.remat)


def init_params(generator: torch.Generator, cfg: MoEConfig,
                device: DeviceLike = None) -> Dict:
    """Random f32 params with the reference's shapes and init scales,
    drawn from ``generator`` in the reference's leaf order and placed on
    ``device`` (CUDA unless ``"cpu"`` is named). The draws are not the
    reference's ``jax.random`` bits; to compare the two, carry weights
    across with :func:`edl_tpu_torch.models.convert.params_from_numpy`."""
    dev = resolve_device(device)
    d, h, kv, hd, ff, L, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff, cfg.n_layers,
                              cfg.n_experts)

    def normal(*shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    return {
        "embed": normal(cfg.vocab, d, scale=0.02),
        "layers": {
            "ln1": ones(L, d),
            "wq": normal(L, d, h * hd, scale=d ** -0.5),
            "wk": normal(L, d, kv * hd, scale=d ** -0.5),
            "wv": normal(L, d, kv * hd, scale=d ** -0.5),
            "wo": normal(L, h * hd, d, scale=(h * hd) ** -0.5),
            "ln2": ones(L, d),
            "router": normal(L, d, E, scale=0.02),
            "w_in": normal(L, E, d, ff, scale=d ** -0.5),
            "w_out": normal(L, E, ff, d, scale=ff ** -0.5),
        },
        "ln_f": ones(d),
        "lm_head": normal(d, cfg.vocab, scale=d ** -0.5),
    }


def param_pspecs(cfg: MoEConfig, plan) -> Dict:
    """The reference's ep x tp x fsdp specs need a mesh, which is not
    ported yet: a plan that shards anything raises. On one device every
    leaf is whole (``None``), in a tree that mirrors
    :func:`init_params`'."""
    require_unsharded(plan, None, "moe.param_pspecs")
    layers = ("ln1", "wq", "wk", "wv", "wo", "ln2", "router", "w_in",
              "w_out")
    return {"embed": None, "layers": {k: None for k in layers},
            "ln_f": None, "lm_head": None}


def _layer(cfg: MoEConfig, x: torch.Tensor, lp: Dict, rope):
    """One decoder layer → (out, aux): llama's attention block, then
    the routed expert FFN, each with its residual."""
    lcfg = cfg._llama_view()
    dt = x.dtype
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    i8, wb = cfg.int8_mxu, cfg.int8_wgrad_bf16
    a = _ll._rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q = _ll._matw(a, lp["wq"], i8, wb).reshape(b, t, h, hd)
    k = _ll._matw(a, lp["wk"], i8, wb).reshape(b, t, kv, hd)
    v = _ll._matw(a, lp["wv"], i8, wb).reshape(b, t, kv, hd)
    q, k = _ll._rope(q, rope), _ll._rope(k, rope)
    o = _ll.attention(q, k, v, lcfg).reshape(b, t, h * hd)
    x = x + _ll._matw(o, lp["wo"], i8, wb)
    m = _ll._rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, aux = moe_ffn(
        {"router": lp["router"].to(dt),
         # int8_mxu quantizes the f32 masters as they are
         "w_in": lp["w_in"] if i8 else lp["w_in"].to(dt),
         "w_out": lp["w_out"] if i8 else lp["w_out"].to(dt)},
        m, k=cfg.top_k, capacity_factor=cfg.capacity_factor, int8_mxu=i8,
        int8_wgrad_bf16=wb)
    return x + y, aux


def forward(params: Dict, tokens: torch.Tensor, cfg: MoEConfig):
    """tokens [B, T] → (logits [B, T, vocab] f32, aux / n_layers).
    Differentiable; with ``cfg.remat`` each layer is checkpointed whole
    (non-reentrant, no policy, as the reference's ``jax.checkpoint``)
    and recomputed in the backward."""
    x = _ll._embed(params, tokens, cfg)
    rope = _ll._rope_tables(cfg._llama_view(), tokens.shape[1], x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _ll._unbind_layers(params):
        if remat:
            x, a = checkpoint(_layer, cfg, x, lp, rope, use_reentrant=False)
        else:
            x, a = _layer(cfg, x, lp, rope)
        aux = aux + a
    x = _ll._rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = _ll._matw(x, params["lm_head"]).float()
    return logits, aux / cfg.n_layers


def make_loss_fn(cfg: MoEConfig, plan=None, mesh=None):
    """Next-token cross entropy plus ``aux_coef · aux``; batch =
    {tokens [B, T+1]} (plus the runtime's optional real-row weights
    ``_w`` [B]). A sharding ``plan``/``mesh`` raises."""
    require_unsharded(plan, mesh, "moe.make_loss_fn")

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        logits, aux = forward(params, tokens[:, :-1], cfg)
        targets = tokens[:, 1:]
        b, t, v = logits.shape
        ce = F.cross_entropy(logits.reshape(b * t, v),
                             targets.reshape(b * t).long(),
                             reduction="none").reshape(b, t)
        # aux (a router-health term over gate statistics) stays unweighted
        # by the rows' weights, as the reference's
        return row_mean(ce.mean(dim=-1), batch) + cfg.aux_coef * aux

    return loss_fn
