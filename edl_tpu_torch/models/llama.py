"""Llama-3-family decoder — the port of ``edl_tpu/models/llama.py``:
the serving half (dense weights; the contiguous KV cache, the paged
block pool with int8 / int4 quantized entries, and the speculative
verify steps) and the training half (differentiable ``forward`` with
per-layer remat, ``make_loss_fn``, ``synthetic_tokens``,
``train_flops_per_token``).

Params are a dict-of-tensors tree with the reference's keys and its
scan-stacked layout (every per-layer weight carries a leading
[n_layers] axis). A serving tree may hold weight-only int8 records
``{"q8", "s8"}`` in place of the projection weights and ``lm_head``
(:func:`quantize_params_int8`); every path takes them. Training can run
the projection products on the int8 path (``LlamaConfig.int8_mxu``,
``ops/int8_matmul.py``). Serving holds the weights in ``cfg.dtype``: the
reference casts every f32 master to ``cfg.dtype`` at its use
(``_matw``, ``_rmsnorm``, the embedding), so holding them cast is
numerically the same and halves the memory (16.1 GB for Llama-3-8B in
bf16). Training holds f32 masters (``init_params(..., dtype=float32)``)
and casts at each use, as the reference does.

The numerics follow the reference op for op: RMSNorm variance in f32,
RoPE angles in f32 with cos/sin cast to the activation dtype, decode
scores divided into f32 (the reference divides by a NumPy scalar,
which promotes) and masked with that dtype's minimum, softmax in f32.
The decode, prefill and verify paths update the KV cache or pool IN
PLACE where the reference donates the buffers to XLA.

KV layouts are head-major where the reference's are position-major:
the contiguous cache is [L, B, KV, S, hd] (the reference's
[L, B, S, KV, hd]) and the paged pool [L, nb, KV, bs, hd] (the
reference's [L, nb, bs, KV, hd]); the quantized pool's scale planes
stay [L, nb, KV]. In the reference's layout the GQA products
``btkgd,bskd->bkgts`` cannot merge (B, KV) into one batch dimension,
so ``torch.einsum`` copied each layer's whole cache before its
``bmm``; head-major, both products are strided ``bmm`` calls over the
cache as it lies (:func:`_gqa_attend`). Values are the same; only the
axis order differs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from edl_tpu_torch.models.losses import row_mean
from edl_tpu_torch.obs import costmodel
from edl_tpu_torch.ops.flash_attention import attention_auto, flash_supported
from edl_tpu_torch.ops.int8_matmul import absmax_quant, int8_matmul
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # activation (and serving weight) dtype
    use_flash: bool = False  # attention through ops/flash_attention
    # rematerialize each layer in the backward pass: only the [B,T,d]
    # layer inputs are saved across layers (torch.utils.checkpoint).
    # Training-only: neither field rides to_meta.
    remat: bool = False
    # what the remat saves besides layer inputs (the FLOPs/HBM dial, a
    # selective-checkpoint policy; see _remat_policy):
    #   "full" — nothing (the flagship's: least memory, most recompute)
    #   "attn" — the flash op's (out, lse): the backward re-runs no
    #            attention (needs use_flash and a flash-supported T)
    #   "mlp"  — the w1 and w3 products' outputs, the MLP's [B,T,d_ff]
    #   "dots" — every weight product (aten.mm), as the reference's
    #            dots_with_no_batch_dims_saveable
    remat_policy: str = "full"
    # run the seven per-layer projection products on the int8 path
    # (ops/int8_matmul.py: dynamic absmax quantization of both operands,
    # STE gradients, forward + dgrad + wgrad int8). Masters, optimizer,
    # attention and lm_head stay as they are. Training-only: never rides
    # to_meta, and generate turns it off.
    int8_mxu: bool = False
    # with int8_mxu: wgrad (a^T @ g) on bf16-rounded operands with an
    # f32 product, while the forward and dgrad stay int8
    int8_wgrad_bf16: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def to_meta(self) -> Dict:
        """JSON-safe architecture record — the reference's export
        manifest format (``LlamaConfig.to_meta``)."""
        return {
            "family": "llama",
            "vocab": self.vocab,
            "d_model": self.d_model,
            "n_layers": self.n_layers,
            "n_heads": self.n_heads,
            "n_kv_heads": self.n_kv_heads,
            "d_ff": self.d_ff,
            "rope_theta": self.rope_theta,
            "norm_eps": self.norm_eps,
            "dtype": str(self.dtype).replace("torch.", ""),
            "use_flash": self.use_flash,
        }

    @classmethod
    def from_meta(cls, meta: Dict) -> "LlamaConfig":
        if meta.get("family") != "llama":
            raise ValueError(f"not a llama export: family={meta.get('family')!r}")
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"unsupported dtype {meta['dtype']!r}")
        return cls(
            vocab=int(meta["vocab"]),
            d_model=int(meta["d_model"]),
            n_layers=int(meta["n_layers"]),
            n_heads=int(meta["n_heads"]),
            n_kv_heads=int(meta["n_kv_heads"]),
            d_ff=int(meta["d_ff"]),
            rope_theta=float(meta["rope_theta"]),
            norm_eps=float(meta["norm_eps"]),
            dtype=_DTYPES[meta["dtype"]],
            use_flash=bool(meta.get("use_flash", False)),
        )

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 256) -> "LlamaConfig":
        """Test size: same architecture, toy dims (the reference's)."""
        return cls(
            vocab=vocab,
            d_model=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
            dtype=torch.float32,
        )


def init_params(
    cfg: LlamaConfig,
    seed: int = 0,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict:
    """Random param tree with the reference's shapes and init scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (one draw per leaf, in the reference's leaf order), held in
    ``dtype`` (default ``cfg.dtype``). The draws are not the reference's
    ``jax.random`` bits; to compare the two, carry weights across with
    :func:`edl_tpu_torch.models.convert.params_from_numpy`."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, h, kv, hd, ff, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.n_layers)

    def normal(*shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.mul_(scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    return {
        "embed": normal(cfg.vocab, d, scale=0.02),
        "layers": {
            "ln1": ones(L, d),
            "wq": normal(L, d, h * hd, scale=d ** -0.5),
            "wk": normal(L, d, kv * hd, scale=d ** -0.5),
            "wv": normal(L, d, kv * hd, scale=d ** -0.5),
            "wo": normal(L, h * hd, d, scale=(h * hd) ** -0.5),
            "ln2": ones(L, d),
            "w1": normal(L, d, ff, scale=d ** -0.5),
            "w3": normal(L, d, ff, scale=d ** -0.5),
            "w2": normal(L, ff, d, scale=ff ** -0.5),
        },
        "ln_f": ones(d),
        "lm_head": normal(d, cfg.vocab, scale=d ** -0.5),
    }


def _layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked leaves; an int8 record ``{"q8" [L,
    din, dout], "s8" [L, dout]}`` gives the layer's record."""
    return {k: ({n: x[i] for n, x in v.items()} if isinstance(v, dict)
                else v[i])
            for k, v in params["layers"].items()}


def _embed(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig):
    return params["embed"][tokens].to(cfg.dtype)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope_tables(
    cfg: LlamaConfig, t: int, device, positions: Optional[torch.Tensor] = None
):
    """RoPE (cos, sin), each [B or 1, T, 1, hd/2] in ``cfg.dtype``:
    angles in f32, then cast, as the reference's ``_rope``. Positions
    are shared by every layer, so a pass computes the tables once (XLA
    dedupes the reference's per-layer recomputation; eager PyTorch
    would launch it 2 x n_layers times). ``positions`` [T] or [B, T]
    (per-row absolute positions, the slot decode) overrides 0..T-1."""
    hd = cfg.head_dim
    # a Python-scalar base: no host-to-device copy (a pageable copy
    # stalls the host behind every queued kernel)
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    freqs = 1.0 / torch.pow(float(cfg.rope_theta), exps)
    if positions is None:
        positions = torch.arange(t, device=device)
    angles = positions.float()[..., :, None] * freqs  # [..., T, hd/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(cfg.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(cfg.dtype)
    return cos, sin


def _rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding over [B, T, H, hd] with :func:`_rope_tables`."""
    cos, sin = tables
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: LlamaConfig
) -> torch.Tensor:
    """Causal GQA attention. q [B,T,H,hd]; k,v [B,T,KV,hd]. With
    ``cfg.use_flash`` and a flash-supported T it is the flash op (the
    Hopper kernel on CUDA); otherwise the reference's dense path."""
    b, t, h, hd = q.shape
    if cfg.use_flash and flash_supported(t):
        return attention_auto(q, k, v, causal=True)
    groups = h // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


_INT8_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _matw(a: torch.Tensor, w, int8_mxu: bool = False,
          wgrad_bf16: bool = False) -> torch.Tensor:
    """``a @ W`` where ``W`` is a dense weight or a weight-only int8
    record ``{"q8", "s8"}`` from :func:`quantize_params_int8`.

    The record computes ``(a @ q8) * s8``, equal to ``a @ (q8 * s8)``
    because ``s8`` is constant along the contraction; the column-scale
    multiply stays f32 (a bf16 ``s8`` would truncate each scale to an
    8-bit mantissa). Eager PyTorch materializes ``q8`` in ``a.dtype``
    for the product, where XLA fuses the convert into the operand read.

    ``int8_mxu`` (training) runs the dense product on the int8 path
    instead (:func:`int8_matmul`): both operands quantized in flight,
    the weight read as its f32 master with no bf16 pre-cast."""
    dt = a.dtype
    if isinstance(w, dict):
        # bf16 x f32 promotes: the product is read as f32 and scaled
        return ((a @ w["q8"].to(dt)) * w["s8"]).to(dt)
    if int8_mxu:
        return int8_matmul(a, w, wgrad_bf16)
    return a @ w.to(dt)


def quantize_params_int8(params: Dict) -> Dict:
    """Weight-only int8 for serving: the seven per-layer projection
    weights and ``lm_head`` become ``{"q8": int8 [..., din, dout], "s8":
    f32 [..., dout]}`` with symmetric per-output-column absmax scales
    (the error per element is at most colmax/254). The embedding and
    the norm scales stay dense. The records equal the reference's bit
    for bit. The tree feeds ``forward``, ``generate`` and the engine
    unchanged: :func:`_matw` dispatches on the record."""

    def q(w):
        q8, s = absmax_quant(w, -2)  # absmax over din: per output column
        return {"q8": q8, "s8": s[..., 0, :]}

    out = dict(params)
    out["layers"] = {k: (q(v) if k in _INT8_WEIGHTS else v)
                     for k, v in params["layers"].items()}
    out["lm_head"] = q(params["lm_head"])
    return out


def _qkv(cfg: LlamaConfig, a: torch.Tensor, lp: Dict, rope):
    b, t, _ = a.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    i8, wb = cfg.int8_mxu, cfg.int8_wgrad_bf16
    q = _matw(a, lp["wq"], i8, wb).reshape(b, t, h, hd)
    k = _matw(a, lp["wk"], i8, wb).reshape(b, t, kv, hd)
    v = _matw(a, lp["wv"], i8, wb).reshape(b, t, kv, hd)
    q = _rope(q, rope)
    k = _rope(k, rope)
    return q, k, v


# the remat policies' counterpart of jax's checkpoint_name: the name of
# the site whose ops are being dispatched, read by a policy
_SITE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "edl_remat_site", default=None)


@contextlib.contextmanager
def _site(name: str):
    token = _SITE.set(name)
    try:
        yield
    finally:
        _SITE.reset(token)


def _mlp(cfg: LlamaConfig, x: torch.Tensor, lp: Dict) -> torch.Tensor:
    """Post-attention SwiGLU block, residual included. The w1 and w3
    products run under the site name ``"mlp"``, which the ``"mlp"``
    remat policy saves."""
    i8, wb = cfg.int8_mxu, cfg.int8_wgrad_bf16
    m = _rmsnorm(x, lp["ln2"], cfg.norm_eps)
    with _site("mlp"):
        gate, up = _matw(m, lp["w1"], i8, wb), _matw(m, lp["w3"], i8, wb)
    return x + _matw(torch.nn.functional.silu(gate) * up, lp["w2"], i8, wb)


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: Dict, rope):
    """One decoder layer → (out, k, v); the prefill collects k/v."""
    b, t, _ = x.shape
    a = _rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, a, lp, rope)
    o = attention(q, k, v, cfg).reshape(b, t, -1)
    x = x + _matw(o, lp["wo"], cfg.int8_mxu, cfg.int8_wgrad_bf16)
    return _mlp(cfg, x, lp), k, v


_MM = torch.ops.aten.mm.default
_FLASH_FWD = torch.ops.edl_tpu_torch.flash_fwd.default
# a weight product: the dense one, or the registered int8 op under
# int8_mxu (whose int32 and f32 intermediates stay inside it)
_PRODUCTS = (_MM, torch.ops.edl_tpu_torch.int8_matmul.default)


def _policy(save: Callable[[object], bool]):
    """A ``checkpoint`` ``context_fn`` whose policy must-saves the
    outputs of the ops ``save`` accepts and recomputes every other."""

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if save(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat_policy(cfg: LlamaConfig) -> Callable:
    """The remat FLOPs/HBM dial (see ``LlamaConfig.remat_policy``) as a
    ``context_fn`` for ``checkpoint``: the reference's
    ``_remat_policy`` (``edl_tpu/models/llama.py:405-426``) over the
    dispatcher's ops.

    Eager recompute re-runs the layer's Python, so a saved op skips
    only its own work, never that of the ops feeding it (no dead-code
    elimination as in XLA), and non-reentrant checkpointing stops once
    the last tensor the backward needs is back. Per layer the backward
    therefore recomputes these weight products (the w2 product's
    output is needed by nothing, so it is never recomputed):

    - ``"full"``: wq, wk, wv, wo, w1, w3 (6) and the flash forward.
    - ``"attn"``: the same 6 products, no flash forward: the flash op's
      ``(out, lse)`` is saved (the reference's ``flash_out`` /
      ``flash_lse``).
    - ``"mlp"``: wq, wk, wv, wo (4) and the flash forward. The policy
      saves the w1 and w3 products' outputs ``[B, T, d_ff]``: the same
      bytes as the reference's ``mlp_gate`` / ``mlp_up``
      (``silu(w1·m)`` and ``w3·m``, ``edl_tpu/models/llama.py:379-380``).
      The port saves at the products, not at ``silu``, because a saved
      ``silu`` would still recompute its input ``w1·m`` here; the cheap
      ``silu`` is what it recomputes instead.
    - ``"dots"``: no product (every ``aten.mm``, the weight products
      with no batch dims, is saved; the attention's batched products and
      the flash op are not), and the flash forward.

    Under ``int8_mxu`` the weight products are ``edl_tpu_torch::
    int8_matmul`` ops, which the policies treat as ``aten.mm``: "mlp"
    and "dots" save their outputs, never their int32 intermediates.
    """
    if cfg.remat_policy == "mlp":
        return _policy(lambda op: op in _PRODUCTS and _SITE.get() == "mlp")
    if cfg.remat_policy == "attn":
        if not cfg.use_flash:
            raise ValueError(
                'remat_policy="attn" saves the flash kernel\'s named '
                "residuals; without use_flash there is nothing to "
                "save and the policy would silently degrade to full "
                "rematerialization"
            )
        return _policy(lambda op: op == _FLASH_FWD)
    if cfg.remat_policy == "dots":
        return _policy(lambda op: op in _PRODUCTS)
    if cfg.remat_policy == "full":
        return noop_context_fn
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _unbind_layers(params: Dict) -> List[Dict]:
    """Per-layer views of the stacked [L, ...] leaves, taken with ONE
    ``unbind`` per leaf: under autograd its backward stacks the L layer
    gradients once, where L separate ``[i]`` indexings would each add a
    full-size [L, ...] zero gradient."""
    keys = list(params["layers"])
    cols = [_unbind(params["layers"][k]) for k in keys]
    return [dict(zip(keys, vals)) for vals in zip(*cols)]


def _unbind(leaf):
    """One ``unbind`` per tensor; an int8 record unbinds into per-layer
    records."""
    if isinstance(leaf, dict):
        parts = {n: x.unbind(0) for n, x in leaf.items()}
        return [dict(zip(parts, vals)) for vals in zip(*parts.values())]
    return leaf.unbind(0)


def _layer_out(cfg: LlamaConfig, x: torch.Tensor, lp: Dict, rope):
    return _layer(cfg, x, lp, rope)[0]


def forward(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
            mesh=None, plan=None):
    """tokens [B, T] → logits [B, T, vocab] (f32). Differentiable: with
    params that require grad it builds the graph, with ``cfg.remat``
    each layer is checkpointed (non-reentrant) and recomputed in the
    backward. Serving params do not require grad, so serving builds no
    graph. ``cfg.remat_policy`` picks what the remat saves
    (:func:`_remat_policy`). A sharding ``plan``/``mesh`` raises (not
    ported yet)."""
    require_unsharded(plan, mesh, "llama.forward")
    if (cfg.remat and cfg.remat_policy == "attn" and cfg.use_flash
            and not flash_supported(tokens.shape[1])):
        # attention() would take the dense path, the flash op would
        # never run, and the policy would degrade to full remat
        raise ValueError(
            f'remat_policy="attn" needs the flash kernel, but '
            f"seq len {tokens.shape[1]} is not flash-supported "
            f"(flash_supported() is False) — pad T or switch policy"
        )
    context_fn = _remat_policy(cfg) if cfg.remat else None
    x = _embed(params, tokens, cfg)
    rope = _rope_tables(cfg, tokens.shape[1], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _unbind_layers(params):
        if remat:
            x = checkpoint(_layer_out, cfg, x, lp, rope, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = _layer_out(cfg, x, lp, rope)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _matw(x, params["lm_head"]).float()


@torch.no_grad()
def prefill_padded(
    params: Dict, tokens: torch.Tensor, last, cfg: LlamaConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill over an END-padded prompt batch [B, Tb] → (logits at each
    row's ``last`` index [B, V] f32, k/v caches [L, B, Tb, KV, hd]).
    Causality makes end-padding invisible to every real position, so
    the serving engine buckets prompt lengths. The caches come out in
    the reference's position-major layout; a writer into the head-major
    decode cache transposes them (``.transpose(2, 3)``)."""
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg)
    rope = _rope_tables(cfg, tokens.shape[1], x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = _layer(cfg, x, _layer_params(params, i), rope)
        ks.append(k)
        vs.append(v)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    last = torch.as_tensor(last, device=x.device).reshape(-1).expand(b)
    xl = x[torch.arange(b, device=x.device), last]  # each row's last real token
    logits = _matw(xl, params["lm_head"]).float()
    return logits, torch.stack(ks), torch.stack(vs)


def _gqa_attend(cfg: LlamaConfig, q, k, v, mask, kv_major: bool = False,
                kscale=None, vscale=None) -> torch.Tensor:
    """Masked dense GQA attention of ``q`` [B, T, H, hd] over a
    head-major cache ``k``/``v`` [B, KV, S, hd] (``kv_major``: [KV, B,
    S, hd], the paged gather's order): the reference's
    ``btkgd,bskd->bkgts`` and ``bkgts,bskd->btkgd`` products as two
    ``bmm`` calls whose batch is the (B, KV) pair, so the cache is read
    where it lies and only q, the scores and the output are rearranged.
    ``mask`` [B|1, 1, 1, T, S] is in the reference's ``bkgts`` layout;
    ``kscale``/``vscale`` (the quantized pool's strips, in the scores'
    layout) multiply the f32 scores and the probs. Returns [B, T,
    H*hd]."""
    b, t, h, hd = q.shape
    kvh = cfg.n_kv_heads
    g = h // kvh
    s = k.shape[2]
    dt = q.dtype
    qh = q.reshape(b, t, kvh, g, hd).permute(
        (2, 0, 3, 1, 4) if kv_major else (0, 2, 3, 1, 4))
    lead = qh.shape[:2]
    scores = torch.bmm(qh.reshape(-1, g * t, hd),
                       k.reshape(-1, s, hd).transpose(1, 2))
    scores = scores.reshape(*lead, g, t, s).float() / math.sqrt(hd)
    if kscale is not None:
        scores = scores * kscale
    if kv_major:
        mask = mask.transpose(0, 1)
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    if vscale is not None:
        probs = probs * vscale
    o = torch.bmm(probs.to(dt).reshape(-1, g * t, s), v.reshape(-1, s, hd))
    o = o.reshape(*lead, g, t, hd).permute(
        (1, 3, 0, 2, 4) if kv_major else (0, 3, 1, 2, 4))
    return o.reshape(b, t, h * hd)


@torch.no_grad()
def decode_step_slots(
    params: Dict,
    tok: torch.Tensor,
    pos: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
):
    """One continuous-batching decode step over B independent KV slots.
    tok/pos [B] (previous token, the cache position this step writes);
    kc/vc [L, B, KV, S, hd] (head-major), updated IN PLACE at (row,
    pos[row]) — unique indices. Returns (logits [B, V] f32, kc, vc)."""
    b = tok.shape[0]
    s = kc.shape[3]
    rows = torch.arange(b, device=tok.device)
    mask = (torch.arange(s, device=tok.device)[None, :] <= pos[:, None])
    mask = mask[:, None, None, None, :]
    x = _embed(params, tok[:, None], cfg)
    rope = _rope_tables(cfg, 1, x.device, pos[:, None])
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        a = _rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, knew, vnew = _qkv(cfg, a, lp, rope)
        kc[i, rows, :, pos] = knew[:, 0]
        vc[i, rows, :, pos] = vnew[:, 0]
        o = _gqa_attend(cfg, q, kc[i], vc[i], mask)
        x = x + _matw(o, lp["wo"])
        x = _mlp(cfg, x, lp)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = _matw(x[:, 0], params["lm_head"]).float()
    return logits, kc, vc


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One draw per row from softmax(logits), on the device, no sync."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def decode_horizon_slots(
    params: Dict,
    tok: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    rem: torch.Tensor,
    eosv: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
    horizon: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    sampling: bool = False,
):
    """``horizon`` slot-decode steps with per-slot termination on the
    device: a row that emits its ``eosv`` token or exhausts ``rem``
    freezes (tok/pos/rem stop, output lanes read -1) and keeps
    re-running an idempotent step. Every mask is a ``torch.where`` on
    the device — the loop never syncs the host. Returns
    ``(toks [B, horizon], tok, pos, active, rem, kc, vc)``."""
    def step(tok, pos):
        return decode_step_slots(params, tok, pos, kc, vc, cfg)[0]

    return _horizon(step, tok, pos, active, rem, eosv, horizon, generator,
                    temperature, sampling) + (kc, vc)


def _horizon(step, tok, pos, active, rem, eosv, horizon, generator,
             temperature, sampling):
    """The horizon loop of the contiguous and paged decodes: ``step(tok,
    pos)`` gives one step's logits [B, V] (writing the caches in place);
    a row that emits its ``eosv`` token or exhausts ``rem`` freezes.
    Returns ``(toks [B, horizon], tok, pos, active, rem)``."""
    outs = []
    for _ in range(horizon):
        logits = step(tok, pos)
        if sampling:
            nxt = _categorical(logits / temperature, generator)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(active, nxt.to(tok.dtype), tok)
        outs.append(torch.where(active, nxt, -1))
        pos = torch.where(active, pos + 1, pos)
        rem = torch.where(active, rem - 1, rem)
        hit = active & (eosv >= 0) & (nxt == eosv)
        active = active & ~hit & (rem > 0)
        tok = nxt
    return torch.stack(outs, dim=1), tok, pos, active, rem


# -- inference: paged KV cache (block tables) ---------------------------------
#
# K/V live in a POOL of fixed-size blocks [L, n_blocks, KV, block_size, hd]
# (head-major inside a block) and each slot carries a BLOCK TABLE row mapping its logical positions to
# physical blocks: logical position p of row r lives at
# (table[r, p // block_size], p % block_size). The serving engine allocates
# blocks as requests grow, frees them on finish, and maps leading entries of
# different rows to the SAME physical block (refcounted shared prefixes).
# Physical block 0 is SCRATCH: inactive/frozen lanes and bucket padding
# write there, no live table entry maps to it, and the causal mask hides
# every position past a row's own, so scratch is never read back. Every
# function below writes the pool IN PLACE (the reference donates it) and
# returns it for symmetry with the reference's signatures. Attention is the
# reference's gather through the table plus masked dense products — the
# gather reads each layer's [nb, KV, bs, hd] blocks as [nb * KV] rows in
# head-major order (:func:`_pool_rows`), so it lands [KV, B, S, hd] and
# the products are strided bmm calls (:func:`_gqa_attend`) — and no flash
# kernel on this path, as in the reference.
#
# Quantized pools (kv_quant "int8" / "int4") store int8 (or two int4 per
# byte along hd) with per-(block, kv-head) f32 absmax scales ks/vs
# [L, nb, KV]. The K scale multiplies the f32 scores (constant along the
# contracted hd), the V scale folds into the probs (indexed like them), so
# the contraction runs on the raw integers cast to the activation dtype.
# Writes quantize on the fly (:func:`_kvq_store`): each written block's
# scale grows to cover the new values' absmax, resets when a write lands at
# block offset 0 (a block's first write), and resident content is rescaled
# under the grown scale.

_KVQ_QMAX = {"int8": 127.0, "int4": 7.0}


def kvq_packed_head_dim(kv_quant: str, head_dim: int) -> int:
    """Innermost stored dim of one pool entry: int4 packs two 4-bit
    values per int8 byte along ``hd`` (requires even head_dim)."""
    if kv_quant == "int4":
        if head_dim % 2:
            raise ValueError(
                f"kv_quant int4 needs an even head_dim, got {head_dim}"
            )
        return head_dim // 2
    return head_dim


def _kvq_pack(q: torch.Tensor, kv_quant: str) -> torch.Tensor:
    """Rounded/clipped quantized values (f32 in [-qmax, qmax]) -> stored
    int8. int4 packs index pairs along the last axis: even index = low
    nibble, odd = high nibble (bit work on int32, never on uint8)."""
    qi = q.to(torch.int32)
    if kv_quant == "int8":
        return qi.to(torch.int8)
    lo = qi[..., 0::2]
    hi = qi[..., 1::2]
    return torch.bitwise_or(torch.bitwise_left_shift(hi, 4),
                            torch.bitwise_and(lo, 0xF)).to(torch.int8)


def _kvq_unpack(p: torch.Tensor, kv_quant: str) -> torch.Tensor:
    """Stored int8 -> quantized values as f32 in [-qmax, qmax]."""
    if kv_quant == "int8":
        return p.float()
    x = p.to(torch.int32)
    hi = torch.bitwise_right_shift(x, 4)  # arithmetic: sign-extends
    lo = torch.bitwise_xor(torch.bitwise_and(x, 0xF), 8) - 8  # sign-extend
    both = torch.stack([lo, hi], dim=-1)  # [..., hd/2, 2]
    return both.reshape(*p.shape[:-1], p.shape[-1] * 2).float()


def _kvq_store(
    pool: torch.Tensor,
    scale: torch.Tensor,
    i: int,
    wblk: torch.Tensor,
    woff: torch.Tensor,
    new: torch.Tensor,
    kv_quant: str,
):
    """Quantize ``new`` [N, KV, hd] lane writes into layer ``i`` of the
    packed ``pool`` [L, nb, KV, bs, hdp] at (``wblk``, ``woff``) [N], in
    place, maintaining the per-(block, kv-head) f32 ``scale`` [L, nb, KV].

    (1) scatter-max the new values' absmax into per-block scale
    proposals; (2) a write at offset 0 marks its block FRESH — the scale
    resets instead of inheriting a freed previous tenant's; (3) written
    blocks' resident content is rescaled under the grown scale (duplicate
    block indices carry identical payloads; fresh blocks' stale content
    zeroes); (4) the new values quantize under the final scale and land
    at their offsets. Only refcount-1 blocks are written (the engine
    copy-on-writes shared ones first), except SCRATCH, never read."""
    qmax = _KVQ_QMAX[kv_quant]
    newf = new.float()
    amax = newf.abs().amax(dim=-1)  # [N, KV]
    nb, kvh = scale.shape[1], scale.shape[2]
    s_old = scale[i]  # [nb, KV]
    prop = torch.zeros_like(s_old).scatter_reduce(
        0, wblk[:, None].expand(-1, kvh), amax, "amax", include_self=True)
    fresh = torch.zeros(nb, dtype=torch.int32, device=pool.device)
    fresh = fresh.scatter_reduce(0, wblk, (woff == 0).to(torch.int32),
                                 "amax", include_self=True) > 0
    touched = torch.zeros(nb, dtype=torch.bool, device=pool.device)
    touched[wblk] = True
    kept = torch.where(fresh[:, None], 0.0, s_old)
    s_new = torch.maximum(kept, prop / qmax)
    s_new = torch.where(touched[:, None], s_new, s_old)
    s_safe = torch.where(s_new > 0.0, s_new, 1.0)
    # resident-content rescale: the identity (ratio 1) when the scale did
    # not move; a fresh block's stale previous-tenant content zeroes
    ratio = (kept / s_safe)[wblk]  # [N, KV]
    cur = _kvq_unpack(pool[i][wblk], kv_quant)  # [N, KV, bs, hd]
    resc = torch.clamp(torch.round(cur * ratio[:, :, None, None]),
                       -qmax, qmax)
    pool[i, wblk] = _kvq_pack(resc, kv_quant)
    qnew = torch.clamp(torch.round(newf / s_safe[wblk][:, :, None]),
                       -qmax, qmax)
    pool[i, wblk, :, woff] = _kvq_pack(qnew, kv_quant)
    scale[i] = s_new
    return pool, scale


def _kvq_scale_strip(scale_i: torch.Tensor, table: torch.Tensor, bs: int):
    """Per-position scale strip for the attention gather: the [nb, KV]
    block scales gathered through the table, expanded to
    [KV, B, 1, 1, S] against the paged gather's ``kbgts`` score/prob
    layout (block j's scale covers positions j*bs .. (j+1)*bs - 1)."""
    sc = scale_i.t()[:, table].repeat_interleave(bs, dim=-1)  # [KV, .., S]
    if sc.dim() == 2:  # single-slot table (prefill): add the batch axis
        sc = sc[:, None]
    return sc[:, :, None, None, :]


def _pool_rows(table: torch.Tensor, kvh: int) -> torch.Tensor:
    """Row ids of the paged gather, [KV, *table.shape]: a pool layer
    [nb, KV, bs, hd] read as [nb * KV, bs * hd] rows, block ``j``'s head
    ``k`` is row ``j * KV + k``. Gathering these rows (a dim-0 gather of
    whole rows, the fast one) lands the table's blocks head-major,
    [KV, B, M, bs * hd]. The table is the same in every layer, so a
    step computes this once."""
    heads = torch.arange(kvh, device=table.device)
    return table[None] * kvh + heads.reshape(kvh, *([1] * table.dim()))


def _paged_attend(cfg, q, kc, vc, i, table, rows, qmask, bs, kv_quant, ks,
                  vs):
    """Masked dense GQA attention of ``q`` [B, T, H, hd] over layer
    ``i``'s pool gathered through ``table`` ([B, M], or [M] for one
    slot; ``rows`` = :func:`_pool_rows` of it): the reference's table
    gather + products, with the quantized pool's factored dequant. The
    gather reads the layer's [KV, nb, bs, hd] blocks as rows, so it
    lands [KV, B, M, bs, hd] in one piece and (KV, B) is the products'
    batch. Returns [B, T, H*hd]."""
    b = q.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    s = table.shape[-1] * bs
    kci = kc[i].reshape(-1, bs * kc.shape[-1])[rows]
    vci = vc[i].reshape(-1, bs * vc.shape[-1])[rows]
    kscale = vscale = None
    if kv_quant != "off":
        kci = _kvq_unpack(kci, kv_quant).to(q.dtype)
        vci = _kvq_unpack(vci, kv_quant).to(q.dtype)
        kscale = _kvq_scale_strip(ks[i], table, bs)
        vscale = _kvq_scale_strip(vs[i], table, bs)
    return _gqa_attend(cfg, q, kci.reshape(kvh, b, s, hd),
                       vci.reshape(kvh, b, s, hd), qmask, kv_major=True,
                       kscale=kscale, vscale=vscale)


def _paged_write(kc, vc, ks, vs, i, wblk, woff, knew, vnew, kv_quant):
    """Lane writes [N, KV, hd] into layer ``i`` at (wblk, woff) [N]."""
    if kv_quant != "off":
        _kvq_store(kc, ks, i, wblk, woff, knew, kv_quant)
        _kvq_store(vc, vs, i, wblk, woff, vnew, kv_quant)
    else:
        kc[i, wblk, :, woff] = knew
        vc[i, wblk, :, woff] = vnew


def _paged_result(logits, kc, vc, ks, vs, kv_quant):
    if kv_quant != "off":
        return logits, kc, vc, ks, vs
    return logits, kc, vc


@torch.no_grad()
def decode_step_slots_paged(
    params: Dict,
    tok: torch.Tensor,
    pos: torch.Tensor,
    table: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
    block_size: int,
    kv_quant: str = "off",
    ks: Optional[torch.Tensor] = None,
    vs: Optional[torch.Tensor] = None,
):
    """One slot-decode step over the paged pool. tok/pos [B]; table
    [B, M] physical block ids; kc/vc [L, n_blocks, KV, block_size, hd]
    (int8 with hd packed under ``kv_quant``, plus scales ``ks``/``vs``).
    Returns (logits [B, V] f32, kc, vc[, ks, vs]).

    Per-row math is :func:`decode_step_slots`'s; only the write target
    (the row's block at ``pos % block_size``) and the read (the table
    gather) differ. Rows whose ``pos`` ran past the table write to
    scratch — a clamped index would alias the last real block."""
    b = tok.shape[0]
    bs = block_size
    m = table.shape[1]
    s = m * bs
    dev = tok.device
    rows = torch.arange(b, device=dev)
    inb = pos < s
    blk = torch.where(inb, table[rows, torch.clamp(pos // bs, 0, m - 1)], 0)
    off = torch.where(inb, pos % bs, 0)
    qmask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])
    qmask = qmask[:, None, None, None, :]
    rows = _pool_rows(table, cfg.n_kv_heads)
    x = _embed(params, tok[:, None], cfg)
    rope = _rope_tables(cfg, 1, dev, pos[:, None])
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        a = _rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, knew, vnew = _qkv(cfg, a, lp, rope)
        _paged_write(kc, vc, ks, vs, i, blk, off, knew[:, 0], vnew[:, 0],
                     kv_quant)
        o = _paged_attend(cfg, q, kc, vc, i, table, rows, qmask, bs,
                          kv_quant, ks, vs)
        x = x + _matw(o, lp["wo"])
        x = _mlp(cfg, x, lp)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = _matw(x[:, 0], params["lm_head"]).float()
    return _paged_result(logits, kc, vc, ks, vs, kv_quant)


@torch.no_grad()
def decode_horizon_slots_paged(
    params: Dict,
    tok: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    rem: torch.Tensor,
    eosv: torch.Tensor,
    table: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
    block_size: int,
    horizon: int,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    sampling: bool = False,
    kv_quant: str = "off",
    ks: Optional[torch.Tensor] = None,
    vs: Optional[torch.Tensor] = None,
):
    """The paged twin of :func:`decode_horizon_slots`: ``horizon``
    :func:`decode_step_slots_paged` steps with the same on-device freeze
    semantics. The table is read-only across the horizon (the engine
    maps every position the horizon can write before it dispatches).
    Returns ``(toks [B, horizon], tok, pos, active, rem, kc, vc[, ks,
    vs])``."""
    def step(tok, pos):
        return decode_step_slots_paged(
            params, tok, pos, table, kc, vc, cfg, block_size,
            kv_quant=kv_quant, ks=ks, vs=vs,
        )[0]

    out = _horizon(step, tok, pos, active, rem, eosv, horizon, generator,
                   temperature, sampling) + (kc, vc)
    if kv_quant != "off":
        return out + (ks, vs)
    return out


@torch.no_grad()
def prefill_paged(
    params: Dict,
    tokens: torch.Tensor,
    start: int,
    last: int,
    table: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
    block_size: int,
    kv_quant: str = "off",
    ks: Optional[torch.Tensor] = None,
    vs: Optional[torch.Tensor] = None,
):
    """Prefill one CHUNK of one slot's prompt into the paged pool.
    ``tokens`` [1, Tb] covers logical positions ``start .. start+Tb-1``
    with real tokens through local index ``last`` (end padding); earlier
    positions are already resident (earlier chunks or shared prefix
    blocks). ``table`` [M] is the slot's block-table row. Returns
    (logits [1, V] f32 at ``last``, kc, vc[, ks, vs]).

    The writes land before the gather, so chunk token t sees every pool
    position <= start + t, its own included. Pad tokens write to
    scratch and their query rows are discarded. Serves admission (start
    = the prefix-hit length), chunked prefill and the recovery replay."""
    b, tb = tokens.shape
    bs = block_size
    m = table.shape[0]
    s = m * bs
    dev = tokens.device
    tpos = torch.arange(tb, device=dev)
    positions = start + tpos  # [Tb] absolute positions
    real = tpos <= last
    wblk = torch.where(real, table[torch.clamp(positions // bs, 0, m - 1)], 0)
    woff = torch.where(real, positions % bs, 0)
    qmask = (torch.arange(s, device=dev)[None, :] <= positions[:, None])
    qmask = qmask[None, None, None]  # [1,1,1,Tb,S]
    rows = _pool_rows(table, cfg.n_kv_heads)
    x = _embed(params, tokens, cfg)
    rope = _rope_tables(cfg, tb, dev, positions)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        a = _rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, knew, vnew = _qkv(cfg, a, lp, rope)
        _paged_write(kc, vc, ks, vs, i, wblk, woff, knew[0], vnew[0],
                     kv_quant)
        o = _paged_attend(cfg, q, kc, vc, i, table, rows, qmask, bs,
                          kv_quant, ks, vs)
        x = x + _matw(o, lp["wo"])
        x = _mlp(cfg, x, lp)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = _matw(x[:, last], params["lm_head"]).float()  # [1, V]
    return _paged_result(logits, kc, vc, ks, vs, kv_quant)


# -- inference: speculative decoding (draft-verify) ---------------------------
#
# A verify step scores K = D+1 query lanes per slot in one pass: the
# pending token plus D host-drafted continuation guesses. Lane j writes
# its K/V at position pos+j BEFORE the gather, so causal lanes see their
# own prefix; lane j's argmax is the true greedy successor of
# ``... tok draft[0..j-1]``. The longest draft prefix matching argmax is
# committed, plus the first non-matching argmax as a bonus token, so a
# rejected draft degrades to exactly one plain decode step. Rejected
# lanes leave garbage past the accepted run, overwritten by the next
# dispatch before its positions unmask. Writes past the cache end are
# DROPPED (the reference's mode="drop"), never clamped.


@torch.no_grad()
def verify_step_slots(
    params: Dict,
    tok: torch.Tensor,
    draft: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    rem: torch.Tensor,
    eosv: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
):
    """One speculative draft-verify step over B contiguous KV slots.
    tok [B] (pending tokens); draft [B, D] (-1 = no draft in that lane:
    never matches an argmax); pos/active/rem/eosv as in
    :func:`decode_horizon_slots`; kc/vc [L, B, KV, S, hd] (head-major),
    written in place. Returns ``(outs [B, D+1], tok, pos, active, rem, kc, vc)`` —
    the committed tokens with -1 tails, the horizon drain contract.

    A lane past the cache end has nowhere to go: its write is redirected
    to its row's lane 0 position with lane 0's own K/V, so the scatter's
    duplicates carry identical payloads (lane 0 is in range: a row's
    ``pos`` stays below S, since a request's prompt plus budget fits
    its slot)."""
    b, k = draft.shape[0], draft.shape[1] + 1
    s = kc.shape[3]
    rows = torch.arange(b, device=tok.device)[:, None]
    qpos = _lane_positions(pos, k)
    inb = qpos < s
    wpos = torch.where(inb, qpos, pos[:, None])
    keep = inb[:, :, None, None]

    def attend(i, q, knew, vnew, qmask):
        # [B, K] row/position pairs around the head slice: [B, K, KV, hd]
        kc[i, rows, :, wpos] = torch.where(keep, knew, knew[:, :1])
        vc[i, rows, :, wpos] = torch.where(keep, vnew, vnew[:, :1])
        return _gqa_attend(cfg, q, kc[i], vc[i], qmask)

    out = _verify_argmax(params, cfg, tok, draft, qpos, s, attend)
    return _spec_accept(tok, draft, out, pos, active, rem, eosv, kc, vc)


def _lane_positions(pos, k):
    """[B, K] cache positions of a verify step's lanes: pos .. pos+K-1."""
    return pos[:, None] + torch.arange(k, device=pos.device)[None, :]


def _verify_argmax(params, cfg, tok, draft, qpos, s, attend):
    """The layers of a verify step, shared by the contiguous and paged
    caches: lane 0 embeds the pending token, lane j > 0 draft[j-1] (a -1
    sentinel embeds as token 0 and is never accepted), at ``qpos``
    [B, K]. ``attend(i, q, knew, vnew, qmask)`` writes layer ``i``'s lane
    K/V before it gathers, and returns the attention output [B, K,
    H*hd]. Returns the per-lane greedy argmax [B, K]."""
    k = qpos.shape[1]
    dev = tok.device
    toks = torch.cat([tok[:, None], torch.clamp(draft, min=0)], dim=1)
    qmask = (torch.arange(s, device=dev)[None, None, :] <= qpos[:, :, None])
    qmask = qmask[:, None, None]  # [B,1,1,K,S]
    x = _embed(params, toks, cfg)
    rope = _rope_tables(cfg, k, dev, qpos)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        a = _rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, knew, vnew = _qkv(cfg, a, lp, rope)
        x = x + _matw(attend(i, q, knew, vnew, qmask), lp["wo"])
        x = _mlp(cfg, x, lp)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = _matw(x, params["lm_head"]).float()  # [B, K, V]
    return torch.argmax(logits, dim=-1)


def _spec_accept(tok, draft, out, pos, active, rem, eosv, kc, vc):
    """On-device acceptance shared by the contiguous and paged verify
    steps: commit the longest draft prefix matching greedy argmax plus
    one bonus token, truncated by the remaining budget and cut after the
    first emitted EOS. Pure slot-state bookkeeping — every committed
    position's K/V was already written by the verify lanes."""
    b, d = draft.shape
    k = d + 1
    dev = tok.device
    rows = torch.arange(b, device=dev)
    # a = accepted draft prefix length: out[:, j] is the successor of the
    # sequence THROUGH draft[j-1]
    match = (draft == out[:, :d]).long()
    a = torch.cumprod(match, dim=1).sum(dim=1)  # [B] in 0..D
    idx = torch.arange(k, device=dev)[None, :]
    emit = (active[:, None] & (idx < (a + 1)[:, None])
            & (idx < rem[:, None]))
    is_eos = (eosv[:, None] >= 0) & (out == eosv[:, None])
    eos_emitted = (emit & is_eos).long()
    # lanes strictly AFTER the first emitted EOS are cut; the EOS itself
    # is emitted (exclusive running count)
    before = torch.cumsum(eos_emitted, dim=1) - eos_emitted
    emit = emit & (before == 0)
    e = emit.long().sum(dim=1)  # [B] emitted count
    outs = torch.where(emit, out, -1)
    # the new pending token is the LAST emitted one (its K/V is written by
    # the next dispatch's lane 0)
    tok = torch.where(e > 0, out[rows, torch.clamp(e - 1, 0, k - 1)], tok)
    pos = pos + e
    rem = rem - e
    hit = ((eos_emitted > 0) & emit).any(dim=1)
    active = active & ~hit & (rem > 0)
    return outs, tok, pos, active, rem, kc, vc


@torch.no_grad()
def verify_step_slots_paged(
    params: Dict,
    tok: torch.Tensor,
    draft: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    rem: torch.Tensor,
    eosv: torch.Tensor,
    table: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    cfg: LlamaConfig,
    block_size: int,
    kv_quant: str = "off",
    ks: Optional[torch.Tensor] = None,
    vs: Optional[torch.Tensor] = None,
):
    """The paged twin of :func:`verify_step_slots`: lane writes target
    (table[row, (pos+j) // bs], (pos+j) % bs); lanes past the table go
    to scratch. The engine maps every position an accepted run can
    commit before it dispatches. Under ``kv_quant`` the [B, K] lane
    writes flatten into one :func:`_kvq_store` per plane per layer, and
    the result grows ``(ks, vs)``."""
    b, k = draft.shape[0], draft.shape[1] + 1
    bs = block_size
    m = table.shape[1]
    s = m * bs
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    rows = torch.arange(b, device=tok.device)[:, None]
    qpos = _lane_positions(pos, k)
    inb = qpos < s
    wblk = torch.where(
        inb, table[rows, torch.clamp(qpos // bs, 0, m - 1)], 0
    ).reshape(-1)
    woff = torch.where(inb, qpos % bs, 0).reshape(-1)
    rows = _pool_rows(table, kvh)

    def attend(i, q, knew, vnew, qmask):
        _paged_write(kc, vc, ks, vs, i, wblk, woff,
                     knew.reshape(b * k, kvh, hd),
                     vnew.reshape(b * k, kvh, hd), kv_quant)
        return _paged_attend(cfg, q, kc, vc, i, table, rows, qmask, bs,
                             kv_quant, ks, vs)

    out = _verify_argmax(params, cfg, tok, draft, qpos, s, attend)
    acc = _spec_accept(tok, draft, out, pos, active, rem, eosv, kc, vc)
    if kv_quant != "off":
        return acc + (ks, vs)
    return acc


def _sample(logits, temperature, generator, top_k: int, top_p: float):
    """The reference's sampler: greedy at temperature 0, else
    categorical over ``logits / temperature`` after top-k truncation
    and nucleus filtering (exclusive cumulative mass < p, so the first
    token always stays eligible)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    if not top_k and top_p >= 1.0:
        return _categorical(logits / temperature, generator)
    m = top_k if top_k else logits.shape[-1]
    vals, idx = torch.topk(logits, m, dim=-1)
    scaled = vals / temperature
    if top_p < 1.0:
        probs = torch.softmax(scaled, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        scaled = torch.where(cum < top_p, scaled, -math.inf)
    j = _categorical(scaled, generator)
    return torch.gather(idx, 1, j[:, None])[:, 0]


@torch.no_grad()
def generate(
    params: Dict,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    max_new: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Autoregressive generation from a prompt [B, T0] → [B, max_new]:
    greedy at ``temperature == 0``, else sampling with an explicit
    ``generator`` (required) and the top-k / top-p controls. Greedy
    tokens match the reference's; sampled streams are deterministic per
    generator seed but not the reference's ``jax.random`` draws."""
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    if temperature <= 0 and (top_k or top_p < 1.0):
        raise ValueError(
            "top_k/top_p require temperature > 0 "
            "(greedy decoding ignores them)"
        )
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if top_k < 0 or top_k > cfg.vocab:
        raise ValueError(f"top_k must be in [0, vocab], got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if cfg.int8_mxu:
        # the training-only flag would quantize some decode products
        # (_qkv, _mlp) and not others; serving quantizes with
        # quantize_params_int8 instead
        cfg = dataclasses.replace(cfg, int8_mxu=False, int8_wgrad_bf16=False)
    b, t0 = tokens.shape
    dev = tokens.device
    logits, ks, vs = prefill_padded(params, tokens, t0 - 1, cfg)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, t0 + max_new, cfg.head_dim)
    kc = torch.zeros(shape, dtype=ks.dtype, device=dev)
    vc = torch.zeros(shape, dtype=vs.dtype, device=dev)
    kc[:, :, :, :t0] = ks.transpose(2, 3)
    vc[:, :, :, :t0] = vs.transpose(2, 3)
    out = []
    for i in range(max_new):
        tok = _sample(logits, temperature, generator, top_k, top_p)
        out.append(tok)
        if i + 1 < max_new:
            pos = torch.full((b,), t0 + i, dtype=torch.long, device=dev)
            logits, kc, vc = decode_step_slots(params, tok, pos, kc, vc, cfg)
    return torch.stack(out, dim=1)


# -- training -----------------------------------------------------------------


def train_flops_per_token(cfg: LlamaConfig, seq: int) -> float:
    """Model FLOPs per trained token (fwd+bwd), the MFU numerator:
    6 × matmul params (embedding lookup excluded, lm_head included) plus
    causal attention 12·L·(T/2)·d_attn; remat recompute is not counted.
    The formula lives in ``obs/costmodel.py``."""
    return costmodel.train_flops_per_token(cfg, seq)


def make_loss_fn(cfg: LlamaConfig, plan=None, mesh=None):
    """Next-token cross entropy; batch = {tokens [B, T+1]} (plus the
    runtime's optional real-row weights ``_w`` [B]). Per-row mean over T
    of ``logsumexp − target logit`` on the f32 logits, then
    :func:`row_mean`. A sharding ``plan``/``mesh`` raises."""
    require_unsharded(plan, mesh, "llama.make_loss_fn")

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = forward(params, inputs, cfg)
        b, t, v = logits.shape
        ce = F.cross_entropy(logits.reshape(b * t, v),
                             targets.reshape(b * t).long(),
                             reduction="none").reshape(b, t)
        return row_mean(ce.mean(dim=-1), batch)

    return loss_fn


def synthetic_tokens(
    rng: np.random.RandomState, batch: int, seq: int, vocab: int
) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic text: next token correlates with current, so
    the loss curve has signal. The reference's draws, in its order, so
    one seed gives the same arrays on both sides."""
    toks = np.zeros((batch, seq + 1), np.int32)
    toks[:, 0] = rng.randint(0, vocab, batch)
    drift = rng.randint(1, 7, (batch,))
    for t in range(1, seq + 1):
        noise = rng.rand(batch) < 0.1
        toks[:, t] = np.where(
            noise, rng.randint(0, vocab, batch), (toks[:, t - 1] + drift) % vocab
        )
    return {"tokens": toks}
