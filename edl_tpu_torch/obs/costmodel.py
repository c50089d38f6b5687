"""Analytic FLOPs and bytes — the port's copy of formulas of
``edl_tpu/obs/costmodel.py``: the train FLOPs (the MFU numerators) of a
Llama-family config per token and of the CTR tower per example, and
the decode roofline's bytes (params, the KV cache and its scale
planes: ``decode_step_bytes``).

Configs are duck typed: anything with ``vocab / d_model / n_layers /
n_heads / n_kv_heads / d_ff`` works. Device peaks are not here: the
port reads its card's numbers where it measures (``chip_smoke.py``).
"""

from __future__ import annotations


def _dims(cfg):
    hd = getattr(cfg, "head_dim", None)
    if hd is None:
        hd = cfg.d_model // cfg.n_heads
    return (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd, cfg.d_ff,
            cfg.n_layers, cfg.vocab)


def matmul_params(cfg) -> float:
    """Parameters participating in matmuls per token (embedding lookup
    excluded, lm_head included) — the ``N`` of the 6N rule."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    per_layer = (
        d * h * hd  # wq
        + 2 * d * kv * hd  # wk, wv
        + h * hd * d  # wo
        + 3 * d * ff  # w1, w3, w2
    )
    return L * per_layer + d * V  # + lm_head


def n_params(cfg) -> float:
    """Total parameter count: embed + layers + ln_f + lm_head."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    per_layer = (
        2 * d  # ln1, ln2
        + d * h * hd + 2 * d * kv * hd + h * hd * d
        + 3 * d * ff
    )
    return V * d + L * per_layer + d + d * V


def param_bytes(cfg, bytes_per_param: int = 2) -> float:
    """Weight bytes a decode step streams (bf16 export default)."""
    return n_params(cfg) * bytes_per_param


def kv_cache_bytes(
    cfg, slots: int, max_len: int, bytes_per_el: float = 2
) -> float:
    """The K + V cache pair of ``slots`` x ``max_len`` positions;
    ``bytes_per_el`` may be fractional (packed int4 KV = 0.5)."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 2.0 * L * slots * max_len * kv * hd * bytes_per_el


def kv_scale_bytes(cfg, slots: int, s_pad: int, kv_block_size: int) -> float:
    """The per-block-per-kv-head f32 K + V scale planes a quantized
    decode step reads over ``ceil(s_pad / block)`` blocks a slot; 0
    when ``kv_block_size`` is 0 (unquantized)."""
    if kv_block_size <= 0:
        return 0.0
    d, h, kv, hd, ff, L, V = _dims(cfg)
    blocks = -(-s_pad // kv_block_size)
    return 2.0 * L * slots * blocks * kv * 4.0


def decode_step_bytes(
    cfg, param_bytes_total: float, b: int, s_pad: int,
    kv_bytes_per_el: float = 2, kv_block_size: int = 0,
) -> float:
    """Bytes one decode step must move: every parameter byte plus the
    whole padded KV cache (the masked dense decode attention reads all
    ``s_pad`` positions every step) and, for quantized paged KV, its
    scale planes. The numerator of ``decode_pct_peak_bw``."""
    return (
        param_bytes_total
        + kv_cache_bytes(cfg, b, s_pad, kv_bytes_per_el)
        + kv_scale_bytes(cfg, b, s_pad, kv_block_size)
    )


def attn_flops_per_token_train(cfg, seq: int) -> float:
    """Causal attention fwd+bwd: 12·L·(T/2)·d_attn per token."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 12.0 * L * (seq / 2.0) * (h * hd)


def train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per trained token (fwd+bwd): 6 × matmul params plus
    causal attention. Remat recompute is NOT counted (MFU counts model
    FLOPs, not hardware FLOPs)."""
    return 6.0 * matmul_params(cfg) + attn_flops_per_token_train(cfg, seq)


def ctr_train_flops_per_example(
    emb: int = 16, mlp_dims=(400, 400, 400, 1), n_sparse: int = 26,
    n_dense: int = 13,
) -> float:
    """6 x matmul params of the Criteo-shaped CTR tower (models/ctr.py
    defaults). The embedding gather itself is bandwidth, not FLOPs."""
    in_dim = n_dense + n_sparse * emb
    total = 0.0
    for out_dim in mlp_dims:
        total += in_dim * out_dim
        in_dim = out_dim
    return 6.0 * total
