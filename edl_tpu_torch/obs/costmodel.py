"""Analytic FLOPs — the port's copy of the train-FLOPs formulas of
``edl_tpu/obs/costmodel.py`` (the MFU numerators): a Llama-family
config's per token, and the CTR tower's per example.

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
