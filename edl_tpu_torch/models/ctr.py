"""CTR deep model — the port of ``edl_tpu/models/ctr.py``, the
Criteo-style click-through-rate predictor that ``BASELINE.json`` names
as the elastic workload: 13 dense features, 26 hashed sparse slots over
one shared embedding table, a 400-400-400 ReLU MLP, a sigmoid output
and the log loss (reference workload: example/ctr/ctr/train.py:183-235).

Params are a dict-of-tensors tree with the reference's keys
(``embedding`` [V, E]; ``mlp``: a list of {``w``, ``b``}; ``out``:
{``w`` [400, 1], ``b`` [1]}). The lookup is
:func:`edl_tpu_torch.ops.embedding.embedding_lookup`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from edl_tpu_torch.models.losses import row_mean
from edl_tpu_torch.ops.embedding import embedding_lookup
from edl_tpu_torch.utils.device import DeviceLike, resolve_device
from edl_tpu_torch.utils.tree import leaves, replace_leaves

N_DENSE = 13  # Criteo dense feature count
N_SPARSE = 26  # Criteo categorical slots
DEFAULT_EMBEDDING = 16  # reference default 10 (train.py:46-49); 16 tiles lanes
DEFAULT_VOCAB = 2**20  # reference: sparse_feature_dim hash space
MLP_DIMS = (400, 400, 400)  # reference network_conf fc stack


def init_params(
    generator: torch.Generator,
    vocab: int = DEFAULT_VOCAB,
    emb: int = DEFAULT_EMBEDDING,
    mlp_dims: Tuple[int, ...] = MLP_DIMS,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Dict:
    """Random params with the reference's shapes and scales (normal
    table / sqrt(E); He-normal MLP weights; LeCun-normal output; zero
    biases), drawn from ``generator`` where it lives, one draw per leaf
    in the reference's order, then placed on ``device`` (CUDA unless
    ``"cpu"`` is named). The draws are not the reference's
    ``jax.random`` bits; to compare the two, carry weights across with
    :func:`edl_tpu_torch.models.convert.ctr_params_from_numpy`."""
    dev = resolve_device(device)

    def normal(*shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(device=dev, dtype=dtype)

    params: Dict = {"embedding": normal(vocab, emb, scale=1 / math.sqrt(emb))}
    in_dim = N_SPARSE * emb + N_DENSE
    layers = []
    for out_dim in mlp_dims:
        layers.append({
            "w": normal(in_dim, out_dim, scale=math.sqrt(2.0 / in_dim)),
            "b": torch.zeros(out_dim, device=dev, dtype=dtype),
        })
        in_dim = out_dim
    params["mlp"] = layers
    params["out"] = {
        "w": normal(in_dim, 1, scale=math.sqrt(1.0 / in_dim)),
        "b": torch.zeros(1, device=dev, dtype=dtype),
    }
    return params


def forward(params, dense: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
    """Logits [B] for dense [B, 13] float and sparse [B, 26] ids."""
    emb = embedding_lookup(params["embedding"], sparse)  # [B, 26, E]
    x = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
    for layer in params["mlp"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return (x @ params["out"]["w"] + params["out"]["b"])[:, 0]


def make_loss_fn(compute_dtype: torch.dtype = torch.float32):
    """Stable sigmoid cross entropy with the forward in
    ``compute_dtype`` (bf16 feeds the tensor cores; params and the
    optimizer stay f32): every float leaf is cast, biases too — one f32
    leaf in a bias add would promote the activation back to f32. The
    loss is always f32, reduced by :func:`row_mean`."""

    def _loss(params, batch):
        if compute_dtype != torch.float32:
            params = replace_leaves(params, [
                p.to(compute_dtype) if p.is_floating_point() else p
                for p in leaves(params)])
        logits = forward(params, batch["dense"].to(compute_dtype),
                         batch["sparse"]).float()
        # reshape, not broadcast: a [N, 1] label column against [N]
        # logits would silently blow per_row up to [N, N]
        labels = batch["label"].float().reshape(logits.shape)
        per_row = (torch.clamp_min(logits, 0) - logits * labels
                   + torch.log1p(torch.exp(-logits.abs())))
        return row_mean(per_row, batch)

    return _loss


# Sigmoid cross entropy at f32, the default loss; bf16 via make_loss_fn.
loss_fn = make_loss_fn()


def batch_auc(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Batch AUC via the rank statistic (0.5 when the batch holds one
    class). Labels are flattened to [N]: a [N, 1] column would silently
    broadcast the rank sum to [N, N]."""
    labels = labels.reshape(-1)
    if labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"labels {tuple(labels.shape)} do not match logits "
            f"{tuple(logits.shape)}"
        )
    n = logits.shape[0]
    order = torch.argsort(logits, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=logits.device)
    pos = labels > 0.5
    n_pos = pos.sum()
    n_neg = n - n_pos
    sum_pos_ranks = torch.where(pos, ranks, 0).sum()
    auc = ((sum_pos_ranks - n_pos * (n_pos - 1) / 2.0)
           / torch.clamp_min(n_pos * n_neg, 1))
    return torch.where((n_pos == 0) | (n_neg == 0), 0.5, auc)


def synthetic_batch(
    rng: np.random.RandomState, batch: int, vocab: int = DEFAULT_VOCAB
) -> Dict[str, np.ndarray]:
    """Click-biased synthetic Criteo-shaped data: the label correlates
    with dense feature 0, so AUC is learnable. The reference's draws in
    its order, so one seed gives byte-identical arrays on both sides."""
    dense = rng.rand(batch, N_DENSE).astype(np.float32)
    sparse = rng.randint(0, vocab, size=(batch, N_SPARSE), dtype=np.int32)
    click_prob = 1.0 / (1.0 + np.exp(-(8.0 * dense[:, 0] - 4.0)))
    label = (rng.rand(batch) < click_prob).astype(np.int32)
    return {"dense": dense, "sparse": sparse, "label": label}
