"""Chunked evaluation math — the port of ``edl_tpu/models/evals.py``:
the held-out metrics that the offline scorer (``runtime/predict.py``,
``python -m edl_tpu_torch predict``) publishes.

Everything is chunked: LM heads emit [rows, T, vocab] f32 logits, and
one unchunked call over a real split would not fit. Rows arrive as
NumPy; each chunk goes to the device of the params. ``logits_fn(params,
tokens)`` takes and returns tensors; it runs with grad off.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.utils.device import tree_device

CHUNK = 64  # rows per forward


def _argmax(logits: torch.Tensor) -> np.ndarray:
    # torch.argmax keeps the first maximum, as jnp.argmax does
    return logits.argmax(-1).to(torch.int32).cpu().numpy()


@torch.no_grad()
def lm_scan(
    logits_fn: Callable, params, toks: np.ndarray, chunk: int = CHUNK
) -> Tuple[np.ndarray, float, int]:
    """One chunked pass over ``toks [N, T]``: (greedy next token after
    the last position [N], total next-token CE, CE count). CE covers
    positions 0..T-2 predicting 1..T-1 (empty when T < 2)."""
    toks = np.asarray(toks)
    dev = tree_device(params)
    nxt = []
    total, count = 0.0, 0
    for s in range(0, len(toks), chunk):
        t = torch.as_tensor(toks[s : s + chunk], device=dev)
        logits = logits_fn(params, t)
        nxt.append(_argmax(logits[:, -1]))
        if toks.shape[1] >= 2:
            v = logits.shape[-1]
            ce = F.cross_entropy(logits[:, :-1].float().reshape(-1, v),
                                 t[:, 1:].reshape(-1).long(),
                                 reduction="none")
            total += float(ce.sum())
            count += ce.numel()
    return (np.concatenate(nxt) if nxt else np.zeros((0,), np.int32),
            total, count)


def lm_ppl(logits_fn: Callable, params, toks: np.ndarray,
           chunk: int = CHUNK) -> float:
    """Next-token perplexity over ``toks [N, T]``."""
    _, total, count = lm_scan(logits_fn, params, toks, chunk)
    return float(np.exp(total / max(count, 1)))


@torch.no_grad()
def masked_top1(
    logits_fn: Callable, params, rows: Dict[str, np.ndarray],
    chunk: int = CHUNK,
) -> Tuple[float, np.ndarray]:
    """(masked top-1 accuracy, per-position predictions [N, T]) over
    ``{tokens, mask, targets}`` MLM rows — accuracy counted only where
    mask > 0; 0.0 when nothing is masked."""
    toks = np.asarray(rows["tokens"])
    dev = tree_device(params)
    preds = []
    correct = total = 0
    for s in range(0, len(toks), chunk):
        sl = slice(s, s + chunk)
        pred = _argmax(logits_fn(params, torch.as_tensor(toks[sl],
                                                         device=dev)))
        preds.append(pred)
        if "mask" in rows and "targets" in rows:
            mask = np.asarray(rows["mask"][sl]) > 0
            correct += int(
                (pred[mask] == np.asarray(rows["targets"][sl])[mask]).sum()
            )
            total += int(mask.sum())
    return (
        correct / max(total, 1) if total else 0.0,
        np.concatenate(preds) if preds else np.zeros_like(toks),
    )
