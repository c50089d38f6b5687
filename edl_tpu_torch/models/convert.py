"""Weights carried across: NumPy param trees → the port's torch trees.

The reference's param tree (a nested dict of ``jax.Array``), read out
as NumPy with ``np.asarray``, becomes the port's tree of tensors with
the same keys. bfloat16 leaves (``ml_dtypes.bfloat16`` on the NumPy
side) are reinterpreted bit for bit, so no leaf changes value in
transit; ``dtype`` then casts the floating leaves (the port serves in
``cfg.dtype``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from edl_tpu_torch.utils.device import DeviceLike, resolve_device


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """CPU tensor holding exactly ``arr``'s values; bfloat16 arrays go
    through their uint16 bit pattern (NumPy has no native bf16)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def to_device(leaf: torch.Tensor, dev: torch.device,
              dtype: Optional[torch.dtype]) -> torch.Tensor:
    if dtype is not None and leaf.is_floating_point():
        leaf = leaf.to(dtype)
    return leaf.to(dev)


def params_from_numpy(
    tree: Any, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Any:
    """Nested dict/list of NumPy arrays → the same structure of tensors
    on ``device`` (CUDA unless ``"cpu"`` is named), floating leaves cast
    to ``dtype`` when given."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return to_device(tensor_from_numpy(node), dev, dtype)

    return conv(tree)


def ctr_params_from_numpy(
    tree: Any, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Any:
    """The reference's CTR param tree (``edl_tpu/models/ctr.py``, read
    out as NumPy) → the port's (:mod:`edl_tpu_torch.models.ctr`):
    ``embedding``, ``mlp`` (a list of {``w``, ``b``}) and ``out``. Raises
    on any other top-level key, so a llama tree is not mistaken for
    it."""
    if set(tree) != {"embedding", "mlp", "out"}:
        raise ValueError(f"not a CTR param tree: keys {sorted(tree)}")
    return params_from_numpy(tree, device, dtype)
