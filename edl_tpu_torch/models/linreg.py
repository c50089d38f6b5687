"""fit_a_line — the port of ``edl_tpu/models/linreg.py``: one dense
layer regressing 13 UCI-housing-shaped features to 1 target under
squared error, on a fixed random linear problem (the reference's
``synthetic_dataset``, draw for draw).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from edl_tpu_torch.models.losses import row_mean
from edl_tpu_torch.utils.device import DeviceLike, resolve_device

N_FEATURES = 13  # uci_housing feature width


def init_params(generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``w`` [13, 1] normal x 0.01 drawn from ``generator``, ``b`` [1]
    zeros, both f32 on ``device`` (CUDA unless ``"cpu"`` is named). The
    draws are not the reference's ``jax.random`` bits; carry weights
    across with :func:`edl_tpu_torch.models.convert.params_from_numpy`."""
    dev = resolve_device(device)
    w = torch.randn((N_FEATURES, 1), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return {"w": w.mul_(0.01).to(dev),
            "b": torch.zeros(1, device=dev, dtype=torch.float32)}


def predict(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def loss_fn(params, batch) -> torch.Tensor:
    """Mean squared error, reduced by :func:`row_mean`."""
    pred = predict(params, batch["x"])
    return row_mean(((pred - batch["y"]) ** 2).mean(dim=-1), batch)


def synthetic_dataset(
    n: int, seed: int = 0, noise: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """A fixed random linear problem so loss-goes-down is testable."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(N_FEATURES, 1).astype(np.float32)
    x = rng.randn(n, N_FEATURES).astype(np.float32)
    y = x @ w_true + noise * rng.randn(n, 1).astype(np.float32)
    return x, y
