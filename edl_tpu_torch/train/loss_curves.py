"""The loss curves of the small workloads' training recipes under other
compute dtypes and learning rates, from the same initial params and
batch: tells a loss spike that Adam's step size causes from one that
bf16 rounding causes.

    python -m edl_tpu_torch.train.loss_curves [--steps N] [--tiny]
        [--device cpu|cuda]

For each model (ResNet-50, ``ResNetConfig.resnet50()``, on the
reference's 32 x 32 ``synthetic_batch`` of 128 images; BERT-base,
``BertConfig.base()``, on ``synthetic_mlm_batch`` B32 T512) and each arm
of ARMS, it draws the params from ``torch.Generator(device)
.manual_seed(0)`` and the batch from ``RandomState(0)`` (the recipe of
``chip_smoke.py``'s small_workloads phase), then takes ``--steps``
``adam(lr)`` steps through ``make_train_step`` on that one batch with
the config's compute dtype replaced by the arm's (f32 with TF32 off in
cuBLAS and cuDNN). Prints one JSON line an arm: every loss, the first,
the largest and its step, and the last. ``--tiny`` runs ``tiny()``
configs at small batches (a check of the script on the CPU). Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from edl_tpu_torch.utils.device import resolve_device

# (compute dtype, Adam's learning rate): the recipe's own arm first
ARMS = (("bfloat16", 1e-3), ("float32", 1e-3), ("bfloat16", 1e-4))
FULL = {"resnet": {"batch": 128, "size": 32}, "bert": {"batch": 32, "seq": 512}}
TINY = {"resnet": {"batch": 8, "size": 8}, "bert": {"batch": 2, "seq": 16}}


def _model(name: str, tiny: bool, rng: np.random.RandomState):
    """(config, loss_fn maker, init, numpy batch) of one model."""
    from edl_tpu_torch.models import bert, resnet

    shape = (TINY if tiny else FULL)[name]
    if name == "resnet":
        cfg = resnet.ResNetConfig.tiny() if tiny else resnet.ResNetConfig.resnet50()
        batch = resnet.synthetic_batch(rng, shape["batch"], size=shape["size"])
        return cfg, resnet.make_loss_fn, resnet.init_params, batch
    cfg = bert.BertConfig.tiny() if tiny else bert.BertConfig.base()
    batch = bert.synthetic_mlm_batch(rng, shape["batch"], shape["seq"],
                                     cfg.vocab)
    return cfg, bert.make_loss_fn, bert.init_params, batch


def run_arm(name: str, dtype: str, lr: float, steps: int, tiny: bool,
            device) -> Dict:
    """Losses of ``steps`` ``adam(lr)`` steps of ``name`` computed in
    ``dtype`` from seed 0's params and batch."""
    from edl_tpu_torch.train import trainer

    dev = resolve_device(device)
    cfg, make_loss_fn, init, nb = _model(name, tiny, np.random.RandomState(0))
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    params = init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    tx = trainer.adam(lr)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(make_loss_fn(cfg), tx)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    peak = int(np.argmax(losses))
    return {"model": name, "config": "tiny" if tiny else "full", "dtype": dtype,
            "lr": lr, "steps": steps, "first": losses[0],
            "max": losses[peak], "max_step": peak, "last": losses[-1],
            "losses": losses}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=21)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in ("resnet", "bert"):
            for dtype, lr in ARMS:
                print(json.dumps(run_arm(name, dtype, lr, args.steps,
                                         args.tiny, args.device)), flush=True)
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
