"""ResNet-class convolutional classifier — the port of
``edl_tpu/models/resnet.py``, the vision elastic-DP workload.

The reference's construction and tree, unchanged: NHWC images at the
API, HWIO conv kernels, GroupNorm (stateless) in place of BatchNorm,
bf16 compute over f32 params, and ``stages`` as a list of lists of
blocks, so an export passes between the two packages as it is and
:func:`edl_tpu_torch.models.convert.params_from_numpy` carries weights
across. The reference computes its convolutions in XLA
(``lax.conv_general_dilated``), not in Pallas; here they are
``F.conv2d`` on ``channels_last`` views of the same memory (an NHWC
tensor permuted to NCHW, an HWIO kernel permuted to OIHW).

XLA's ``padding="SAME"`` is not symmetric: a dimension of size ``n``
under kernel ``k`` and stride ``s`` is padded by ``max((ceil(n/s) - 1)
* s + k - n, 0)`` in all, the low side getting the floor of half. On an
even input a 3 x 3 stride-2 conv is padded (0, 1), where
``F.conv2d(padding=1)`` would pad (1, 1) and shift every downsampled
map by one pixel; :func:`_conv` pads by XLA's rule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.models.losses import row_mean
from edl_tpu_torch.models.meta import dataclass_from_meta, dataclass_meta
from edl_tpu_torch.utils.device import (DeviceLike, require_unsharded,
                                        resolve_device)


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    widths: Tuple[int, ...] = (256, 512, 1024, 2048)
    blocks_per_stage: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50-ish
    stem_width: int = 128
    groups: int = 32  # GroupNorm groups
    dtype: Any = torch.bfloat16

    def to_meta(self) -> dict:
        """JSON-safe architecture record for export manifests (the one
        shared rule: models/meta.py)."""
        return dataclass_meta(self, "resnet")

    @classmethod
    def from_meta(cls, meta: dict) -> "ResNetConfig":
        return dataclass_from_meta(cls, meta, "resnet")

    @classmethod
    def resnet50(cls) -> "ResNetConfig":
        return cls()

    @classmethod
    def tiny(cls, num_classes: int = 10) -> "ResNetConfig":
        return cls(
            num_classes=num_classes,
            widths=(16, 32),
            blocks_per_stage=(1, 1),
            stem_width=16,
            groups=4,
            dtype=torch.float32,
        )


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device: DeviceLike = None) -> Dict:
    """Random f32 params with the reference's shapes and scales
    (He-normal conv kernels, unit GroupNorm scales, zero shifts, a
    LeCun-normal head), drawn from ``generator`` in the reference's leaf
    order and placed on ``device`` (CUDA unless ``"cpu"`` is named)."""
    dev = resolve_device(device)

    def normal(*shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dev)

    def conv(kh, kw, cin, cout):
        return normal(kh, kw, cin, cout, scale=math.sqrt(2.0 / (kh * kw * cin)))

    def gn(c):
        return {"g": torch.ones(c, device=dev), "b": torch.zeros(c, device=dev)}

    params: Dict = {
        "stem": conv(3, 3, 3, cfg.stem_width),
        "stem_gn": gn(cfg.stem_width),
        "stages": [],
    }
    cin = cfg.stem_width
    for width, n_blocks in zip(cfg.widths, cfg.blocks_per_stage):
        stage = []
        for _ in range(n_blocks):
            blk = {"conv1": conv(3, 3, cin, width), "gn1": gn(width),
                   "conv2": conv(3, 3, width, width), "gn2": gn(width)}
            if cin != width:
                blk["proj"] = conv(1, 1, cin, width)
            stage.append(blk)
            cin = width
        params["stages"].append(stage)
    params["head"] = {
        "w": normal(cin, cfg.num_classes, scale=math.sqrt(1.0 / cin)),
        "b": torch.zeros(cfg.num_classes, device=dev),
    }
    return params


def param_pspecs(cfg: ResNetConfig, plan) -> Dict:
    """The reference's partition specs need a mesh, which is not ported
    yet: a plan that shards anything raises. On one device every leaf
    is whole (``None``), in a tree that mirrors :func:`init_params`'."""
    require_unsharded(plan, None, "resnet.param_pspecs")
    gn = {"g": None, "b": None}
    stages = []
    cin = cfg.stem_width
    for width, n_blocks in zip(cfg.widths, cfg.blocks_per_stage):
        stage = []
        for _ in range(n_blocks):
            blk = {"conv1": None, "gn1": dict(gn), "conv2": None,
                   "gn2": dict(gn)}
            if cin != width:
                blk["proj"] = None
            stage.append(blk)
            cin = width
        stages.append(stage)
    return {"stem": None, "stem_gn": dict(gn), "stages": stages,
            "head": {"w": None, "b": None}}


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` for one dimension: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` (*) HWIO ``w`` → NHWC, XLA's SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
    pad = 0
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])  # symmetric: the conv pads without a copy
    else:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    # the cast writes the OIHW kernel in channels_last (HWIO's memory
    # order is O-innermost), the layout cuDNN takes beside NHWC input
    w = w.permute(3, 2, 0, 1).to(x.dtype, memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _groupnorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (H, W, the channels of a group) in f32 with the
    population variance; scale and shift in f32, cast to x's dtype."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), groups, g.float(),
                     b.float(), eps)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def forward(params: Dict, images: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] → logits [B, num_classes] (f32)."""
    x = images.to(cfg.dtype)
    x = _conv(x, params["stem"])
    x = F.relu(_groupnorm(x, params["stem_gn"]["g"], params["stem_gn"]["b"],
                          cfg.groups))
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if bi == 0 and si > 0 else 1
            y = _conv(x, blk["conv1"], stride=stride)
            y = F.relu(_groupnorm(y, blk["gn1"]["g"], blk["gn1"]["b"],
                                  cfg.groups))
            y = _conv(y, blk["conv2"])
            y = _groupnorm(y, blk["gn2"]["g"], blk["gn2"]["b"], cfg.groups)
            sc = x
            if "proj" in blk:
                sc = _conv(sc, blk["proj"], stride=stride)
            elif stride != 1:
                sc = sc[:, ::stride, ::stride]
            x = F.relu(y + sc)
    x = x.mean(dim=(1, 2))  # global average pool
    head = params["head"]
    return (x @ head["w"].to(x.dtype) + head["b"].to(x.dtype)).float()


def make_loss_fn(cfg: ResNetConfig):
    """Softmax cross entropy; batch = {images [B,H,W,3], label [B]}
    (plus the runtime's optional real-row weights ``_w``)."""

    def loss_fn(params, batch):
        logits = forward(params, batch["images"], cfg)
        ce = F.cross_entropy(logits, batch["label"].long(), reduction="none")
        return row_mean(ce, batch)

    return loss_fn


def forward_flops(cfg: ResNetConfig, size: int) -> float:
    """Forward FLOPs an image of ``size`` x ``size``: 2 x MACs of every
    conv (at its output size) and the head; norms and pooling are not
    counted."""
    def out(n, s):
        return -(-n // s)

    flops = 2.0 * size * size * 9 * 3 * cfg.stem_width
    n, cin = size, cfg.stem_width
    for si, (width, n_blocks) in enumerate(zip(cfg.widths,
                                               cfg.blocks_per_stage)):
        for bi in range(n_blocks):
            s = 2 if bi == 0 and si > 0 else 1
            m = out(n, s)
            flops += 2.0 * m * m * 9 * (cin * width + width * width)
            if cin != width:
                flops += 2.0 * m * m * cin * width
            n, cin = m, width
    return flops + 2.0 * cin * cfg.num_classes


def synthetic_batch(
    rng: np.random.RandomState, batch: int, size: int = 32,
    num_classes: int = 10,
) -> Dict[str, np.ndarray]:
    """Class-dependent brightness pattern so the loss is learnable (the
    reference's draws, in its order)."""
    label = rng.randint(0, num_classes, size=batch, dtype=np.int32)
    images = rng.rand(batch, size, size, 3).astype(np.float32)
    images += (label / num_classes)[:, None, None, None]
    return {"images": images, "label": label}
