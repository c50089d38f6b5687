"""Device selection — beside ``utils/platform.py`` (the port's
counterpart of ``edl_tpu/utils/platform.py``, the process pool).

The reference forces a virtual CPU platform for hardware-free tests.
The port's rule is the opposite direction: every entry point runs on
CUDA unless the caller asks for the CPU by name, and nothing silently
moves to the CPU when no card is present.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when CUDA is unavailable); ``"cpu"``
    → the CPU; any CUDA device string is checked against the runtime.
    Anything else raises."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (use cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tree_device(tree) -> Optional[torch.device]:
    """Device of the first tensor leaf of a nested dict/list tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return None
    for v in items:
        d = tree_device(v)
        if d is not None:
            return d
    return None


def require_unsharded(plan=None, mesh=None, what: str = "this path") -> None:
    """Raise unless ``plan``/``mesh`` describe one device: for the paths
    that take whole params only (the MoE's, BERT's and ResNet's
    partition specs; the one-device staging). ``plan`` is duck typed as
    the reference's ``MeshPlan`` (``axes`` = ((name, size), ...))."""
    sharded = [(a, n) for a, n in getattr(plan, "axes", ()) if n > 1]
    if mesh is not None or sharded:
        raise NotImplementedError(
            f"{what}: mesh/sharding plans {sharded or mesh} are not ported "
            f"yet here (ROADMAP Queue A, item 2b's second half); this path "
            f"takes whole params"
        )
