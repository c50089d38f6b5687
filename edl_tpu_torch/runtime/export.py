"""Inference export, read side — the port of ``edl_tpu/runtime/export.py``.

Reads the reference's export layout unchanged::

    <root>/step-00000042/params.npz     leaf path -> array
    <root>/step-00000042/manifest.json  step, dtype, shapes, model
    <root>/latest                       "step-00000042"

bfloat16 leaves are stored as uint16 views; they decode here with
``torch.from_numpy(a).view(torch.bfloat16)`` (no ml_dtypes needed), so a
load is bit-exact.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.models.convert import to_device
from edl_tpu_torch.utils.device import DeviceLike, resolve_device


def export_status(root: str) -> Optional[Dict[str, Any]]:
    """Manifest of the latest published export (with ``_dir``), or
    None. The ``latest`` pointer is authoritative."""
    ptr = os.path.join(root, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    mpath = os.path.join(root, name, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        doc = json.load(f)
    doc["_dir"] = os.path.join(root, name)
    return doc


def _iter_param_leaves(doc):
    """Yield (key-parts, CPU tensor) for every leaf of an export; the
    zip stays open across the sweep."""
    with np.load(os.path.join(doc["_dir"], "params.npz")) as z:
        for key in z.files:
            arr = np.array(z[key])
            t = torch.from_numpy(arr)
            if doc["dtypes"].get(key) == "bfloat16":
                t = t.view(torch.bfloat16)
            yield key.split("/"), t


def _tree_insert(tree: Dict[str, Any], parts, leaf) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _restore_lists(node):
    """Rebuild dense integer-keyed dicts ({'0': .., '1': ..}) as lists,
    exactly as the reference does."""
    if isinstance(node, dict):
        node = {k: _restore_lists(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
    return node


def load_export(
    root: str, device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Tuple[Any, Dict[str, Any]]:
    """(params tree of tensors on ``device``, manifest) of the latest
    export. ``dtype`` casts the floating leaves (None keeps the stored
    type bit for bit). Runs on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    doc = export_status(root)
    if doc is None:
        raise FileNotFoundError(f"no published export under {root}")
    params: Dict[str, Any] = {}
    for parts, leaf in _iter_param_leaves(doc):
        _tree_insert(params, parts, to_device(leaf, dev, dtype))
    return _restore_lists(params), doc
