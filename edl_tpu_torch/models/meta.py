"""Shared architecture-record helper for export manifests — the port of
``edl_tpu/models/meta.py``.

One rule for "config dataclass → JSON-safe dict" (resnet and bert use
it as it is; llama hand-picks its serving fields). The record is the
reference's, key for key: a dtype is written as its name
(``"bfloat16"``, ``"float32"``), tuples as lists, so an export written
by either package carries the same ``model`` record.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (NumPy's and JAX's name)."""
    return str(dtype).replace("torch.", "")


def dtype_from_name(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unsupported dtype {name!r}")
    return dt


def dataclass_meta(cfg: Any, family: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {"family": family}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = dtype_name(v)
        elif isinstance(v, tuple):
            v = list(v)  # JSON round-trip safe
        out[f.name] = v
    return out


def dataclass_from_meta(cls, meta: Dict[str, Any], family: str):
    """Rebuild a config dataclass from its export architecture record —
    the inverse of :func:`dataclass_meta`. Unknown keys are ignored
    (forward compat); a family mismatch is a hard error, so a consumer
    can never run the wrong forward over an export's weights."""
    got = meta.get("family")
    if got != family:
        raise ValueError(f"not a {family} export: family={got!r}")
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in meta:
            continue
        v = meta[f.name]
        if f.name == "dtype":
            v = dtype_from_name(v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)
