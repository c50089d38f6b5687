"""Inference export — the port of ``edl_tpu/runtime/export.py``:
params-only servable artifacts, in the reference's layout::

    <root>/step-00000042/params.npz     leaf path -> array
    <root>/step-00000042/manifest.json  step, dtype, dtypes, shapes,
                                        source, model
    <root>/latest                       "step-00000042"  (renamed last)

Each package reads what the other writes. bfloat16 leaves are stored
as uint16 views (npz has no bf16) and decode with
``torch.from_numpy(a).view(torch.bfloat16)``; no ml_dtypes on either
side, and every load is bit-exact. The ``latest`` pointer is the
publish: renamed into place last, and never moved back to an older
step. Leaf keys come from the checkpoint format's one rule
(:func:`edl_tpu_torch.runtime.checkpoint._leaf_keys`).

Not ported yet (ROADMAP Queue A item 2b, the shard format and the
mesh): :func:`export_from_checkpoint` and :func:`load_export_sharded`,
which raise.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import threading
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.models.convert import to_device
from edl_tpu_torch.models.meta import dtype_from_name, dtype_name
from edl_tpu_torch.utils.device import DeviceLike, resolve_device

_FLOATS = ("float64", "float32", "float16", "bfloat16")

# serializes the read-check-rename publish against concurrent in-process
# writers (background commit threads); one process exports at a time
_publish_lock = threading.Lock()


def _leaf_keys(tree):
    # the ONE key-derivation rule, shared with the checkpoint format
    from edl_tpu_torch.runtime.checkpoint import _leaf_keys as ck

    return ck(tree)


def _cast(t: torch.Tensor, dtype: str) -> torch.Tensor:
    """Cast a float tensor to the export dtype; ints/bools pass
    through, and ``"none"`` keeps every leaf as it is."""
    if dtype_name(t.dtype) not in _FLOATS or dtype == "none":
        return t
    return t.to(dtype_from_name(dtype))


def _store_view(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(npz-safe array, recorded dtype name)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), dtype_name(t.dtype)


def _write_export(
    root: str,
    step: int,
    flat: Dict[str, torch.Tensor],
    dtype: str,
    source: str,
    model: Optional[Dict[str, Any]] = None,
) -> str:
    d = os.path.join(root, f"step-{step:08d}")
    os.makedirs(d, exist_ok=True)
    payload, dtypes, shapes = {}, {}, {}
    for key, t in flat.items():
        t = _cast(t, dtype)
        stored, name = _store_view(t)
        payload[key] = stored
        dtypes[key] = name
        shapes[key] = list(t.shape)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, os.path.join(d, "params.npz"))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    os.close(fd)
    with open(tmp, "w") as f:
        json.dump(
            {
                "step": step,
                "dtype": dtype,
                "dtypes": dtypes,
                "shapes": shapes,
                "source": source,
                # architecture record (e.g. ResNetConfig.to_meta()): a
                # consumer rebuilds the model from it alone
                "model": model or {},
            },
            f,
        )
    os.replace(tmp, os.path.join(d, "manifest.json"))
    # the latest pointer is the publish, renamed into place LAST; a
    # monotonic max-write, so a slow writer never moves it back past a
    # newer publish (its dir stays unpointed and the GC reaps it)
    with _publish_lock:
        cur = export_status(root)
        if cur is None or int(cur["step"]) < step:
            fd, tmp = tempfile.mkstemp(dir=root)
            with os.fdopen(fd, "w") as f:
                f.write(os.path.basename(d))
            os.replace(tmp, os.path.join(root, "latest"))
        _gc_exports(root, keep=2)
    return d


def _gc_exports(root: str, keep: int = 2) -> None:
    """Reap superseded export dirs: the pointed one, the newest
    ``keep - 1`` below it, and anything newer (a publish in progress)
    survive."""
    doc = export_status(root)
    if doc is None:
        return
    pointed = os.path.basename(doc["_dir"])
    dirs = sorted(d for d in os.listdir(root) if d.startswith("step-"))
    older = [d for d in dirs if d <= pointed and d != pointed]
    victims = older[: max(0, len(older) - (keep - 1))]
    for d in victims:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def export_params(
    root: str,
    params: Any,
    step: int,
    dtype: str = "bfloat16",
    source: str = "in-process",
    model_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Export a param tree of tensors (on any device) as ``dtype``
    (``"bfloat16"``, ``"float32"``, ... or ``"none"``). Returns the
    export step directory."""
    flat = {key: leaf.detach().cpu() for key, leaf in _leaf_keys(params)}
    return _write_export(root, step, flat, dtype, source, model=model_meta)


def export_from_checkpoint(ckpt_root: str, export_root: str,
                           dtype: str = "bfloat16", ram=None,
                           model_meta: Optional[Dict[str, Any]] = None):
    """The reference assembles an export from a sharded checkpoint; the
    shard format is not ported yet."""
    raise NotImplementedError(
        "export_from_checkpoint is not ported yet (ROADMAP item 2b: the "
        "sharded checkpoint format)")


def load_export_sharded(root: str, mesh, pspecs):
    """The reference loads an export onto a device mesh; the mesh is
    not ported yet."""
    raise NotImplementedError(
        "load_export_sharded is not ported yet (ROADMAP item 2b: the "
        "device mesh)")


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


def _stored_array(path: str, zf: zipfile.ZipFile, name: str, f):
    """Member ``name`` of the npz at ``path`` as a copy-on-write memory
    map of its bytes in the archive, or None where it cannot be mapped
    (compressed, or an object array). ``np.savez`` stores members
    uncompressed, so the array is read in place: no zip read, no CRC
    pass and no intermediate copies of the leaf."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    local = f.read(30)  # the member's local header; then its name, extra
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    f.seek(info.header_offset + 30 + name_len + extra_len)
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    if dtype.hasobject:
        return None
    if not int(np.prod(shape)):
        return np.empty(shape, dtype, order="F" if fortran else "C")
    return np.memmap(path, dtype=dtype, mode="c", offset=f.tell(),
                     shape=shape, order="F" if fortran else "C")


def _iter_param_leaves(doc):
    """Yield (key-parts, CPU tensor) for every leaf of an export; the
    zip stays open across the sweep. Uncompressed leaves are memory
    maps of the archive (copy-on-write), so a load to the card copies
    each leaf once, from the page cache."""
    path = os.path.join(doc["_dir"], "params.npz")
    with np.load(path) as z, open(path, "rb") as f:
        for key in z.files:
            arr = _stored_array(path, z.zip, key + ".npy", f)
            if arr is None:
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
        out = to_device(leaf, dev, dtype)
        if out.data_ptr() == leaf.data_ptr():
            out = out.clone()  # the params own their memory, not the map
        _tree_insert(params, parts, out)
    return _restore_lists(params), doc
