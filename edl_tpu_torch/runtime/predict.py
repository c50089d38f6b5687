"""Batch prediction from a published export — the port of
``edl_tpu/runtime/predict.py``: the scoring consumer for every family.

An export carries an architecture record (``model`` in its manifest),
and this module rebuilds the family's config and forward from that
record alone: a consumer needs the export directory and a batch of
rows, not the training repo config.

====== ======================= ===========================================
family rows (npz keys)         outputs
====== ======================= ===========================================
ctr    dense [B,13] f32,       prob [B] (sigmoid click probability);
       sparse [B,26] i32,      auc when label present
       label [B] (optional)
resnet images [B,H,W,C] f32,   class [B] top-1; acc when label present
       label [B] (optional)
bert   tokens [B,T] i32,       pred [B,T] top-1 token per position;
       mask/targets (optional) masked_acc when mask+targets present
llama  tokens [B,T] i32        next_token [B] (argmax after the last
                               position); ppl over the batch when T >= 2
====== ======================= ===========================================

Params load onto the card (or the device named) as stored, and the
forwards run there in chunks of ``models/evals.CHUNK`` rows with grad
off. Not ported yet: the ``moe`` family (ROADMAP Queue A item 7), a
sharded load over ``mesh_spec`` (item 2b), and rows from a shards-dir
dataset (``load_rows(data_dir=...)``, ``runtime/shards.py``, item 6);
each raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.models.evals import CHUNK as _CHUNK  # one chunking rule
from edl_tpu_torch.utils.device import DeviceLike, tree_device
from edl_tpu_torch.utils.tree import leaves, replace_leaves


def _chunks(n: int):
    for s in range(0, n, _CHUNK):
        yield slice(s, min(s + _CHUNK, n))


def load_params_for_predict(
    export_dir: str, mesh_spec: Optional[str] = None,
    device: DeviceLike = None,
) -> Tuple[Any, Dict[str, Any]]:
    """(params, manifest) of the latest export, on ``device`` (CUDA
    unless ``"cpu"`` is named), each leaf as stored. A ``mesh_spec``
    raises: the sharded load is not ported yet."""
    from edl_tpu_torch.runtime.export import load_export

    if mesh_spec:
        raise NotImplementedError(
            "predict over a mesh is not ported yet (ROADMAP Queue A item "
            "2b)")
    return load_export(export_dir, device=device)


def predict_batch(
    params: Any, doc: Dict[str, Any], rows: Dict[str, np.ndarray]
) -> Dict[str, Any]:
    """Family-dispatched scoring of ``rows`` against an export's
    params. Returns per-row outputs plus any metrics the provided
    labels allow (see module table). Raises ValueError for an export
    without a usable architecture record."""
    meta = doc.get("model") or {}
    family = meta.get("family")
    if family == "ctr":
        return _predict_ctr(params, rows)
    if family == "resnet":
        return _predict_resnet(params, meta, rows)
    if family == "bert":
        return _predict_bert(params, meta, rows)
    if family == "llama":
        return _predict_lm(params, meta, rows)
    if family == "moe":
        raise NotImplementedError(
            "predict for the moe family is not ported yet (ROADMAP Queue "
            "A item 7)")
    raise ValueError(
        f"export has no architecture record predict understands "
        f"(model={meta or None}); re-export with model_meta"
    )


def _need(rows: Dict[str, np.ndarray], *keys: str) -> None:
    missing = [k for k in keys if k not in rows]
    if missing:
        raise ValueError(
            f"input rows missing {missing}; have {sorted(rows)}"
        )


@torch.no_grad()
def _predict_ctr(params, rows) -> Dict[str, Any]:
    from edl_tpu_torch.models import ctr

    _need(rows, "dense", "sparse")
    dev = tree_device(params)
    # the reference promotes a bf16 export's leaves against the f32
    # dense features, so its products run in f32 on the stored values
    params = replace_leaves(params, [p.float() if p.is_floating_point()
                                     else p for p in leaves(params)])
    dense = np.asarray(rows["dense"], np.float32)
    sparse = np.asarray(rows["sparse"], np.int32)
    logits = np.concatenate([
        ctr.forward(params, torch.as_tensor(dense[c], device=dev),
                    torch.as_tensor(sparse[c], device=dev)).cpu().numpy()
        for c in _chunks(len(dense))
    ])
    out: Dict[str, Any] = {"prob": 1.0 / (1.0 + np.exp(-logits))}
    if "label" in rows:
        out["auc"] = float(ctr.batch_auc(
            torch.from_numpy(logits),
            torch.as_tensor(np.asarray(rows["label"]), dtype=torch.float32)))
    return out


@torch.no_grad()
def _predict_resnet(params, meta, rows) -> Dict[str, Any]:
    from edl_tpu_torch.models import resnet

    _need(rows, "images")
    cfg = resnet.ResNetConfig.from_meta(meta)
    dev = tree_device(params)
    images = np.asarray(rows["images"], np.float32)
    cls = np.concatenate([
        resnet.forward(params, torch.as_tensor(images[c], device=dev), cfg)
        .argmax(-1).to(torch.int32).cpu().numpy()
        for c in _chunks(len(images))
    ])
    out: Dict[str, Any] = {"class": cls}
    if "label" in rows:
        out["acc"] = float(
            (cls == np.asarray(rows["label"]).reshape(-1)).mean()
        )
    return out


def _predict_bert(params, meta, rows) -> Dict[str, Any]:
    from edl_tpu_torch.models import bert
    from edl_tpu_torch.models.evals import masked_top1

    _need(rows, "tokens")
    cfg = bert.BertConfig.from_meta(meta)
    # the SAME chunked masked-accuracy math the in-job eval publishes
    acc, pred = masked_top1(
        lambda p, t: bert.forward(p, t, cfg), params,
        dict(rows, tokens=np.asarray(rows["tokens"], np.int32)),
    )
    out: Dict[str, Any] = {"pred": pred}
    if "mask" in rows and "targets" in rows:
        out["masked_acc"] = acc
    return out


def _predict_lm(params, meta, rows) -> Dict[str, Any]:
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.models.evals import lm_scan

    _need(rows, "tokens")
    cfg = llama.LlamaConfig.from_meta(meta)
    # one chunked pass (models/evals): greedy next tokens + the SAME
    # CE accumulation the in-job perplexity eval publishes
    nxt, total, count = lm_scan(
        lambda p, t: llama.forward(p, t, cfg), params,
        np.asarray(rows["tokens"], np.int32),
    )
    out: Dict[str, Any] = {"next_token": nxt}
    if count:
        out["ppl"] = float(np.exp(total / count))
    return out


def load_rows(
    path: Optional[str] = None,
    data_dir: Optional[str] = None,
    n_rows: int = 256,
) -> Dict[str, np.ndarray]:
    """Rows from an ``.npz`` file. The reference also reads the head of
    a shards-dir dataset (``data_dir``); ``runtime/shards.py`` is not
    ported yet, so that raises."""
    if (path is None) == (data_dir is None):
        raise ValueError("give exactly one of path / data_dir")
    if path is not None:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    raise NotImplementedError(
        "--data-dir is not ported yet (ROADMAP Queue A item 6: "
        "runtime/shards.py)")
