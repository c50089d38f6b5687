"""Workload registry — the port of ``edl_tpu/runtime/workloads.py``: each
built-in model family as an elastic-worker workload, on the port's
models.

Each entry builds a :class:`Workload`: ``batch_fn(start, end)``
synthesizes the samples of index range [start, end) with the
reference's NumPy draws, bit for bit, so any worker of either package
can materialize any leased task (the RecordIO-shard analog);
``init_params(device)`` draws the params from a ``torch.Generator``
seeded with ``cfg.seed`` (not the reference's ``jax.random`` bits:
tests carry weights across with ``models/convert``); ``eval_fn(params,
rows)`` is the held-out metric the commit leader publishes
(runtime/eval_hook.py); ``model_meta`` is the architecture record an
export carries; ``flops_per_example`` is the port's cost model's.

A workload may carry the reference's ``pspecs`` (``plan -> spec tree``,
llama's 2D TP x FSDP layout) and its mesh-aware ``make_loss(plan,
mesh)`` (llama's loss over a mesh's slices); :meth:`Workload.loss_for`
picks the loss for a mesh, as the reference's does. The elastic process
runtime itself still runs dp meshes (ROADMAP Queue A item 2h); an
``ElasticTrainer`` over a pool runs the others. ``loss_weight(batch)``
is a process's share of the loss's denominator,
which the data-parallel step all-reduces
(:func:`edl_tpu_torch.models.losses.batch_weight`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from edl_tpu_torch.obs import costmodel
from edl_tpu_torch.runtime.worker_config import WorkerConfig

_EVAL_CHUNK = 64  # rows per forward in held-out evals (the reference's)


@dataclass
class Workload:
    init_params: Callable[[torch.device], Any]
    loss_fn: Callable
    batch_fn: Callable[[int, int], Dict[str, np.ndarray]]
    model_meta: Optional[Dict[str, Any]] = None
    eval_fn: Optional[Callable[[Any, Dict[str, np.ndarray]], float]] = None
    flops_per_example: Optional[float] = None
    loss_weight: Optional[Callable[[Any], Any]] = None
    pspecs: Optional[Callable[[Any], Any]] = None
    make_loss: Optional[Callable[[Any, Any], Callable]] = None

    def loss_for(self, plan, mesh) -> Callable:
        """The loss for ``plan``/``mesh``: the mesh-aware ``make_loss``
        when the workload has one, else the static ``loss_fn``."""
        return self.make_loss(plan, mesh) if self.make_loss else self.loss_fn


def _generator(cfg: WorkerConfig) -> torch.Generator:
    return torch.Generator().manual_seed(cfg.seed)


def _rng(cfg: WorkerConfig, start: int) -> np.random.RandomState:
    return np.random.RandomState(cfg.seed * 1_000_003 + start + 1)


def _on(params, rows, key):
    return torch.as_tensor(rows[key], device=_device_of(params))


def _device_of(params) -> torch.device:
    from edl_tpu_torch.utils.device import tree_device

    return tree_device(params)


def _linreg_workload(cfg: WorkerConfig) -> Workload:
    from edl_tpu_torch.models import linreg

    rng = np.random.RandomState(cfg.seed)
    w_true = rng.randn(linreg.N_FEATURES, 1).astype(np.float32)

    def batch_fn(start: int, end: int) -> Dict[str, np.ndarray]:
        r = _rng(cfg, start)
        x = r.randn(end - start, linreg.N_FEATURES).astype(np.float32)
        y = x @ w_true + 0.1 * r.randn(end - start, 1).astype(np.float32)
        return {"x": x, "y": y}

    @torch.no_grad()
    def eval_rmse(params, rows):
        pred = linreg.predict(params, _on(params, rows, "x")).cpu().numpy()
        return float(np.sqrt(np.mean((pred - rows["y"]) ** 2)))

    return Workload(
        lambda dev: linreg.init_params(_generator(cfg), device=dev),
        linreg.loss_fn,
        batch_fn,
        eval_fn=eval_rmse,
    )


def _ctr_workload(cfg: WorkerConfig) -> Workload:
    from edl_tpu_torch.models import ctr

    def batch_fn(start: int, end: int) -> Dict[str, np.ndarray]:
        return ctr.synthetic_batch(_rng(cfg, start), end - start,
                                   vocab=cfg.vocab)

    @torch.no_grad()
    def eval_auc(params, rows):
        # the reference's in-train-loop metric (example/ctr/ctr/
        # train.py:161-167): AUC over the held-out split
        logits = ctr.forward(params, _on(params, rows, "dense"),
                             _on(params, rows, "sparse"))
        return float(ctr.batch_auc(logits, _on(params, rows, "label")))

    emb_kw = {"emb": cfg.emb} if cfg.emb else {}
    return Workload(
        lambda dev: ctr.init_params(_generator(cfg), vocab=cfg.vocab,
                                    device=dev, **emb_kw),
        ctr.loss_fn,
        batch_fn,
        eval_fn=eval_auc,
        flops_per_example=costmodel.ctr_train_flops_per_example(**emb_kw),
        model_meta={
            "family": "ctr",
            "vocab": cfg.vocab,
            "emb": cfg.emb or ctr.DEFAULT_EMBEDDING,
            "mlp_dims": list(ctr.MLP_DIMS),
        },
    )


def _lm_ppl_eval(logits_fn):
    """Chunked next-token perplexity over {tokens [N, T+1]}: the same
    implementation ``predict`` scores with (models/evals.py)."""

    def eval_ppl(params, rows):
        from edl_tpu_torch.models.evals import lm_ppl

        return lm_ppl(logits_fn, params, rows["tokens"], chunk=_EVAL_CHUNK)

    return eval_ppl


def _llama_workload(cfg: WorkerConfig) -> Workload:
    from edl_tpu_torch.models import llama

    mcfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab=cfg.vocab),
        int8_mxu=cfg.int8_mxu,
        int8_wgrad_bf16=cfg.int8_wgrad_bf16,
    )

    def batch_fn(start: int, end: int) -> Dict[str, np.ndarray]:
        return llama.synthetic_tokens(_rng(cfg, start), end - start,
                                      cfg.seq_len, cfg.vocab)

    return Workload(
        lambda dev: llama.init_params(mcfg, seed=cfg.seed, device=dev),
        llama.make_loss_fn(mcfg),
        batch_fn,
        pspecs=lambda plan: llama.param_pspecs(mcfg, plan),
        make_loss=lambda plan, mesh: llama.make_loss_fn(mcfg, plan, mesh),
        model_meta=mcfg.to_meta(),
        eval_fn=_lm_ppl_eval(lambda p, t: llama.forward(p, t, mcfg)),
        flops_per_example=cfg.seq_len
        * costmodel.train_flops_per_token(mcfg, cfg.seq_len),
    )


def _bert_workload(cfg: WorkerConfig) -> Workload:
    from edl_tpu_torch.models import bert

    mcfg = bert.BertConfig.tiny(vocab=cfg.vocab)

    def batch_fn(start: int, end: int) -> Dict[str, np.ndarray]:
        return bert.synthetic_mlm_batch(_rng(cfg, start), end - start,
                                        cfg.seq_len, cfg.vocab)

    def eval_mlm_acc(params, rows):
        from edl_tpu_torch.models.evals import masked_top1

        acc, _ = masked_top1(lambda p, t: bert.forward(p, t, mcfg), params,
                             rows, chunk=_EVAL_CHUNK)
        return acc

    def masked_rows(batch):
        # the loss normalizes by the masked positions of the real rows
        mask = torch.as_tensor(batch["mask"]).float()
        w = batch.get("_w")
        if w is not None:
            mask = mask * torch.as_tensor(w, device=mask.device).float()[:, None]
        return mask.sum()

    return Workload(
        lambda dev: bert.init_params(_generator(cfg), mcfg, device=dev),
        bert.make_loss_fn(mcfg),
        batch_fn,
        model_meta=mcfg.to_meta(),
        eval_fn=eval_mlm_acc,
        loss_weight=masked_rows,
    )


def _resnet_workload(cfg: WorkerConfig) -> Workload:
    from edl_tpu_torch.models import resnet

    mcfg = resnet.ResNetConfig.tiny()

    def batch_fn(start: int, end: int) -> Dict[str, np.ndarray]:
        return resnet.synthetic_batch(_rng(cfg, start), end - start)

    @torch.no_grad()
    def eval_top1(params, rows):
        logits = resnet.forward(params, _on(params, rows, "images"), mcfg)
        pred = logits.argmax(-1).cpu().numpy()
        return float((pred == rows["label"]).mean())

    return Workload(
        lambda dev: resnet.init_params(_generator(cfg), mcfg, device=dev),
        resnet.make_loss_fn(mcfg),
        batch_fn,
        model_meta=mcfg.to_meta(),
        eval_fn=eval_top1,
    )


def _moe_workload(cfg: WorkerConfig) -> Workload:
    """Mixture-of-Experts decoder. Under the dp step its router aux term
    and its expert capacity are per process (the reference computes both
    over the global batch), so a dp moe job is not the reference's
    function at world > 1; the ep mesh waits for item 2e."""
    from edl_tpu_torch.models import moe

    mcfg = dataclasses.replace(
        moe.MoEConfig.tiny(vocab=cfg.vocab),
        int8_mxu=cfg.int8_mxu,
        int8_wgrad_bf16=cfg.int8_wgrad_bf16,
    )

    def batch_fn(start: int, end: int) -> Dict[str, np.ndarray]:
        return moe.synthetic_tokens(_rng(cfg, start), end - start,
                                    cfg.seq_len, cfg.vocab)

    return Workload(
        lambda dev: moe.init_params(_generator(cfg), mcfg, device=dev),
        moe.make_loss_fn(mcfg),
        batch_fn,
        model_meta=mcfg.to_meta(),
        eval_fn=_lm_ppl_eval(lambda p, t: moe.forward(p, t, mcfg)[0]),
        flops_per_example=cfg.seq_len
        * costmodel.train_flops_per_token(mcfg, cfg.seq_len),
    )


WORKLOADS: Dict[str, Callable[[WorkerConfig], Workload]] = {
    "linreg": _linreg_workload,
    "ctr": _ctr_workload,
    "llama": _llama_workload,
    "bert": _bert_workload,
    "resnet": _resnet_workload,
    "moe": _moe_workload,
}
