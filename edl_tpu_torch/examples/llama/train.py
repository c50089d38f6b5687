"""Llama-class training over a mesh of processes — the twin of
``examples/llama/train.py``: a tiny Llama trained with the
reference's layouts (batch over dp, params and optimizer over fsdp,
heads over tp, sequence over sp, layer stages over pp) on a pool of
``--devices`` processes.

    python -m edl_tpu_torch.examples.llama.train [--devices 8]
        [--mesh "sp=2,dp" | --mesh "pp=2,dp"] [--device cpu]

``--mesh`` is ``MeshPlan.parse``'s grammar ("sp=2,dp": ring attention,
"pp=2,dp": the GPipe schedule); the default is the job manifest's mesh
block (fsdp 2 x tp 2). ``--export-dir`` publishes a float32 export at
the end and decodes a sample from it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from edl_tpu_torch.examples import _pool

# examples/llama/job.yaml
JOB = {
    "apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
    "metadata": {"name": "llama-fsdp", "namespace": "default"},
    "spec": {
        "fault_tolerant": True, "passes": 1, "accelerator_type": "v5e",
        "mesh": {"fsdp": 2, "tp": 2},
        "worker": {
            "entrypoint": "python examples/llama/train.py",
            "min_replicas": 1, "max_replicas": 4,
            "resources": {"requests": {"cpu": "8", "memory": "64Gi",
                                       "tpu": 4},
                          "limits": {"tpu": 4}}}}}


def train(a: Dict[str, Any]) -> Dict[str, Any]:
    """The rank program: rank 0 returns the lines the reference prints
    and the losses."""
    import numpy as np
    import torch

    from edl_tpu_torch.api.job import TrainingJob
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.parallel.mesh import MeshPlan, pool_group
    from edl_tpu_torch.train import trainer

    dev = _pool.rank_device(a["device"])
    lead = _pool.first_rank()
    lines: List[str] = []
    if a["mesh"]:
        plan = MeshPlan.parse(a["mesh"], a["devices"])
    else:
        job = TrainingJob.from_dict(JOB)
        plan = MeshPlan.create(**job.spec.mesh.axis_sizes())
    mesh = plan.build([dev])
    lines.append(f"mesh: {plan.describe()}")
    cfg = llama.LlamaConfig.tiny(vocab=1024)
    pspecs = llama.param_pspecs(cfg, plan)
    tx = trainer.adamw(3e-4)
    params = llama.init_params(cfg, seed=0, device=dev)
    # the mesh-aware loss: ring or Ulysses attention on an sp axis, the
    # GPipe schedule on a pp axis
    state = trainer.shard_state(trainer.TrainState.create(params, tx),
                                plan, mesh, param_pspecs=pspecs)
    step = trainer.make_train_step(llama.make_loss_fn(cfg, plan, mesh), tx,
                                   plan, mesh)
    rng = np.random.RandomState(0)
    shards = plan.batch_shards()
    losses = []
    for i in range(a["steps"]):
        tokens = llama.synthetic_tokens(rng, a["per_shard_batch"] * shards,
                                        a["seq"], cfg.vocab)
        if mesh.member:
            state, metrics = step(state, trainer.global_batch(tokens, plan,
                                                              mesh))
            losses.append(float(metrics["loss"]))
            lines.append(f"step {i}: loss={losses[-1]:.4f}")
    if mesh.member and int(state.step) != a["steps"]:
        raise RuntimeError(f"state step {int(state.step)} != {a['steps']}")
    pool = pool_group(range(torch.distributed.get_world_size()))
    whole = trainer.gather_state(state, mesh, pool) if a["export_dir"] \
        else None
    if whole is not None:
        from edl_tpu_torch.runtime.export import export_params, load_export

        d = export_params(a["export_dir"], whole.params, a["steps"],
                          dtype="float32", model_meta=cfg.to_meta())
        lines.append(f"export published: {d}")
        # the serving round trip: load ONLY the export, decode with the
        # KV cache
        served, _ = load_export(a["export_dir"], device=dev)
        prompt = torch.tensor([[1, 2, 3, 4]], device=dev)
        toks = llama.generate(served, prompt, cfg, max_new=8)
        lines.append(f"generated from export: {toks[0].tolist()}")
    lines.append("ok")
    return {"lines": lines, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    _pool.add_common(ap, 8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--per-shard-batch", type=int, default=2)
    ap.add_argument("--export-dir", default="")
    ap.add_argument("--mesh", default="",
                    help='MeshPlan.parse override, e.g. "sp=2,dp" (ring '
                    'attention) or "pp=2,dp" (GPipe) — default: the job '
                    'manifest\'s mesh block')
    args = ap.parse_args(argv)
    out = _pool.run_on_pool(train, dict(
        devices=args.devices, device=args.device, steps=args.steps,
        seq=args.seq, per_shard_batch=args.per_shard_batch,
        export_dir=args.export_dir, mesh=args.mesh),
        args.devices, args.device)
    for line in out["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
