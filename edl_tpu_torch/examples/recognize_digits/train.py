"""Classic (non-elastic) distributed digit recognition — the twin of
``examples/recognize_digits/train.py`` (reference
example/fit_a_line/fluid/recognize_digits.py:107-145): a FIXED worker
count for the life of the job, each worker reading its static shard of
chunks (``runtime/data.StaticShardReader``: chunk ``i`` is worker ``i %
N``'s), a checkpoint each epoch, the tiny ResNet trained through
``runtime/local.LocalJobRunner``.

    python -m edl_tpu_torch.examples.recognize_digits.train [--devices 8]
        [--device cpu]

``--real-data`` exits 1 (ROADMAP Queue A item 9f).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Any, Dict, List

from edl_tpu_torch.examples import _pool

# examples/recognize_digits/job.yaml
JOB = {
    "apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
    "metadata": {"name": "recognize-digits", "namespace": "default"},
    "spec": {
        "fault_tolerant": False, "passes": 2,
        "worker": {
            "entrypoint": "python examples/recognize_digits/train.py",
            "min_replicas": 4, "max_replicas": 4,
            "resources": {"requests": {"cpu": "500m", "memory": "1Gi",
                                       "tpu": 1},
                          "limits": {"tpu": 1}}}}}


def train(a: Dict[str, Any]) -> Dict[str, Any]:
    """The rank program: rank 0 returns the lines the reference prints
    and the job's final phase; every rank its losses."""
    import numpy as np
    import torch

    from edl_tpu_torch.api.job import JobPhase, TrainingJob
    from edl_tpu_torch.cluster.fake import FakeCluster, FakeHost
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.models import resnet
    from edl_tpu_torch.parallel import collectives as coll
    from edl_tpu_torch.runtime import checkpoint
    from edl_tpu_torch.runtime.data import StaticShardReader
    from edl_tpu_torch.runtime.local import LocalJobRunner
    from edl_tpu_torch.train import trainer

    dev = _pool.rank_device(a["device"])
    lead = _pool.first_rank()
    lines: List[str] = []
    job = TrainingJob.from_dict(JOB)
    ctl = None
    n_workers = epochs = None
    if lead:
        cluster = FakeCluster(hosts=[FakeHost(f"h{i}", 8000, 16000, 1)
                                     for i in range(a["devices"])])
        ctl = Controller(cluster, max_load_desired=1.0)
        cluster.submit_job(job)
        ctl.step()
        assert ctl.phase_of(job.name) == JobPhase.RUNNING
        n_workers = job.status.parallelism
        assert not job.elastic(), "this is the fixed-membership mode"
        lines.append(f"submitted {job.name}: fixed {n_workers} workers")
        epochs = a["epochs"] if a["epochs"] is not None else job.spec.passes
    n_workers, epochs = coll.broadcast_object(
        (n_workers, epochs), 0, coll.Group(
            None, torch.distributed.get_world_size(),
            torch.distributed.get_rank()))
    if epochs < 1:
        raise ValueError(f"--epochs/spec.passes must be >= 1, got {epochs}")
    cfg = resnet.ResNetConfig.tiny()
    rng = np.random.RandomState(0)
    samples = a["samples"]
    data = resnet.synthetic_batch(rng, samples, size=16)
    # every worker owns at least one chunk
    chunk = min(a["chunk"], max(samples // n_workers, 1))
    readers = [StaticShardReader(samples, chunk, n_workers, w)
               for w in range(n_workers)]
    shards = [np.asarray(r.epoch_indices(), np.int64) for r in readers]
    cursors = [0] * n_workers

    def data_fn(global_bs):
        # each worker's equal slice of the global batch from its shard
        per = global_bs // n_workers
        parts = []
        for w in range(n_workers):
            take = np.arange(cursors[w], cursors[w] + per) % len(shards[w])
            cursors[w] = (cursors[w] + per) % len(shards[w])
            parts.append(shards[w][take])
        idx = np.concatenate(parts)
        return {k: v[idx] for k, v in data.items()}

    runner = LocalJobRunner(
        ctl, job, resnet.make_loss_fn(cfg), trainer.adam(1e-3),
        resnet.init_params(torch.Generator().manual_seed(0), cfg,
                           device=dev),
        per_chip_batch=a["per_worker_batch"], device=dev)
    steps_per_epoch = max(samples // (a["per_worker_batch"] * n_workers), 1)
    ckpt_dir = a["ckpt_dir"]
    report = None
    for epoch in range(epochs):
        report = runner.trainer.train_steps(data_fn, steps_per_epoch)
        # a checkpoint each epoch (reference: recognize_digits.py:84-88)
        path = os.path.join(ckpt_dir, f"epoch_{epoch}")
        merged = runner.trainer.merged_state
        if lead:
            checkpoint.save(path, merged, {"epoch": epoch})
            lines.append(f"epoch {epoch}: loss {report.losses[-1]:.4f} "
                         f"(ckpt -> {path})")
    runner.run(data_fn, n_steps=1)  # the final step, then complete
    out = {"losses": report.losses}
    if lead:
        all_idx = np.sort(np.concatenate(shards))
        out.update(final_phase=ctl.phase_of(job.name).value,
                   shards_cover=bool(np.array_equal(all_idx,
                                                    np.arange(samples))))
        lines.append(f"done: phase={out['final_phase']} workers={n_workers} "
                     f"epochs={epochs} final_loss={report.losses[-1]:.4f}")
        out["lines"] = lines
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    _pool.add_common(ap, 8)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=None,
                    help="defaults to the manifest's spec.passes")
    ap.add_argument("--per-worker-batch", type=int, default=32)
    ap.add_argument("--real-data", action="store_true",
                    help="not ported (ROADMAP Queue A item 9f)")
    args = ap.parse_args(argv)
    if args.real_data:
        return _pool.refuse_real_data("recognize_digits")
    out = _pool.run_on_pool(train, dict(
        devices=args.devices, device=args.device, samples=args.samples,
        chunk=args.chunk, epochs=args.epochs,
        per_worker_batch=args.per_worker_batch,
        ckpt_dir=tempfile.mkdtemp(prefix="digits_ckpt_")),
        args.devices, args.device)
    for line in out["lines"]:
        print(line)
    ok = (out["final_phase"] == "succeeded" and out["shards_cover"]
          and out["losses"][-1] < out["losses"][0] * 1.05)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
