"""Elastic CTR training on on-disk shards — the twin of
``examples/ctr/train.py`` (reference example/ctr/ctr/train.py:120-235):
the Criteo-shaped deep model trained data-parallel by elastic workers
through ``runtime/local.LocalJobRunner``, its rows read from a prepared
shard directory (``runtime/shards``) through the lease queue.

    python -m edl_tpu_torch.examples.ctr.train [--devices 8] [--steps 30]
        [--device cpu]

Beyond the reference's flags: ``--kill-one-worker`` (a host dies after
the growth; the runtime reshards down to the live workers),
``--drain`` (after ``--steps``, train until the queue's ``--passes``
drain, so the job ends SUCCEEDED) and ``--check-one-rank`` (the first
rank holds the pool to one process fed the same global batches, two
ways: each step's loss against one process's step from the pool's
state before the previous step, and the whole run's losses against one
process trained from the init; the second drifts, since Adam turns the
summation order of the pool's gradient all-reduce into updates of up to
lr on entries whose gradient cancels to about zero, and the drift
grows with the steps). ``--real-data`` exits 1 (ROADMAP Queue A item
9f).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Any, Dict, List

from edl_tpu_torch.examples import _pool

# examples/ctr/job.yaml
JOB = {
    "apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
    "metadata": {"name": "ctr", "namespace": "default"},
    "spec": {
        "fault_tolerant": True, "passes": 1,
        "data_dir": "/data/ctr", "checkpoint_dir": "/ckpt/ctr",
        "checkpoint_every": 200,
        "volumes": [
            {"name": "dataset",
             "persistentVolumeClaim": {"claimName": "ctr-dataset"}},
            {"name": "ckpt",
             "persistentVolumeClaim": {"claimName": "ctr-ckpt"}}],
        "volume_mounts": [
            {"name": "dataset", "mount_path": "/data", "read_only": True},
            {"name": "ckpt", "mount_path": "/ckpt"}],
        "worker": {
            "entrypoint": "python examples/ctr/train.py",
            "min_replicas": 2, "max_replicas": 8,
            "resources": {"requests": {"cpu": "2", "memory": "8Gi",
                                       "tpu": 1},
                          "limits": {"tpu": 1}}}}}


def prepare(data_dir: str, samples: int, vocab: int, seed: int = 0) -> str:
    """Write ``samples`` synthetic rows as shards under ``data_dir``
    unless a dataset is there (the image-prebake analog); returns the
    line the reference prints, or ""."""
    import numpy as np

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime.shards import write_shards

    if os.path.exists(os.path.join(data_dir, "manifest.json")):
        return ""
    rows = ctr.synthetic_batch(np.random.RandomState(seed), samples,
                               vocab=vocab)
    write_shards(data_dir, rows, shard_size=8192)
    return f"prepared {samples} rows of CTR data under {data_dir}"


LR = 1e-3  # the reference's optax.adam(1e-3)


def _one_rank_losses(batches, vocab, dev) -> List[float]:
    """One process's losses over ``batches`` from the same init."""
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.train import trainer

    tx = trainer.adam(LR)
    params = ctr.init_params(torch.Generator().manual_seed(0), vocab=vocab,
                             device=dev)
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(ctr.make_loss_fn(), tx)
    out = []
    for b in batches:
        state, m = step(state, trainer.global_batch(b, device=dev))
        out.append(float(m["loss"]))
    return out


class _OneStep:
    """One process beside the pool on its first rank: before each of the
    pool's steps it takes the pool's state, predicts that step's loss
    from one process's own step before it (the pool's state one step
    earlier, the batch it stepped on), and takes that one-process step
    for the next prediction. The predictions equal the pool's losses up
    to one step's rounding: nothing accumulates."""

    def __init__(self, dev):
        from edl_tpu_torch.models import ctr
        from edl_tpu_torch.train import trainer

        self.dev, self.trainer = dev, trainer
        self.loss = ctr.make_loss_fn()
        self.step = trainer.make_train_step(self.loss, trainer.adam(LR))
        self.ahead = None
        self.predicted: List[float] = []

    def before(self, state, batch) -> None:
        import torch

        tr = self.trainer
        b = tr.global_batch(batch, device=self.dev)
        mine = tr.shard_state(state, device=self.dev)  # a copy
        with torch.no_grad():
            self.predicted.append(float(self.loss(
                (self.ahead or mine).params, b)))
        self.ahead, _ = self.step(mine, b)


def train(a: Dict[str, Any]) -> Dict[str, Any]:
    """The rank program: rank 0 returns the lines the reference prints,
    the job's phases, the workers of each step, the report and (with
    ``check_one_rank``) the one-process losses; the others their
    report."""
    import numpy as np
    import torch

    from edl_tpu_torch.api.job import JobPhase, TrainingJob
    from edl_tpu_torch.cluster.fake import FakeCluster, FakeHost
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime.data import ElasticDataQueue, QueueBatcher
    from edl_tpu_torch.runtime.export import export_params
    from edl_tpu_torch.runtime.local import LocalJobRunner
    from edl_tpu_torch.runtime.shards import FileShardSource
    from edl_tpu_torch.train import trainer

    dev = _pool.rank_device(a["device"])
    lead = _pool.first_rank()
    lines: List[str] = []
    phases: List[str] = []
    job = TrainingJob.from_dict(JOB)
    cluster = ctl = None
    if lead:
        cluster = FakeCluster(hosts=[FakeHost(f"h{i}", 16000, 32000, 1)
                                     for i in range(a["devices"])])
        ctl = Controller(cluster, max_load_desired=1.0)
        cluster.submit_job(job)
        ctl.step()
        assert ctl.phase_of(job.name) == JobPhase.RUNNING

    def phase(tag):
        if lead:
            phases.append((tag, ctl.phase_of(job.name).value))

    phase("submitted")
    source = FileShardSource(a["data_dir"])
    # streaming (the reference's 10**6 passes) unless the run drains
    queue = ElasticDataQueue(source.n_samples, chunk_size=512,
                             passes=a["passes"])
    batcher = QueueBatcher(queue, source.fetch)
    fed: List[Dict[str, Any]] = []
    workers: List[int] = []
    holder: Dict[str, Any] = {}
    one_step = _OneStep(dev) if lead and a["check_one_rank"] else None

    def data_fn(bs):
        b = batcher.next_batch(bs, rollover=True)
        if b is None:  # drained: recycle rows to keep shapes aligned
            b = source.fetch_range(0, bs)
        if next(iter(b.values())).shape[0] < bs:
            b = {k: np.resize(v, (bs,) + v.shape[1:]) for k, v in b.items()}
        tr = holder["runner"].trainer
        workers.append(tr.n_workers)
        if one_step is not None:
            fed.append(b)
            one_step.before(tr.state, b)  # the state this step starts from
        return b

    runner = LocalJobRunner(
        ctl, job, ctr.make_loss_fn(), trainer.adam(LR),
        ctr.init_params(torch.Generator().manual_seed(0), vocab=a["vocab"],
                        device=dev),
        chips_per_worker=1, per_chip_batch=a["batch"],
        sync_every=a["sync_every"], device=dev)
    holder["runner"] = runner
    exported = [-1]

    def state_step():
        st = runner.trainer.state
        return None if st is None else int(st.step)

    def publish_export(tag=""):
        merged = runner.trainer.merged_state  # a collective when K > 1
        step_now = state_step()
        if not lead or not a["export_dir"] or step_now <= exported[0]:
            return
        d = export_params(a["export_dir"], merged.params, step_now)
        exported[0] = step_now
        lines.append(f"{tag}export published: {d}")

    t0 = time.perf_counter()
    steps = a["steps"]
    third = max(steps // 3, 1)
    report = runner.trainer.train_steps(data_fn, third)
    if lead:  # grow into the idle fleet -> in-place reshard
        ctl.autoscaler.tick()
    phase("after the autoscaler's tick")
    for start in range(third, steps, third):
        n = min(third, steps - start)
        report = runner.trainer.train_steps(data_fn, n)
        phase(f"after step {start + n}")
        if a["ckpt_every"] and (start + n) % a["ckpt_every"] < third:
            merged = runner.trainer.merged_state
            if lead:
                path = os.path.join(a["ckpt_dir"], f"step-{state_step()}")
                ckpt.save(path, merged)
                lines.append(f"checkpoint saved: {path}")
            publish_export()
    if a["kill_one_worker"]:
        if lead:
            victim = next(p for p in cluster.pods.values()
                          if p.role == "worker" and p.host is not None)
            lines.append(f"host {victim.host} dies (taking worker pod "
                         f"{victim.name})")
            cluster.remove_host(victim.host)
        queue.release_worker("w-dead")
        if lead:
            cluster.reconcile()
        phase("after the host died")
    if a["drain"]:
        report = runner.run(data_fn, queue=queue)
        phase("after the queue drained")
    train_s = time.perf_counter() - t0
    stats = queue.progress()
    lines.append(
        f"trained {report.steps} steps on {runner.trainer.n_workers} "
        f"workers: loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}, "
        f"{report.examples_per_sec:.0f} examples/s, "
        f"reshards={[(e.from_workers, e.to_workers) for e in report.reshards]}"
        f", data: {stats['done']} file chunks acked from {a['data_dir']}")
    publish_export(tag="final ")
    if not a["drain"]:
        runner.detach()
    out = {"losses": report.losses, "steps": report.steps,
           "examples": report.examples,
           "examples_per_sec": report.examples_per_sec,
           "train_seconds": report.train_seconds, "wall_s": train_s,
           "workers": workers, "state_step": state_step(),
           "reshards": [dict(from_workers=e.from_workers,
                             to_workers=e.to_workers, stall_s=e.stall_s,
                             recompile_s=e.recompile_s, step=e.step,
                             path="host" if e.fallback else "device")
                        for e in report.reshards]}
    if lead:
        st = job.status
        out.update(lines=lines, phases=phases,
                   reshard_count=st.reshard_count,
                   last_reshard_stall_s=st.last_reshard_stall_s,
                   final_phase=ctl.phase_of(job.name).value)
        if a["check_one_rank"]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            one = _one_rank_losses(fed, a["vocab"], dev)

            def rel(xs):
                return [abs(x - y) / abs(y) for x, y in zip(report.losses,
                                                             xs)]

            out["one_rank_losses"] = one
            out["one_rank_rel"] = rel(one)
            out["one_step_rel"] = rel(one_step.predicted)
            out["one_rank_max_rel"] = max(out["one_rank_rel"])
            out["one_step_max_rel"] = max(out["one_step_rel"])
            lines.append(f"one process fed the same global batches: max "
                         f"relative loss difference a step "
                         f"{out['one_step_max_rel']:.3g}, over the run "
                         f"{out['one_rank_max_rel']:.3g}")
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    _pool.add_common(ap, 8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64, help="per-chip batch")
    ap.add_argument("--vocab", type=int, default=2 ** 14,
                    help="embedding slots (2^20 on real hardware)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint period in steps (0 = off)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--export-dir", default="",
                    help="publish a servable params-only export here on "
                    "the ckpt cadence and at the end")
    ap.add_argument("--data-dir", default="",
                    help="shard-manifest dataset dir; prepared with "
                    "synthetic rows when absent")
    ap.add_argument("--real-data", action="store_true",
                    help="not ported (ROADMAP Queue A item 9f)")
    ap.add_argument("--samples", type=int, default=65536)
    ap.add_argument("--sync-every", type=int, default=1,
                    help="delayed-sync DP: K local steps between averages")
    ap.add_argument("--passes", type=int, default=10 ** 6)
    ap.add_argument("--kill-one-worker", action="store_true")
    ap.add_argument("--drain", action="store_true")
    ap.add_argument("--check-one-rank", action="store_true")
    return ap


def rank_args(args) -> Dict[str, Any]:
    """The rank program's arguments from parsed flags (the dataset
    prepared)."""
    data_dir = args.data_dir or tempfile.mkdtemp(prefix="ctr_shards_")
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), "edl-ctr-ckpt")
    return dict(devices=args.devices, device=args.device, steps=args.steps,
                batch=args.batch, vocab=args.vocab,
                ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
                export_dir=args.export_dir, data_dir=data_dir,
                sync_every=args.sync_every, passes=args.passes,
                kill_one_worker=args.kill_one_worker, drain=args.drain,
                check_one_rank=args.check_one_rank,
                prepared=prepare(data_dir, args.samples, args.vocab))


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.real_data:
        return _pool.refuse_real_data("ctr")
    a = rank_args(args)
    if a["prepared"]:
        print(a["prepared"])
    out = _pool.run_on_pool(train, a, args.devices, args.device)
    for line in out["lines"]:
        print(line)
    if args.drain and out["final_phase"] != "succeeded":
        print(f"job ended {out['final_phase']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
