"""Elastic fault-tolerant fit_a_line — the twin of
``examples/fit_a_line/train_ft.py`` (the reference's flagship demo,
reference example/fit_a_line/train_ft.py:33-114): a trainer that pulls
work from a lease-based task queue while the autoscaler retargets it,
resharding in place on each scale event (zero restarts).

    python -m edl_tpu_torch.examples.fit_a_line.train_ft [--devices 8]
        [--kill-one-worker] [--device cpu]

The fleet, controller and cluster live on the pool's first rank; every
rank trains (``runtime/local.LocalJobRunner``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from edl_tpu_torch.examples import _pool

# examples/fit_a_line/job.yaml
JOB = {
    "apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
    "metadata": {"name": "fit-a-line", "namespace": "default"},
    "spec": {
        "fault_tolerant": True, "passes": 2,
        "worker": {
            "entrypoint": "python examples/fit_a_line/train_ft.py",
            "min_replicas": 2, "max_replicas": 10,
            "resources": {"requests": {"cpu": "500m", "memory": "1Gi",
                                       "tpu": 1},
                          "limits": {"tpu": 1}}}}}


def train(a: Dict[str, Any]) -> Dict[str, Any]:
    """The rank program: every rank returns its report; rank 0 also the
    lines the reference prints and the job's phases."""
    import numpy as np
    import torch

    from edl_tpu_torch.api.job import JobPhase, TrainingJob
    from edl_tpu_torch.cluster.fake import FakeCluster, FakeHost
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.models import linreg
    from edl_tpu_torch.monitor.collector import ClusterSource
    from edl_tpu_torch.runtime.data import ElasticDataQueue, QueueBatcher
    from edl_tpu_torch.runtime.local import LocalJobRunner
    from edl_tpu_torch.train import trainer

    dev = _pool.rank_device(a["device"])
    lead = _pool.first_rank()
    lines: List[str] = []
    job = TrainingJob.from_dict(JOB)
    cluster = ctl = None
    if lead:
        # one chip a host, so the elastic range is visible
        cluster = FakeCluster(hosts=[FakeHost(f"h{i}", 8000, 16000, 1)
                                     for i in range(a["devices"])])
        ctl = Controller(cluster, max_load_desired=1.0)
        cluster.submit_job(job)
        ctl.step()
        assert ctl.phase_of(job.name) == JobPhase.RUNNING
        lines.append(f"submitted {job.name}: workers start at "
                     f"{job.status.parallelism}")
    # the master task queue's analog: chunk leases, redelivered on loss
    queue = ElasticDataQueue(n_samples=a["samples"], chunk_size=a["chunk"],
                             passes=job.spec.passes)
    x, y = linreg.synthetic_dataset(a["samples"])
    batcher = QueueBatcher(
        queue, lambda t: {"x": x[t.start:t.end], "y": y[t.start:t.end]})

    def data_fn(bs):
        b = batcher.next_batch(bs)
        if b is None:
            return {"x": x[:bs], "y": y[:bs]}
        if b["x"].shape[0] < bs:
            b = {k: np.resize(v, (bs,) + v.shape[1:]) for k, v in b.items()}
        return b

    runner = LocalJobRunner(
        ctl, job, linreg.loss_fn, trainer.sgd(0.05),
        linreg.init_params(torch.Generator().manual_seed(0), device=dev),
        per_chip_batch=16, device=dev)
    runner.trainer.train_steps(data_fn, 3)
    if lead:  # idle fleet: the autoscaler grows the job
        ctl.autoscaler.tick()
    runner.trainer.train_steps(data_fn, 3)  # the reshard up happens here
    if a["kill_one_worker"]:
        # a host dies mid-pass: the runtime reshards down to the live
        # membership and the dead worker's leases are redelivered
        if lead:
            victim = next(p for p in cluster.pods.values()
                          if p.role == "worker" and p.host is not None)
            lines.append(f"host {victim.host} dies (taking worker pod "
                         f"{victim.name})")
            cluster.remove_host(victim.host)
        queue.release_worker("w-dead")
        if lead:
            cluster.reconcile()
    report = runner.run(data_fn, queue=queue)
    out = {"losses": report.losses, "steps": report.steps,
           "reshards": [(e.from_workers, e.to_workers, e.stall_s,
                         e.fallback) for e in report.reshards]}
    if lead:
        lines.append(ClusterSource(cluster).sample().render())
        reshards = [f"{e.from_workers}->{e.to_workers} "
                    f"{e.stall_s * 1e3:.0f}ms" for e in report.reshards]
        lines.append(
            f"done: phase={ctl.phase_of(job.name).value} "
            f"steps={int(runner.trainer.state.step)} "
            f"final_loss={report.losses[-1]:.4f} reshards={reshards}")
        out.update(lines=lines, phase=ctl.phase_of(job.name).value,
                   state_step=int(runner.trainer.state.step),
                   workers=runner.trainer.n_workers)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    _pool.add_common(ap, 8)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--kill-one-worker", action="store_true",
                    help="fail a worker mid-pass to demo fault tolerance")
    args = ap.parse_args(argv)
    out = _pool.run_on_pool(train, dict(
        devices=args.devices, device=args.device, samples=args.samples,
        chunk=args.chunk, kill_one_worker=args.kill_one_worker),
        args.devices, args.device)
    for line in out["lines"]:
        print(line)
    if out["phase"] != "succeeded":
        print(f"job ended {out['phase']}", file=sys.stderr)
        return 1
    if not out["losses"][-1] < out["losses"][0]:
        print("loss did not fall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
