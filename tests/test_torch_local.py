"""Port parity of ``runtime/local.LocalJobRunner`` — the minimum
end-to-end slice: submit → controller creates workers → train →
autoscaler rescales → in-place reshard → the job succeeds.

Both scenarios of ``tests/test_e2e.py`` (the job grows 2 → 4 workers
by an autoscaler tick; a host dies and the job finishes on the live
workers) run over one module-scoped pool of four gloo processes on the
CPU at 1 chip a worker — the controller on rank 0, every rank training —
against the reference's ``LocalJobRunner`` on four virtual devices on
the same schedule: losses, phases, reshard counts, the status stall and
the final step. A pool of one process with no process group runs the
reference's runner alone.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.api.job import TrainingJob as JJob
from edl_tpu.cluster.fake import FakeCluster as JCluster
from edl_tpu.cluster.fake import FakeHost as JHost
from edl_tpu.controller.controller import Controller as JController
from edl_tpu.models import linreg as jlinreg
from edl_tpu.runtime.data import ElasticDataQueue as JQueue
from edl_tpu.runtime.data import QueueBatcher as JBatcher
from edl_tpu.runtime.local import LocalJobRunner as JRunner
from edl_tpu_torch.utils.platform import ProcessPool
from tests import torch_pool_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    with ProcessPool(4, device="cpu", timeout_s=240, threads=1) as p:
        yield p


def _params_np():
    p = jlinreg.init_params(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


def _reference(scenario, devices):
    """``tests/test_e2e.py``'s scenario on the reference at 1 chip a
    worker, recorded as ``torch_pool_cases.local_e2e`` records it."""
    cluster = JCluster(hosts=[JHost(f"h{i}", 8000, 16000, 2)
                              for i in range(4)])
    ctl = JController(cluster, max_load_desired=1.0)
    job = JJob.from_yaml(cases.E2E_JOB_YAML)
    cluster.submit_job(job)
    ctl.step()
    phases = []

    def phase():
        phases.append(ctl.phase_of("fit-a-line").value)

    params = jlinreg.init_params(jax.random.PRNGKey(0))
    if scenario == "grow":
        phase()
        x, y = jlinreg.synthetic_dataset(2048)
        cursor = {"i": 0}

        def data_fn(bs):
            lo = cursor["i"] % (2048 - bs)
            cursor["i"] += bs
            return {"x": x[lo:lo + bs], "y": y[lo:lo + bs]}

        runner = JRunner(ctl, job, jlinreg.loss_fn, optax.sgd(0.05), params,
                         chips_per_worker=1, per_chip_batch=16,
                         devices=devices)
        n0 = runner.trainer.n_workers
        runner.trainer.train_steps(data_fn, 5)
        ctl.autoscaler.tick()
        phase()
        report = runner.trainer.train_steps(data_fn, 5)
        phase()
        mid = (job.status.reshard_count, job.status.last_reshard_stall_s,
               [e.stall_s for e in report.reshards])
        report = runner.run(data_fn, n_steps=5)
    else:
        ctl.autoscaler.tick()
        phase()
        queue = JQueue(n_samples=640, chunk_size=64, passes=1)
        x, y = jlinreg.synthetic_dataset(640)
        batcher = JBatcher(
            queue, lambda t: {"x": x[t.start:t.end], "y": y[t.start:t.end]})

        def data_fn(bs):
            b = batcher.next_batch(bs)
            if b is None:
                return {"x": x[:bs], "y": y[:bs]}
            if b["x"].shape[0] < bs:
                b = {k: np.resize(v, (bs,) + v.shape[1:])
                     for k, v in b.items()}
            return b

        runner = JRunner(ctl, job, jlinreg.loss_fn, optax.sgd(0.05), params,
                         chips_per_worker=1, per_chip_batch=8,
                         devices=devices)
        n0 = runner.trainer.n_workers
        runner.trainer.train_steps(data_fn, 2)
        victim = next(p for p in cluster.pods.values() if p.role == "worker")
        cluster.remove_host(victim.host)
        queue.release_worker("w-dead")
        cluster.reconcile()
        mid = cluster.job_pods(job)
        ctl.autoscaler.tick()
        phase()
        report = runner.run(data_fn, queue=queue)
    phase()
    return {"losses": report.losses, "steps": report.steps, "n0": n0,
            "workers": runner.trainer.n_workers,
            "state_step": int(runner.trainer.state.step), "phases": phases,
            "mid": mid, "reshard_count": job.status.reshard_count,
            "events": [(e.from_workers, e.to_workers, e.fallback)
                       for e in report.reshards]}


@pytest.mark.parametrize("scenario", ["grow", "kill"])
def test_the_e2e_scenarios_match_the_reference(pool, cpu_devices, scenario):
    ref = _reference(scenario, cpu_devices[:4])
    out = pool.run(cases.local_e2e, scenario, _params_np())
    got = out[0]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for k in ("steps", "n0", "workers", "state_step", "phases",
              "reshard_count", "events"):
        assert got[k] == ref[k], k
    assert got["phases"][-1] == "succeeded"
    # every rank trained the same steps on the same mesh
    for o in out[1:]:
        assert o["losses"] == got["losses"]
        assert (o["workers"], o["steps"]) == (got["workers"], got["steps"])
    if scenario == "grow":
        count, stall, stalls = got["mid"]
        assert count == ref["mid"][0] == 1
        # the reshard's stall flowed back into the job's status
        assert stall == stalls[0] == got["stalls"][0]
        assert got["n0"] == 2 and got["workers"] == 4
        assert got["state_step"] == 15  # zero restarts
        assert got["losses"][-1] < got["losses"][0] * 0.5
    else:
        assert tuple(got["mid"]) == tuple(ref["mid"]) == (5, 3, 1)
        assert got["workers"] == 3 and got["live"] == 3
        assert got["last_stall"] == got["stalls"][0]
        assert got["events"][-1][:2] == (4, 3)


def test_a_pool_of_one_is_the_references_runner(cpu_devices):
    """No process group: the port's runner on one process (a job of one
    worker, min = max = 1) equals the reference's on one device: its
    losses, the job SUCCEEDED, its step and the runner detached."""
    from edl_tpu_torch.api.job import TrainingJob
    from edl_tpu_torch.cluster.fake import FakeCluster, FakeHost
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.models import linreg
    from edl_tpu_torch.models.convert import params_from_numpy
    from edl_tpu_torch.runtime.local import LocalJobRunner
    from edl_tpu_torch.train import trainer

    yaml = cases.E2E_JOB_YAML.replace("min_replicas: 2", "min_replicas: 1") \
        .replace("max_replicas: 4", "max_replicas: 1")
    x, y = jlinreg.synthetic_dataset(512)

    def data(bs, cur):
        lo = cur["i"] % (512 - bs)
        cur["i"] += bs
        return {"x": x[lo:lo + bs], "y": y[lo:lo + bs]}

    runs = {}
    for side in ("port", "reference"):
        cur = {"i": 0}
        if side == "port":
            cluster = FakeCluster(hosts=[FakeHost("h0", 8000, 16000, 2)])
            ctl, job = Controller(cluster, max_load_desired=1.0), \
                TrainingJob.from_yaml(yaml)
            cluster.submit_job(job)
            ctl.step()
            runner = LocalJobRunner(ctl, job, linreg.loss_fn,
                                    trainer.sgd(0.05),
                                    params_from_numpy(_params_np(),
                                                      device="cpu"),
                                    chips_per_worker=1, per_chip_batch=16,
                                    device="cpu")
        else:
            cluster = JCluster(hosts=[JHost("h0", 8000, 16000, 2)])
            ctl, job = JController(cluster, max_load_desired=1.0), \
                JJob.from_yaml(yaml)
            cluster.submit_job(job)
            ctl.step()
            runner = JRunner(ctl, job, jlinreg.loss_fn, optax.sgd(0.05),
                             jlinreg.init_params(jax.random.PRNGKey(0)),
                             chips_per_worker=1, per_chip_batch=16,
                             devices=cpu_devices[:1])
        runner.trainer.train_steps(lambda bs: data(bs, cur), 3)
        report = runner.run(lambda bs: data(bs, cur), n_steps=3)
        runs[side] = (report.losses, ctl.phase_of("fit-a-line").value,
                      int(runner.trainer.state.step),
                      runner.trainer.n_workers, runner._attached)
    port, ref = runs["port"], runs["reference"]
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5)
    assert port[1:] == ref[1:] == ("succeeded", 6, 1, False)


def test_chip_smoke_local_phase_runs_on_the_cpu(pool):
    """chip_smoke.py's local phase end to end on this CPU pool at a
    small size: 2 -> 4 -> 3 workers, the queue drained, every gate
    (phases, workers a step, stalls, no restart, one process's losses
    within 1e-5)."""
    import chip_smoke

    c = dict(chip_smoke.LOCAL, vocab=4096, batch=32, steps=6,
             samples=32 * (2 * 2 + 4 * 4 + 3 * 3))
    row = chip_smoke.local_phase("cpu", pool, device="cpu", c=c)
    assert row["workers"][:2] == [2, 2] and row["workers"][-1] == 3
