"""The port's elastic process runtime as real worker processes on the CPU
(``local_devices=1``, gloo): the twins of the reference's dp jobs in
tests/test_multiproc.py, through the port's ProcessJobLauncher, native
coordinator and ``python -m edl_tpu_torch.runtime.worker_main`` — grow,
graceful drain, SIGKILL of a survivor and of rank 0, a SIGKILLed and
restarted coordinator, on-disk shards, the CTR AUC eval, background
commits under a rescale, and delayed-sync dp. The processes never
restart: a membership change regroups them in place.

Timing: a worker boots in ~3-7 s on an idle host here (torch's import
alone takes ~2.8 s), and a joiner needs its boot plus a store host's
(another torch import) before its first step. A job that grows (or
whose victim must be reaped) runs 0.1 s steps over 256 single-worker
steps: ~25 s of work after the event on one worker, so an event lands
well inside the job even when a loaded host makes a boot several times
slower (the race of ROADMAP Queue C item 3 needs the job to end before
the joiner boots). Every wait has a timeout, and the launcher kills
every worker and store host on teardown.
"""

import glob
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.parallel.mesh import MeshPlan as JMeshPlan
from edl_tpu.runtime import workloads as jwl
from edl_tpu.runtime import worker_config as jwc
from edl_tpu.train import trainer as jtrainer
from edl_tpu_torch.models import ctr as tctr
from edl_tpu_torch.runtime import checkpoint as ckpt
from edl_tpu_torch.runtime import shards
from edl_tpu_torch.runtime import workloads as twl
from edl_tpu_torch.runtime import worker_config as twc
from edl_tpu_torch.runtime.launcher import ProcessJobLauncher

pytestmark = pytest.mark.multiproc

JOB = dict(model="linreg", max_workers=4, per_device_batch=32,
           local_devices=1)
# 8192 samples of 32-row tasks: 256 steps on one worker, at 0.1 s each
# where a joiner must boot mid-job; 0.05 s where nobody joins
LONG = dict(n_samples=8192, step_sleep_s=0.1)
SHORT = dict(n_samples=8192, step_sleep_s=0.05)
WAIT_S = 240


def _assert_succeeded(launcher, rcs):
    assert all(rc == 0 for rc in rcs.values()), (
        rcs, {w: launcher.log_tail(w) for w in rcs})
    assert launcher.kv("phase") == "succeeded"
    assert float(launcher.kv("loss_last")) < float(launcher.kv("loss_first"))


def _final_params(launcher):
    m = ckpt.latest_manifest(launcher.ckpt_dir)
    assert m is not None and m["step"] == launcher.progress()
    assert int(launcher.kv("ckpt_step")) == launcher.progress()
    return dict(ckpt._leaf_keys(ckpt.load_sharded_params(
        launcher.ckpt_dir, manifest=m, device="cpu")))


def test_two_workers_complete_and_replay_the_reference_step_by_step(tmp_path):
    """A fixed membership of 2 over 1036 samples: 33 tasks of 32 rows,
    the last ragged (12 rows), so step 16 has one task (its peer replays
    with ``_w = 0``). The native queue leases in task order, so step i
    trains tasks {2i, 2i+1}: the final params are the reference's
    make_train_step replayed over those global batches from the port's
    initial params."""
    n, chunk = 1036, 32
    with ProcessJobLauncher(job="tmp2", min_workers=2, n_samples=n,
                            work_dir=str(tmp_path), **JOB) as launcher:
        launcher.start(2)
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        got = _final_params(launcher)
        stats = launcher.client.queue_stats()
        assert stats["done"] == 33 and stats["dead"] == 0, stats
        assert launcher.progress() == 17
        assert int(launcher.kv("digests_agreed")) >= 1
        assert launcher.kv("digest_mismatches") is None
        for w in rcs:
            log = launcher.log_tail(w, n_bytes=100_000)
            assert "device='cpu' backend='gloo'" in log, log

    env = {"EDL_MODEL": "linreg", "EDL_SEED": "0"}
    init = twl.WORKLOADS["linreg"](twc.WorkerConfig.from_env(env)) \
        .init_params(torch.device("cpu"))
    jp = jax.tree_util.tree_map(lambda t: np.asarray(t), init)
    jwk = jwl.WORKLOADS["linreg"](jwc.WorkerConfig.from_env(env))
    plan = JMeshPlan.data_parallel(1)
    mesh = plan.build(jax.devices()[:1])
    tx = optax.adam(1e-2)
    state = jtrainer.shard_state(jtrainer.TrainState.create(jp, tx), plan,
                                 mesh)
    step = jtrainer.make_train_step(jwk.loss_fn, tx, plan, mesh)
    n_tasks = -(-n // chunk)
    for i in range(-(-n_tasks // 2)):
        rows = [jwk.batch_fn(t * chunk, min(n, (t + 1) * chunk))
                for t in (2 * i, 2 * i + 1) if t < n_tasks]
        b = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
        b["_w"] = np.ones(len(b["x"]), np.float32)
        state, _ = step(state, jtrainer.global_batch(b, plan, mesh))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(state.params[k]),
                                   atol=2e-5, rtol=0)


def test_scale_up_reshards_in_place(tmp_path):
    with ProcessJobLauncher(job="tmpup", min_workers=1,
                            work_dir=str(tmp_path), **JOB, **LONG) as launcher:
        launcher.start(1)
        launcher.wait_progress(3, timeout_s=WAIT_S)
        launcher.scale_to(2)
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        assert len(rcs) == 2
        assert int(launcher.kv("reshards") or "0") >= 1
        # w000 regrouped in place: one process, two epochs or more
        log0 = launcher.log_tail("w000", n_bytes=200_000)
        assert log0.count("epoch up") >= 2, log0
        assert "world=2" in launcher.log_tail("w001", n_bytes=200_000)
        # rank 0 started a store host for each epoch it came up in
        hosts = glob.glob(os.path.join(launcher.log_dir,
                                       "dist_service_e*.log"))
        assert len(hosts) >= 2, hosts
        for path in hosts:
            with open(path) as f:
                assert "dist_service up" in f.read(), path


def test_scale_down_graceful_drain(tmp_path):
    with ProcessJobLauncher(job="tmpdown", min_workers=3,
                            work_dir=str(tmp_path), **JOB, **SHORT
                            ) as launcher:
        launcher.start(3)
        launcher.wait_progress(3, timeout_s=WAIT_S)
        assert launcher.scale_to(2) == ["w002"]  # SIGTERM: graceful drain
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)  # the drained worker too
        assert int(launcher.kv("reshards") or "0") >= 1
        assert "departing (scale-down)" in launcher.log_tail("w002")


@pytest.mark.parametrize("victim", ["survivor", "rank0"])
def test_crash_sigkill_survivors_recover(tmp_path, victim):
    """A hard kill (no drain): the survivor's all-reduce fails, the
    state it holds is the last completed step, and after the
    coordinator reaps the dead peer it regroups and finishes. Killing
    rank 0 also kills the go decisions' publisher and the peer that
    started the epoch's store host."""
    with ProcessJobLauncher(job=f"tmkill{victim}", min_workers=2,
                            member_ttl_s=2.0, lease_timeout_s=3.0,
                            work_dir=str(tmp_path), **JOB, **SHORT
                            ) as launcher:
        launcher.start(2)
        launcher.wait_progress(3, timeout_s=WAIT_S)
        live = launcher.live_workers()
        dead = (live[0] if victim == "rank0" else live[-1]).worker_id
        launcher.kill(dead)
        rcs = launcher.wait(timeout_s=WAIT_S)
        assert rcs.pop(dead) != 0
        assert all(rc == 0 for rc in rcs.values()), (
            rcs, {w: launcher.log_tail(w) for w in rcs})
        assert launcher.kv("phase") == "succeeded"
        assert float(launcher.kv("loss_last")) < float(
            launcher.kv("loss_first"))
        stats = launcher.client.queue_stats()
        assert stats["dead"] == 0 and stats["todo"] == 0, stats


def test_coordinator_sigkill_restart_job_completes(tmp_path):
    """SIGKILL the coordinator mid-job and restart it: the WAL restores
    KV, membership and the queue, the workers' clients reconnect, and
    every task is acked exactly once."""
    with ProcessJobLauncher(job="tmpcoord", min_workers=2, n_samples=4096,
                            step_sleep_s=0.05, work_dir=str(tmp_path),
                            **JOB) as launcher:
        launcher.start(2)
        launcher.wait_progress(3, timeout_s=WAIT_S)
        launcher.kill_coordinator()
        time.sleep(1.0)  # workers hit the dead socket and back off
        launcher.restart_coordinator()
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        stats = launcher.client.queue_stats()
        assert stats["done"] == 4096 // 32, stats
        assert stats["dead"] == 0 and stats["todo"] == 0, stats
        assert stats["leased"] == 0, stats


def test_workers_train_from_on_disk_shards(tmp_path):
    rows = tctr.synthetic_batch(np.random.RandomState(7), 2048, vocab=4096)
    data_dir = str(tmp_path / "ds")
    shards.write_shards(data_dir, rows, shard_size=512)
    with ProcessJobLauncher(job="tmpdata", min_workers=2, n_samples=999999,
                            data_dir=data_dir, work_dir=str(tmp_path),
                            extra_env={"EDL_VOCAB": "4096"},
                            **{**JOB, "model": "ctr"}) as launcher:
        launcher.start(2)
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        # the queue was sized from the manifest (2048 rows): 64 tasks
        # over 2 workers, exactly once
        assert 2048 // 64 <= launcher.progress() <= 2048 // 64 + 2
        stats = launcher.client.queue_stats()
        assert stats["done"] == 2048 // 32, stats
        assert stats["todo"] == 0 and stats["leased"] == 0, stats


def test_ctr_job_publishes_auc_eval_metric(tmp_path):
    """The commit leader evaluates every published export against a
    held-out split (the reference's AUC in the train loop,
    example/ctr/ctr/train.py:161-167)."""
    eval_rows = tctr.synthetic_batch(np.random.RandomState(7), 512,
                                     vocab=1024)
    eval_dir = str(tmp_path / "eval")
    shards.write_shards(eval_dir, eval_rows, shard_size=512)
    with ProcessJobLauncher(job="tmpauc", min_workers=2,
                            n_samples=2048, ckpt_every=8, export=True,
                            work_dir=str(tmp_path),
                            extra_env={"EDL_VOCAB": "1024",
                                       "EDL_EVAL_DIR": eval_dir},
                            **{**JOB, "model": "ctr", "max_workers": 2}
                            ) as launcher:
        launcher.start(2)
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        metric = launcher.kv("eval_metric")
        assert metric is not None, "no eval_metric published"
        step_s, auc_s = metric.split(":")
        assert int(step_s) == launcher.progress(), metric
        # the synthetic click model is learnable (the reference's bar,
        # tests/test_multiproc.py:746)
        assert 0.55 < float(auc_s) <= 1.0, metric


def test_background_commits_under_rescale(tmp_path):
    """ckpt_every=1 keeps a background commit in flight at every step; a
    scale-up serializes behind it and the final manifest carries the
    final step."""
    with ProcessJobLauncher(job="tmpbg", min_workers=1,
                            ckpt_every=1, work_dir=str(tmp_path),
                            **{**JOB, "max_workers": 3}, **LONG) as launcher:
        launcher.start(2)
        launcher.wait_progress(3, timeout_s=WAIT_S)
        launcher.scale_to(3)
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        assert int(launcher.kv("reshards") or "0") >= 1
        _final_params(launcher)  # manifest step == progress == ckpt_step
        assert launcher.kv("digest_mismatches") is None


def test_delayed_sync_job_completes(tmp_path):
    """sync_every=4: local steps between averages; every commit is the
    merged state, so the replicas' digests agree."""
    with ProcessJobLauncher(job="tmpsync", min_workers=2, n_samples=4096,
                            sync_every=4, ckpt_every=8,
                            work_dir=str(tmp_path), **JOB) as launcher:
        launcher.start(2)
        rcs = launcher.wait(timeout_s=WAIT_S)
        _assert_succeeded(launcher, rcs)
        _final_params(launcher)
        assert int(launcher.kv("digests_agreed")) >= 2
        assert launcher.kv("digest_mismatches") is None


def _store_host(port, *args):
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.runtime.dist_service",
         "--job", "j", *args, "--coordinator", f"127.0.0.1:{port}"],
        env=dict(os.environ, PYTHONPATH=os.getcwd()),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _await_kv(cl, key, proc, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while cl.kv_get(key) is None:
        assert time.monotonic() < deadline and proc.poll() is None, key
        time.sleep(0.05)
    return cl.kv_get(key)


def test_dist_service_serves_one_epoch_and_leaves_when_dismissed(tmp_path):
    """The store host: publishes ``{job}/dist/{epoch}``, serves a
    TCPStore there, and exits on its instance's ``dist_done`` mark."""
    from torch.distributed import TCPStore

    from edl_tpu_torch.runtime.coordinator import CoordinatorServer

    with CoordinatorServer() as s:
        cl = s.client()
        proc = _store_host(s.port, "--epoch", "3", "--world", "1")
        try:
            host, port = _await_kv(cl, "j/dist/3", proc).rsplit(":", 1)
            st = TCPStore(host, int(port), is_master=False)
            st.set("k", "v")
            assert st.get("k") == b"v"
            cl.kv_put(f"j/dist_done/3/{port}", "1")
            assert proc.wait(timeout=30) == 0
            assert b"dismissed" in proc.stdout.read()
            assert cl.kv_get(f"j/dist_done/3/{port}") is None  # retired
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            cl.close()


@pytest.mark.parametrize("cause", ["orphaned", "coordinator unreachable"])
def test_dist_service_exits_when_its_epoch_is_stale_or_the_job_is_over(
        cause):
    """Undismissed, the store host exits once the membership epoch has
    left its own for ``--orphan-grace`` seconds, or once the coordinator
    is gone (the launcher stopped it: the job is over)."""
    from edl_tpu_torch.runtime.coordinator import CoordinatorServer

    with CoordinatorServer() as s:
        cl = s.client()
        epoch = cl.epoch()
        proc = _store_host(s.port, "--epoch", str(epoch), "--world", "1",
                           "--orphan-grace", "0.5")
        try:
            _await_kv(cl, f"j/dist/{epoch}", proc)
            if cause == "orphaned":
                cl.register("w", 0)  # the membership moves on
                assert cl.epoch() != epoch
            else:
                cl.close()
                s.stop()
            assert proc.wait(timeout=60) == 0
            assert cause.encode() in proc.stdout.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            cl.close()


def test_chip_smoke_elastic_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's elastic phase, its schedule, report and gates, at a
    small size on the CPU (the card runs CTR at 2^20; a CPU worker steps
    in ~10 ms here, so 1200 tasks of 64 rows outlast the events)."""
    import chip_smoke

    c = dict(chip_smoke.ELASTIC, vocab=4096, per_device_batch=64,
             tasks=1200, ckpt_every=50, eval_rows=1024, timeout_s=WAIT_S)
    row = chip_smoke.elastic_phase("cpu", device="cpu", c=c, check=dict(
        vocab=4096, rows=128, world=2, steps=3))
    assert all(row["gates"].values()), row["gates"]
    assert [s["worlds"] for s in row["stalls"]] == [[2, 3], [3, 2], [2, 1]]
    assert [e["world"] for e in row["epochs"]] == [2, 3, 2, 1]
    assert row["boots"]["w000"]["total_s"] > 0
    assert row["boots"]["w002"]["total_s"] > 0
    # w000 stays rank 0 and spawns every epoch's store host
    assert all(s["store_host_boot_s"] > 0 for s in row["stalls"])
    assert {c["kind"] for c in row["commits"]} == {"reshard", "crash"}
    # the fleet read side beside the job: a window at each world, the
    # grow's reshard and step critical paths, coordinator_main's process
    fleet = row["fleet"]
    assert [w["world"] for w in fleet["windows"]] == [2, 3, 2, 1]
    assert [w["members"] for w in fleet["windows"]] == [
        ["w000", "w001"], ["w000", "w001", "w002"], ["w000", "w001"],
        ["w000"]]
    grow = fleet["windows"][1]
    assert sorted(grow["barrier_wait_s"]) == ["w000", "w001", "w002"]
    assert grow["step_critical_path"]["hops"] >= 1
    assert fleet["grow_reshard"]["path"]["hops"] >= 1
    assert fleet["grow_reshard"]["epoch"] == row["stalls"][0]["epochs"][1]
    assert fleet["coordinator_process"]["sigterm_rc"] == 0
    assert fleet["watch"]["pages"] == 0 and fleet["fleet_history_appends"] > 1
