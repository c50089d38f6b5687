"""The elastic process runtime of the port, in process (and in a few
short-lived gloo processes), held against the JAX package: the jax-free
copies (WorkerConfig, the coordinator client, EpochKeyGC, the
entrypoint), the six workloads, the data-parallel step and
LocalSyncStepper over two gloo processes on the CPU
(``edl_tpu_torch/train/dp_check.py``), the sharded checkpoint format
both ways, the telemetry the worker starts, and the guards of what is
not ported yet. The launcher jobs are in tests/test_torch_multiproc.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import ctr as jctr
from edl_tpu.obs import disttrace as jdisttrace
from edl_tpu.obs import fleet as jfleet
from edl_tpu.parallel.mesh import MeshPlan as JMeshPlan
from edl_tpu.runtime import checkpoint as jckpt
from edl_tpu.runtime import coordinator as jcoord
from edl_tpu.runtime import entrypoint as jentry
from edl_tpu.runtime import epoch_gc as jgc
from edl_tpu.runtime import shards as jshards
from edl_tpu.runtime import worker_config as jwc
from edl_tpu.runtime import workloads as jwl
from edl_tpu.train import trainer as jtrainer
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import disttrace as tdisttrace
from edl_tpu_torch.obs import fleet as tfleet
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.parallel import mesh as tmesh
from edl_tpu_torch.runtime import checkpoint as tckpt
from edl_tpu_torch.runtime import coordinator as tcoord
from edl_tpu_torch.runtime import entrypoint as tentry
from edl_tpu_torch.runtime import epoch_gc as tgc
from edl_tpu_torch.runtime import export as texport
from edl_tpu_torch.runtime import shards as tshards
from edl_tpu_torch.runtime import worker_config as twc
from edl_tpu_torch.runtime import workloads as twl
from edl_tpu_torch.runtime.worker_main import ElasticWorker
from edl_tpu_torch.train import dp_check
from edl_tpu_torch.train import trainer as ttrainer

LOSS_RTOL = 1e-5  # the workloads' losses at f32 (test_torch_small_models)
# params after Adam steps: the update normalizes a gradient that cancels
# to ~0, so its rounding moves a param by up to a fraction of lr.
# linreg: test_torch_train.py's bound; CTR (whose 400-wide layers hold
# many such entries): test_torch_ctr.py's ADAM_E2E_TOL
PARAM_TOL = {"linreg": dict(atol=2e-5, rtol=0),
             "ctr": dict(atol=1e-4, rtol=1e-4)}
MODELS = ("linreg", "ctr", "llama", "bert", "resnet", "moe")


@pytest.fixture(scope="module")
def server():
    with tcoord.CoordinatorServer(member_ttl_s=5.0) as s:
        yield s


def _flat_np(tree, prefix=""):
    """A reference param tree (NumPy leaves) flattened with the
    checkpoint format's keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_np(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the jax-free copies ------------------------------------------------------

ENVS = (
    {},
    {"EDL_JOB_NAME": "j", "EDL_WORKER_ID": "w3",
     "EDL_COORDINATOR": "10.0.0.2:9000", "EDL_WORKERS": "3",
     "EDL_MODEL": "ctr", "EDL_LOCAL_DEVICES": "1", "EDL_P2P": "0",
     "EDL_VOCAB": "1048576", "EDL_PER_DEVICE_BATCH": "4096",
     "EDL_CKPT_EVERY": "50", "EDL_SYNC_EVERY": "4",
     "EDL_FAULT_TOLERANT": "1", "EDL_METRICS_PUSH_S": "0",
     "EDL_MEMBER_TTL_S": "2.5", "EDL_EVAL_DIR": "/e"},
    {"HOSTNAME": "pod-7", "EDL_WORKERS_MIN": "2", "EDL_WORKERS_MAX": "9",
     "MEGASCALE_SLICE_ID": "3", "EDL_INT8_MXU": "1"},
)


@pytest.mark.parametrize("env", ENVS)
def test_worker_config_from_env_matches_reference(env):
    got = twc.WorkerConfig.from_env(env)
    want = jwc.WorkerConfig.from_env(env)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(got):
        if f.name != "worker_id" or env:  # no id: w<pid> on both
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def _norm(x):
    if isinstance(x, list):
        return [_norm(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return tuple(getattr(x, f) for f in x.__dataclass_fields__)
    return x


def _coord_ops(cl):
    out = []
    out.append(cl.ping())
    cl.kv_put("j/a", "1 2 3")
    out += [cl.kv_get("j/a"), cl.kv_get("j/none")]
    cl.kv_del("j/a")
    out.append(cl.kv_get("j/a"))
    out += [cl.register("w1", 1), cl.register("w2", 1), cl.register("w1", 1),
            cl.epoch(), cl.members(), cl.heartbeat("w1"), cl.heartbeat("x")]
    out += [cl.barrier_arrive("j/start", "w1"), cl.barrier_arrive("j/start",
                                                                  "w2"),
            cl.barrier_arrive("j/start", "w1"), cl.barrier_count("j/start")]
    cl.queue_init(100, 32, passes=1, lease_timeout_s=10.0)
    out += [cl.lease("w1"), cl.lease("w2"), cl.queue_stats(), cl.ack(0),
            cl.nack(1), cl.ack(99), cl.queue_stats(), cl.queue_done()]
    out += [cl.lease("w1"), cl.lease("w1"), cl.lease("w2"), cl.lease("w2"),
            cl.lease("w2"), cl.release_worker("w1"), cl.queue_stats()]
    out += [cl.leave("w2"), cl.expire(), cl.members(), cl.epoch()]
    out.append(cl.time() is not None)
    return [_norm(x) for x in out]


def test_coordinator_client_answers_as_the_reference():
    """The same call sequence through each package's client, each on a
    fresh server of the port's build: the same answers."""
    answers = []
    for client_cls in (tcoord.CoordinatorClient, jcoord.CoordinatorClient):
        with tcoord.CoordinatorServer(member_ttl_s=30.0) as s:
            cl = client_cls("127.0.0.1", s.port)
            answers.append(_coord_ops(cl))
            cl.close()
    assert answers[0] == answers[1]
    assert answers[0][8] == [("w1", 1, 0), ("w2", 1, 1)]


def test_coordinator_builds_into_the_port_build_dir():
    assert tcoord.ensure_native_built()
    assert os.path.dirname(tcoord.BIN_PATH) == tcoord.BUILD_DIR
    assert os.sep + os.path.join("edl_tpu_torch", "_build",
                                 "coordinator") in tcoord.BUILD_DIR


def test_epoch_gc_matches_reference():
    runs = []
    for mod in (tgc, jgc):
        gc, deleted = mod.EpochKeyGC(), []
        gc.defer("a", "b")
        gc.defer_late("c")
        gc.extend(["d"], late=True)
        n1 = gc.drain(deleted.append)
        gc.defer("e")
        n2 = gc.drain(deleted.append)
        state = (gc.due, gc.late, gc.pending())
        n3 = gc.drain(deleted.append)

        def flaky(k, _seen=[]):
            if k == "x" and not _seen:
                _seen.append(k)
                raise ConnectionError("hiccup")
            deleted.append(k)

        gc.defer("w", "x", "y")
        with pytest.raises(ConnectionError):
            gc.drain(flaky)
        runs.append((deleted, n1, n2, n3, state, gc.due, gc.drain(flaky)))
    assert runs[0] == runs[1]


def test_entrypoint_bootstrap_and_failure_gate_match_reference():
    out = []
    for mod in (tentry, jentry):
        with tcoord.CoordinatorServer(member_ttl_s=30.0) as s:
            cl = s.client()
            env = {"EDL_JOB_NAME": "j", "EDL_WORKER_ID": "w1",
                   "EDL_WORKERS_MIN": "1", "EDL_FAULT_TOLERANT": "1",
                   "EDL_WORKERS": "2"}
            ctx1 = mod.bootstrap(cl, env=env)
            ctx2 = mod.bootstrap(cl, env={**env, "EDL_WORKER_ID": "w0"})
            fails = [mod.record_failure(cl, "j", "boom") for _ in range(2)]
            mod.check_failure_gate(cl, "j", True, budget=2)
            with pytest.raises(mod.FailureGateError):
                mod.check_failure_gate(cl, "j", False, budget=2)
            mod.record_failure(cl, "j", "boom")
            with pytest.raises(mod.FailureGateError):
                mod.check_failure_gate(cl, "j", True, budget=2)
            out.append((
                [(c.rank, c.world_size, c.incarnation, c.membership_epoch)
                 for c in (ctx1, ctx2)], fails,
                cl.kv_get("j/incarnation/w1"), cl.kv_get("j/last_failure"),
                [mod.classify_exit(c) for c in (0, 134, 136, 139, 3)]))
            cl.close()
    assert out[0] == out[1]


def test_collective_timeout_follows_the_member_ttl():
    assert tentry.collective_timeout_s(2.0) == 20.0
    assert tentry.collective_timeout_s(10.0) == 60.0
    assert tentry.BACKEND == "gloo"


def test_shards_read_each_others_datasets(tmp_path):
    rows = jctr.synthetic_batch(np.random.RandomState(0), 700, vocab=64)
    tshards.write_shards(str(tmp_path / "t"), rows, shard_size=256)
    jshards.write_shards(str(tmp_path / "j"), rows, shard_size=256)
    for d in ("t", "j"):
        for mod in (tshards, jshards):
            src = mod.FileShardSource(str(tmp_path / d))
            got = src.fetch_range(200, 600)
            for k in rows:
                np.testing.assert_array_equal(got[k], rows[k][200:600])
    with open(tmp_path / "t" / "manifest.json") as a, \
            open(tmp_path / "j" / "manifest.json") as b:
        assert json.load(a) == json.load(b)


# -- workloads ----------------------------------------------------------------


def _cfgs(model):
    env = {"EDL_MODEL": model, "EDL_VOCAB": "128", "EDL_SEQ_LEN": "16",
           "EDL_SEED": "3"}
    return twc.WorkerConfig.from_env(env), jwc.WorkerConfig.from_env(env)


@pytest.mark.parametrize("model", MODELS)
def test_workload_batches_are_the_references_bit_for_bit(model):
    tcfg, jcfg = _cfgs(model)
    got_fn = twl.WORKLOADS[model](tcfg).batch_fn
    want_fn = jwl.WORKLOADS[model](jcfg).batch_fn
    for start, end in ((0, 5), (37, 45), (1000, 1003)):
        got, want = got_fn(start, end), want_fn(start, end)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, (model, k)
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("model", MODELS)
def test_workload_loss_on_converted_params_matches_reference(model):
    tcfg, jcfg = _cfgs(model)
    twk, jwk = twl.WORKLOADS[model](tcfg), jwl.WORKLOADS[model](jcfg)
    jp = jwk.init_params()
    tp = params_from_numpy(_np_tree(jp), "cpu")
    batch = jwk.batch_fn(10, 14)
    batch["_w"] = np.array([1, 1, 1, 0], np.float32)
    want = float(jwk.loss_fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()}))
    got = float(twk.loss_fn(tp, ttrainer.global_batch(batch, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the port's own init: the reference's shapes and dtypes
    mine = texport._leaf_keys(twk.init_params(torch.device("cpu")))
    ref = _flat_np(_np_tree(jp))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in mine} == {k: (v.shape, v.dtype.name)
                                  for k, v in ref.items()}
    assert twk.model_meta == jwk.model_meta
    if jwk.flops_per_example is None:
        assert twk.flops_per_example is None
    else:
        np.testing.assert_allclose(twk.flops_per_example,
                                   jwk.flops_per_example, rtol=1e-12)


@pytest.mark.parametrize("model", ("linreg", "ctr"))
def test_workload_eval_matches_reference(model):
    tcfg, jcfg = _cfgs(model)
    twk, jwk = twl.WORKLOADS[model](tcfg), jwl.WORKLOADS[model](jcfg)
    jp = jwk.init_params()
    rows = jwk.batch_fn(0, 300)
    got = twk.eval_fn(params_from_numpy(_np_tree(jp), "cpu"), rows)
    np.testing.assert_allclose(got, jwk.eval_fn(jp, rows), rtol=1e-5)


def test_bert_loss_weight_is_the_real_rows_masked_positions():
    tcfg, _ = _cfgs("bert")
    wk = twl.WORKLOADS["bert"](tcfg)
    b = wk.batch_fn(0, 6)
    b["_w"] = np.array([1, 1, 0, 1, 0, 0], np.float32)
    tb = ttrainer.global_batch(b, device="cpu")
    assert float(wk.loss_weight(tb)) == float(
        (b["mask"] * b["_w"][:, None]).sum())


# -- the data-parallel step over two gloo processes ---------------------------


def _ragged_batches(model, jcfg, rows, steps):
    """Global batches from the workload's own batch_fn; the last is a
    ragged tail whose second half (rank 1's rows) is all ``_w = 0``."""
    fn = jwl.WORKLOADS[model](jcfg).batch_fn
    out = []
    for i in range(steps):
        b = fn(i * rows * 2, (i + 1) * rows * 2)
        w = np.ones(rows * 2, np.float32)
        if i == steps - 1:
            w[rows // 2:] = 0.0
        b["_w"] = w
        out.append(b)
    return out


def _reference_steps(jwk, jp, batches, tx):
    devs = jax.devices()[:1]
    plan = JMeshPlan.data_parallel(1)
    mesh = plan.build(devs)
    state = jtrainer.shard_state(jtrainer.TrainState.create(jp, tx), plan,
                                 mesh)
    step = jtrainer.make_train_step(jwk.loss_fn, tx, plan, mesh)
    losses = []
    for b in batches:
        state, m = step(state, jtrainer.global_batch(b, plan, mesh))
        losses.append(float(m["loss"]))
    return _flat_np(_np_tree(state.params)), losses


@pytest.mark.parametrize("model", ("linreg", "ctr"))
def test_dp_step_over_two_processes_is_the_reference_step_on_the_whole_batch(
        model, tmp_path):
    """3 Adam steps; the last batch's real rows end inside rank 0's
    share, so rank 1 adds nothing (the replayed tail of a job)."""
    tcfg, jcfg = _cfgs(model)
    jwk = jwl.WORKLOADS[model](jcfg)
    jp = jwk.init_params()
    batches = _ragged_batches(model, jcfg, 16, 3)
    ranks = [r["adam"] for r in dp_check.run_ranks(
        model, _flat_np(_np_tree(jp)), batches, "cpu", world=2,
        workdir=str(tmp_path))]
    want, want_losses = _reference_steps(jwk, jp, batches, optax.adam(1e-3))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=LOSS_RTOL)
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, err_msg=k,
                                       **PARAM_TOL[model])
            # replicas stay bit-identical
            np.testing.assert_array_equal(r["params"][k],
                                          ranks[0]["params"][k])


def test_dp_step_under_sgd_differs_from_one_process_by_rounding(tmp_path):
    """The card's form of the check (chip_smoke.py's elastic phase) at a
    small size: SGD params within f32 rounding of one process's."""
    out = dp_check.dp_step_check("cpu", vocab=2048, rows=64)
    assert out["max_abs_err"] < 1e-6, out
    assert out["loss_abs_err"] < 1e-6, out
    assert out["rank_spread"] == 0.0, out


def test_failed_allreduce_leaves_the_state_bit_equal(tmp_path):
    tcfg, jcfg = _cfgs("ctr")
    jp = jwl.WORKLOADS["ctr"](jcfg).init_params()
    batches = _ragged_batches("ctr", jcfg, 16, 3)
    ranks = dp_check.run_ranks("ctr", _flat_np(_np_tree(jp)), batches,
                               "cpu", world=2, mode="fail",
                               workdir=str(tmp_path))
    assert ranks[1] is None  # the victim was SIGKILLed
    survivor = ranks[0]["adam"]
    assert "failed" in survivor, survivor
    assert bool(survivor["bit_equal"])
    assert len(survivor["losses"]) == 1  # one good step before it


def test_local_sync_stepper_matches_the_reference_on_a_two_device_mesh(
        cpu_devices, tmp_path):
    """K = 2 local steps, a sync, two more and a sync, then merge: the
    reference's stepper on a virtual 2-device CPU mesh (each group's
    rows are its half of the global batch, as a process's are)."""
    tcfg, jcfg = _cfgs("ctr")
    jwk = jwl.WORKLOADS["ctr"](jcfg)
    jp = jwk.init_params()
    batches = []
    for i in range(4):
        b = jwk.batch_fn(i * 32, (i + 1) * 32)
        b["_w"] = np.ones(32, np.float32)
        batches.append(b)
    ranks = [r["adam"] for r in dp_check.run_ranks(
        "ctr", _flat_np(_np_tree(jp)), batches, "cpu", world=2,
        mode="localsync", sync_every=2, workdir=str(tmp_path))]
    plan = JMeshPlan.data_parallel(2)
    mesh = plan.build(cpu_devices[:2])
    tx = optax.adam(1e-3)
    state = jtrainer.shard_state(jtrainer.TrainState.create(jp, tx), plan,
                                 mesh)
    stepper = jtrainer.LocalSyncStepper(jwk.loss_fn, tx, plan, mesh)
    lstate = stepper.localize(state)
    losses = []
    for i, b in enumerate(batches):
        lstate, m = stepper.step(lstate, jtrainer.global_batch(b, plan, mesh))
        losses.append(float(m["loss"]))
        if (i + 1) % 2 == 0:
            lstate = stepper.sync(lstate)
    want = _flat_np(_np_tree(stepper.merge(lstate).params))
    # the mean of the groups' losses, on every process
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, err_msg=k,
                                       **PARAM_TOL["ctr"])


# -- the sharded checkpoint format --------------------------------------------


def _port_state(vocab=64):
    gen = torch.Generator().manual_seed(1)
    from edl_tpu_torch.models import ctr

    tx = ttrainer.adam(1e-3)
    st = ttrainer.TrainState.create(
        ctr.init_params(gen, vocab=vocab, emb=8, device="cpu"), tx)
    step = ttrainer.make_train_step(ctr.loss_fn, tx)
    b = ctr.synthetic_batch(np.random.RandomState(0), 16, vocab=vocab)
    for _ in range(2):
        st, _ = step(st, ttrainer.global_batch(b, device="cpu"))
    return st, tx


def _port_commit(root, st, world=2):
    snaps = [tckpt.snapshot_local(st, r) for r in range(world)]
    files = [tckpt.save_shards(root, s, r, world, host_leaves=(r == 0))
             for r, s in enumerate(snaps)]
    tckpt.write_manifest(root, snaps[0], files, {"job": "j"})
    return snaps


def test_port_dp_checkpoint_loads_through_the_reference(tmp_path):
    st, tx = _port_state()
    _port_commit(str(tmp_path), st)
    m = jckpt.latest_manifest(str(tmp_path))
    assert m["step"] == 2 and set(m) == {"step", "files", "shapes", "dtypes",
                                         "meta", "_dir"}
    assert m["files"] == ["shards-r0000-of-0002.npz",
                          "shards-r0001-of-0002.npz"]
    # rank 1 holds no replica 0: its file is empty, as the reference's
    with np.load(os.path.join(m["_dir"], m["files"][1])) as z:
        assert z.files == []
    index = jckpt._PieceIndex(m, None)
    try:
        for key, leaf in tckpt._leaf_keys(st.params):
            fq = f"p:{key}"
            shape = tuple(m["shapes"][fq])
            got = index.assemble(fq, tuple(slice(None) for _ in shape), shape,
                                 np.dtype(m["dtypes"][fq]))
            np.testing.assert_array_equal(got, leaf.detach().numpy())
    finally:
        index.close()
    # and the port restores the whole state bit for bit
    back = tckpt.load_sharded(str(tmp_path), tx, device="cpu")
    assert back.step == st.step
    for a, b in zip(ttrainer.leaves(st.params), ttrainer.leaves(back.params)):
        assert torch.equal(a, b)
    got = {(i, n): t for i, n, t, _ in ttrainer.optimizer_tensors(back)}
    for i, n, t, _ in ttrainer.optimizer_tensors(st):
        assert torch.equal(got[(i, n)], t), (i, n)


def test_reference_dp_checkpoint_loads_its_params_in_the_port(cpu_devices,
                                                              tmp_path):
    plan = JMeshPlan.data_parallel(2)
    mesh = plan.build(cpu_devices[:2])
    jp = jctr.init_params(jax.random.PRNGKey(4), vocab=64, emb=8)
    tx = optax.adam(1e-3)
    state = jtrainer.shard_state(jtrainer.TrainState.create(jp, tx), plan,
                                 mesh)
    snap = jckpt.snapshot_local(state)
    f = jckpt.save_shards(str(tmp_path), snap, 0, 1, host_leaves=True)
    jckpt.write_manifest(str(tmp_path), snap, [f], {"job": "j"})
    got = tckpt.load_sharded_params(str(tmp_path), device="cpu")
    want = _flat_np(_np_tree(jp))
    mine = dict(tckpt._leaf_keys(got))
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k].numpy(), v)


def test_gc_step_dirs_reaps_what_the_reference_reaps(tmp_path):
    layout = {1: True, 2: False, 3: True, 4: True, 5: False, 6: True,
              7: False}
    for name in ("t", "j"):
        for step, committed in layout.items():
            d = tmp_path / name / f"step-{step:08d}"
            d.mkdir(parents=True)
            if committed:
                (d / "manifest.json").write_text(json.dumps({"step": step}))
    tckpt.gc_step_dirs(str(tmp_path / "t"), keep=2)
    jckpt.gc_step_dirs(str(tmp_path / "j"), keep=2)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == ["step-00000004", "step-00000006",
                                        "step-00000007"]
    assert tckpt.latest_manifest(str(tmp_path / "t"))["step"] == \
        jckpt.latest_manifest(str(tmp_path / "j"))["step"] == 6


def test_export_from_checkpoint_matches_the_reference(tmp_path):
    st, _ = _port_state()
    snaps = _port_commit(str(tmp_path / "ck"), st)
    meta = {"family": "ctr", "vocab": 64, "emb": 8, "mlp_dims": [400] * 3}
    d = texport.export_from_checkpoint(str(tmp_path / "ck"),
                                       str(tmp_path / "t"), dtype="float32",
                                       ram=snaps[0], model_meta=meta)
    from edl_tpu.runtime import export as jexport

    jd = jexport.export_from_checkpoint(str(tmp_path / "ck"),
                                        str(tmp_path / "j"), dtype="float32",
                                        model_meta=meta)
    assert os.path.basename(d) == os.path.basename(jd) == "step-00000002"
    tp, tdoc = texport.load_export(str(tmp_path / "t"), device="cpu")
    jp, jdoc = jexport.load_export(str(tmp_path / "j"))
    assert tdoc["model"] == jdoc["model"] == meta
    for k, v in _flat_np(_np_tree(jp)).items():
        np.testing.assert_array_equal(dict(tckpt._leaf_keys(tp))[k].numpy(),
                                      v)
    # the same step again exports nothing
    assert texport.export_from_checkpoint(str(tmp_path / "ck"),
                                          str(tmp_path / "t")) is None


# -- telemetry the worker starts ------------------------------------------------


def test_metrics_pusher_publishes_what_the_reference_aggregates():
    reg = MetricsRegistry()
    reg.counter("edl_train_steps_total", "optimizer steps completed").inc(3)
    reg.histogram("edl_train_step_seconds", "step").observe(0.2)
    got = {}
    pusher = tfleet.MetricsPusher(lambda s: got.setdefault("m", s),
                                  interval_s=60, registry=reg,
                                  events_publish=lambda s: got.setdefault(
                                      "e", s),
                                  trace_publish=lambda s: got.setdefault(
                                      "t", s))
    assert pusher.push_once() and pusher.pushes == 1
    agg = jfleet.aggregate_snapshots({"w0": got["m"]})
    text = agg.render()
    assert 'edl_train_steps_total{worker="w0"} 3' in text
    assert jdisttrace.load_span_window(got["t"]) is not None
    assert [tfleet.metrics_key("j", "w"), tfleet.events_key("j", "w"),
            tfleet.trace_key("j", "w"), tfleet.clock_key("j", "w")] == [
        jfleet.metrics_key("j", "w"), jfleet.events_key("j", "w"),
        jfleet.trace_key("j", "w"), jfleet.clock_key("j", "w")]
    # a failing publish backs off instead of raising
    bad = tfleet.MetricsPusher(lambda s: 1 / 0, interval_s=1.0, registry=reg)
    assert not bad.push_once() and bad.next_wait_s() >= 1.0


def test_clock_sync_and_ctx_propagation_match_the_reference():
    ests = []
    for mod in (tdisttrace, jdisttrace):
        ticks = iter([10.0, 10.2, 20.0, 20.1, 30.0, 30.5])
        remote = iter([110.1, 120.05, None])
        cs = mod.ClockSync(clock=lambda: next(ticks))
        est = cs.sample(lambda: next(remote), n=3)
        ests.append((est.offset_s, est.rtt_s, est.n, est.to_json()))
    assert ests[0] == ests[1]
    kv = {}
    with tdisttrace.root("step", "j", 1, 5):
        ctx = tdisttrace.current()
        tdisttrace.publish_ctx(kv.__setitem__, "j/go/1", tag="5")
    got = jdisttrace.fetch_ctx(kv.get, "j/go/1", tag="5")
    assert (got.trace_id, got.span_id) == (ctx.trace_id, ctx.span_id)
    assert jdisttrace.fetch_ctx(kv.get, "j/go/1", tag="6") is None
    link = tdisttrace.link_attrs(got)
    assert link["trace_id"] == ctx.trace_id and link["parent_id"] == \
        ctx.span_id


# -- what is not ported yet -----------------------------------------------------


def test_mesh_plan_parses_as_the_reference_and_builds_dp_only():
    for s, n in (("dp", 4), ("", 3), ("fsdp", 4), ("fsdp,tp=2", 8),
                 ("dp,pp=2", 6)):
        assert tmesh.MeshPlan.parse(s, n).axes == JMeshPlan.parse(s, n).axes
        p = tmesh.MeshPlan.parse(s, n)
        assert p.batch_shards() == JMeshPlan.parse(s, n).batch_shards()
    for bad in (("tp", 4), ("dp=0", 2), ("fsdp=3", 4)):
        with pytest.raises(ValueError):
            tmesh.MeshPlan.parse(*bad)
    m = tmesh.MeshPlan.data_parallel(1).build([torch.device("cpu")])
    assert (m.device, m.world, m.rank) == (torch.device("cpu"), 1, 0)
    # an fsdp plan builds over a pool of processes (tests/test_torch_mesh.py);
    # a world of one process has too few
    with pytest.raises(ValueError, match="group has 1"):
        tmesh.MeshPlan.parse("fsdp", 4).build([torch.device("cpu")])
    with pytest.raises(ValueError, match="group has 1"):
        tmesh.MeshPlan.data_parallel(2).build([torch.device("cpu")])
    for s in ("fsdp", "dp,tp=1", "sp", "pp=2", "ep=2,dp"):
        with pytest.raises(NotImplementedError, match="item 2b"):
            tmesh.check_dp_only(s)
    tmesh.check_dp_only("dp")
    assert tmesh.process_device(1) == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="item 2b"):
        tmesh.process_device(2)
    sp = ttrainer.state_pspecs(_port_state()[0], tmesh.MeshPlan.create(dp=2))
    assert sp.step == () and set(sp.opt_state.values()) == {()}
    # a tp plan with no model specs: the generic rule, fsdp over nothing
    sp = ttrainer.state_pspecs(_port_state()[0], tmesh.MeshPlan.create(tp=2))
    from edl_tpu_torch.parallel.sharding import spec_leaves

    assert set(spec_leaves(sp.params)) == {()}
    assert set(sp.opt_state.values()) == {()}


def test_process_device_zero_is_the_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.process_device(0)


@pytest.mark.parametrize("env,match", [
    ({"EDL_P2P": "0", "EDL_MESH": "fsdp", "EDL_LOCAL_DEVICES": "1"},
     "item 2b"),
    ({"EDL_P2P": "0", "EDL_LOCAL_DEVICES": "2"}, "item 2b"),
])
def test_worker_refuses_what_is_not_ported_yet(server, env, match):
    cfg = twc.WorkerConfig.from_env({
        **env, "EDL_COORDINATOR": f"127.0.0.1:{server.port}",
        "EDL_WORKER_ID": "wx", "EDL_JOB_NAME": "refuse"})
    with pytest.raises(NotImplementedError, match=match):
        ElasticWorker(cfg).run()
    cl = server.client()
    assert "wx" not in [m.name for m in cl.members()]  # never joined
    cl.close()


def test_a_dp_job_migrates_to_disjoint_workers_from_peers_ram():
    """chip_smoke.py's p2p migration on the CPU (CTR at vocab 4096): w000
    and w001 train, then w002 and w003 start while both originals drain
    (SIGTERM); the new world restores from the leavers' RAM over the
    shard plane — ``restore_last`` is ``p2p:``, no shard file is read,
    the state it brings up is the leavers' last snapshot by digest — and
    finishes the queue with exact accounting."""
    import chip_smoke

    c = dict(chip_smoke.P2P_MIGRATION, vocab=4096, per_device_batch=64,
             tasks=200, linger_s=60.0, timeout_s=240)
    row = chip_smoke.p2p_migration("cpu", device="cpu", c=c)
    assert all(row["gates"].values()), row["gates"]
    assert row["kv"]["restore_last"] == f"p2p:{row['leavers_step']}"
    assert row["queue"] == {"todo": 0, "leased": 0, "done": 200, "dead": 0,
                            "epoch": 0}
    assert set(row["exit_codes"].values()) == {0}
    for w in ("w002", "w003"):
        assert row["pieces_read"][w]["disk"] == 0
        assert row["restore_bytes"][w] > 0


def test_the_step_factories_take_the_reference_signature():
    """``bench.py`` passes ``param_pspecs`` positionally."""
    from edl_tpu_torch.models import linreg

    tx = ttrainer.adam(1e-2)
    one = tmesh.MeshPlan.create()
    for make in (ttrainer.make_train_step, ttrainer.make_train_multistep):
        make(linreg.loss_fn, tx, one, None, None)
        make(linreg.loss_fn, tx, one, None, param_pspecs=None, donate=False)
    with pytest.raises(NotImplementedError, match="item 2b"):
        ttrainer.make_train_step(linreg.loss_fn, tx,
                                 tmesh.MeshPlan.create(dp=2, tp=2),
                                 tmesh.Mesh(torch.device("cpu"), 4, 0))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ttrainer.LocalSyncStepper(linreg.loss_fn, tx, one, object())


def test_chip_smoke_reads_the_worker_logs():
    """chip_smoke.py's elastic report parses the workers' ``key=repr``
    log lines and the store hosts' up lines; the epoch of a SIGKILLed
    worker counts its rows as w000's."""
    import chip_smoke

    line = ("2026-01-01 00:00:00,000 INFO  [edl_tpu_torch.worker] {msg} "
            "{kv}")
    kv = ("epoch={e} rank={r} world={w} peak_mem_bytes={m} steps={n} "
          "rows={rows} step_s=1.0 allreduce_s=0.5 first_t={a} last_t={b}")
    lead = [kv.format(e=2, r=0, w=2, m=5, n=10, rows=40, a=1.0, b=3.0),
            kv.format(e=3, r=0, w=3, m=6, n=4, rows=16, a=4.5, b=6.0)]
    logs = {
        "w000": "\n".join([line.format(msg="epoch stats", kv=k)
                           for k in lead] + [
            line.format(msg="store host spawned", kv="epoch=3 t=3.25"),
            line.format(msg="epoch up", kv="epoch=3 rank=0 world=3 "
                        "dist='a b' device='cpu' backend='gloo' t=4.0")]),
        "w001": line.format(msg="epoch stats", kv=kv.format(
            e=2, r=1, w=2, m=7, n=10, rows=40, a=1.0, b=3.0)),
        "w002": "\n".join([
            line.format(msg="boot", kv="worker='w002' main=10.0 imports=11.0 "
                        "device_ready=12.0 registered=12.5 device='cpu'"),
            line.format(msg="epoch up", kv="epoch=3 rank=2 world=3 "
                        "dist='a b' device='cpu' backend='gloo' t=13.0"),
            line.format(msg="restored", kv="step=9 from_ram=False "
                        "load_s=0.25"),
            line.format(msg="restore done", kv="epoch=3 step=9 "
                        "dist_s=13.5 t=14.0"),
            line.format(msg="epoch stats", kv=kv.format(
                e=3, r=2, w=3, m=9, n=4, rows=16, a=14.5, b=15.0))]),
    }
    assert chip_smoke._log_records(logs["w002"], "epoch up")[0]["dist"] == \
        "a b"
    hosts = {3: "dist_service up epoch=3 port=1 pid=2 t=3.75\n"}
    stalls, boots, commits, epochs, peaks = chip_smoke._elastic_report(
        logs, hosts, [("grow", 9.0)], {"w002": 9.5})
    joiner = boots["w002"]
    assert stalls == [{"worlds": [2, 3], "epochs": [2, 3], "stall_s": 1.5,
                       "last_step_to_epoch_up_s": 1.0,
                       "store_host_boot_s": 0.5,
                       "event": "grow", "event_to_first_step_s": -4.5}]
    assert joiner["rendezvous_s"] == 0.5 and joiner["restore_s"] == 0.5
    assert joiner["total_s"] == 14.5 - 9.5 and commits == []
    # epoch 3: w000's and w002's rows, w001's (killed) taken as w000's
    assert [e["examples"] for e in epochs] == [80, 16 + 16 + 16]
    assert peaks == {"w000": 6, "w001": 7, "w002": 9}
