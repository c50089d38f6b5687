"""Port parity of the mesh slice: ``parallel/{mesh,sharding,collectives}``,
``models/llama.param_pspecs`` and its forward over a mesh,
``ops/embedding.sharded_embedding_lookup`` and the trainer's sharded
step, against the JAX reference.

The pure functions (plan arithmetic, partition specs, each rank's local
slice) are held to the reference's on the ``cpu_devices`` fixture. The
sharded step runs on a pool of four gloo processes on the CPU
(``utils/platform.ProcessPool``, one for the module): ``LlamaConfig.tiny``
in f32 from the reference's init carried through NumPy, on fsdp2 x tp2,
dp2 x tp2 and dp2 x fsdp2, against the reference's ``make_train_step``
on the same plan over four virtual devices. The port runs its flash
path (the plain version on the CPU, on each tp rank's local heads); the
reference its dense attention (the same math).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import ctr as jctr
from edl_tpu.models import llama as jl
from edl_tpu.ops import embedding as jemb
from edl_tpu.parallel import sharding as jshd
from edl_tpu.parallel.mesh import MeshPlan as JMeshPlan
from edl_tpu.train import trainer as jtrainer
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.parallel import sharding as tshd
from edl_tpu_torch.parallel.mesh import MeshPlan
from edl_tpu_torch.train import mesh_check
from edl_tpu_torch.utils.platform import ProcessPool
from tests import torch_pool_cases as cases

torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny()
FLAGSHIP = dict(vocab=32768, d_model=2048, n_layers=16, n_heads=16,
                n_kv_heads=8, d_ff=6144)
PLANS = [dict(fsdp=2), dict(fsdp=3), dict(fsdp=6), dict(tp=2),
         dict(dp=2, fsdp=2, tp=2), dict(fsdp=2, tp=2), dict(dp=2, tp=2),
         dict(dp=2, fsdp=2)]
MESH_PLANS = [dict(fsdp=2, tp=2), dict(dp=2, tp=2), dict(dp=2, fsdp=2)]
B, T = 4, 16
# params after 3 steps. AdamW normalizes each gradient entry, so an entry
# that cancels to ~0 turns its summation-order rounding (the reference's
# XLA reductions vs the port's collectives) into up to a fraction of lr:
# test_torch_train.py's Adam bound, 2e-5. Adafactor's update is scaled by
# row and column RMS, which rounding does not flip.
PARAM_TOL = {"adamw": dict(atol=2e-5, rtol=0),
             "adafactor": dict(atol=1e-5, rtol=1e-5)}


def _ids(p):
    return "x".join(f"{k}{v}" for k, v in p.items())


@pytest.fixture(scope="module")
def pool():
    with ProcessPool(4, device="cpu", timeout_s=240, threads=1) as p:
        yield p


def _jp(spec):
    return tuple(spec)


def _items(tree, prefix=""):
    """[(key, leaf)] of a nested dict of arrays, keyed "a/b"."""
    out = []
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out += _items(v, key) if isinstance(v, dict) else [(key, v)]
    return out


# -- pure functions --------------------------------------------------------------


@pytest.mark.parametrize("sizes", PLANS, ids=_ids)
def test_plan_arithmetic_matches_the_reference(sizes):
    from edl_tpu.api.job import MeshSpec as JSpec
    from edl_tpu_torch.api.job import MeshSpec as TSpec

    t, j = MeshPlan.create(**sizes), JMeshPlan.create(**sizes)
    assert (t.axes, t.names, t.shape, t.size()) == \
        (j.axes, j.names, j.shape, j.size())
    assert t.batch_axes() == j.batch_axes()
    assert t.batch_shards() == j.batch_shards()
    assert t.describe() == j.describe()
    assert t.batch_pspec() == _jp(j.batch_pspec())
    for rank in (2, 3):
        assert t.sequence_pspec(rank) == _jp(j.sequence_pspec(rank))
    n = t.size()
    for m in (n, 2 * n):
        spec = {k: v for k, v in sizes.items() if k != "dp"}
        assert MeshPlan.from_spec(TSpec(**spec), m) == \
            MeshPlan(JMeshPlan.from_spec(JSpec(**spec), m).axes)
    assert MeshPlan.fsdp_only(n).axes == JMeshPlan.fsdp_only(n).axes
    assert MeshPlan.data_parallel(n).axes == JMeshPlan.data_parallel(n).axes
    assert t.slice_layout() == j.slice_layout([None] * n)


@pytest.mark.parametrize("model", ["tiny", "flagship"])
@pytest.mark.parametrize("sizes", PLANS, ids=_ids)
def test_pspecs_match_the_reference(model, sizes):
    jcfg = JCFG if model == "tiny" else jl.LlamaConfig(**FLAGSHIP)
    tcfg = tl.LlamaConfig.tiny() if model == "tiny" else \
        tl.LlamaConfig(**FLAGSHIP)
    t, j = MeshPlan.create(**sizes), JMeshPlan.create(**sizes)
    jspecs = jl.param_pspecs(jcfg, j)
    tspecs = tl.param_pspecs(tcfg, t)
    flat_j = dict(tshd.spec_items(jax.tree_util.tree_map(
        tuple, jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))))
    assert dict(tshd.spec_items(tspecs)) == flat_j
    # the generic rules over the same shapes
    shapes = [(jcfg.vocab, jcfg.d_model), (jcfg.n_layers, jcfg.d_model,
                                            jcfg.d_ff), (7,), (6, 4), ()]
    for shape in shapes:
        for f in (1, 2, 3, 6):
            assert tshd.fsdp_pspec(shape, f) == \
                _jp(jshd.fsdp_pspec(shape, f))
        assert tshd.fit_pspec(t, shape, *(["fsdp", "tp", None][:len(shape)])) \
            == _jp(jshd.fit_pspec(j, shape,
                                  *(["fsdp", "tp", None][:len(shape)])))
    ctr_shapes = jax.tree_util.tree_map(
        lambda x: x, jctr.init_params(jax.random.PRNGKey(0), vocab=4096,
                                      emb=8))
    jctr_specs = jshd.param_pspecs(ctr_shapes, j)
    tctr = tshd.param_pspecs(jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), ctr_shapes), t)
    assert dict(tshd.spec_items(tctr)) == dict(tshd.spec_items(
        jax.tree_util.tree_map(tuple, jctr_specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))))


@pytest.mark.parametrize("sizes", PLANS, ids=_ids)
def test_local_slices_are_the_reference_shards(sizes, cpu_devices):
    """Each mesh rank's box of every llama tiny leaf is the reference's
    addressable shard of the device at the same mesh position."""
    t, j = MeshPlan.create(**sizes), JMeshPlan.create(**sizes)
    jmesh = j.build(cpu_devices[:j.size()])
    devs = list(np.asarray(jmesh.devices).reshape(-1))
    params = jl.init_params(jax.random.PRNGKey(0), JCFG)
    jspecs = jl.param_pspecs(JCFG, j)
    tspecs = dict(tshd.spec_items(tl.param_pspecs(tl.LlamaConfig.tiny(), t)))
    placed = jshd.shard_tree(params, jmesh, jspecs)
    for key, leaf in _items(placed):
        by_dev = {s.device: s for s in leaf.addressable_shards}
        for r, d in enumerate(devs):
            off, ext = tshd.local_box(leaf.shape, tspecs[key], t,
                                      t.coords(r))
            sh = by_dev[d]
            assert ext == sh.data.shape, (key, r)
            assert off == tuple(int(s.start or 0) for s in sh.index), \
                (key, r)


# -- over the pool ---------------------------------------------------------------


def _batches(n, seed=0, t=T, b=B, vocab=JCFG.vocab):
    rng = np.random.RandomState(seed)
    return [jl.synthetic_tokens(rng, b, t, vocab) for _ in range(n)]


def _ref_steps(sizes, opt, batches, devices, cfg=JCFG, lr=1e-3):
    jplan = JMeshPlan.create(**sizes)
    jmesh = jplan.build(devices[:jplan.size()])
    tx = {"adamw": optax.adamw, "adafactor": optax.adafactor}[opt](lr)
    jps = jl.param_pspecs(cfg, jplan)
    state = jtrainer.shard_state(jtrainer.TrainState.create(
        jl.init_params(jax.random.PRNGKey(0), cfg), tx), jplan, jmesh, jps)
    step = jtrainer.make_train_step(jl.make_loss_fn(cfg, jplan, jmesh), tx,
                                    jplan, jmesh, jps)
    losses = []
    for b in batches:
        state, m = step(state, jtrainer.global_batch(b, jplan, jmesh))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


_PARAMS_NP = None


def _params_np():
    global _PARAMS_NP
    if _PARAMS_NP is None:
        p = jl.init_params(jax.random.PRNGKey(0), JCFG)
        _PARAMS_NP = mesh_check.flat(jax.tree_util.tree_map(np.asarray, p))
    return _PARAMS_NP


TINY_KW = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=128, dtype="float32", use_flash=True)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("sizes", MESH_PLANS, ids=_ids)
def test_sharded_llama_step_matches_the_reference(pool, sizes, opt,
                                                  cpu_devices):
    batches = _batches(3)
    out = pool.run(cases.mesh_steps, "llama", _params_np(), batches,
                   sizes, opt, 1e-3, TINY_KW)
    got = out[0]
    ref_losses, ref_params = _ref_steps(sizes, opt, batches, cpu_devices)
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5,
                               atol=1e-5)
    ref = mesh_check.flat(ref_params)
    assert set(got["params"]) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got["params"][k], ref[k], err_msg=k,
                                   **PARAM_TOL[opt])
    # every rank saw the same global losses
    for o in out[1:]:
        assert o["losses"] == got["losses"]


def test_sharded_grads_equal_the_one_process_grads(pool):
    """fsdp2 x tp2 gradients gathered whole equal the reference's
    ``jax.grad`` of the whole batch's loss."""
    batches = _batches(1, seed=3)
    got = pool.run(cases.mesh_steps, "llama", _params_np(), batches,
                   dict(fsdp=2, tp=2), "adamw", 1e-3, TINY_KW,
                   grads=True)[0]
    p = jl.init_params(jax.random.PRNGKey(0), JCFG)
    g = jax.grad(jl.make_loss_fn(JCFG))(p, batches[0])
    ref = mesh_check.flat(jax.tree_util.tree_map(np.asarray, g))
    for k in ref:
        np.testing.assert_allclose(got["grads"][k], ref[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_tp_flash_heads_keep_their_gqa_groups(pool):
    """At T=128 the port's flash path runs on each tp rank's 2 query
    heads and 1 KV head (tp=2 of H4 KV2); the loss equals the
    reference's dense one-process loss: a wrong q → kv group would not."""
    batches = _batches(1, seed=5, t=128)
    got = pool.run(cases.mesh_steps, "llama", _params_np(), batches,
                   dict(dp=2, tp=2), "adamw", 1e-3, TINY_KW)[0]
    p = jl.init_params(jax.random.PRNGKey(0), JCFG)
    ref = float(jl.make_loss_fn(JCFG)(p, batches[0]))
    np.testing.assert_allclose(got["losses"][0], ref, rtol=1e-5)


def _sharded_lookup_case(table_np, ids_np, ct_np):
    import torch.distributed as dist

    from edl_tpu_torch.ops.embedding import sharded_embedding_lookup

    _, mesh, _ = mesh_check.pool_mesh(dict(dp=2, tp=2), "cpu")
    tp = mesh.group("tp")
    per = table_np.shape[0] // tp.size
    tab = torch.tensor(table_np[tp.rank * per:(tp.rank + 1) * per],
                       requires_grad=True)
    out = sharded_embedding_lookup(tab, torch.tensor(ids_np), mesh, "tp")
    (out * torch.tensor(ct_np)).sum().backward()
    return {"rank": dist.get_rank(), "tp": tp.rank,
            "out": out.detach().numpy(), "grad": tab.grad.numpy()}


def test_sharded_embedding_lookup_matches_the_reference(pool, cpu_devices):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(0)
    table = rng.randn(64, 8).astype(np.float32)
    ids = rng.randint(-3, 70, size=(5, 7)).astype(np.int32)
    ct = rng.randn(5, 7, 8).astype(np.float32)
    mesh = Mesh(np.array(cpu_devices[:2]), ("tp",))
    tab = jax.device_put(table, NamedSharding(mesh, P("tp", None)))

    def f(t):
        return (jemb.sharded_embedding_lookup(t, ids, mesh, "tp") * ct).sum()

    jout = np.asarray(jax.jit(lambda t: jemb.sharded_embedding_lookup(
        t, ids, mesh, "tp"))(tab))
    jgrad = np.asarray(jax.jit(jax.grad(f))(tab))
    for r in pool.run(_sharded_lookup_case, table, ids, ct):
        np.testing.assert_allclose(r["out"], jout, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["grad"], jgrad[r["tp"] * 32:
                                                    (r["tp"] + 1) * 32],
                                   rtol=1e-6, atol=1e-6)


def _collective_case():
    from edl_tpu_torch.parallel import collectives as coll

    _, mesh, pool = mesh_check.pool_mesh(dict(fsdp=2, tp=2), "cpu")
    fs = mesh.group("fsdp")
    x = torch.arange(4.0) + 10 * fs.rank
    g = coll.all_gather(x, 0, fs)
    rs = coll.reduce_scatter(torch.arange(4.0) * (fs.rank + 1), 0, fs)
    m = torch.tensor([float(mesh.rank)])
    coll.all_reduce(m, pool, "max")
    b = torch.tensor([float(mesh.rank)])
    coll.broadcast(b, 0, pool)
    return {"coords": mesh.coords(), "gather": g.tolist(),
            "rs": rs.tolist(), "max": float(m), "b": float(b),
            "stats": coll.stats()}


def test_collectives_over_the_pool(pool):
    out = pool.run(_collective_case)
    for r, o in enumerate(out):
        c = o["coords"]
        assert c == {"fsdp": r // 2, "tp": r % 2}
        assert o["gather"] == [0, 1, 2, 3, 10, 11, 12, 13]
        # sum over fsdp of arange * (1, 2) = 3 * arange, then my half
        assert o["rs"] == [3.0 * i for i in range(4)][c["fsdp"] * 2:
                                                        c["fsdp"] * 2 + 2]
        assert o["max"] == 3.0 and o["b"] == 0.0
        # CPU tensors are never staged
        assert all(v["staged_bytes"] == 0 for v in o["stats"].values())


def test_the_backend_follows_the_topology():
    from edl_tpu_torch.parallel.collectives import choose_backend

    assert choose_backend("cpu", 0, 4)[0] == "gloo"
    assert choose_backend("cuda", 4, 4)[0] == "nccl"
    assert choose_backend("cuda", 8, 4)[0] == "nccl"
    backend, why = choose_backend("cuda", 1, 4)
    assert backend == "gloo" and "share" in why


def test_sp_pp_ep_plans_name_their_items():
    """ep still waits for its item; sp and pp are ported
    (tests/test_torch_sp_pp.py)."""
    with pytest.raises(NotImplementedError, match="item 2e"):
        MeshPlan.create(ep=2).build([torch.device("cpu")])


def test_remat_policies_and_multistep_over_a_mesh(pool):
    """On dp2 x tp2 at T=128 (the flash path on each rank's heads): every
    remat policy gives the no-remat loss and gradients ("attn" keeps
    each tp rank's flash outputs), and make_train_multistep over
    stack_batches equals as many make_train_step calls."""
    batches = _batches(2, seed=7, t=128)
    got = pool.run(cases.remat_and_multistep, _params_np(), TINY_KW,
                   batches, dict(dp=2, tp=2))[0]
    base = got["loss"]["None"]
    for policy in ("full", "attn", "mlp", "dots"):
        np.testing.assert_allclose(got["loss"][policy], base, rtol=1e-6)
        assert got["grad_diff"][policy] <= 1e-6, policy
    a, b = got["runs"]["step"], got["runs"]["multistep"]
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_workload_loss_for_picks_the_mesh_loss():
    """``Workload.loss_for`` (the reference's): llama's mesh loss for a
    mesh that splits params, the static loss for none."""
    from edl_tpu_torch.parallel.mesh import Mesh
    from edl_tpu_torch.runtime import workloads as twl
    from edl_tpu_torch.runtime.worker_config import WorkerConfig

    wl = twl.WORKLOADS["llama"](WorkerConfig.from_env({"EDL_MODEL": "llama"}))
    assert not getattr(wl.loss_for(None, None), "local_shards", False)
    plan = MeshPlan.create(tp=2)
    mesh = Mesh(torch.device("cpu"), 2, 0, plan=plan, ranks=(0, 1))
    assert getattr(wl.loss_for(plan, mesh), "local_shards", False)
    lin = twl.WORKLOADS["linreg"](WorkerConfig.from_env({}))
    assert lin.loss_for(plan, mesh) is lin.loss_fn
    assert wl.pspecs(plan)["layers"]["wq"] == (None, None, "tp")


def test_apply_chip_grant_resolves_to_a_feasible_worker_count():
    """The elastic surface on a pool of one process: a grant of any chip
    count floors at one worker, an infeasible target is ignored."""
    from edl_tpu_torch.models import linreg
    from edl_tpu_torch.runtime.elastic import ElasticTrainer

    tr = ElasticTrainer(linreg.loss_fn, tl_sgd(), device="cpu")
    tr.start(linreg.init_params(torch.Generator().manual_seed(0),
                                device="cpu"), 1)
    assert tr.apply_chip_grant(5) == 5 and tr._resolve_target(5) == 1
    assert tr.apply_chip_grant(0) == 1
    with pytest.raises(ValueError):
        tr.apply_chip_grant(-1)
    assert not tr._feasible(2) and tr._feasible(1)
    tr._maybe_rescale()  # target 1 == current: nothing happens
    assert tr.report.reshards == [] and tr.n_workers == 1


def tl_sgd():
    from edl_tpu_torch.train import trainer

    return trainer.sgd(0.1)
