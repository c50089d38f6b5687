"""Port parity of sequence and pipeline parallelism:
``parallel/{ring_attention,ulysses,pipeline}``, ``parallel/collectives``'
``ppermute`` and ``all_to_all``, llama's sp and pp forward and loss, the
trainer's sums over sp and pp, and ``ElasticTrainer`` with sp pinned,
against the JAX reference.

The port runs on one module-scoped pool of four gloo processes on the
CPU (``utils/platform.ProcessPool``); the reference on four of the
``cpu_devices`` fixture's virtual devices. Llama runs
``LlamaConfig.tiny()`` in f32 from the reference's init carried through
NumPy (``tests/llama_harness.loss_curve``'s: PRNGKey(1), batches of 8 x
16, SGD 1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from edl_tpu.models import llama as jl
from edl_tpu.parallel import pipeline as jpipe
from edl_tpu.parallel import ring_attention as jring
from edl_tpu.parallel import ulysses as jul
from edl_tpu.parallel.mesh import MeshPlan as JMeshPlan
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.parallel import sharding as tshd
from edl_tpu_torch.parallel.mesh import Mesh, MeshPlan
from edl_tpu_torch.parallel.ring_attention import reference_attention
from edl_tpu_torch.train import mesh_check
from edl_tpu_torch.utils.platform import ProcessPool
from tests import torch_pool_cases as cases
from tests.llama_harness import loss_curve

torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny()
CFG_KW = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, dtype="float32")
FLAGSHIP = dict(vocab=32768, d_model=2048, n_layers=16, n_heads=16,
                n_kv_heads=8, d_ff=6144)


def _ids(p):
    return "x".join(f"{k}{v}" for k, v in p.items())


@pytest.fixture(scope="module")
def pool():
    with ProcessPool(4, device="cpu", timeout_s=240, threads=1) as p:
        yield p


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- attention over sp ------------------------------------------------------------

ATTN_CASES = [
    # (impl, plan, causal, b, t, h, kv, d)
    ("ring", dict(sp=4), True, 2, 32, 4, 4, 16),
    ("ring", dict(sp=4), False, 2, 32, 4, 4, 16),
    ("ring", dict(dp=2, sp=2), True, 4, 16, 4, 2, 8),
    ("ring", dict(dp=2, sp=2), False, 4, 16, 4, 2, 8),
    ("ulysses", dict(sp=4), True, 2, 32, 8, 8, 16),
    ("ulysses", dict(sp=4), False, 2, 32, 8, 4, 16),
    ("ulysses", dict(dp=2, sp=2), True, 4, 16, 4, 2, 8),
    ("ulysses", dict(sp=4), True, 2, 32, 8, 2, 16),  # kv 2: expanded first
]


def _attn_id(c):
    return f"{c[0]}-{_ids(c[1])}-{'causal' if c[2] else 'full'}-kv{c[6]}"


@pytest.mark.parametrize("case", ATTN_CASES, ids=[_attn_id(c)
                                                  for c in ATTN_CASES])
def test_sp_attention_matches_the_reference(pool, cpu_devices, case):
    """Each rank's output rows and positions equal the reference's
    sharded call (and the oracle) within 1e-5; the ranks' q gradients
    under a fixed output weight equal the unsharded oracle's."""
    impl, sizes, causal, b, t, h, kv, d = case
    rng = np.random.RandomState(len(sizes) + h + kv + causal)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, t, kv, d).astype(np.float32)
    v = rng.randn(b, t, kv, d).astype(np.float32)
    plan = JMeshPlan.create(**sizes)
    mesh = plan.build(cpu_devices[:plan.size()])
    bspec = "dp" if "dp" in sizes else None
    sh = NamedSharding(mesh, P(bspec, "sp", None, None))
    fn = jring.ring_attention if impl == "ring" else jul.ulysses_attention

    def f(q_):
        return fn(q_, jax.device_put(k, sh), jax.device_put(v, sh), mesh,
                  causal=causal)

    ref = np.asarray(f(jax.device_put(q, sh)))
    out = pool.run(cases.seq_attention, impl, q, k, v, sizes, causal)
    tq = torch.tensor(q, requires_grad=True)
    oracle = reference_attention(
        tq, torch.tensor(np.repeat(k, h // kv, axis=2)),
        torch.tensor(np.repeat(v, h // kv, axis=2)), causal)
    # each rank's fixed weight over its part of the output
    w = torch.zeros(oracle.shape)
    for o in out:
        r0, r1 = o["rows"]
        t0, n = o["pos0"], o["out"].shape[1]
        w[r0:r1, t0:t0 + n] = torch.linspace(
            -1.0, 1.0, o["out"].size).reshape(o["out"].shape)
    (oracle * w).sum().backward()
    oracle = oracle.detach().numpy()
    for o in out:
        r0, r1 = o["rows"]
        t0, n = o["pos0"], o["out"].shape[1]
        np.testing.assert_allclose(o["out"], ref[r0:r1, t0:t0 + n],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(o["out"], oracle[r0:r1, t0:t0 + n],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(o["dq"], tq.grad.numpy()[r0:r1,
                                                            t0:t0 + n],
                                   atol=1e-5, rtol=1e-5)


def test_reference_attention_is_the_reference():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    for causal in (True, False):
        got = reference_attention(*(torch.tensor(x) for x in (q, k, v)),
                                  causal=causal).numpy()
        want = np.asarray(jring.reference_attention(q, k, v, causal=causal))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _fake_mesh(sizes):
    """A port Mesh whose groups have their sizes but no process group:
    enough for the checks a call makes before its first collective."""
    plan = MeshPlan.create(**sizes)
    groups = {a: coll.Group(None, n, 0) for a, n in plan.axes if n > 1}
    return Mesh(torch.device("cpu"), plan.size(), 0, plan=plan,
                ranks=tuple(range(plan.size())), groups=groups)


def test_ulysses_rejects_indivisible_heads(cpu_devices):
    from edl_tpu_torch.parallel.ulysses import ulysses_attention

    x = torch.zeros(1, 8, 6, 4)  # 6 heads, sp=4
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(x, x, x, _fake_mesh(dict(sp=4)))
    plan = JMeshPlan.create(sp=4)
    with pytest.raises(ValueError, match="not divisible"):
        jul.ulysses_attention(jnp.zeros((1, 8, 6, 4)), jnp.zeros((1, 8, 6, 4)),
                              jnp.zeros((1, 8, 6, 4)),
                              plan.build(cpu_devices[:4]))


# -- the pipeline -----------------------------------------------------------------


def _stage_params(n, d, seed=0, scale_b=0.1):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(n, d, d) * 0.3).astype(np.float32),
            "b": (rng.randn(n, d) * scale_b).astype(np.float32)}


@pytest.mark.parametrize("sizes,n_micro,mb", [
    (dict(pp=4), 8, 4), (dict(dp=2, pp=2), 4, 4), (dict(pp=2), 2, 2)],
    ids=["pp4", "dp2xpp2", "pp2"])
def test_pipeline_matches_sequential_and_the_reference_grads(
        pool, cpu_devices, sizes, n_micro, mb):
    """The last stage's output equals the stages run in order (and the
    reference's ``pipeline_apply``) within 1e-5; each stage's gradient
    of mean(out²) is within 1e-5 relative L2 of ``jax.grad`` of the
    reference's."""
    n, d = sizes["pp"], 16
    params = _stage_params(n, d)
    x = np.random.RandomState(1).randn(n_micro, mb, d).astype(np.float32)
    ref = x
    for s in range(n):
        ref = np.tanh(ref @ params["w"][s] + params["b"][s])
    plan = JMeshPlan.create(**sizes)
    mesh = plan.build(cpu_devices[:plan.size()])

    def jloss(p):
        y = jpipe.pipeline_apply(lambda pp_, xx: jnp.tanh(xx @ pp_["w"]
                                                          + pp_["b"]),
                                 p, x, mesh, data_axes=plan.batch_axes())
        return jnp.mean(y ** 2), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(np.asarray(jy), ref, atol=1e-5)
    out = [o for o in pool.run(cases.pipeline_case, params, x, sizes)
           if o is not None]
    for o in out:
        if o["out"] is not None:
            r0, r1 = o["rows"]
            np.testing.assert_allclose(o["out"], ref[:, r0:r1], atol=1e-5)
        for k in ("w", "b"):
            assert _rel_l2(o["grads"][k], np.asarray(jg[k])[o["stage"]]) \
                <= 1e-5, (k, o["stage"])
    assert sum(o["out"] is not None for o in out) == plan.size() // n


def test_pipeline_checks_the_stage_count():
    from edl_tpu_torch.parallel.pipeline import pipeline_apply

    params = {"w": torch.zeros(3, 4, 4)}
    with pytest.raises(ValueError, match="leading dim 3 != pp"):
        pipeline_apply(lambda p, h: h, params, torch.zeros(2, 1, 4),
                       _fake_mesh(dict(pp=2)))


# -- llama over sp and pp ---------------------------------------------------------


_PARAMS = {}


def _params_np(seed=1, **over):
    key = (seed, tuple(sorted(over.items())))
    if key not in _PARAMS:
        cfg = dataclasses.replace(JCFG, **over)
        p = jl.init_params(jax.random.PRNGKey(seed), cfg)
        _PARAMS[key] = mesh_check.flat(jax.tree_util.tree_map(np.asarray,
                                                               p))
    return _PARAMS[key]


LLAMA_PLANS = [
    (dict(dp=2, sp=2), {}),
    (dict(dp=2, sp=2), {"sp_impl": "ulysses"}),
    (dict(fsdp=2, sp=2), {"remat": True}),
    (dict(dp=2, pp=2), {}),
    (dict(dp=2, pp=2), {"pp_microbatches": 4}),
    (dict(pp=2, tp=2), {}),
    (dict(pp=2, fsdp=2), {}),
    (dict(pp=4), {"n_layers": 4}),
]


def _plan_id(c):
    sizes, over = c
    return _ids(sizes) + "".join(f"-{k}{v}" for k, v in over.items())


@pytest.mark.parametrize("case", LLAMA_PLANS,
                         ids=[_plan_id(c) for c in LLAMA_PLANS])
def test_llama_loss_curve_and_grads_match_the_reference(pool, cpu_devices,
                                                        case):
    """3 SGD steps on the plan equal the reference's ``loss_curve`` on
    the same plan over four virtual devices within 1e-5 relative; the
    first batch's gathered gradients are within 1e-5 relative L2 of
    the reference's one-process ``jax.grad``."""
    sizes, over = case
    jover = {k: v for k, v in over.items()}
    jcfg = dataclasses.replace(JCFG, **jover)
    ref = loss_curve(JMeshPlan.create(**sizes), cfg=jcfg)
    shape_over = {k: v for k, v in over.items() if k == "n_layers"}
    params = _params_np(**shape_over)
    batches = [jl.synthetic_tokens(np.random.RandomState(i), 8, 16,
                                   jcfg.vocab) for i in range(3)]
    got = pool.run(cases.mesh_steps, "llama", params, batches, sizes, "sgd",
                   1e-2, {**CFG_KW, **over}, grads=True)
    np.testing.assert_allclose(got[0]["losses"], ref, rtol=1e-5)
    for o in got[1:]:
        assert o["losses"] in ([], got[0]["losses"])
    p = jax.tree_util.tree_map(jnp.asarray, mesh_check.unflat(params))
    g = jax.grad(jl.make_loss_fn(jcfg))(p, batches[0])
    want = mesh_check.flat(jax.tree_util.tree_map(np.asarray, g))
    for k in want:
        assert _rel_l2(got[0]["grads"][k], want[k]) <= 1e-5, k


@pytest.mark.parametrize("sizes", [dict(dp=2, sp=2), dict(sp=4)],
                         ids=_ids)
def test_sp_logits_are_the_unsharded_logits(pool, sizes):
    """Every rank's logits — its rows, its T / sp positions — equal the
    reference's unsharded forward within 2e-4 (the reference's bar)."""
    params = _params_np(seed=0)
    toks = (np.arange(4 * 16, dtype=np.int32).reshape(4, 16) % JCFG.vocab)
    p = jax.tree_util.tree_map(jnp.asarray, mesh_check.unflat(params))
    ref = np.asarray(jl.forward(p, jnp.asarray(toks), JCFG))
    out = pool.run(cases.sp_logits, params, CFG_KW, toks, sizes)
    for o in out:
        r0, r1 = o["rows"]
        t0, n = o["pos0"], o["logits"].shape[1]
        assert n == 16 // sizes["sp"]
        np.testing.assert_allclose(o["logits"], ref[r0:r1, t0:t0 + n],
                                   atol=2e-4)


@pytest.mark.parametrize("model", ["tiny", "flagship"])
@pytest.mark.parametrize("sizes", [dict(dp=4, pp=2), dict(pp=2, fsdp=2, tp=2),
                                   dict(pp=4), dict(dp=2, sp=4),
                                   dict(fsdp=2, sp=2, dp=2)], ids=_ids)
def test_pp_and_sp_pspecs_match_the_reference(model, sizes, cpu_devices):
    """``param_pspecs`` with pp (the layer axis over pp) and sp equal
    the reference's, and each rank's box of every leaf is the
    reference's addressable shard of the device at its mesh place."""
    jcfg = (dataclasses.replace(JCFG, n_layers=4) if model == "tiny"
            else jl.LlamaConfig(**FLAGSHIP))
    tcfg = tl.LlamaConfig(**{k: getattr(jcfg, k) for k in (
        "vocab", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff")})
    t, j = MeshPlan.create(**sizes), JMeshPlan.create(**sizes)
    jspecs = jl.param_pspecs(jcfg, j)
    flat_j = dict(tshd.spec_items(jax.tree_util.tree_map(
        tuple, jspecs, is_leaf=lambda x: isinstance(x, P))))
    tspecs = dict(tshd.spec_items(tl.param_pspecs(tcfg, t)))
    assert tspecs == flat_j
    assert t.sequence_pspec(3) == tuple(j.sequence_pspec(3))
    if model == "flagship":
        return
    jmesh = j.build(cpu_devices[:j.size()])
    devs = list(np.asarray(jmesh.devices).reshape(-1))
    from edl_tpu.parallel import sharding as jshd

    placed = jshd.shard_tree(jl.init_params(jax.random.PRNGKey(0), jcfg),
                             jmesh, jspecs)
    for key, spec in tspecs.items():
        node = placed
        for part in key.split("/"):
            node = node[part]
        by_dev = {s.device: s for s in node.addressable_shards}
        for r, dv in enumerate(devs):
            off, ext = tshd.local_box(node.shape, spec, t, t.coords(r))
            sh = by_dev[dv]
            assert ext == sh.data.shape, (key, r)
            assert off == tuple(int(s.start or 0) for s in sh.index), \
                (key, r)


def test_refusals_keep_the_references_messages():
    """sp with pp, the "attn" remat under sp, an indivisible sequence
    and ep each raise with the reference's words."""
    cfg = tl.LlamaConfig(**{**CFG_KW, "dtype": torch.float32})
    toks = torch.zeros(4, 16, dtype=torch.long)
    mesh = _fake_mesh(dict(dp=2, sp=2, pp=2))
    with pytest.raises(ValueError, match="sp and pp"):
        tl.forward({}, toks, cfg, mesh=mesh, plan=mesh.layout)
    attn = dataclasses.replace(cfg, remat=True, remat_policy="attn",
                               use_flash=True)
    mesh = _fake_mesh(dict(dp=4, sp=2))
    with pytest.raises(ValueError, match="flash kernel"):
        tl.forward({}, torch.zeros(4, 128, dtype=torch.long), attn,
                   mesh=mesh, plan=mesh.layout)
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        tl.make_loss_fn(cfg, mesh.layout, mesh)(
            {}, {"tokens": torch.zeros(4, 16, dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="item 2e"):
        MeshPlan.create(ep=2).build([torch.device("cpu")])


def test_elastic_sp_rescale_matches_the_reference(pool, cpu_devices):
    """``ElasticTrainer(MeshSpec(sp=2), chips_per_worker=2)``, 1 → 2
    workers, 3 adam steps each, the loss rebuilt for each mesh: the
    losses equal the reference's on the same schedule within 1e-5
    relative, dp absorbs the change and the step never resets (the
    reference's ``test_llama_elastic_sp_reshard``)."""
    from edl_tpu.api.job import MeshSpec as JSpec
    from edl_tpu.runtime.elastic import ElasticTrainer as JTrainer

    params = _params_np(seed=0)
    got = pool.run(cases.elastic_llama_sp, params, CFG_KW, [(1, 3), (2, 3)])
    tr = JTrainer(None, optax.adam(1e-3), mesh_spec=JSpec(sp=2),
                  chips_per_worker=2, per_chip_batch=4,
                  param_pspecs=lambda plan: jl.param_pspecs(JCFG, plan),
                  make_loss=lambda plan, mesh: jl.make_loss_fn(JCFG, plan,
                                                               mesh),
                  devices=cpu_devices[:4])
    tr.start(jax.tree_util.tree_map(jnp.asarray, mesh_check.unflat(params)),
             n_workers=1)
    rng = np.random.RandomState(0)

    def data(bs):
        return jl.synthetic_tokens(rng, bs, 16, JCFG.vocab)

    tr.train_steps(data, 3)
    tr.request_rescale(2)
    tr.train_steps(data, 3)
    g = got[0]
    np.testing.assert_allclose(g["losses"], tr.report.losses, rtol=1e-5)
    assert g["plans"] == [{"sp": 2}, {"dp": 2, "sp": 2}]
    assert tr.plan.describe() == {"dp": 2, "sp": 2}
    assert [(a, b, f) for a, b, _, f in g["events"]] == [(1, 2, False)]
    assert g["state_step"] == int(tr.state.step) == 6


def test_chip_smoke_long_context_phase_runs_on_the_cpu(pool):
    """chip_smoke.py's long_context phase end to end on this CPU pool at
    llama tiny (T=64 for sp, 32 for pp; the launch gates need the card's
    kernels): sp4 ring, sp4 Ulysses and pp2 x dp2 against the one-rank
    gradients and first loss, the elastic sp2 1 -> 2 -> 1 job, every
    gate."""
    import chip_smoke

    kw = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, dtype="float32", use_flash=True, remat=True)
    plans = tuple(dict(p, seq=64 if "sp" in p["sizes"] else 32,
                       grad_seq=64 if "sp" in p["sizes"] else 32, steps=2)
                  for p in chip_smoke.LONG["plans"])
    c = dict(chip_smoke.LONG, plans=plans, elastic_seq=32)
    launches = chip_smoke.long_context_phase("cpu", pool, device="cpu",
                                             cfg_kw=kw, c=c,
                                             expect_launches=False)
    assert set(launches) == {chip_smoke.LONG_ULYSSES_SHAPE,
                             chip_smoke.MESH_FSDP_SHAPE}
