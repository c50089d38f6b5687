"""Port parity of the MoE family: ``edl_tpu_torch.parallel.moe`` and
``edl_tpu_torch.models.moe`` against ``edl_tpu``'s, on the CPU.

Inputs come from NumPy seeds; weights are the reference's init carried
across through NumPy. ``moe_ffn`` in f32 against the reference's dense
one-hot einsums: y within 1e-5 and aux within 1e-6 (absolute), the
grads of x, router, w_in and w_out within 1e-5 of each one's largest
entry (1e-4 for the router at k = 1, where the combine weight is
top/top and its gradient cancels to rounding noise), over k, capacity
factors that drop choices and that do not, planted router ties and
``int8_mxu``. ``MoEConfig.tiny`` forward, loss, aux and grads against
``jax.value_and_grad`` (dense attention, the flash op, int8_mxu) at
1e-5, and 5 Adam steps through ``make_train_step`` against the
reference's on a one-device plan, losses within 1e-5.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import moe as jmoe
from edl_tpu.obs import costmodel as jcost
from edl_tpu.parallel import moe as jpm
from edl_tpu.parallel.mesh import MeshPlan
from edl_tpu.train import trainer as jtrainer
from edl_tpu_torch.models import moe as tmoe
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import costmodel as tcost
from edl_tpu_torch.ops import flash_attention as tfa
from edl_tpu_torch.ops import int8_matmul as tim
from edl_tpu_torch.parallel import moe as tpm
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

JCFG = jmoe.MoEConfig.tiny()
TCFG = tmoe.MoEConfig.tiny()
JP = jmoe.init_params(jax.random.PRNGKey(0), JCFG)
B, T = 2, 16
FFN_Y_ATOL = 1e-5
FFN_AUX_ATOL = 1e-6
GRAD_OF_MAX = 1e-5
ROUTER_K1_OF_MAX = 1e-4
MODEL_TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tparams():
    return params_from_numpy(_np(JP), "cpu", torch.float32)


def _batch(seed, b=B, t=T):
    return tmoe.synthetic_tokens(np.random.RandomState(seed), b, t,
                                 JCFG.vocab)


def _of_max(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# -- the layer ------------------------------------------------------------------


def _ffn_data(ties, b=2, t=24, d=16, f=24, e=4):
    rng = np.random.RandomState(0)
    x = rng.randn(b, t, d).astype(np.float32)
    router = (rng.randn(d, e) * 0.5).astype(np.float32)
    if ties:
        router[:, 2] = router[:, 1]  # experts 1 and 2 tie on every token
        x[0, :5] = 0.0  # all four experts tie on these tokens
    params = {
        "router": router,
        "w_in": (rng.randn(e, d, f) * np.sqrt(2 / d)).astype(np.float32),
        "w_out": (rng.randn(e, f, d) * np.sqrt(1 / f)).astype(np.float32),
    }
    ct = rng.randn(b, t, d).astype(np.float32)
    return params, x, ct


@pytest.mark.parametrize("k,cf,ties,int8", list(itertools.product(
    [1, 2], [0.5, 1.25, 2.0], [False, True], [False, True])))
def test_moe_ffn_matches_reference(k, cf, ties, int8):
    """y, aux and the grads of x, router, w_in and w_out (through the
    scalar sum(y * ct) + aux) against the reference's ``moe_ffn`` and
    ``jax.grad``. Capacity factor 0.5 drops choices; with ties the
    lower expert index must win, as ``lax.top_k``'s."""
    params, x, ct = _ffn_data(ties)

    def jloss(p, x):
        y, aux = jpm.moe_ffn(p, x, k=k, capacity_factor=cf, int8_mxu=int8)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tim.reset_calls()
    y, aux = tpm.moe_ffn(tp, tx, k=k, capacity_factor=cf, int8_mxu=int8)
    assert tim.calls["fwd"] == (2 * 4 if int8 else 0)  # 2 products x E
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=FFN_Y_ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=0,
                               atol=FFN_AUX_ATOL)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + aux,
                                [tx, tp["router"], tp["w_in"], tp["w_out"]])
    for name, g, w in zip(("x", "router", "w_in", "w_out"), grads,
                          (jgx, jgp["router"], jgp["w_in"], jgp["w_out"])):
        rel = ROUTER_K1_OF_MAX if (name, k) == ("router", 1) else GRAD_OF_MAX
        _of_max(g, w, rel)
    # the cases do what they claim: 0.5 drops, 2.0 keeps every choice
    n = x.shape[0] * x.shape[1]
    cap = tpm.capacity(n, k, cf, 4)
    probs = torch.softmax(torch.from_numpy(x).reshape(n, -1)
                          @ torch.from_numpy(params["router"]), -1)
    kept = tpm.route(probs, k, cap)[3]
    if cf != 1.25:
        assert bool(kept.all()) == (cf == 2.0)


def test_route_priority_ties_and_drops():
    """Pairs are queued n·k + j (a token's choices interleaved in token
    order), ties go to the lower expert, and a pair past the capacity
    is dropped: a hand-worked case."""
    probs = torch.tensor([[0.4, 0.4, 0.1, 0.1],   # tie 0/1 -> (0, 1)
                          [0.1, 0.2, 0.3, 0.4],   # (3, 2)
                          [0.25, 0.25, 0.25, 0.25],  # (0, 1)
                          [0.7, 0.1, 0.1, 0.1]])  # (0, 1) tie 1/2/3 -> 1
    top, idx, slot, keep = tpm.route(probs, 2, 2)
    assert idx.tolist() == [[0, 1], [3, 2], [0, 1], [0, 1]]
    np.testing.assert_allclose(top.numpy(), probs.gather(1, idx).numpy())
    assert slot.tolist() == [[0, 0], [0, 0], [1, 1], [2, 2]]
    assert keep.tolist() == [[True] * 2, [True] * 2, [True] * 2,
                             [False] * 2]
    assert tpm.capacity(4, 2, 1.25, 4) == 3  # ceil(2.5)


def test_moe_ffn_is_deterministic_and_never_builds_the_dense_form():
    """Two runs give the same bits, and no tensor of N·E·C elements (the
    reference's dispatch and combine) is allocated on the way."""
    params, x, _ = _ffn_data(False, b=4, t=64)
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    n, e = 4 * 64, 4
    cap = tpm.capacity(n, 2, 1.25, e)
    seen = []

    class Sizes(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    seen.append(o.numel())
            return out

    with Sizes():
        y1, a1 = tpm.moe_ffn(tp, torch.from_numpy(x))
    y2, a2 = tpm.moe_ffn(tp, torch.from_numpy(x))
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert max(seen) < n * e * cap


def test_init_and_pspecs():
    """The port's init has the reference's tree and shapes; one device
    gives whole leaves and a sharded plan raises, for the model and the
    layer."""
    tp = tmoe.init_params(torch.Generator().manual_seed(0), TCFG, "cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), JP)
    tshapes = {k: ({n: tuple(x.shape) for n, x in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tp.items()}
    assert tshapes == jshapes
    assert all(x.dtype == torch.float32 for x in trainer.leaves(tp))
    lp = tpm.init_moe_params(torch.Generator().manual_seed(0), 16, 24, 4,
                             device="cpu")
    jl = jpm.init_moe_params(jax.random.PRNGKey(0), 16, 24, 4)
    assert {k: tuple(v.shape) for k, v in lp.items()} == \
        {k: tuple(v.shape) for k, v in jl.items()}
    spec = tmoe.param_pspecs(TCFG, MeshPlan.create())
    assert jax.tree_util.tree_structure(spec, is_leaf=lambda x: x is None) \
        == jax.tree_util.tree_structure(tshapes, is_leaf=lambda x:
                                        isinstance(x, tuple))
    assert tpm.moe_pspecs(MeshPlan.create()) == {
        "router": None, "w_in": None, "w_out": None}
    for fn in (lambda p: tmoe.param_pspecs(TCFG, p), tpm.moe_pspecs):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            fn(MeshPlan.create(ep=2))


@pytest.mark.parametrize("cfg", ["tiny", "default"])
def test_meta_and_costmodel_are_the_references(cfg):
    """``to_meta`` is the reference's record key for key (without the
    int8 flags) and ``from_meta`` inverts it; the port's cost model
    reads the port's config as the reference's reads its own."""
    j = JCFG if cfg == "tiny" else jmoe.MoEConfig()
    t = TCFG if cfg == "tiny" else tmoe.MoEConfig()
    for jc, tc in ((j, t), (dataclasses.replace(j, int8_mxu=True),
                            dataclasses.replace(t, int8_mxu=True))):
        assert tc.to_meta() == jc.to_meta()
    assert tmoe.MoEConfig.from_meta(t.to_meta()) == t
    assert tmoe.MoEConfig.from_meta(j.to_meta()) == t
    with pytest.raises(ValueError, match="not a moe export"):
        tmoe.MoEConfig.from_meta({"family": "llama"})
    for fn in ("matmul_params", "n_params"):
        assert getattr(tcost, fn)(t) == getattr(jcost, fn)(j)
    assert tcost.train_flops_per_token(t, 2048) == \
        jcost.train_flops_per_token(j, 2048)


def test_params_from_numpy_carries_the_moe_tree():
    """The generic converter carries the stacked [L, ...] and [L, E, ...]
    leaves across value for value, and casts them when asked."""
    tp = params_from_numpy(_np(JP), "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(JP)
    assert len(flat_j) == len(trainer.leaves(tp)) == 12
    for (path, w), g in zip(flat_j, trainer.leaves(tp)):
        assert g.dtype == torch.float32, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bf = params_from_numpy(_np(JP), "cpu", torch.bfloat16)
    assert bf["layers"]["w_in"].dtype == torch.bfloat16
    assert bf["layers"]["w_in"].shape == (2, 4, 64, 96)


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "flash", "int8"])
def test_forward_loss_and_grads_match_reference(mode):
    """Logits, aux, loss and every gradient leaf of ``MoEConfig.tiny``
    against the reference's (its flash in Pallas interpret mode, the
    port's plain flash versions on the CPU) at 1e-5; the flash op runs
    one lse forward a layer, int8 mode 4 + 2·E int8 products a layer."""
    over = {"flash": dict(use_flash=True), "int8": dict(int8_mxu=True)}
    jc = dataclasses.replace(JCFG, **over.get(mode, {}))
    tc = dataclasses.replace(TCFG, **over.get(mode, {}))
    nb = _batch(0)
    jlogits, jaux = jmoe.forward(JP, jnp.asarray(nb["tokens"][:, :-1]), jc)
    w_loss, w_grads = jax.value_and_grad(jmoe.make_loss_fn(jc))(
        JP, {"tokens": jnp.asarray(nb["tokens"])})
    params = trainer.trainable(_tparams())
    with torch.no_grad():
        logits, aux = tmoe.forward(
            params, torch.from_numpy(nb["tokens"][:, :-1]), tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL)
    tfa.reset_launches()
    tim.reset_calls()
    loss, grads = trainer.value_and_grad(tmoe.make_loss_fn(tc))(
        params, {"tokens": torch.from_numpy(nb["tokens"])})
    L, E = TCFG.n_layers, TCFG.n_experts
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_fwd_lse": 0,
                                   "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert tim.calls == ({"fwd": (4 + 2 * E) * L, "bwd": (4 + 2 * E) * L}
                         if mode == "int8" else {"fwd": 0, "bwd": 0})
    np.testing.assert_allclose(float(loss), float(w_loss), **MODEL_TOL)
    flat_w = jax.tree_util.tree_leaves_with_path(w_grads)
    for (path, w), g in zip(flat_w, trainer.leaves(grads)):
        _of_max(g, w, 1e-4 if mode == "int8" else GRAD_OF_MAX)


def test_flash_op_carries_the_attention():
    """With ``use_flash`` the attention goes through the registered flash
    op (one forward a layer, its backward once a layer): the path the
    card's kernels take."""
    seen = []

    class Ops(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    tc = dataclasses.replace(TCFG, use_flash=True)
    params = trainer.trainable(_tparams())
    with Ops():
        trainer.value_and_grad(tmoe.make_loss_fn(tc))(
            params, {"tokens": torch.from_numpy(_batch(0)["tokens"])})
    ops = torch.ops.edl_tpu_torch
    assert seen.count(ops.flash_fwd.default) == TCFG.n_layers
    assert seen.count(ops.flash_bwd.default) == TCFG.n_layers


def test_remat_changes_no_value():
    """Each layer checkpointed whole recomputes the same routing: loss,
    aux and grads bit for bit equal to the graph without remat."""
    nb = {"tokens": torch.from_numpy(_batch(1)["tokens"])}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat, use_flash=True)
        out.append(trainer.value_and_grad(tmoe.make_loss_fn(cfg))(
            trainer.trainable(_tparams()), nb))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(trainer.leaves(out[0][1]), trainer.leaves(out[1][1])):
        assert torch.equal(a, b)


def test_five_adam_steps_match_the_reference():
    """``MoEConfig.tiny`` through the reference's ``make_train_step`` on a
    one-device plan and the port's, ``adam(3e-3)`` from the same weights
    on the same 5 batches: per-step losses within 1e-5."""
    plan = MeshPlan.create()
    mesh = plan.build()
    pspecs = jmoe.param_pspecs(JCFG, plan)
    tx = optax.adam(3e-3)
    # a copy: the reference's step donates the state's buffers
    jp = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), JP)
    jstate = jtrainer.shard_state(jtrainer.TrainState.create(jp, tx), plan,
                                  mesh, pspecs)
    jstep = jtrainer.make_train_step(jmoe.make_loss_fn(JCFG), tx, plan, mesh,
                                     pspecs)
    ttx = trainer.adam(3e-3)
    tstate = trainer.TrainState.create(_tparams(), ttx)
    tstep = trainer.make_train_step(tmoe.make_loss_fn(TCFG), ttx)
    rng = np.random.RandomState(3)
    want, got = [], []
    for _ in range(5):
        nb = tmoe.synthetic_tokens(rng, 4, 32, JCFG.vocab)
        jstate, m = jstep(jstate, jtrainer.global_batch(nb, plan, mesh))
        want.append(float(m["loss"]))
        tstate, m = tstep(tstate, {"tokens": torch.from_numpy(nb["tokens"])})
        got.append(float(m["loss"]))
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- chip_smoke's moe gates ---------------------------------------------------


def test_chip_smoke_moe_launch_and_int8_gates_trip():
    """The launch gate wants one lse forward a layer (two under remat)
    and one of each backward sweep; the int8 gate 4 + 2·E ops a layer
    each way. Each trips on a count one off."""
    import chip_smoke

    chip_smoke._moe_launch_check(
        {"flash_fwd": 0, "flash_fwd_lse": 80, "flash_bwd_dq": 40,
         "flash_bwd_dkv": 40}, 8, 5, remat=True)
    for bad in ({"flash_fwd_lse": 41}, {"flash_fwd": 1},
                {"flash_bwd_dkv": 39}):
        counts = {"flash_fwd": 0, "flash_fwd_lse": 40, "flash_bwd_dq": 40,
                  "flash_bwd_dkv": 40, **bad}
        with pytest.raises(AssertionError, match="flash launches"):
            chip_smoke._moe_launch_check(counts, 8, 5)
    cfg = tmoe.MoEConfig()
    assert chip_smoke._moe_int8_check({"fwd": 160, "bwd": 160}, cfg) == 160
    with pytest.raises(AssertionError, match="int8 op calls"):
        chip_smoke._moe_int8_check({"fwd": 160, "bwd": 159}, cfg)


@pytest.mark.parametrize("fault", [None, "slot", "keep", "expert"])
def test_chip_smoke_moe_route_gate_trips(fault):
    """The routing gate re-routes each recorded call's probabilities on
    the CPU: equal outputs pass and report the dropped share; a planted
    difference in a slot, a kept flag or an expert trips it."""
    import chip_smoke

    tc = dataclasses.replace(TCFG, capacity_factor=0.5)
    with torch.no_grad(), chip_smoke._moe_routes() as calls:
        tmoe.forward(_tparams(), torch.from_numpy(_batch(0)["tokens"]), tc)
    assert len(calls) == TCFG.n_layers
    if fault is not None:
        probs, k, cap, (top, idx, slot, keep) = calls[1]
        idx, slot, keep = idx.clone(), slot.clone(), keep.clone()
        {"slot": slot, "keep": keep, "expert": idx}[fault][3, 0] ^= True
        calls[1] = (probs, k, cap, (top, idx, slot, keep))
        with pytest.raises(AssertionError, match="routing 1 differs"):
            chip_smoke._moe_route_check(calls)
        return
    dropped = chip_smoke._moe_route_check(calls)
    assert len(dropped) == TCFG.n_layers and all(0 < d < 1 for d in dropped)


@pytest.mark.parametrize("fault", [None, "moment"])
def test_chip_smoke_moe_reshard_gate_trips(monkeypatch, fault):
    """The reshard gate on a tiny CPU state after two adamw steps: f32
    staging equals snapshot + restore and the next two losses equal the
    unresharded run's; a staged moment one ulp off trips it."""
    import chip_smoke
    from edl_tpu_torch.runtime import checkpoint as ckpt

    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(_tparams(), tx)
    step = trainer.make_train_step(tmoe.make_loss_fn(TCFG), tx)
    batch = {"tokens": torch.from_numpy(_batch(2)["tokens"])}
    for _ in range(2):
        state, _ = step(state, batch)
    if fault == "moment":
        real = ckpt.staged_reshard

        def off(st, **kw):
            out = real(st, **kw)
            _, _, t, _ = trainer.optimizer_tensors(out)[3]
            t.view(-1)[0] = torch.nextafter(t.view(-1)[0],
                                            torch.tensor(1.0))
            return out

        monkeypatch.setattr(ckpt, "staged_reshard", off)
        with pytest.raises(AssertionError, match="differs from snapshot"):
            chip_smoke._moe_reshard_check(state, step, batch, "cpu")
        return
    got, _ = chip_smoke._moe_reshard_check(state, step, batch, "cpu")
    assert got["losses_after_reshard"] == got["losses_without_reshard"]
