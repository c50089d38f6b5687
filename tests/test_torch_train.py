"""Port parity of the training path: edl_tpu_torch's loss, gradients and
optimizer steps against edl_tpu's (``make_loss_fn`` →
``jax.value_and_grad`` → ``optax.adamw``).

``LlamaConfig.tiny`` in f32 with ``use_flash=True`` on both sides (the
reference's Pallas kernels in interpret mode, the port's plain flash
versions on the CPU); weights are the reference's JAX init carried
across through NumPy; tokens come from ``synthetic_tokens`` with one
NumPy seed. Loss and gradients at atol/rtol 1e-4, the tolerance of
tests/test_torch_llama.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.models.losses import row_mean as j_row_mean
from edl_tpu.parallel.mesh import MeshPlan
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.models.losses import row_mean
from edl_tpu_torch.obs.metrics import MetricsRegistry
from edl_tpu_torch.ops import flash_attention as tfa
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

JCFG = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash=True)
TCFG = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True)
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 2, 16


def _tparams():
    """A fresh f32 copy of the reference's init on the CPU."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu",
                             torch.float32)


def _batch(seed, b=B, t=T):
    return tl.synthetic_tokens(np.random.RandomState(seed), b, t, JCFG.vocab)


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_tree_close(got, want, **tol):
    """Leaf by leaf, in the reference's key order."""
    g_leaves = trainer.leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for name, g, w in zip(_paths(want), g_leaves, w_leaves):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    jc = dataclasses.replace(JCFG, remat=remat)
    tc = dataclasses.replace(TCFG, remat=remat)
    nb = _batch(0)
    w_loss, w_grads = jax.value_and_grad(jl.make_loss_fn(jc))(
        JP, {k: jnp.asarray(v) for k, v in nb.items()})
    params = trainer.trainable(_tparams())
    loss, grads = trainer.value_and_grad(tl.make_loss_fn(tc))(
        params, _tbatch(nb))
    np.testing.assert_allclose(float(loss), float(w_loss), **TOL)
    _assert_tree_close(grads, w_grads, **TOL)
    assert all(p.grad is None for p in trainer.leaves(params))


def test_value_and_grad_holds_no_gradient_after_return():
    """The grads die with their last reference, without a garbage
    collection: nothing inside value_and_grad keeps them in a reference
    cycle (a training loop would hold a second copy of the gradients)."""
    import gc
    import weakref

    gc.disable()
    try:
        loss, grads = trainer.value_and_grad(tl.make_loss_fn(TCFG))(
            trainer.trainable(_tparams()), _tbatch(_batch(0)))
        refs = [weakref.ref(g) for g in trainer.leaves(grads)]
        assert len(refs) == len(jax.tree_util.tree_leaves(JP))
        del loss, grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_remat_changes_no_value():
    """Full remat recomputes the same layers: loss and grads identical to
    the non-remat graph, bit for bit on the CPU."""
    nb = _tbatch(_batch(1))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        out.append(trainer.value_and_grad(tl.make_loss_fn(cfg))(
            trainer.trainable(_tparams()), nb))
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=0)
    for a, b in zip(trainer.leaves(out[0][1]), trainer.leaves(out[1][1])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _jax_steps(batches, lr=1e-3):
    tx = optax.adamw(lr)
    params, opt = JP, tx.init(JP)
    loss_fn = jl.make_loss_fn(JCFG)
    losses = []
    for nb in batches:
        loss, g = jax.value_and_grad(loss_fn)(
            params, {k: jnp.asarray(v) for k, v in nb.items()})
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    return losses, params


def test_three_adamw_steps_match_optax():
    """Per-step losses at rtol 1e-4. Params at atol 2e-5: Adam's update
    lr·m̂/(√v̂ + eps) is ~lr·sign(g) early on, so where |g| is small a
    last-bit difference in g between the frameworks moves a coordinate
    by lr·δg/(|g| + eps), far more than δg itself (largest seen on the
    CPU: 2.6e-6, on wk; a flipped sign could cost up to 2·lr)."""
    batches = [_batch(10 + i) for i in range(3)]
    w_losses, w_params = _jax_steps(batches)
    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(_tparams(), tx)
    step = trainer.make_train_step(tl.make_loss_fn(TCFG), tx)
    losses = []
    for nb in batches:
        state, m = step(state, _tbatch(nb))
        losses.append(float(m["loss"]))
    assert state.step == 3
    np.testing.assert_allclose(losses, w_losses, rtol=1e-4)
    _assert_tree_close(state.params, w_params, atol=2e-5, rtol=0)


def test_adamw_defaults_are_optax():
    opt = trainer.adamw(3e-4).init({"w": torch.zeros(2)})
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)
    assert isinstance(opt, torch.optim.AdamW)
    assert isinstance(trainer.adam(1e-3).init({"w": torch.zeros(2)}),
                      torch.optim.Adam)
    with pytest.raises(NotImplementedError, match="eps_root"):
        trainer.adamw(1e-3, eps_root=1e-8)


def test_multistep_equals_k_steps():
    batches = [_tbatch(_batch(20 + i)) for i in range(3)]
    tx = trainer.adamw(1e-3)
    loss_fn = tl.make_loss_fn(TCFG)
    s1 = trainer.TrainState.create(_tparams(), tx)
    step = trainer.make_train_step(loss_fn, tx)
    losses = []
    for b in batches:
        s1, m = step(s1, b)
        losses.append(m["loss"])
    s2 = trainer.TrainState.create(_tparams(), tx)
    stacked = {"tokens": torch.stack([b["tokens"] for b in batches])}
    s2, m2 = trainer.make_train_multistep(loss_fn, tx)(s2, stacked)
    assert s2.step == s1.step == 3
    torch.testing.assert_close(m2["losses"], torch.stack(losses), atol=0,
                               rtol=0)
    torch.testing.assert_close(m2["loss"], losses[-1], atol=0, rtol=0)
    for a, b in zip(trainer.leaves(s1.params), trainer.leaves(s2.params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_step_records_dispatch_and_counts_no_launch(monkeypatch):
    reg = MetricsRegistry()
    monkeypatch.setattr(trainer.obs_metrics, "default_registry", lambda: reg)
    tx = trainer.adamw(1e-3)
    state = trainer.TrainState.create(_tparams(), tx)
    tfa.reset_launches()
    trainer.make_train_step(tl.make_loss_fn(TCFG), tx)(
        state, _tbatch(_batch(30)))
    assert reg.counter("edl_train_steps_total").value() == 1
    assert reg.histogram("edl_train_dispatch_seconds").stats()["count"] == 1
    # the CPU path ran the plain versions: no kernel launched
    assert tfa.launch_counts() == dict.fromkeys(tfa.KERNELS, 0)


def test_synthetic_tokens_identical():
    for seed, b, t, v in ((0, 2, 16, 256), (5, 4, 33, 32768)):
        want = jl.synthetic_tokens(np.random.RandomState(seed), b, t, v)
        got = tl.synthetic_tokens(np.random.RandomState(seed), b, t, v)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["tokens"].dtype == want["tokens"].dtype


def test_train_flops_per_token_matches_reference():
    # the flagship training config (bench.py flagship_train_config)
    dims = dict(vocab=32768, d_model=2048, n_layers=16, n_heads=16,
                n_kv_heads=8, d_ff=6144)
    jc = jl.LlamaConfig(**dims, remat=True, use_flash=True)
    tc = tl.LlamaConfig(**dims, remat=True, use_flash=True)
    got = tl.train_flops_per_token(tc, 2048)
    assert got == jl.train_flops_per_token(jc, 2048)
    assert round(got / 1e6, 1) == 5637.1
    for cfg in (TCFG, tl.LlamaConfig.llama3_8b()):
        jcfg = jl.LlamaConfig(**{k: getattr(cfg, k) for k in dims})
        for t in (16, 4096):
            assert tl.train_flops_per_token(cfg, t) == \
                jl.train_flops_per_token(jcfg, t)


@pytest.mark.parametrize("w", [None, [1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
def test_row_mean_matches_reference(w):
    per_row = np.array([1.5, 7.0, -2.0], np.float32)
    jb = {} if w is None else {"_w": jnp.asarray(w, jnp.float32)}
    tb = {} if w is None else {"_w": torch.tensor(w)}
    x = torch.from_numpy(per_row).requires_grad_()
    got = row_mean(x, tb)
    np.testing.assert_allclose(float(got.detach()), float(j_row_mean(
        jnp.asarray(per_row), jb)), rtol=1e-6)
    got.backward()
    if w is not None and not any(w):
        assert float(got.detach()) == 0.0 and not x.grad.any()  # a no-op step


def test_weighted_rows_in_the_loss_match_reference():
    nb = _batch(40, b=3)
    nb["_w"] = np.array([1.0, 0.0, 1.0], np.float32)
    want = jl.make_loss_fn(JCFG)(JP, {k: jnp.asarray(v) for k, v in nb.items()})
    got = tl.make_loss_fn(TCFG)(_tparams(), _tbatch(nb))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("policy", ["attn", "mlp", "dots"])
def test_unported_remat_policies_raise(policy):
    """Each selective remat policy: loss and grads against
    ``jax.value_and_grad`` of the reference under the same
    ``remat_policy`` (its flash in Pallas interpret mode) at 1e-4, and
    equal to the port's own ``"full"`` remat bit for bit (the policies
    change what is saved, not what is computed)."""
    jc = dataclasses.replace(JCFG, remat=True, remat_policy=policy)
    tc = dataclasses.replace(TCFG, remat=True, remat_policy=policy)
    nb = _batch(2)
    w_loss, w_grads = jax.value_and_grad(jl.make_loss_fn(jc))(
        JP, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = trainer.value_and_grad(tl.make_loss_fn(tc))(
        trainer.trainable(_tparams()), _tbatch(nb))
    np.testing.assert_allclose(float(loss), float(w_loss), **TOL)
    _assert_tree_close(grads, w_grads, **TOL)
    full = dataclasses.replace(tc, remat_policy="full")
    f_loss, f_grads = trainer.value_and_grad(tl.make_loss_fn(full))(
        trainer.trainable(_tparams()), _tbatch(nb))
    torch.testing.assert_close(loss, f_loss, atol=0, rtol=0)
    for a, b in zip(trainer.leaves(grads), trainer.leaves(f_grads)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_sharding_plans_raise_and_one_device_plan_runs():
    tx = trainer.adamw(1e-3)
    plan = MeshPlan.create(fsdp=2, dp=2)
    for make in (trainer.make_train_step, trainer.make_train_multistep):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            make(tl.make_loss_fn(TCFG), tx, plan=plan)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            make(tl.make_loss_fn(TCFG), tx, mesh=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tl.make_loss_fn(TCFG, plan=MeshPlan.create(tp=2))
    # a plan of one device shards nothing
    trainer.make_train_step(tl.make_loss_fn(TCFG, plan=MeshPlan.create()),
                            tx, plan=MeshPlan.create())


def test_training_fields_never_ride_to_meta():
    cfg = dataclasses.replace(TCFG, remat=True, remat_policy="full")
    assert cfg.to_meta() == dataclasses.replace(JCFG, remat=True).to_meta()
    assert "remat" not in cfg.to_meta()


def test_serving_params_build_no_graph():
    """forward is differentiable, but serving params do not require
    grad: no autograd graph, as under the old no_grad decorator."""
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")
    logits = tl.forward(params, torch.zeros(1, 8, dtype=torch.long), TCFG)
    assert logits.grad_fn is None and not logits.requires_grad


# -- adafactor -----------------------------------------------------------

# one leaf per branch of optax's adafactor: factored over two largest
# dims that are not the last two (argsort [1, 2, 0]: rows over axis 2,
# columns over axis 0); a square factored leaf (the argsort tie); an
# [L, d] leaf with L < 128, which optax leaves whole (torch.optim.
# Adafactor would factor it); and a leaf whose update the block-RMS clip
# cuts (its gradient grows 30x in the second step, past what the decayed
# estimate has seen)
AF_SHAPES = {"a_perm": (256, 4, 128), "b_square": (128, 128),
             "c_layers": (4, 160), "d_clip": (8, 16)}
AF_GROW = {"d_clip": (1.0, 30.0, 1.0)}


def _af_data():
    rng = np.random.RandomState(7)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in AF_SHAPES.items()}
    batches = [{k: (rng.randn(*s).astype(np.float32),
                    rng.randn(*s).astype(np.float32),
                    np.float32(AF_GROW.get(k, (1.0,) * 3)[i]))
                for k, s in AF_SHAPES.items()} for i in range(3)]
    return params, batches


def _af_loss(tanh, mean, params, batch):
    """sum over leaves of c * mean(tanh(p * x) * y)."""
    return sum(batch[k][2] * mean(tanh(params[k] * batch[k][0]) * batch[k][1])
               for k in sorted(params))


def test_three_adafactor_steps_match_optax():
    """``adafactor(1e-3)`` against ``optax.adafactor(1e-3)`` over 3 steps
    through ``make_train_step``: losses at rtol 1e-4, params at atol 2e-5
    (as for AdamW), the factored and unfactored statistics within 1e-4 of
    each one's largest entry (they square the gradient, so an entry near
    zero carries twice the gradient's relative rounding), and the state's
    bytes equal to optax's apart from its 1-element
    placeholders and ``count``."""
    params0, batches = _af_data()
    tx = optax.adafactor(1e-3)
    rms_tx = optax.scale_by_factored_rms()  # the chain's first stage
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    opt, rms_st = tx.init(jp), rms_tx.init(jp)
    j_loss = jax.value_and_grad(
        lambda p, b: _af_loss(jnp.tanh, jnp.mean, p, b))
    w_losses, clip_rms = [], []
    for nb in batches:
        loss, g = j_loss(jp, nb)
        u, rms_st = rms_tx.update(g, rms_st, jp)
        clip_rms.append(float(jnp.sqrt(jnp.mean(u["d_clip"] ** 2))))
        upd, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, upd)
        w_losses.append(float(loss))
    assert max(clip_rms) > 1.0  # the clip branch ran

    ttx = trainer.adafactor(1e-3)
    state = trainer.TrainState.create(
        {k: torch.from_numpy(v.copy()) for k, v in params0.items()}, ttx)
    step = trainer.make_train_step(
        lambda p, b: _af_loss(torch.tanh, torch.mean, p, b), ttx)
    losses = []
    for nb in batches:
        state, m = step(state, {k: tuple(torch.as_tensor(x) for x in v)
                                for k, v in nb.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, w_losses, rtol=1e-4)
    for k in AF_SHAPES:
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   np.asarray(jp[k]), atol=2e-5, rtol=0,
                                   err_msg=k)

    fac = opt[0]  # FactoredState(count, v_row, v_col, v)
    got = {k: state.opt_state.state[state.params[k]] for k in AF_SHAPES}
    for k, st in got.items():
        factored = k in ("a_perm", "b_square")
        assert sorted(st) == (["step", "v_col", "v_row"] if factored
                              else ["step", "v"]), k
        assert float(st["step"]) == 3 == int(fac.count)
        for name in sorted(set(st) - {"step"}):
            want = np.asarray(getattr(fac, name)[k])
            assert st[name].shape == want.shape, (k, name)
            np.testing.assert_allclose(st[name].numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{k}/{name}")
    assert got["a_perm"]["v_row"].shape == (4, 128)   # mean over axis 0
    assert got["a_perm"]["v_col"].shape == (256, 4)   # mean over axis 2
    want_bytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(opt)
                     if x.size > 1)
    assert want_bytes == sum(t.nbytes for st in got.values()
                             for n, t in st.items() if n != "step")


def test_adafactor_defaults_are_optax_and_unported_options_raise():
    import inspect

    want = inspect.signature(optax.adafactor).parameters
    got = inspect.signature(trainer.adafactor).parameters
    assert list(got) == list(want)
    for name, p in want.items():
        if name != "dtype_momentum":
            assert got[name].default == p.default, name
    opt = trainer.adafactor(1e-3).init({"w": torch.zeros(2)})
    assert isinstance(opt, trainer.Adafactor)
    assert not isinstance(opt, torch.optim.Adafactor)
    assert opt.defaults == dict(lr=1e-3)
    # every value but optax's default raises, the learning rate's None
    # (no lr step) and a schedule too
    for kw in (dict(learning_rate=None), dict(learning_rate=lambda step: 1e-3),
               dict(min_dim_size_to_factor=64), dict(decay_rate=0.5),
               dict(decay_offset=10), dict(multiply_by_parameter_scale=False),
               dict(clipping_threshold=None), dict(clipping_threshold=2.0),
               dict(momentum=0.9), dict(weight_decay_rate=1e-4),
               dict(eps=1e-8), dict(factored=False),
               dict(weight_decay_mask=lambda p: p)):
        with pytest.raises(NotImplementedError, match="not ported"):
            trainer.adafactor(**{"learning_rate": 1e-3, **kw})
    trainer.adafactor(1e-3, dtype_momentum=np.float32)  # shapes no momentum
    # optax's _factored_dims at its defaults, shape by shape
    from optax._src.factorized import _factored_dims

    for shape in ((256, 4, 128), (128, 128), (4, 160), (16, 2048, 6144),
                  (32768, 2048), (2048,), (127, 512), (128, 3, 128)):
        assert trainer.Adafactor.factored_dims(shape) == \
            _factored_dims(shape, True, 128), shape


@pytest.mark.parametrize("fault", [None, "v_col", "lr", "lost"])
def test_chip_smoke_adafactor_agreement_trips(fault, monkeypatch):
    """chip_smoke's three-step adafactor check between two devices, run
    here between two CPU runs: equal runs pass with both branches'
    statistics compared, and the check trips on a v_col 1e-3 off, on a
    learning rate 1% off (losses and statistics still agree: the params
    do not) and on a run that lost a statistic."""
    import chip_smoke

    a = chip_smoke._adafactor_small_run("cpu")
    if fault == "lr":
        af = trainer.adafactor
        monkeypatch.setattr(trainer, "adafactor", lambda lr: af(lr * 1.01))
    b = chip_smoke._adafactor_small_run("cpu")
    if fault is None:
        worst, n_stats = chip_smoke._adafactor_agreement(a, b)
        assert worst == 0
        kinds = [n for _, n, _, _ in trainer.optimizer_tensors(b[1])]
        assert n_stats == len(kinds) - kinds.count("step")
        assert {"v_row", "v_col", "v"} <= set(kinds)  # both branches ran
        return
    for p in trainer.leaves(b[1].params):
        st = b[1].opt_state.state[p]
        if fault == "v_col" and "v_col" in st:
            st["v_col"].mul_(1 + 1e-3)
            break
        if fault == "lost" and "v" in st:
            del st["v"]
            break
    with pytest.raises(AssertionError, match="adafactor"):
        chip_smoke._adafactor_agreement(a, b)


@pytest.mark.parametrize("fault", [None, "nan", "flat", "lse_launch",
                                   "primal_launch"])
def test_chip_smoke_ladder_check_trips(fault):
    import chip_smoke

    n_layers, steps = 16, 26
    losses = [10.4, 10.1, 9.7]
    counts = {"flash_fwd": 0, "flash_fwd_lse": 32 * steps,
              "flash_bwd_dq": 16 * steps, "flash_bwd_dkv": 16 * steps}
    if fault == "nan":
        losses[1] = float("nan")
    elif fault == "flat":
        losses[-1] = losses[0]
    elif fault == "lse_launch":
        counts["flash_fwd_lse"] = 16 * steps  # an "attn"-like step
    elif fault == "primal_launch":
        counts["flash_fwd"] = 1
    if fault is None:
        chip_smoke._ladder_check(losses, counts, n_layers, steps)
        return
    with pytest.raises(AssertionError, match="ladder"):
        chip_smoke._ladder_check(losses, counts, n_layers, steps)
