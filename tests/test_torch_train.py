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
    cfg = dataclasses.replace(TCFG, remat=True, remat_policy=policy)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tl.make_loss_fn(cfg)(_tparams(), _tbatch(_batch(0)))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tl.forward(_tparams(), torch.zeros(1, 4, dtype=torch.long),
                   dataclasses.replace(TCFG, remat=True, remat_policy="x"))


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
