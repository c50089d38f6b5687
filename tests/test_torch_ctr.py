"""Port parity of the CTR workload: edl_tpu_torch's embedding lookup,
CTR model, loss, gradients, Adam steps, AUC and synthetic data against
edl_tpu's (``embedding_lookup``, ``ctr.make_loss_fn`` →
``jax.value_and_grad`` → ``optax.adam``).

Weights are the reference's JAX init carried across with
``ctr_params_from_numpy``; batches come from ``synthetic_batch`` with one
NumPy seed. Tolerances: the lookup's forward and f32 gradient 2e-5 (the
reference's own ``tests/test_embedding.py``); a bf16 table's gradient
0.25 against the f32 scatter (one bf16 ulp of the accumulated sums, the
reference's ``test_bf16_table_close_to_f32_scatter``); the f32 loss,
gradients and three Adam steps 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import edl_tpu.ops.embedding as jemb
from edl_tpu.models import ctr as jctr
from edl_tpu_torch.models import ctr as tctr
from edl_tpu_torch.models.convert import ctr_params_from_numpy
from edl_tpu_torch.obs import costmodel
from edl_tpu_torch.ops import embedding as temb
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

VOCAB, EMB, BATCH = 4096, 8, 64
JP = jctr.init_params(jax.random.PRNGKey(0), vocab=VOCAB, emb=EMB)
TOL = dict(atol=1e-5, rtol=1e-5)


def _tparams():
    return ctr_params_from_numpy(jax.tree_util.tree_map(np.asarray, JP),
                                 "cpu")


def _batch(seed, b=BATCH):
    return jctr.synthetic_batch(np.random.RandomState(seed), b, vocab=VOCAB)


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _np_tree(tree):
    """A torch tree as NumPy, so JAX flattens both sides alike (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().float().numpy()


def _assert_tree_close(got, want, **tol):
    g = jax.tree_util.tree_leaves(_np_tree(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


# -- embedding -----------------------------------------------------------------


def _ids_uniform(rng):
    return rng.randint(0, 4096, 1000)


def _ids_zipf(rng):
    return np.minimum(rng.zipf(1.3, 1000) - 1, 4095)


def _ids_second_window(rng):
    base = np.repeat(np.arange(0, 4096, 200), 49)[:1000]
    return np.minimum(base + rng.randint(0, 190, 1000), 4095)


def _ids_vocab_end(rng):
    return rng.randint(4096 - 140, 4096, 1000)


def _ids_out_of_range(rng):
    return np.concatenate([[-5, 5000, -1], rng.randint(0, 130, 997)])


# (ids, BLOCK_ROWS, VOCAB_WINDOW) of the reference's fast-path cases;
# "plain" keeps the reference's defaults (64 ids: its plain scatter)
EMB_CASES = {
    "plain": (lambda rng: rng.randint(0, 500, 64), None, None),
    "uniform": (_ids_uniform, 64, 256),
    "zipf_duplicates": (_ids_zipf, 64, 256),
    "second_window": (_ids_second_window, 64, 128),
    "vocab_end_clamp": (_ids_vocab_end, 64, 128),
    "adversarial_fallback": (_ids_uniform, 64, 128),
    "out_of_range_ids": (_ids_out_of_range, 64, 128),
}


def _lookup_pair(table, ids, w, table_dtype):
    """(forward, table gradient) of sum(lookup(table, ids) * w), JAX
    and port, the table held in ``table_dtype`` (the gradient in it)."""
    jt = jnp.asarray(table).astype(table_dtype)

    def jloss(t):
        return jnp.sum(jemb.embedding_lookup(t, ids).astype(jnp.float32) * w)

    jout = jemb.embedding_lookup(jt, ids)
    jgrad = jax.grad(jloss)(jt)
    tdt = torch.bfloat16 if table_dtype == jnp.bfloat16 else torch.float32
    tt = torch.from_numpy(table).to(tdt).requires_grad_()
    tout = temb.embedding_lookup(tt, torch.from_numpy(ids))
    (tout.float() * torch.from_numpy(w)).sum().backward()
    assert tt.grad.dtype == tdt
    return (np.asarray(jout, np.float32), np.asarray(jgrad, np.float32),
            tout.detach().float().numpy(), tt.grad.float().numpy())


@pytest.mark.parametrize("case", list(EMB_CASES))
def test_embedding_lookup_matches_reference(case, monkeypatch):
    """Forward and f32 gradient against the reference's lookup on its own
    fast-path cases (``MIN_FAST_IDS`` lowered on the JAX side, so its
    sorted block-matmul backward runs): duplicates, a second vocab
    window, the vocab-end clamp, the adversarial fallback and ids out of
    range in both directions, which clamp."""
    make_ids, rows, window = EMB_CASES[case]
    if rows is not None:
        monkeypatch.setattr(jemb, "MIN_FAST_IDS", 1)
        monkeypatch.setattr(jemb, "BLOCK_ROWS", rows)
        monkeypatch.setattr(jemb, "VOCAB_WINDOW", window)
    rng = np.random.RandomState(len(case))
    ids = make_ids(rng).astype(np.int32)
    table = rng.randn(4096, 16).astype(np.float32)
    w = rng.randn(ids.shape[0], 16).astype(np.float32)
    jout, jgrad, tout, tgrad = _lookup_pair(table, ids, w, jnp.float32)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_allclose(tgrad, jgrad, atol=2e-5)
    # the clamp in both directions: the gradient of the clamped ids
    clamped = np.clip(ids, 0, 4095)
    np.testing.assert_allclose(
        tgrad, _lookup_pair(table, clamped, w, jnp.float32)[3], atol=2e-5)


def test_embedding_bf16_table_close_to_f32_scatter(monkeypatch):
    """A bf16 table's gradient is bf16(sum_f32(ct)): within one bf16 ulp
    of the accumulated sums (0.25) of the f32 scatter, as the
    reference's own fast path is; the forward equals the reference's."""
    monkeypatch.setattr(jemb, "MIN_FAST_IDS", 1)
    monkeypatch.setattr(jemb, "BLOCK_ROWS", 64)
    monkeypatch.setattr(jemb, "VOCAB_WINDOW", 256)
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 4096, 1000).astype(np.int32)
    table = rng.randn(4096, 16).astype(np.float32)
    w = rng.randn(1000, 16).astype(np.float32)
    jout, jgrad_bf16, tout, tgrad_bf16 = _lookup_pair(table, ids, w,
                                                      jnp.bfloat16)
    np.testing.assert_array_equal(tout, jout)
    ref_f32 = _lookup_pair(table, ids, w, jnp.float32)[1]
    np.testing.assert_allclose(tgrad_bf16, ref_f32, atol=0.25)
    np.testing.assert_allclose(tgrad_bf16, jgrad_bf16, atol=0.25)


def test_sharded_embedding_lookup_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="Queue A 2b"):
        temb.sharded_embedding_lookup(torch.zeros(4, 2), torch.zeros(1),
                                      mesh=None)


# -- the CTR model ---------------------------------------------------------------


def test_forward_loss_and_grads_match_reference_f32():
    nb = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want_logits = jctr.forward(JP, jb["dense"], jb["sparse"])
    want_loss, want_grads = jax.value_and_grad(jctr.make_loss_fn())(JP, jb)
    tp = trainer.trainable(_tparams())
    tb = _tbatch(nb)
    got_logits = tctr.forward(tp, tb["dense"], tb["sparse"])
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), **TOL)
    loss, grads = trainer.value_and_grad(tctr.make_loss_fn())(tp, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_tree_close(grads, want_grads, **TOL)
    with torch.no_grad():
        assert float(tctr.loss_fn(tp, tb)) == float(loss)


# bf16 compute: both sides round every matmul output, bias add and ReLU
# to bf16 (8 bits of mantissa, 2^-8 relative a rounding) through four
# layers, and may round a tie the other way; the f32 loss is a mean over
# the batch, so it agrees within a few roundings of its size, and each
# gradient leaf within 2^-5 of its largest entry (a handful of bf16
# roundings of the accumulated products)
BF16_LOSS_ATOL = 4e-3
BF16_GRAD_OF_MAX = 2 ** -5


def test_loss_and_grads_match_reference_bf16():
    nb = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want_loss, want_grads = jax.value_and_grad(
        jctr.make_loss_fn(jnp.bfloat16))(JP, jb)
    loss, grads = trainer.value_and_grad(tctr.make_loss_fn(torch.bfloat16))(
        trainer.trainable(_tparams()), _tbatch(nb))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(want_loss)) <= BF16_LOSS_ATOL
    assert all(g.dtype == torch.float32  # master grads stay f32
               for g in trainer.leaves(grads))
    for g, w in zip(jax.tree_util.tree_leaves(_np_tree(grads)),
                    jax.tree_util.tree_leaves(want_grads)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=BF16_GRAD_OF_MAX * np.abs(w).max())


def test_three_adam_steps_match_optax():
    """The update rule on the same gradients: optax's (the reference's
    JAX gradients of each step) fed to the port's optimizer give optax's
    params and moments within 1e-5 after three steps."""
    tx = optax.adam(1e-3)
    jparams, jstate = JP, tx.init(JP)
    grad_j = jax.jit(jax.grad(jctr.make_loss_fn()))
    state = trainer.TrainState.create(_tparams(), trainer.adam(1e-3))
    opt = state.opt_state
    tparams = _sorted_leaves(state.params)  # paired with JAX's leaves
    for s in range(3):
        nb = _batch(10 + s)
        jg = grad_j(jparams, {k: jnp.asarray(v) for k, v in nb.items()})
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(tparams, jax.tree_util.tree_leaves(jg)):
            p.grad = torch.from_numpy(np.array(g))
        opt.step()
    _assert_tree_close(state.params, jparams, **TOL)
    _assert_tree_close(
        [opt.state[p]["exp_avg"] for p in tparams],
        jax.tree_util.tree_leaves(jstate[0].mu), **TOL)


def _sorted_leaves(tree):
    """The port tree's tensors in JAX's flatten order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


# Three steps end to end, each from its own gradients: Adam's first steps
# divide a gradient by its own magnitude, so an element whose gradient is
# near eps (1e-8) turns the f32 summation-order noise of the two
# backward passes into a visible part of its ~lr update (3.3e-5 on 2 of
# the first layer's 160000 weights here); the losses stay within 1e-5
# and the params within 1e-4, the tolerance tests/test_torch_train.py
# holds the same three AdamW steps to.
ADAM_E2E_TOL = dict(atol=1e-4, rtol=1e-4)


def test_three_adam_steps_end_to_end_match_optax():
    tx = optax.adam(1e-3)
    jparams, jstate = JP, tx.init(JP)
    loss_j = jax.jit(jax.value_and_grad(jctr.make_loss_fn()))
    ttx = trainer.adam(1e-3)
    state = trainer.TrainState.create(_tparams(), ttx)
    step = trainer.make_train_step(tctr.make_loss_fn(), ttx)
    for s in range(3):
        nb = _batch(10 + s)
        jl, jg = loss_j(jparams, {k: jnp.asarray(v) for k, v in nb.items()})
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state, m = step(state, trainer.global_batch(nb, device="cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jl), **TOL)
    assert state.step == 3
    _assert_tree_close(state.params, jparams, **ADAM_E2E_TOL)


def test_multistep_over_stacked_batches_equals_single_steps():
    """``stack_batches`` + ``make_train_multistep`` (the bench's chunk)
    take the same steps as one ``make_train_step`` call a batch."""
    raw = [_batch(20 + s) for s in range(3)]
    tx = trainer.adam(1e-3)
    a = trainer.TrainState.create(_tparams(), tx)
    b = trainer.TrainState.create(_tparams(), tx)
    stacked = trainer.stack_batches(raw, device="cpu")
    assert tuple(stacked["sparse"].shape) == (3, BATCH, tctr.N_SPARSE)
    a, ma = trainer.make_train_multistep(tctr.make_loss_fn(), tx)(a, stacked)
    step = trainer.make_train_step(tctr.make_loss_fn(), tx)
    for nb in raw:
        b, mb = step(b, trainer.global_batch(nb, device="cpu"))
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(trainer.leaves(a.params), trainer.leaves(b.params)):
        assert torch.equal(x, y)


def test_batch_auc_matches_reference():
    rng = np.random.RandomState(3)
    logits = rng.randn(257).astype(np.float32)
    labels = (rng.rand(257) < 0.3).astype(np.int32)
    cases = [(logits, labels), (logits, labels[:, None]),  # a label column
             (logits, np.ones(257, np.int32)),  # one class: 0.5
             (logits, np.zeros(257, np.int32))]
    for lg, lb in cases:
        want = float(jctr.batch_auc(jnp.asarray(lg), jnp.asarray(lb)))
        got = float(tctr.batch_auc(torch.from_numpy(lg), torch.from_numpy(lb)))
        assert got == pytest.approx(want, abs=1e-6)
    assert float(tctr.batch_auc(torch.from_numpy(logits),
                                torch.ones(257))) == 0.5
    with pytest.raises(ValueError, match="do not match"):
        tctr.batch_auc(torch.zeros(4), torch.zeros(5))


def test_synthetic_batch_byte_identical():
    a = jctr.synthetic_batch(np.random.RandomState(7), 300, vocab=1 << 20)
    b = tctr.synthetic_batch(np.random.RandomState(7), 300, vocab=1 << 20)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_init_params_shapes_and_constants_match_reference():
    assert (tctr.N_DENSE, tctr.N_SPARSE, tctr.DEFAULT_EMBEDDING,
            tctr.DEFAULT_VOCAB, tctr.MLP_DIMS) == (
        jctr.N_DENSE, jctr.N_SPARSE, jctr.DEFAULT_EMBEDDING,
        jctr.DEFAULT_VOCAB, jctr.MLP_DIMS)
    tp = tctr.init_params(torch.Generator().manual_seed(0), vocab=VOCAB,
                          emb=EMB, device="cpu")
    jshapes = [x.shape for x in jax.tree_util.tree_leaves(JP)]
    assert [x.shape for x in jax.tree_util.tree_leaves(_np_tree(tp))] == (
        jshapes)
    emb_std = float(tp["embedding"].std())
    assert emb_std == pytest.approx(1 / np.sqrt(EMB), rel=0.05)
    assert float(tp["mlp"][0]["w"].std()) == pytest.approx(
        np.sqrt(2.0 / (26 * EMB + 13)), rel=0.05)
    with pytest.raises(ValueError, match="not a CTR param tree"):
        ctr_params_from_numpy({"embed": np.zeros(2)}, "cpu")


def test_ctr_flops_match_reference_costmodel():
    from edl_tpu.obs import costmodel as jcost

    for kw in ({}, {"emb": 8, "mlp_dims": (64, 1)}):
        assert (costmodel.ctr_train_flops_per_example(**kw)
                == jcost.ctr_train_flops_per_example(**kw))


def test_ctr_entry_points_default_to_cuda(monkeypatch):
    """No CUDA and no explicit "cpu": the CTR entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tctr.init_params(torch.Generator(), vocab=16, emb=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.stack_batches([_batch(0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.global_batch(_batch(0))
    with pytest.raises(NotImplementedError, match="not ported"):
        trainer.stack_batches([_batch(0)], mesh=object(), device="cpu")
