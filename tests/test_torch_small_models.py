"""Port parity of the small workloads: edl_tpu_torch's models/meta,
linreg (fit_a_line), resnet, bert and evals against edl_tpu's.

Weights are the reference's JAX init carried across with
``params_from_numpy``; inputs come from the reference's synthetic
batches with one NumPy seed. Tolerances, none loosened later:

- linreg: loss and gradients within 1e-6 (absolute and relative).
- resnet ``tiny()`` (f32, inputs 32 x 32 and 33 x 33: XLA's SAME padding
  is asymmetric on the even one) and bert ``tiny()`` (f32): logits within
  1e-4 of their largest magnitude, the loss within 1e-5 relative, every
  gradient leaf within 1e-4 of its largest magnitude, with and without
  the runtime's row weights ``_w``. A conv padded symmetrically (1, 1)
  and an erf GELU each break these bounds (shown below).
- bf16 (one forward a model, the configs' bf16 compute): both packages
  round the same f32 computation at the same points, so each lands
  within the rounding error of the f32 forward. With E the reference's
  own (max |ref_bf16 - ref_f32| over the logits), the port's bf16
  logits are within 2 E of the f32 logits and within 2 E of the
  reference's bf16 logits (triangle inequality, each side's error at
  most E, plus a factor of 2 for where the roundings land; measured
  0.7-1.05 E).
- evals: greedy tokens and predictions equal, CE totals within 1e-5
  relative, CE counts and masked accuracy equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from edl_tpu.models import bert as jb
from edl_tpu.models import evals as jevals
from edl_tpu.models import linreg as jlin
from edl_tpu.models import llama as jl
from edl_tpu.models import resnet as jr
from edl_tpu_torch.models import bert as tb
from edl_tpu_torch.models import evals as tevals
from edl_tpu_torch.models import linreg as tlin
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models import meta as tmeta
from edl_tpu_torch.models import resnet as tr
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

LOGIT_OF_MAX = 1e-4
LOSS_RTOL = 1e-5
GRAD_OF_MAX = 1e-4
BF16_OF_E = 2.0
CE_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tparams(jp):
    return params_from_numpy(_np(jp), "cpu")


def _tbatch(nb):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()}


def _np_tree(tree):
    """A torch tree as NumPy, so JAX flattens both sides alike."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().float().numpy()


def _of_max(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _grad_errs(got, want):
    g = jax.tree_util.tree_leaves(_np_tree(got))
    w = jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
    return [_of_max(a, b) for a, b in zip(g, w)]


# -- meta ------------------------------------------------------------------------


META_CASES = [
    ("resnet", "tiny"), ("resnet", "resnet50"), ("bert", "tiny"),
    ("bert", "base"),
]


def _cfgs(family, ctor):
    if family == "resnet":
        return (getattr(jr.ResNetConfig, ctor)(),
                getattr(tr.ResNetConfig, ctor)())
    return getattr(jb.BertConfig, ctor)(), getattr(tb.BertConfig, ctor)()


@pytest.mark.parametrize("family,ctor", META_CASES)
def test_meta_record_equals_the_reference(family, ctor):
    """The record is the reference's key for key, through JSON both
    ways: each package's from_meta rebuilds the other's config."""
    jcfg, tcfg = _cfgs(family, ctor)
    assert tcfg.to_meta() == jcfg.to_meta()
    wire = json.loads(json.dumps(jcfg.to_meta()))
    assert type(tcfg).from_meta(wire) == tcfg
    assert type(jcfg).from_meta(json.loads(json.dumps(tcfg.to_meta()))) == jcfg
    # unknown keys are ignored, missing ones take the defaults
    assert type(tcfg).from_meta({**wire, "future_key": 1}) == tcfg
    assert type(tcfg).from_meta({"family": family}) == type(tcfg)()


def test_meta_family_mismatch_raises_the_reference_message():
    for jcls, tcls, other in ((jr.ResNetConfig, tr.ResNetConfig, "bert"),
                              (jb.BertConfig, tb.BertConfig, "resnet")):
        with pytest.raises(ValueError) as want:
            jcls.from_meta({"family": other})
        with pytest.raises(ValueError) as got:
            tcls.from_meta({"family": other})
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unsupported dtype"):
        tr.ResNetConfig.from_meta({"family": "resnet", "dtype": "complex"})
    assert tmeta.dtype_name(torch.bfloat16) == "bfloat16"


# -- linreg ----------------------------------------------------------------------


def test_linreg_dataset_is_byte_identical():
    for n, seed, noise in ((4096, 0, 0.1), (7, 3, 0.5)):
        jx, jy = jlin.synthetic_dataset(n, seed=seed, noise=noise)
        tx, ty = tlin.synthetic_dataset(n, seed=seed, noise=noise)
        assert jx.tobytes() == tx.tobytes() and jy.tobytes() == ty.tobytes()
    assert tlin.N_FEATURES == jlin.N_FEATURES


@pytest.mark.parametrize("weighted", [False, True])
def test_linreg_loss_and_grads_match(weighted):
    jp = jlin.init_params(jax.random.PRNGKey(0))
    x, y = jlin.synthetic_dataset(64, seed=1)
    nb = {"x": x, "y": y}
    if weighted:
        nb["_w"] = (np.arange(64) % 3 != 0).astype(np.float32)
    want_l, want_g = jax.value_and_grad(jlin.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    got_l, got_g = trainer.value_and_grad(tlin.loss_fn)(
        trainer.trainable(_tparams(jp)), _tbatch(nb))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6,
                               atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=1e-6, atol=1e-6)
    p = tlin.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert p["w"].shape == (13, 1) and p["b"].shape == (1,)
    assert float(p["w"].abs().max()) < 0.1 and float(p["b"].abs().max()) == 0


# -- resnet ----------------------------------------------------------------------


RCFG_J, RCFG_T = jr.ResNetConfig.tiny(), tr.ResNetConfig.tiny()
RJP = jr.init_params(jax.random.PRNGKey(0), RCFG_J)


def _resnet_errs(size, weighted):
    """(logits, loss, worst grad leaf) errors of the port's tiny ResNet
    against the reference's at ``size`` x ``size`` inputs."""
    nb = jr.synthetic_batch(np.random.RandomState(size), 6, size=size)
    if weighted:
        nb["_w"] = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    want_logits = jr.forward(RJP, jbatch["images"], RCFG_J)
    want_l, want_g = jax.value_and_grad(jr.make_loss_fn(RCFG_J))(RJP, jbatch)
    tp = trainer.trainable(_tparams(RJP))
    got_logits = tr.forward(tp, torch.from_numpy(nb["images"]), RCFG_T)
    got_l, got_g = trainer.value_and_grad(tr.make_loss_fn(RCFG_T))(
        tp, _tbatch(nb))
    return (_of_max(got_logits.detach().numpy(), want_logits),
            abs(float(got_l) - float(want_l)) / abs(float(want_l)),
            max(_grad_errs(got_g, want_g)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_forward_loss_and_grads_match(size, weighted):
    logits, loss, grad = _resnet_errs(size, weighted)
    assert logits <= LOGIT_OF_MAX and loss <= LOSS_RTOL and grad <= GRAD_OF_MAX


def test_resnet_parity_fails_with_symmetric_padding(monkeypatch):
    """F.conv2d's symmetric padding (1, 1) on the even input, where XLA
    pads a 3 x 3 stride-2 conv (0, 1): the bounds above catch it."""
    monkeypatch.setattr(tr, "same_pads", lambda n, k, s: ((k - 1) // 2,) * 2)
    logits, _, grad = _resnet_errs(32, False)
    assert logits > LOGIT_OF_MAX * 100 and grad > GRAD_OF_MAX


def test_resnet_same_pads_is_xla_rule():
    assert tr.same_pads(32, 3, 2) == (0, 1)
    assert tr.same_pads(33, 3, 2) == (1, 1)
    assert tr.same_pads(32, 3, 1) == (1, 1)
    assert tr.same_pads(32, 1, 2) == (0, 0)
    assert tr.same_pads(33, 1, 2) == (0, 0)


def test_resnet_init_shapes_and_pspecs():
    cfg = tr.ResNetConfig.tiny(num_classes=7)
    tp = tr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jr.init_params(jax.random.PRNGKey(0), jr.ResNetConfig.tiny(7))
    assert jax.tree_util.tree_structure(_np_tree(tp)) == \
        jax.tree_util.tree_structure(_np(jp))
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(tp)),
                    jax.tree_util.tree_leaves(_np(jp))):
        assert a.shape == b.shape and a.dtype == b.dtype
    specs = tr.param_pspecs(cfg, None)
    assert jax.tree_util.tree_structure(
        specs, is_leaf=lambda x: x is None) == \
        jax.tree_util.tree_structure(_np_tree(tp))

    class Plan:
        axes = (("fsdp", 2),)

    with pytest.raises(NotImplementedError, match="not ported"):
        tr.param_pspecs(cfg, Plan())
    # the analytic FLOP count, against a hand count of the tiny net
    n = 32 * 32
    want = 2 * (n * 27 * 16 + n * 9 * (16 * 16 + 16 * 16)
                + 16 * 16 * (9 * (16 * 32 + 32 * 32) + 16 * 32) + 32 * 7)
    assert tr.forward_flops(cfg, 32) == want


# -- bert ------------------------------------------------------------------------


BCFG_J, BCFG_T = jb.BertConfig.tiny(), tb.BertConfig.tiny()
BJP = jb.init_params(jax.random.PRNGKey(0), BCFG_J)


def _bert_errs(weighted):
    nb = jb.synthetic_mlm_batch(np.random.RandomState(3), 4, 24, BCFG_J.vocab)
    if weighted:
        nb["_w"] = np.array([1, 0, 1, 1], np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    want_logits = jb.forward(BJP, jbatch["tokens"], BCFG_J)
    want_l, want_g = jax.value_and_grad(jb.make_loss_fn(BCFG_J))(BJP, jbatch)
    tp = trainer.trainable(_tparams(BJP))
    got_logits = tb.forward(tp, torch.from_numpy(nb["tokens"]), BCFG_T)
    got_l, got_g = trainer.value_and_grad(tb.make_loss_fn(BCFG_T))(
        tp, _tbatch(nb))
    return (_of_max(got_logits.detach().numpy(), want_logits),
            abs(float(got_l) - float(want_l)) / abs(float(want_l)),
            max(_grad_errs(got_g, want_g)))


@pytest.mark.parametrize("weighted", [False, True])
def test_bert_forward_loss_and_grads_match(weighted):
    logits, loss, grad = _bert_errs(weighted)
    assert logits <= LOGIT_OF_MAX and loss <= LOSS_RTOL and grad <= GRAD_OF_MAX


def test_bert_parity_fails_with_erf_gelu(monkeypatch):
    """torch's default GELU (erf) in place of jax.nn.gelu's tanh form:
    the bounds above catch it."""
    gelu = F.gelu
    monkeypatch.setattr(tb.F, "gelu", lambda x, approximate="none": gelu(x))
    logits, _, grad = _bert_errs(False)
    assert logits > LOGIT_OF_MAX and grad > GRAD_OF_MAX


def test_bert_init_shapes_pspecs_and_flops():
    cfg = tb.BertConfig.tiny(vocab=64)
    tp = tb.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jb.init_params(jax.random.PRNGKey(0), jb.BertConfig.tiny(vocab=64))
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(tp)),
                    jax.tree_util.tree_leaves(_np(jp))):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert set(tb.param_pspecs(cfg, None)) == set(tp)
    assert set(tb.param_pspecs(cfg, None)["layers"]) == set(tp["layers"])
    d, ff, L, t = 64, 128, 2, 24
    assert tb.train_flops_per_token(cfg, t) == 6 * (
        L * (4 * d * d + 2 * d * ff) + d * 64) + 12 * L * t * d
    nb = tb.synthetic_mlm_batch(np.random.RandomState(0), 3, 9, 64)
    want = jb.synthetic_mlm_batch(np.random.RandomState(0), 3, 9, 64)
    for k in want:
        assert nb[k].tobytes() == want[k].tobytes() and \
            nb[k].dtype == want[k].dtype
    assert tb.MASK_TOKEN == jb.MASK_TOKEN


# -- bf16 ------------------------------------------------------------------------


def _bf16_case(model):
    if model == "resnet":
        nb = jr.synthetic_batch(np.random.RandomState(1), 8, size=32)
        x = nb["images"]
        jfwd = lambda c: jr.forward(RJP, jnp.asarray(x), c)  # noqa: E731
        return (jfwd(RCFG_J),
                jfwd(dataclasses.replace(RCFG_J, dtype=jnp.bfloat16)),
                tr.forward(_tparams(RJP), torch.from_numpy(x),
                           dataclasses.replace(RCFG_T, dtype=torch.bfloat16)))
    nb = jb.synthetic_mlm_batch(np.random.RandomState(1), 4, 32, BCFG_J.vocab)
    x = nb["tokens"]
    jfwd = lambda c: jb.forward(BJP, jnp.asarray(x), c)  # noqa: E731
    return (jfwd(BCFG_J), jfwd(dataclasses.replace(BCFG_J, dtype=jnp.bfloat16)),
            tb.forward(_tparams(BJP), torch.from_numpy(x),
                       dataclasses.replace(BCFG_T, dtype=torch.bfloat16)))


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_bf16_forward_within_the_references_rounding(model):
    f32, ref, got = _bf16_case(model)
    f32, ref = np.asarray(f32, np.float64), np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    e = np.abs(ref - f32).max()
    assert e > 0  # bf16 really rounded
    assert np.abs(got - f32).max() <= BF16_OF_E * e
    assert np.abs(got - ref).max() <= BF16_OF_E * e


# -- evals -----------------------------------------------------------------------


LCFG_J = jl.LlamaConfig.tiny(vocab=128)
LCFG_T = tl.LlamaConfig.tiny(vocab=128)
LJP = jl.init_params(jax.random.PRNGKey(4), LCFG_J)


@pytest.mark.parametrize("n,t", [(70, 6), (5, 9), (9, 1)])
def test_lm_scan_and_ppl_match(n, t):
    """N above and not a multiple of CHUNK, N below it, and T = 1 (no
    next-token CE)."""
    toks = np.random.RandomState(n).randint(0, 128, (n, t)).astype(np.int32)
    jfn = lambda p, x: jl.forward(p, x, LCFG_J)  # noqa: E731
    tfn = lambda p, x: tl.forward(p, x, LCFG_T)  # noqa: E731
    tp = _tparams(LJP)
    jn, jt, jc = jevals.lm_scan(jfn, LJP, toks)
    tn, tt, tc = tevals.lm_scan(tfn, tp, toks)
    assert tn.dtype == np.int32 and np.array_equal(tn, jn)
    assert tc == jc == n * (t - 1)
    if jc:
        np.testing.assert_allclose(tt, jt, rtol=CE_RTOL)
    else:
        assert tt == jt == 0.0
    np.testing.assert_allclose(tevals.lm_ppl(tfn, tp, toks),
                               jevals.lm_ppl(jfn, LJP, toks), rtol=CE_RTOL)
    assert tevals.CHUNK == jevals.CHUNK
    empty = tevals.lm_scan(tfn, tp, toks[:0])
    assert empty[0].shape == (0,) and empty[0].dtype == np.int32


@pytest.mark.parametrize("n,with_mask", [(70, True), (5, True), (70, False)])
def test_masked_top1_matches(n, with_mask):
    rows = jb.synthetic_mlm_batch(np.random.RandomState(n), n, 12,
                                  BCFG_J.vocab)
    if not with_mask:
        rows = {"tokens": rows["tokens"]}
    jfn = lambda p, x: jb.forward(p, x, BCFG_J)  # noqa: E731
    tfn = lambda p, x: tb.forward(p, x, BCFG_T)  # noqa: E731
    jacc, jpred = jevals.masked_top1(jfn, BJP, rows)
    tacc, tpred = tevals.masked_top1(tfn, _tparams(BJP), rows)
    assert tpred.dtype == np.int32 and np.array_equal(tpred, jpred)
    assert tacc == jacc
    if not with_mask:
        assert tacc == 0.0


def test_argmax_keeps_the_first_maximum():
    logits = torch.tensor([[[1.0, 3.0, 3.0, 0.0]]])
    assert tevals._argmax(logits[:, -1]).tolist() == [1]
    assert int(jnp.argmax(jnp.asarray([1.0, 3.0, 3.0, 0.0]))) == 1


# -- chip_smoke's small_workloads gates ----------------------------------------


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_chip_smoke_plain_reference_gate_holds_on_the_cpu(model):
    """The card's gate (the port's f32 forward against chip_smoke's own
    NumPy float64 forward) holds on the CPU."""
    err = chip_smoke._small_reference_check(model, "cpu")
    assert max(err.values()) <= chip_smoke.SMALL_REF_OF_MAX[model]


def test_chip_smoke_plain_reference_gate_trips_on_symmetric_padding(
        monkeypatch):
    monkeypatch.setattr(tr, "same_pads", lambda n, k, s: ((k - 1) // 2,) * 2)
    with pytest.raises(AssertionError, match="resnet"):
        chip_smoke._small_reference_check("resnet", "cpu")


def test_chip_smoke_plain_reference_gate_trips_on_erf_gelu(monkeypatch):
    gelu = F.gelu
    monkeypatch.setattr(tb.F, "gelu", lambda x, approximate="none": gelu(x))
    with pytest.raises(AssertionError, match="bert"):
        chip_smoke._small_reference_check("bert", "cpu")


def test_chip_smoke_numpy_reference_matches_jax():
    """chip_smoke's NumPy forwards are the reference's math: held to the
    JAX forwards here, so the card gate holds the port to the reference
    without JAX."""
    for size in (32, 33):
        nb = jr.synthetic_batch(np.random.RandomState(size), 3, size=size)
        want = np.asarray(jr.forward(RJP, jnp.asarray(nb["images"]), RCFG_J))
        got = chip_smoke._np_resnet(_np(RJP), nb["images"], RCFG_J.groups)
        assert _of_max(got, want) <= LOGIT_OF_MAX
    nb = jb.synthetic_mlm_batch(np.random.RandomState(0), 2, 16, BCFG_J.vocab)
    want = np.asarray(jb.forward(BJP, jnp.asarray(nb["tokens"]), BCFG_J))
    got = chip_smoke._np_bert(_np(BJP), nb["tokens"], BCFG_J.n_heads,
                              BCFG_J.norm_eps)
    assert _of_max(got, want) <= LOGIT_OF_MAX


def test_chip_smoke_fit_a_line_recipe_learns_on_the_cpu():
    out = chip_smoke._fit_a_line("cpu", steps=200)
    assert out["final_loss"] < 1.5 and out["losses"][-1] < out["losses"][0]


def test_chip_smoke_small_step_agreement_holds_on_the_cpu():
    """The card-vs-CPU step gate, both sides on the CPU: equal."""
    for model in ("fit_a_line", "resnet", "bert"):
        assert chip_smoke._small_step_agreement(model, "cpu") == 0.0


def test_loss_curves_arms_share_params_and_batch_on_the_cpu(capsys):
    """``train/loss_curves`` at ``tiny()``: every arm starts from the same
    params and batch (the f32 arm's first loss equals the bf16 arms' to
    bf16's rounding; the two 1e-3 arms take the same path), and the
    1e-4 arm moves less than the 1e-3 arms."""
    from edl_tpu_torch.train import loss_curves

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    assert loss_curves.main(["--tiny", "--device", "cpu", "--steps", "3"]) == 0
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == tf32  # restored
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["model"], r["dtype"], r["lr"]) for r in rows] == [
        (m, d, lr) for m in ("resnet", "bert") for d, lr in loss_curves.ARMS]
    for m in ("resnet", "bert"):
        bf, f32, slow = (r for r in rows if r["model"] == m)
        assert bf["first"] == slow["first"]
        assert abs(bf["first"] - f32["first"]) <= 2 ** -7 * abs(f32["first"])
        assert all(np.isfinite(r["losses"]).all() and len(r["losses"]) == 3
                   for r in (bf, f32, slow))
        assert (bf["first"] - bf["last"]) > (slow["first"] - slow["last"]) > 0
