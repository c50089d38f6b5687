"""The port's remat policies and the registered flash op.

``LlamaConfig.tiny`` in f32 with ``use_flash=True`` (2 layers, T=16),
the port's plain flash version on the CPU. Checks: the reference's
guards raise with the reference's messages; the backward recomputes
exactly the weight products (``aten.mm``) and flash forwards reckoned
for each policy (``chip_smoke.py``'s counter and gate, the ones its
``remat_policies`` phase runs on the card); the gate trips on planted
faults, among them an ``"mlp"`` policy that saves ``silu`` instead of
the products; and ``edl_tpu_torch::flash_fwd`` / ``flash_bwd`` have
fake kernels that give shapes without a launch. Loss and gradient
parity of each policy against the reference is
``tests/test_torch_train.py::test_unported_remat_policies_raise``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from edl_tpu.models import llama as jl
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.ops import flash_attention as tfa
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

JCFG = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash=True, remat=True)
TCFG = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True, remat=True)
JP = jl.init_params(jax.random.PRNGKey(0), JCFG)
L = TCFG.n_layers
# per policy, over the 2-layer step: (flash forward ops, forward and
# recompute; weight products the backward recomputes)
WANT = {"full": (2 * L, 6 * L), "attn": (L, 6 * L), "mlp": (2 * L, 4 * L),
        "dots": (2 * L, 0)}


def _params():
    return trainer.trainable(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, JP), "cpu", torch.float32))


def _batch(t=16):
    nb = tl.synthetic_tokens(np.random.RandomState(3), 2, t, JCFG.vocab)
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _raised(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("case", ["attn_without_flash", "attn_unsupported_t",
                                  "unknown_policy"])
def test_remat_guards_raise_with_the_reference_messages(case):
    over = {"attn_without_flash": dict(remat_policy="attn", use_flash=False),
            "attn_unsupported_t": dict(remat_policy="attn"),
            "unknown_policy": dict(remat_policy="x")}[case]
    t = 600 if case == "attn_unsupported_t" else 16
    assert tl.flash_supported(16) and not tl.flash_supported(600)
    tokens = np.zeros((1, t), np.int32)
    want = _raised(lambda: jl.forward(JP, jnp.asarray(tokens),
                                      dataclasses.replace(JCFG, **over)))
    got = _raised(lambda: tl.forward(_params(), torch.from_numpy(tokens),
                                     dataclasses.replace(TCFG, **over)))
    assert got == want
    assert {"attn_without_flash": "without use_flash",
            "attn_unsupported_t": "seq len 600 is not flash-supported",
            "unknown_policy": "unknown remat_policy 'x'"}[case] in got


@functools.lru_cache(maxsize=None)
def _full():
    loss, grads, _ = chip_smoke._remat_step(_params(), TCFG, _batch())
    return loss, grads


@pytest.mark.parametrize("policy", sorted(WANT))
def test_backward_recomputes_the_reckoned_products(policy):
    """The counts pinned per policy on the CPU plain path, and
    chip_smoke's gate passing on them with loss and grads equal to
    "full"'s bit for bit."""
    cfg = dataclasses.replace(TCFG, remat_policy=policy)
    loss, grads, counts = chip_smoke._remat_step(_params(), cfg, _batch())
    flash, mm = WANT[policy]
    assert counts == {"flash_fwd_ops": flash, "recomputed_mm": mm}
    # on the CPU each flash forward op stands for the launch it makes on
    # the card
    got = chip_smoke._remat_check(policy, L, counts, counts["flash_fwd_ops"],
                                  loss, grads, *_full())
    assert got["loss_rel_diff_vs_full"] == 0
    assert got["grad_max_abs_diff_vs_full"] == 0
    # the CPU path runs the plain versions: no kernel launched
    assert tfa.launch_counts() == dict.fromkeys(tfa.KERNELS, 0)


def test_without_remat_or_grad_nothing_is_recomputed():
    loss, _, counts = chip_smoke._remat_step(
        _params(), dataclasses.replace(TCFG, remat=False), _batch())
    assert counts == {"flash_fwd_ops": L, "recomputed_mm": 0}
    torch.testing.assert_close(loss, _full()[0], atol=0, rtol=0)


def _planted_policy(monkeypatch, save):
    monkeypatch.setattr(tl, "_remat_policy", lambda cfg: tl._policy(save))


@pytest.mark.parametrize("fault", ["mlp_saves_silu", "attn_saves_nothing",
                                   "dots_saves_bmm", "lse_launches",
                                   "grad_leaf", "loss"])
def test_remat_gate_trips(fault, monkeypatch):
    """The remat_policies gate fails on: an "mlp" policy that saves the
    ``silu`` output (the reference's ``mlp_gate`` site) instead of the
    w1/w3 products, so w1·m is still recomputed; an "attn" policy that
    saves no flash output; a "dots" policy that saves the batched
    products instead of the weight products; a launch count off by one;
    one gradient leaf or the loss off by 1e-4."""
    policy = {"mlp_saves_silu": "mlp", "attn_saves_nothing": "attn",
              "dots_saves_bmm": "dots"}.get(fault, "full")
    silu = torch.ops.aten.silu.default
    if fault == "mlp_saves_silu":
        _planted_policy(monkeypatch, lambda op: op == silu)
    elif fault == "attn_saves_nothing":
        _planted_policy(monkeypatch, lambda op: False)
    elif fault == "dots_saves_bmm":
        _planted_policy(monkeypatch,
                        lambda op: op == torch.ops.aten.bmm.default)
    cfg = dataclasses.replace(TCFG, remat_policy=policy)
    loss, grads, counts = chip_smoke._remat_step(_params(), cfg, _batch())
    launches = counts["flash_fwd_ops"]
    if fault == "lse_launches":
        launches -= 1
    elif fault == "grad_leaf":
        grads[3] = grads[3] + 1e-4 * grads[3].abs().max()
    elif fault == "loss":
        loss = loss * (1 + 1e-4)
    match = "vs 'full'" if fault in ("grad_leaf", "loss") else "counts"
    with pytest.raises(AssertionError, match=match):
        chip_smoke._remat_check(policy, L, counts, launches, loss, grads,
                                *_full())


def test_flash_ops_are_registered_with_fake_kernels():
    """Dispatch modes and meta/fake tensors see the ops' shapes without
    running either path, and the public op's gradient flows through
    ``edl_tpu_torch::flash_bwd``."""
    b, t, h, kv, d = 2, 256, 4, 2, 64
    for mode in (FakeTensorMode(), None):
        dev = "meta" if mode is None else "cpu"
        with mode or torch.device(dev):
            q = torch.empty(b, t, h, d, dtype=torch.bfloat16)
            k = torch.empty(b, t, kv, d, dtype=torch.bfloat16)
            out, lse = torch.ops.edl_tpu_torch.flash_fwd(q, k, k, True, 512,
                                                         1024)
            dq, dk, dv = torch.ops.edl_tpu_torch.flash_bwd(
                q, k, k, out, lse, q, True, 512, 1024)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert lse.shape == (b, h, t) and lse.dtype == torch.float32
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 32, n, 16).astype(np.float32))
               .requires_grad_() for n in (4, 2, 2))
    out = tfa.flash_attention(q, k, v)
    assert "edl_tpu_torch_flash_fwd" in out.grad_fn.name()
    out.sum().backward()
    ref_out, lse = tfa.flash_attention_lse_ref(q.detach(), k.detach(),
                                               v.detach())
    want = tfa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       ref_out, lse, torch.ones_like(ref_out))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
