"""Port parity of the training half of flash attention: the lse forward
and the dQ / dK/dV backward of edl_tpu_torch against the reference's
Pallas kernels (interpret mode on the CPU). The Hopper kernels
themselves are held against these plain versions in
tests/test_torch_cuda.py.

Inputs are made with numpy from a seed and handed to both. Tolerances:
f32 atol 5e-4 on the gradients, as tests/test_flash_attention.py holds
the reference kernel's own gradients to its oracle; the lse at 2e-5,
the forward's tolerance (same base-2 online softmax over the same
blocks, only f32 summation order differs). bf16: one bf16 rounding of
the result (rtol 2^-7) on top of the f32 atol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import flash_attention as jfa
from edl_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# (b, t, h, kv, d, causal, block_q, block_k)
CASES = {
    "causal": (2, 128, 2, 2, 32, True, 32, 32),
    "full": (2, 128, 2, 2, 32, False, 32, 32),
    "gqa_causal": (1, 64, 4, 2, 16, True, 32, 32),
    "gqa_full": (1, 64, 4, 2, 16, False, 32, 32),
    # 640 divides neither 512 nor 1024: both blocks step down to 128
    "t640_step_down": (1, 640, 2, 1, 16, True, 512, 1024),
}


def _inputs(seed, b, t, h, kv, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, n, d).astype(np.float32) for n in (h, kv, kv))
    w = rng.randn(b, t, h, d).astype(np.float32)  # upstream gradient
    return q, k, v, w


def _jax_lse(q, k, v, causal, block_q, block_k):
    b, t, h, d = q.shape
    kv = k.shape[2]
    bq, bk = jfa._fit_block(block_q, t), jfa._fit_block(block_k, t)
    flat = lambda x, n: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(  # noqa
        b * n, t, d)
    _, lse = jfa._fwd_call(flat(q, h), flat(k, kv), flat(v, kv), h // kv,
                           bq, bk, causal, True, with_lse=True)
    return np.asarray(lse)[..., 0].reshape(b, h, t)


def _jax_grads(q, k, v, w, causal, block_q, block_k, dtype=jnp.float32):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _torch_grads(q, k, v, w, causal, block_q, block_k, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=causal, block_q=block_q,
                              block_k=block_k)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_reference_kernel(case):
    b, t, h, kv, d, causal, bq, bk = CASES[case]
    q, k, v, _ = _inputs(0, b, t, h, kv, d)
    want = _jax_lse(q, k, v, causal, bq, bk)
    out, lse = tfa.flash_attention_lse_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, bq, bk)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5)
    # the forward output is flash_attention_ref's, bit for bit
    ref = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal, bq, bk)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_reference_kernel(case):
    b, t, h, kv, d, causal, bq, bk = CASES[case]
    q, k, v, w = _inputs(1, b, t, h, kv, d)
    want = _jax_grads(q, k, v, w, causal, bq, bk)
    got = _torch_grads(q, k, v, w, causal, bq, bk)
    for g, r, name in zip(got, want, "qkv"):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=5e-4, err_msg=f"d{name}")


def test_bwd_ref_is_the_autograd_backward():
    """The flash op's CPU backward (``edl_tpu_torch::flash_bwd``) is
    flash_attention_bwd_ref on the lse forward's residuals, and both
    agree with autograd through the dense softmax (the math the sweeps
    must reproduce)."""
    b, t, h, kv, d = 1, 64, 4, 2, 16
    q, k, v, w = (torch.from_numpy(x)
                  for x in _inputs(2, b, t, h, kv, d))
    out, lse = tfa.flash_attention_lse_ref(q, k, v, True, 32, 32)
    dq, dk, dv = tfa.flash_attention_bwd_ref(q, k, v, out, lse, w, True,
                                             32, 32)
    got = _torch_grads(*(x.numpy() for x in (q, k, v, w)), True, 32, 32)
    for a, g in zip((dq, dk, dv), got):
        np.testing.assert_array_equal(a.numpy(), g)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    kr, vr = (x.repeat_interleave(h // kv, dim=2) for x in (ks, vs))
    s = torch.einsum("bthd,bshd->bhts", qs, kr) / d ** 0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhts,bshd->bthd", s.softmax(-1), vr)
    (o * w).sum().backward()
    for a, r in zip((dq, dk, dv), (qs.grad, ks.grad, vs.grad)):
        torch.testing.assert_close(a, r, atol=5e-4, rtol=0)


def test_bf16_grads_within_one_rounding():
    """bf16 inputs: p rounded to dO's dtype and ds to q/k's before the
    products on both sides; dq/dk/dv agree to one bf16 rounding."""
    b, t, h, kv, d = 1, 128, 4, 2, 32
    q, k, v, w = _inputs(3, b, t, h, kv, d)
    want = _jax_grads(q, k, v, w, True, 64, 64, jnp.bfloat16)
    got = _torch_grads(q, k, v, w, True, 64, 64, torch.bfloat16)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, r, atol=5e-4 + 2 ** -7 * np.abs(r).max(),
                                   rtol=2 ** -7, err_msg=f"d{name}")


def test_cpu_path_counts_no_launch_and_no_grad_skips_lse():
    b, t, h, kv, d = 1, 32, 4, 2, 16
    q, k, v, w = _inputs(4, b, t, h, kv, d)
    tfa.reset_launches()
    _torch_grads(q, k, v, w, True, 512, 1024)
    with torch.no_grad():
        tfa.attention_auto(*(torch.from_numpy(x).requires_grad_()
                             for x in (q, k, v)))
    assert tfa.launch_counts() == dict.fromkeys(tfa.KERNELS, 0)
    # no input needs a grad: the primal forward, no autograd node
    out = tfa.attention_auto(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.grad_fn is None


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only; the dispatch sends
    CPU tensors to the plain versions before any wrapper is reached."""
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_lse_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_bwd_cuda(x, x, x, x, lse, x)
