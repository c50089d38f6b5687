"""Port parity: edl_tpu_torch flash attention vs the reference Pallas
kernel (interpret mode on the CPU). The Hopper kernel itself is held
against the plain version in tests/test_torch_cuda.py.

Tolerances: f32 atol 2e-5, as tests/test_flash_attention.py holds the
reference kernel to its oracle (both sides run the same base-2 online
softmax over the same blocks, so only f32 summation order differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edl_tpu.ops import flash_attention as jfa
from edl_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _qkv(seed, b, t, h, kv, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, n, d).astype(np.float32) for n in (h, kv, kv)]


def _both(q, k, v, causal, block_q, block_k):
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block_q, block_k=block_k, interpret=True,
    )
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=block_q, block_k=block_k,
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_ref_matches_reference_kernel(causal):
    q, k, v = _qkv(0, 2, 128, 2, 2, 32)
    want, got = _both(q, k, v, causal, 32, 32)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ref_gqa_no_repeat(causal):
    """H=4 query heads over KV=2 heads, grouped h -> h // 2."""
    q, k, v = _qkv(1, 2, 64, 4, 2, 16)
    want, got = _both(q, k, v, causal, 32, 32)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_ref_fit_block_step_down():
    """T=640 divides neither 512 nor 1024: both blocks step down to 128,
    on both sides, and the results agree."""
    assert tfa._fit_block(512, 640) == 128
    q, k, v = _qkv(2, 1, 640, 2, 1, 16)
    want, got = _both(q, k, v, True, 512, 1024)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_flash_supported_parity():
    """The dispatch predicate picks the kernel on exactly the reference's
    sequence lengths."""
    for t in range(1, 4097):
        assert tfa.flash_supported(t) == jfa.flash_supported(t), t
        assert tfa._fit_block(1024, t) == jfa._fit_block(1024, t), t


def test_ref_rejects_unsupported_seq_and_bad_groups():
    q = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, q[:, :, :1].repeat(1, 1, 3, 1), q[:, :, :1]
                            .repeat(1, 1, 3, 1))


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 32, 4, 2, 16))
    before = tfa.launches
    out = tfa.attention_auto(q, k, v)
    assert tfa.launches == before
    torch.testing.assert_close(
        out, tfa.flash_attention_ref(q, k, v), atol=0, rtol=0
    )


@pytest.mark.parametrize("block", [64, 128])
def test_ref_bf16_rounds_p_like_the_reference(block):
    """bf16 inputs: P is rounded to V's dtype before P·V on both sides;
    outputs agree to one bf16 rounding of the output (2^-8 relative).
    d=128, GQA H4/KV2, T=256, at the backward kernels' 64 x 64 tiles and
    the forward kernel's 128 x 128 ones: the plain version the card holds
    the Hopper kernel to, at its own tile, is itself held to the Pallas
    kernel here."""
    q, k, v = _qkv(4, 1, 256, 4, 2, 128)
    want = jfa.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), block_q=block, block_k=block,
        interpret=True,
    )
    got = tfa.flash_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), block_q=block, block_k=block,
    )
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-2, rtol=2 ** -7)
