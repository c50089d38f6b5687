"""Hopper kernels of edl_tpu_torch on the card, held against their
plain PyTorch versions. Needs a CUDA card and nvcc; skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from edl_tpu_torch.ops import flash_attention as tfa


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 128, 1024, 1536])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernel_matches_plain_version(t, causal):
    """The Hopper kernel against flash_attention_ref on the card (bf16,
    H=32, KV=8, d=128). Tolerance: 2e-2 absolute plus 2^-7 relative —
    both sides round the output to bf16 and sum in different orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (
        torch.randn(1, t, n, 128, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
        for n in (32, 8, 8)
    )
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    want = tfa.flash_attention_ref(q, k, v, causal, 64, 64)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)
