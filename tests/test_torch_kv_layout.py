"""The port's KV cache and pool are head-major ([L, B, KV, S, hd] and
[L, nb, KV, bs, hd]), so the GQA products of decode, verify and paged
attention are strided ``bmm`` calls over the cache as it lies.

In the reference's position-major layout ``torch.einsum`` could not
merge (B, KV) into one batch dimension and copied each layer's whole
cache before its ``bmm`` (32 MiB a product at Llama-3-8B's decode
shape). These tests profile one call of each path on the CPU at a small
GQA shape and fail on any ``aten::copy_`` / ``aten::clone`` as large as
one layer's cache. Numerics against the reference are held by
tests/test_torch_{llama,paged,kv_quant,spec}.py.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from edl_tpu_torch.models import llama as tl

CFG = tl.LlamaConfig.tiny()  # H4 KV2 (two query heads a group), hd 16
L, KV, HD = CFG.n_layers, CFG.n_kv_heads, CFG.head_dim
B, S = 3, 512
BS, M = 32, 16  # paged: 16 blocks of 32 a row = S positions
NB = B * M + 1
PARAMS = tl.init_params(CFG, seed=0, device="cpu")
LAYER_ELEMS = B * KV * S * HD  # one layer's K (or V) cache


def _copies(fn):
    """(op name, input shape) of every copy/clone in one call of ``fn``
    at least one layer's cache in size."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    big = []
    for ev in p.events():
        if ev.name not in ("aten::copy_", "aten::clone"):
            continue
        shape = ev.input_shapes[0] if ev.input_shapes else []
        if shape and int(np.prod(shape)) >= LAYER_ELEMS:
            big.append((ev.name, tuple(shape)))
    return big


def _cache():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(L, B, KV, S, HD, generator=g) for _ in range(2)]


def _pool():
    g = torch.Generator().manual_seed(1)
    return [torch.randn(L, NB, KV, BS, HD, generator=g) for _ in range(2)]


def _table():
    return torch.arange(1, NB).reshape(B, M)


def _decode():
    kc, vc = _cache()
    tok = torch.tensor([5, 17, 200])
    pos = torch.tensor([4, 300, S - 1])
    return lambda: tl.decode_step_slots(PARAMS, tok, pos, kc, vc, CFG)


def _verify():
    kc, vc = _cache()
    z = torch.zeros(B, dtype=torch.long)
    draft = torch.tensor([[1, 2, 3]] * B)
    pos = torch.tensor([4, 300, S - 2])
    return lambda: tl.verify_step_slots(
        PARAMS, z, draft, pos, torch.ones(B, dtype=torch.bool), z + 8,
        z - 1, kc, vc, CFG)


def _paged_attend():
    kc, vc = _pool()
    q = torch.randn(B, 1, CFG.n_heads, HD)
    pos = torch.tensor([4, 300, S - 1])
    qmask = (torch.arange(S)[None, :] <= pos[:, None])[:, None, None, None]
    table = _table()
    rows = tl._pool_rows(table, KV)
    return lambda: tl._paged_attend(CFG, q, kc, vc, 0, table, rows, qmask,
                                    BS, "off", None, None)


def _paged_decode():
    kc, vc = _pool()
    tok = torch.tensor([5, 17, 200])
    pos = torch.tensor([4, 300, S - 1])
    return lambda: tl.decode_step_slots_paged(PARAMS, tok, pos, _table(), kc,
                                              vc, CFG, BS)


@pytest.mark.parametrize("path", [_decode, _verify, _paged_attend,
                                  _paged_decode],
                         ids=["decode_step_slots", "verify_step_slots",
                              "_paged_attend", "decode_step_slots_paged"])
def test_attention_copies_no_cache_sized_tensor(path):
    fn = path()
    fn()  # first call outside the profile
    assert _copies(fn) == []


def test_head_major_products_equal_the_reference_einsum():
    """The strided products give the reference's einsum over the
    position-major cache within 1e-6 in f32 on one layer."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(B, 2, CFG.n_heads, HD, generator=g)
    k, v = (torch.randn(B, S, KV, HD, generator=g) for _ in range(2))
    pos = torch.tensor([[4, 5], [300, 301], [S - 2, S - 1]])
    mask = (torch.arange(S)[None, None, :] <= pos[:, :, None])[:, None, None]
    got = tl._gqa_attend(CFG, q, k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous(), mask)
    qg = q.reshape(B, 2, KV, CFG.n_heads // KV, HD)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).float() / HD ** 0.5
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    want = torch.einsum("bkgts,bskd->btkgd", probs, v).reshape(B, 2, -1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
