"""``block_masked`` attention of the port against the reference: the host
schedule (``_balanced_schedule``) array for array, and the execution over
masks with causality, windows, prefixes, query offsets, an odd number of
q-blocks and s_q != s_k, with GQA, both dense fallbacks and bf16.

Tolerances: the schedule is exact (``array_equal``); f32 outputs 1e-5
(rtol and atol: the same f32 arithmetic in another summation order); bf16
4e-2, as ``tests/test_torch_models.py`` holds bf16 (``p`` is rounded to
bf16 before ``p.v`` on both sides, and the two frameworks round the
products' inputs at other places).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.models import attention as RA
from repro_torch import caches
from repro_torch.models import attention as A

F32_TOL = 1e-5
BF16_TOL = 4e-2

#: (s_q, s_k, bq, bk, causal, window, prefix, q_offset)
GRID = {
    "causal": (64, 64, 16, 16, True, 0, 0, 0),
    "window": (64, 64, 16, 16, True, 24, 0, 0),
    "prefix-lm": (64, 64, 16, 16, True, 0, 16, 0),
    "prefix-unaligned": (64, 64, 16, 16, True, 0, 24, 0),
    "window-prefix": (64, 64, 16, 16, True, 24, 16, 0),
    "odd-nq": (48, 48, 16, 16, True, 0, 0, 0),
    "odd-nq-window": (80, 80, 16, 16, True, 20, 0, 0),
    "q-offset": (32, 64, 16, 16, True, 0, 0, 32),
    "sq-ne-sk-blocks": (48, 96, 16, 32, True, 16, 0, 48),
    "bidirectional-window": (80, 80, 16, 16, False, 32, 0, 0),
    "bidirectional-window-prefix": (64, 64, 16, 16, False, 24, 16, 0),
}


@pytest.mark.parametrize("case", list(GRID))
def test_schedule_equals_reference(case):
    want = RA._balanced_schedule(*GRID[case])
    got = A._balanced_schedule(*GRID[case])
    assert len(got) == len(want) == 6
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]


def qkv(seed, s_q, s_k, hq=4, hkv=2, d=8, dv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, s_q, d))
    k = rng.standard_normal((2, hkv, s_k, d))
    v = rng.standard_normal((2, hkv, s_k, dv or d))
    return [x.astype(dtype) for x in (q, k, v)]


def ref_attention(q, k, v, **kw):
    return np.asarray(RA.attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   impl="block_masked", **kw)
                      .astype(jnp.float32))


def port_attention(q, k, v, dtype=torch.float32, **kw):
    return A.attention(*(torch.as_tensor(x).to(dtype) for x in (q, k, v)),
                       impl="block_masked", **kw)


@pytest.mark.parametrize("case", list(GRID))
def test_block_masked_matches_reference_f32(case):
    s_q, s_k, bq, bk, causal, window, prefix, q_offset = GRID[case]
    q, k, v = qkv(1, s_q, s_k)
    kw = dict(causal=causal, window=window, prefix=prefix,
              q_offset=q_offset)
    want = np.asarray(RA.block_masked_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bq=bq, bk=bk, **kw))
    calls, falls = A.BLOCK_MASKED_CALLS, A.BLOCK_MASKED_FALLBACKS
    got = A.block_masked_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                   bq=bq, bk=bk, **kw)
    assert (A.BLOCK_MASKED_CALLS - calls, A.BLOCK_MASKED_FALLBACKS - falls) \
        == (1, 0)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    dense = A.dense_masked_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                     **kw).numpy()
    if causal:
        # the element mask is the dense path's: block_masked = dense_masked
        np.testing.assert_allclose(got.numpy(), dense, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        # a bidirectional window: the schedule drops kv tiles past
        # q + window, which the element mask (one-sided, q - k < window)
        # admits; the reference's two impls differ the same way
        ref_dense = np.asarray(RA.dense_masked_attention(
            *(jnp.asarray(x) for x in (q, k, v)), **kw))
        np.testing.assert_allclose(dense, ref_dense, rtol=F32_TOL,
                                   atol=F32_TOL)
        assert not np.allclose(got.numpy(), dense, rtol=F32_TOL, atol=F32_TOL)
        assert not np.allclose(want, ref_dense, rtol=F32_TOL, atol=F32_TOL)


def test_block_masked_gqa_and_head_dims_match_reference():
    """8 query heads on 2 kv heads, and a v head dim other than q.k's (MLA's
    shape), with an explicit scale."""
    q, k, v = qkv(2, 64, 64, hq=8, hkv=2, d=12, dv=8)
    kw = dict(causal=True, window=0, prefix=0, q_offset=0, scale=0.3,
              block=16)
    want = ref_attention(q, k, v, **kw)
    got = port_attention(q, k, v, **kw)
    assert got.shape == (2, 8, 64, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("what", ["not-block-multiples", "dense-mask"])
def test_dense_fallbacks_match_reference(what):
    if what == "not-block-multiples":
        q, k, v = qkv(3, 40, 40)
        kw = dict(causal=True, window=0, prefix=0, block=16)
    else:
        q, k, v = qkv(3, 64, 64)
        kw = dict(causal=False, window=0, prefix=16, block=16)
    want = ref_attention(q, k, v, **kw)
    calls, falls = A.BLOCK_MASKED_CALLS, A.BLOCK_MASKED_FALLBACKS
    got = port_attention(q, k, v, **kw)
    assert (A.BLOCK_MASKED_CALLS - calls, A.BLOCK_MASKED_FALLBACKS - falls) \
        == (0, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", ["causal", "window-prefix", "q-offset"])
def test_block_masked_bf16_matches_reference(case):
    s_q, s_k, bq, _, causal, window, prefix, q_offset = GRID[case]
    q, k, v = qkv(4, s_q, s_k)
    kw = dict(causal=causal, window=window, prefix=prefix,
              q_offset=q_offset, block=bq)
    want = np.asarray(RA.attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        impl="block_masked", **kw).astype(jnp.float32))
    got = port_attention(q, k, v, dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_starcoder_window_schedule_saves_tiles():
    """The reference's property, on the port's schedule: a 128 window over
    512 tokens in 64-blocks visits fewer than half the dense grid's tiles."""
    _, _, kv, _, valid, _ = A._balanced_schedule(512, 512, 64, 64, True, 128,
                                                 0, 0)
    assert valid.sum() < (512 // 64) ** 2 / 2


def test_decode_attention_ignores_window_and_prefix():
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.standard_normal((2, 4, 8)), dtype=torch.float32)
    kc, vc = (torch.as_tensor(rng.standard_normal((2, 2, 16, 8)),
                              dtype=torch.float32) for _ in range(2))
    lens = torch.tensor([5, 16])
    plain = A.decode_attention(q, kc, vc, lens)
    assert torch.equal(A.decode_attention(q, kc, vc, lens, window=4,
                                          prefix=2), plain)
    want = RA.decode_attention(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
                               jnp.asarray(vc.numpy()),
                               jnp.asarray(lens.numpy()), window=4, prefix=2)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_schedule_cache_is_registered():
    info = caches.cache_info()
    assert info["attention-block-schedule"]["capacity"] == \
        caches.env_capacity("REPRO_ATTN_SCHED_CAP", 256)
    A._balanced_schedule(256, 256, 128, 128, True, 0, 0, 0)
    assert caches.cache_info()["attention-block-schedule"]["size"] >= 1
    first = A._balanced_schedule(256, 256, 128, 128, True, 0, 0, 0)
    assert A._balanced_schedule(256, 256, 128, 128, True, 0, 0, 0) is first
    caches.clear_all()
    assert caches.cache_info()["attention-block-schedule"]["size"] == 0
