"""Block-masked flash attention (repro_torch.kernels.flash_mask) against
the reference's flash_mask_kernel in interpret mode, over the reference's
own sweep (tests/test_kernels_flash_mask.py): the worklist, four mask
patterns x three shapes x f32/bf16, the decode offset, the batched GQA op
and the element mask.

On the CPU the port's wrapper runs its plain version.  Tolerances are the
reference's: 2e-5 for f32 and 3e-2 for bf16 (the same online softmax in f32
on both sides; only summation orders and the bf16 rounding of the output
differ).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_mask import ops as ref_ops
from repro.kernels.flash_mask.kernel import (
    build_schedule as ref_build_schedule, flash_mask_kernel as ref_kernel)
from repro.kernels.flash_mask.ref import (
    flash_mask_ref as ref_oracle, mask_allowed as ref_mask_allowed)
from repro_torch import caches
from repro_torch.kernels.flash_mask import kernel as K
from repro_torch.kernels.flash_mask.kernel import build_schedule
from repro_torch.kernels.flash_mask.ops import flash_mask_attention
from repro_torch.kernels.flash_mask.ref import flash_mask_ref, mask_allowed

PATTERNS = [
    dict(causal=True, window=0, prefix=0),            # causal (LM)
    dict(causal=True, window=16, prefix=0),           # sliding window
    dict(causal=True, window=16, prefix=8),           # window + global prefix
    dict(causal=False, window=0, prefix=0),           # dense (encoder/cross)
]
PATTERN_IDS = ["causal", "window", "window+prefix", "dense"]
SHAPES = [(32, 32, 8, 8), (64, 64, 16, 16), (32, 64, 8, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def mk(rng, s, d, jdt):
    return jnp.asarray(rng.standard_normal((s, d)) * 0.5, jdt)


def to_torch(x, tdt):
    return torch.as_tensor(np.array(x, np.float32)).to(tdt)


def sched_tensors(*arrays):
    return [torch.as_tensor(np.array(x)) for x in arrays]


@pytest.mark.parametrize("pattern", PATTERNS, ids=PATTERN_IDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_build_schedule_equals_reference(pattern, shape):
    s_q, s_k, bq, bk = shape
    for q_off in (0, s_k - s_q, 40):
        got = build_schedule(s_q, s_k, bq=bq, bk=bk, q_offset=q_off,
                             **pattern)
        want = ref_build_schedule(s_q, s_k, bq=bq, bk=bk, q_offset=q_off,
                                  **pattern)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("pattern", PATTERNS, ids=PATTERN_IDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_matches_reference_kernel(pattern, shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    s_q, s_k, bq, bk = shape
    d = 16
    rng = np.random.default_rng(11)
    q, k, v = mk(rng, s_q, d, jdt), mk(rng, s_k, d, jdt), mk(rng, s_k, d, jdt)
    q_off = s_k - s_q
    qi, ki, flags = ref_build_schedule(s_q, s_k, bq=bq, bk=bk,
                                       q_offset=q_off, **pattern)
    want = ref_kernel(q, k, v, jnp.asarray(qi), jnp.asarray(ki),
                      jnp.asarray(flags), bq=bq, bk=bk, scale=d ** -0.5,
                      q_offset=q_off, interpret=True, **pattern)
    before = K.LAUNCHES
    got = K.flash_mask_kernel(*(to_torch(x, tdt)[None, None]
                                for x in (q, k, v)),
                              *sched_tensors(qi, ki, flags),
                              bq=bq, bk=bk, scale=d ** -0.5, q_offset=q_off,
                              **pattern)[0, 0]
    assert K.LAUNCHES == before          # the CPU runs the plain version
    assert got.dtype == tdt and got.shape == (s_q, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    # the port's dense oracle against the reference's
    np.testing.assert_allclose(
        flash_mask_ref(to_torch(q, tdt), to_torch(k, tdt), to_torch(v, tdt),
                       q_offset=q_off, **pattern).numpy(),
        np.asarray(ref_oracle(q, k, v, q_offset=q_off, **pattern)),
        rtol=2e-5, atol=2e-5)


def test_decode_offset():
    """Decode: 8 new queries attending over a 64-token history."""
    rng = np.random.default_rng(9)
    d = 16
    q, k, v = (mk(rng, s, d, jnp.float32) for s in (8, 64, 64))
    qi, ki, flags = ref_build_schedule(8, 64, bq=8, bk=8, causal=True,
                                       window=0, prefix=0, q_offset=56)
    want = ref_kernel(q, k, v, jnp.asarray(qi), jnp.asarray(ki),
                      jnp.asarray(flags), bq=8, bk=8, scale=d ** -0.5,
                      causal=True, window=0, prefix=0, q_offset=56,
                      interpret=True)
    got = K.flash_mask_kernel(*(to_torch(x, torch.float32)[None, None]
                                for x in (q, k, v)),
                              *sched_tensors(qi, ki, flags), bq=8, bk=8,
                              scale=d ** -0.5, causal=True, window=0,
                              prefix=0, q_offset=56)[0, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_gqa_batched_op_matches_reference_op():
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d = 2, 4, 2, 32, 16
    q = (rng.standard_normal((b, hq, s, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    ref_ops._sched.cache_clear()         # it caches arrays made under jit
    want = np.asarray(ref_ops.flash_mask_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, bq=8,
        bk=8, interpret=True))
    got = flash_mask_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=True, bq=8, bk=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # query head h reads kv head h // (hq // hkv)
    for bi in range(b):
        for h in range(hq):
            one = flash_mask_ref(torch.as_tensor(q[bi, h]),
                                 torch.as_tensor(k[bi, h // 2]),
                                 torch.as_tensor(v[bi, h // 2]), causal=True)
            np.testing.assert_allclose(got[bi, h].numpy(), one.numpy(),
                                       rtol=2e-5, atol=2e-5)
    assert caches.cache_info()["flash-sched"]["size"] >= 1


def test_mask_allowed_equals_reference():
    for kw in (dict(causal=True, window=3, prefix=2, q_offset=4),
               dict(causal=False, window=5, prefix=0, q_offset=0),
               dict(causal=True, window=0, prefix=3, q_offset=1)):
        np.testing.assert_array_equal(mask_allowed(4, 8, **kw),
                                      ref_mask_allowed(4, 8, **kw))
    ok = mask_allowed(4, 8, causal=True, window=3, prefix=2, q_offset=4)
    for qq in range(4):
        for kk in range(8):
            want = (kk <= qq + 4) and ((qq + 4 - kk) < 3 or kk < 2)
            assert ok[qq, kk] == want


@pytest.mark.parametrize("bad", ["indivisible", "heads", "block"])
def test_wrapper_rejects_bad_shapes(bad):
    q = torch.zeros(1, 4, 32, 16)
    kv = torch.zeros(1, 2, 32, 16)
    kw = dict(bq=8, bk=8)
    if bad == "indivisible":
        q = torch.zeros(1, 4, 36, 16)
    elif bad == "heads":
        kv = torch.zeros(1, 3, 32, 16)
    else:
        kw = dict(bq=256, bk=256)
        q, kv = torch.zeros(1, 4, 512, 16), torch.zeros(1, 2, 512, 16)
    with pytest.raises(ValueError):
        flash_mask_attention(q, kv, kv, causal=True, **kw)


def test_wrapper_takes_the_heads_layout_only():
    """The wrapper takes (B, H, S, D); single-head callers add the axes."""
    x = torch.zeros(32, 16)
    qi, ki, flags = (torch.as_tensor(a) for a in build_schedule(
        32, 32, bq=8, bk=8, causal=True, window=0, prefix=0, q_offset=0))
    with pytest.raises(ValueError):
        K.flash_mask_kernel(x, x, x, qi, ki, flags, bq=8, bk=8, scale=0.25,
                            causal=True, window=0, prefix=0, q_offset=0)
    out = K.flash_mask_kernel(x[None, None], x[None, None], x[None, None],
                              qi, ki, flags, bq=8, bk=8, scale=0.25,
                              causal=True, window=0, prefix=0, q_offset=0)
    assert out.shape == (1, 1, 32, 16)
