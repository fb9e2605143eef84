"""The tile SDDMM (repro_torch masked_matmul) against the reference's
masked_matmul_kernel in interpret mode, over the reference's own sweep
(tests/test_kernels_masked_matmul.py): four shapes x blocks 8/16 x f32/bf16.

On the CPU the port's wrapper runs its plain version.  Tolerances are the
reference's: 1e-5 for f32 and 2e-2 for bf16 (both sides accumulate in f32;
bf16 operands are exact in f32, so only the summation order differs).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.masked_matmul.kernel import (
    masked_matmul_kernel as ref_kernel)
from repro.kernels.masked_matmul.ref import masked_matmul_ref as ref_oracle
from repro_torch.kernels.masked_matmul import kernel as K
from repro_torch.kernels.masked_matmul.ops import masked_matmul
from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref

SHAPES = [(16, 16, 16), (32, 48, 64), (64, 32, 16), (128, 128, 128)]
BLOCKS = [(8, 8, 8), (16, 16, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def random_block_mask(rng, mb, nb, density):
    ok = rng.random((mb, nb)) < density
    if not ok.any():
        ok[0, 0] = True
    bi, bj = np.nonzero(ok)
    return bi.astype(np.int32), bj.astype(np.int32)


def operands(shape, blocks, jdt, seed=42):
    """The reference test's draw: a, b as JAX arrays of ``jdt`` and the
    coordinates of a 0.4-dense tile mask."""
    M, K_, N = shape
    bm, bk, bn = blocks
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((M, K_)), jdt)
    b = jnp.asarray(rng.standard_normal((K_, N)), jdt)
    bi, bj = random_block_mask(rng, M // bm, N // bn, 0.4)
    return a, b, bi, bj


def divisible(shape, blocks):
    (M, K_, N), (bm, bk, bn) = shape, blocks
    return not (M % bm or K_ % bk or N % bn)


CASES = [pytest.param(s, b, d, id=f"{s}-{b[0]}-{d}")
         for s in SHAPES for b in BLOCKS for d in DTYPES if divisible(s, b)]


@pytest.mark.parametrize("shape,blocks,dtype", CASES)
def test_masked_matmul_matches_reference_kernel(shape, blocks, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    bm, bk, bn = blocks
    a, b, bi, bj = operands(shape, blocks, jdt)
    want = np.asarray(ref_kernel(a, b, jnp.asarray(bi), jnp.asarray(bj),
                                 bm=bm, bn=bn, bk=bk, interpret=True),
                      np.float32)
    ta = torch.as_tensor(np.array(a, np.float32)).to(tdt)
    tb = torch.as_tensor(np.array(b, np.float32)).to(tdt)
    got = masked_matmul(ta, tb, torch.as_tensor(bi), torch.as_tensor(bj),
                        bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.float32 and got.shape == (len(bi), bm, bn)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the port's dense oracle agrees with the reference's oracle
    oracle = ref_oracle(a, b, bi, bj, bm=bm, bn=bn)
    np.testing.assert_allclose(
        masked_matmul_ref(ta, tb, bi, bj, bm=bm, bn=bn).numpy(),
        np.asarray(oracle, np.float32), rtol=tol, atol=tol)


def test_plain_is_exact_on_integers_and_counts_no_launch():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.integers(-4, 5, (64, 48)).astype(np.float32))
    b = torch.as_tensor(rng.integers(-4, 5, (48, 32)).astype(np.float32))
    bi, bj = (torch.as_tensor(x) for x in random_block_mask(rng, 4, 2, 0.6))
    before = K.MASKED_MATMUL_LAUNCHES
    got = K.masked_matmul_kernel(a, b, bi, bj, bm=16, bn=16, bk=16)
    assert K.MASKED_MATMUL_LAUNCHES == before
    want = (a @ b).reshape(4, 16, 2, 16).permute(0, 2, 1, 3)[bi.long(),
                                                             bj.long()]
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["indivisible", "dtype", "index_dtype"])
def test_wrapper_rejects_bad_operands(bad):
    a, b = torch.zeros(32, 32), torch.zeros(32, 32)
    bi = bj = torch.zeros(2, dtype=torch.int32)
    kw = dict(bm=8, bn=8, bk=8)
    if bad == "indivisible":
        kw["bm"] = 12
    elif bad == "dtype":
        b = b.double()
    else:
        bi = bi.long()
    with pytest.raises(ValueError):
        masked_matmul(a, b, bi, bj, **kw)
