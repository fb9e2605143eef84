"""The tensor-core kernels' precision schemes, emulated on the CPU.

The SDDMM and block-product kernels compute f32 products as 3xTF32
(``cvt.rna.tf32.f32`` splits each operand into hi + lo and three tf32 mma
passes accumulate in f32), the block product counts structure over 0/1
patterns in one bf16 pass, the bf16 flash kernel computes p.v with p
split into two bf16 terms, and the f32 flash kernel computes q.k^T and p.v
in 3xTF32.  The mma's f32 accumulation truncates (rounds toward zero) instead
of rounding to nearest, as measured on NVIDIA tensor cores (Fasi, Higham,
Mikaitis and Pranesh, "Numerical behavior of NVIDIA tensor cores", 2021);
on an NVIDIA H100 80GB HBM3 at 700 W the SDDMM that accumulated all its
mma in one accumulator read 1.8e-6 normwise from IEEE f32.  So the kernel
starts each k-step of 8 from zero and adds it to its f32 accumulator with
IEEE rounding (3.2e-7 on that card).  The card's own checks hold these
schemes to limits that one tensor-core pass would miss: the SDDMM at
K = 256 to 2e-6 normwise, the full-width flash layer to 2e-3 normwise,
the f32 flash instance to rtol = atol = 2e-5 of its plain version.
These tests emulate both schemes bit for bit where the hardware is
specified (tf32 and bf16 rounding, exact products), each mma's sum
truncated to f32, on seeded inputs, and show that each limit holds with
margin for the kernel's scheme and fails for the single-pass one.
"""
import numpy as np
import pytest
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding to nearest with
    ties away from zero (on the magnitude bits of the f32 pattern)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounding toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def mma_sum(terms, k, step=8, flush=True):
    """sum_i A_i @ B_i as tf32 mma run it: per k-step of ``step``, one mma
    per term in order, each adding its exact products to the accumulator
    and truncating to f32.  ``flush``: each k-step starts from zero and is
    added to an f32 accumulator with round-to-nearest (the kernel's
    scheme); else every mma accumulates into one accumulator."""
    acc = None
    for k0 in range(0, k, step):
        d = None if flush else acc
        for a, b in terms:
            ks = slice(k0, k0 + step)
            p = a[..., ks].double() @ b[..., ks, :].double()
            d = f32_toward_zero(p if d is None else d.double() + p)
        acc = (d if acc is None or not flush
               else (acc.double() + d.double()).float())
    return acc


def sddmm_tiles(seed, ints=False, tiles=16, bs=128, k=256):
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-4, 5, s)) if ints
            else rng.standard_normal)
    a = torch.as_tensor(draw((tiles, bs, k)), dtype=torch.float32)
    b = torch.as_tensor(draw((tiles, k, bs)), dtype=torch.float32)
    return a, b


def three_tf32(a, b, flush=True):
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return mma_sum([(al, bh), (ah, bl), (ah, bh)], a.shape[-1], flush=flush)


def one_tf32(a, b):
    return mma_sum([(tf32_rna(a), tf32_rna(b))], a.shape[-1])


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # a tie rounds away
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # below the tie
    (3.0, 3.0), (2047.0, 2047.0), (0.0, 0.0)])
def test_tf32_rounding_is_cvt_rna(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want
    assert int(got.view(torch.int32)) & 0x1FFF == 0


@pytest.mark.parametrize("split, bits", [("tf32", 21), ("bf16", 16)])
def test_two_term_splits_keep_the_value(split, bits):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(1 << 16), dtype=torch.float32)
    if split == "tf32":
        hi, lo = split_tf32(x)
    else:
        hi = bf16(x)
        lo = bf16(x - hi)
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0 ** -bits).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_sddmm_keeps_f32_accuracy(seed):
    a, b = sddmm_tiles(seed)
    want = a.double() @ b.double()
    got = three_tf32(a, b).double()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 2e-6 / 5           # the card's limit, with margin
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the card holds elementwise errors to 1e-5 of sum_k |a b|
    scale = a.abs().double() @ b.abs().double()
    assert float(((got - want).abs() / scale).max()) <= 1e-5 / 10


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulating_in_the_mma_loses_f32_accuracy(seed):
    """Without the per-k-step flush, 96 truncating mma per output drift an
    order of magnitude past the flushed scheme."""
    a, b = sddmm_tiles(seed)
    want = a.double() @ b.double()
    flushed = float((three_tf32(a, b).double() - want).norm() / want.norm())
    drifted = float((three_tf32(a, b, flush=False).double() - want).norm()
                    / want.norm())
    assert drifted > 5 * flushed


@pytest.mark.parametrize("seed", [0, 1])
def test_1xtf32_sddmm_misses_the_limit(seed):
    a, b = sddmm_tiles(seed)
    want = a.double() @ b.double()
    got = one_tf32(a, b).double()
    assert float((got - want).norm() / want.norm()) > 2e-6 * 10


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_is_exact_on_small_integers(seed):
    a, b = sddmm_tiles(seed, ints=True)
    assert not split_tf32(a)[1].any() and not split_tf32(b)[1].any()
    assert torch.equal(three_tf32(a, b), torch.bmm(a, b))


def flash_emulated(q, k, v, scheme, blk=128):
    """Causal block flash attention with the reference's arithmetic (scores
    and online softmax per tile).  For the bf16 layer, f32 scores and p.v
    taken as ``scheme``: "f32" (the reference), "split" (p = hi + lo in
    bf16, the kernel's) or "single" (bf16(p)), the output rounded to bf16.
    For the f32 instance, both products as ``scheme``: "3xtf32" (the
    kernel's: three tf32 mma per k-step of 8, each k-step added with IEEE
    rounding), "1xtf32" (one tf32 pass) or "f64" (float64 throughout, the
    exact value); these outputs are not rounded."""
    def product(a, b):
        if scheme == "3xtf32":
            return three_tf32(a, b)
        if scheme == "1xtf32":
            return one_tf32(a, b)
        return a @ b

    if scheme == "f64":
        q, k, v = q.double(), k.double(), v.double()
    s_len, d = q.shape[-2:]
    out = torch.empty_like(q)
    cols = torch.arange(blk)[None, :]
    for qb in range(s_len // blk):
        qs = q[..., qb * blk:(qb + 1) * blk, :]
        m = torch.full(qs.shape[:-1] + (1,), -1e30, dtype=q.dtype)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qs)
        rows = torch.arange(blk)[:, None] + qb * blk
        for kb in range(qb + 1):
            ks = k[..., kb * blk:(kb + 1) * blk, :]
            vs = v[..., kb * blk:(kb + 1) * blk, :]
            s = product(qs, ks.transpose(-1, -2)) * d ** -0.5
            ok = cols + kb * blk <= rows
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            if scheme == "split":
                hi = bf16(p)
                pv = bf16(p - hi) @ vs + hi @ vs
            elif scheme == "single":
                pv = bf16(p) @ vs
            else:
                pv = product(p, vs)
            acc = acc * alpha + pv
            m = m_new
        out[..., qb * blk:(qb + 1) * blk, :] = acc / l
    return out if scheme in ("3xtf32", "1xtf32", "f64") else bf16(out)


@pytest.fixture(scope="module", params=[(1, 0), (2, 1)],
                ids=["1-head", "2-heads"])
def flash_case(request):
    """The full-width layer's shape per head (S 2048, D 64, causal, bf16
    q, k, v of 0.5 randn) and the reference's output."""
    heads, seed = request.param
    rng = np.random.default_rng(seed)
    q, k, v = (bf16(torch.as_tensor(rng.standard_normal((heads, 2048, 64))
                                    * 0.5, dtype=torch.float32))
               for _ in range(3))
    return q, k, v, flash_emulated(q, k, v, "f32")


def test_split_p_flash_stays_under_the_layer_limit(flash_case):
    q, k, v, want = flash_case
    got = flash_emulated(q, k, v, "split")
    assert float((got - want).norm() / want.norm()) <= 2e-3 / 10


def test_single_term_p_flash_misses_the_layer_limit(flash_case):
    q, k, v, want = flash_case
    got = flash_emulated(q, k, v, "single")
    assert float((got - want).norm() / want.norm()) > 2e-3


def block_worklist(seed, ints=False, outs=4, pairs=6, bs=128):
    """The block product's K stream as the kernel sees it: for each output
    block, the concatenation of its worklist pairs' A rows (outs, bs,
    pairs * bs) and B columns (outs, pairs * bs, bs), the tile-8192 main
    path's shape (bs 128, about 6 pairs per output)."""
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(1, 5, s)) if ints
            else rng.standard_normal)
    a = torch.as_tensor(draw((outs, bs, pairs * bs)), dtype=torch.float32)
    b = torch.as_tensor(draw((outs, pairs * bs, bs)), dtype=torch.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_block_replay_keeps_f32_accuracy(seed):
    """3xTF32 with truncating mma sums and IEEE k-step adds over a
    worklist of 6 pairs (K = 768) stays within the card's 2e-6 normwise
    of float64, with margin."""
    a, b = block_worklist(seed)
    want = a.double() @ b.double()
    got = three_tf32(a, b).double()
    assert float((got - want).norm() / want.norm()) <= 2e-6 / 5


@pytest.mark.parametrize("seed", [0, 1])
def test_1xtf32_block_replay_misses_the_limit(seed):
    a, b = block_worklist(seed)
    want = a.double() @ b.double()
    got = one_tf32(a, b).double()
    assert float((got - want).norm() / want.norm()) > 2e-6 * 10


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_block_replay_is_exact_on_integers(seed):
    """The tile route's integer data (values 1..4): every partial sum is
    an integer below 2^24, so the kernel's values equal the exact
    product."""
    a, b = block_worklist(seed, ints=True)
    assert torch.equal(three_tf32(a, b).double(), a.double() @ b.double())


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_pattern_counts_are_exact(seed):
    """0/1 patterns in one bf16 pass, every m16n8k16 mma adding into the
    accumulator with truncation (no k-step flush), count exactly."""
    rng = np.random.default_rng(seed)
    a, b = (torch.as_tensor(rng.random(shape) < 0.7, dtype=torch.float32)
            for shape in ((4, 128, 6 * 128), (4, 6 * 128, 128)))
    got = mma_sum([(bf16(a), bf16(b))], a.shape[-1], step=16, flush=False)
    assert torch.equal(got.double(), a.double() @ b.double())


@pytest.fixture(scope="module", params=[(1, 0), (2, 1)],
                ids=["1-head", "2-heads"])
def f32_flash_case(request):
    """The f32 instance's inputs per head (S 1024, D 64, causal, f32 q, k,
    v of 0.5 randn, not rounded to any shorter type) and the exact output
    (float64)."""
    heads, seed = request.param
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((heads, 1024, 64)) * 0.5,
                               dtype=torch.float32) for _ in range(3))
    return q, k, v, flash_emulated(q, k, v, "f64")


def test_3xtf32_flash_stays_under_the_f32_limit(f32_flash_case):
    """3xTF32 q.k^T and p.v with IEEE k-step adds hold the f32 sweep's
    rtol = atol = 2e-5 against the exact output ten times over."""
    q, k, v, want = f32_flash_case
    got = flash_emulated(q, k, v, "3xtf32").double()
    assert torch.allclose(got, want, rtol=2e-5 / 10, atol=2e-5 / 10)
    assert float((got - want).norm() / want.norm()) <= 1e-6


def test_1xtf32_flash_misses_the_f32_limit(f32_flash_case):
    """One tf32 pass for each product misses the sweep's 2e-5 and 1e-4
    normwise."""
    q, k, v, want = f32_flash_case
    got = flash_emulated(q, k, v, "1xtf32").double()
    assert not torch.allclose(got, want, rtol=2e-5, atol=2e-5)
    assert float((got - want).norm() / want.norm()) > 1e-4
