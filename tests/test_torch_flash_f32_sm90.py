"""The Hopper f32 flash kernel's dispatch and numerics, on the CPU.

``flash.sm90_takes`` sends an f32 flash launch to
``csrc/flash_mask_f32_sm90.cu`` (TMA + mbarriers, tf32 ``wgmma``) with q and
kv blocks of 64 or 128 and a head dim of 64, 112 or 128, contiguous and
16-byte aligned; every other f32 shape stays on flash_mask.cu's ``mma.sync``
kernel, ``variant="sm90"`` on such a shape raises and ``"mma_sync"`` forces
the old kernel.  On the CPU the wrapper runs the plain version and counts no
launch, whatever the variant.

The kernel computes both products in 3xTF32 on wgmma, whose f32 sums
truncate (tests/test_torch_tc_numerics.py): q.k^T sums FLUSH_QK k8 steps
(three wgmma each) in a partial added to the scores with IEEE rounding,
p.v sums FLUSH_PV k8 steps of keys (chunks of KC = 64 keys at D 64) in a
partial added with IEEE rounding to O after O = O * alpha.  With RAW_HI
the hi of each split is the raw f32 word, which tf32 wgmma reads truncated
to tf32, and lo = rna(x - trunc(x)).  ``kernel_scheme`` emulates that,
with the intervals, the chunk and the hi scheme read from the source, at
S 256, D 64, causal, against float64: within 2e-6 / 5
normwise and 2e-5 / 10 elementwise (the card's gates, with margin), where
O accumulating in the tensor cores across chunks, or one tf32 pass, miss.
No kernel runs here: its agreement with the plain version is in
tests/test_torch_cuda.py and chip_smoke.py phase 9.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_mask import kernel as flash
from test_torch_tc_numerics import f32_toward_zero, tf32_rna
from test_torch_tc_numerics import split_tf32 as split_rna

SOURCE = Path(flash.__file__).parent / "csrc" / "flash_mask_f32_sm90.cu"


def constant(name: str) -> int:
    """A ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text()).group(1))


def raw_hi() -> bool:
    """The source's ``RAW_HI``: the hi of each split is the raw f32 word,
    which tf32 wgmma reads truncated to its upper 19 bits."""
    return re.search(r"constexpr bool RAW_HI = (true|false);",
                     SOURCE.read_text()).group(1) == "true"


def chunk_keys(dp: int) -> int:
    """Keys a chunk at padded head dim ``dp`` (the source's ``Cfg::KC``)."""
    m = re.search(r"KC = DP == 64 \? (\d+) : (\d+);", SOURCE.read_text())
    return int(m.group(1) if dp == 64 else m.group(2))


def operands(d, dtype=torch.float32, s=128, hq=2, hkv=1):
    return (torch.zeros((1, hq, s, d), dtype=dtype),
            torch.zeros((1, hkv, s, d), dtype=dtype),
            torch.zeros((1, hkv, s, d), dtype=dtype))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_f32_hopper_shapes_go_to_sm90(bq, bk, d):
    q, k, v = operands(d)
    assert flash.sm90_takes(q, k, v, bq, bk)
    assert flash.choose_variant(None, q, k, v, bq, bk) == "sm90"
    assert flash.choose_variant("sm90", q, k, v, bq, bk) == "sm90"
    assert flash.choose_variant("mma_sync", q, k, v, bq, bk) == "mma_sync"


@pytest.mark.parametrize("bq,bk,d,why", [
    (8, 8, 16, "the reference sweep's small blocks"),
    (16, 16, 64, "the reduced configs' attn_block 16"),
    (1, 128, 64, "decode at bq = 1"),
    (32, 128, 64, "bq 32"),
    (128, 32, 64, "bk 32"),
    (128, 128, 16, "D 16"),
    (128, 128, 32, "D 32"),
    (128, 128, 96, "D 96"),
    (64, 64, 120, "D 120"),
])
def test_other_f32_shapes_stay_on_mma_sync(bq, bk, d, why):
    q, k, v = operands(d)
    assert not flash.sm90_takes(q, k, v, bq, bk), why
    assert flash.choose_variant(None, q, k, v, bq, bk) == "mma_sync", why
    with pytest.raises(ValueError, match="sm90 flash kernel takes"):
        flash.choose_variant("sm90", q, k, v, bq, bk)


def test_f32_layout_rules():
    """Non-contiguous or misaligned f32 operands keep mma.sync."""
    q, k, v = operands(64)
    qt = torch.zeros((1, 128, 2, 64)).transpose(1, 2)
    assert not qt.is_contiguous()
    assert not flash.sm90_takes(qt, k, v, 128, 128)
    assert flash.sm90_takes(qt.contiguous(), k, v, 128, 128)
    # a contiguous view 4 bytes into its storage is not 16-byte aligned
    flat = torch.zeros(2 * 128 * 64 + 1)
    shifted = flat[1:].view(1, 2, 128, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert not flash.sm90_takes(shifted, k, v, 128, 128)
    assert not flash.sm90_takes(q, k, shifted[:, :1], 128, 128)
    # one variant name for both dtypes
    assert flash.VARIANTS == ("sm90", "mma_sync")
    assert not flash.sm90_takes(q.double(), k.double(), v.double(), 128, 128)


def test_f32_wrapper_on_the_cpu_counts_nothing():
    """The CPU path runs the plain version whatever kernel is asked for,
    refuses what a card would refuse, and counts no launch."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, h, 128, 64)) * 0.5,
                               dtype=torch.float32) for h in (2, 1, 1))
    wl = [torch.as_tensor(x) for x in flash.build_schedule(
        128, 128, bq=64, bk=64, causal=True, window=0, prefix=0, q_offset=0)]
    kw = dict(scale=0.125, causal=True, window=0, prefix=0, q_offset=0)
    before = (flash.LAUNCHES, flash.TC_LAUNCHES, flash.SM90_LAUNCHES,
              flash.F32_LAUNCHES)
    want = flash.flash_mask_plain(q, k, v, *wl, bq=64, bk=64, **kw)
    for variant in (None, "sm90", "mma_sync"):
        out = flash.flash_mask_kernel(q, k, v, *wl, bq=64, bk=64,
                                      variant=variant, **kw)
        assert out.dtype == torch.float32 and torch.equal(out, want)
    small = [torch.as_tensor(x) for x in flash.build_schedule(
        128, 128, bq=16, bk=16, causal=True, window=0, prefix=0, q_offset=0)]
    with pytest.raises(ValueError, match="sm90 flash kernel takes"):
        flash.flash_mask_kernel(q, k, v, *small, bq=16, bk=16,
                                variant="sm90", **kw)
    assert (flash.LAUNCHES, flash.TC_LAUNCHES, flash.SM90_LAUNCHES,
            flash.F32_LAUNCHES) == before


# ---------------------------------------------------------------------------
# source
# ---------------------------------------------------------------------------


def test_the_source_is_built_and_issues_tf32_wgmma_behind_tma():
    """The kernel is a source of the package's build with its two entry
    points, and it runs tf32 ``wgmma`` on tiles that TMA loads behind
    mbarriers (the primitives of the shared header), with no mma.sync."""
    assert _build.SOURCES["flash_mask_f32_sm90"] == SOURCE
    src = SOURCE.read_text()
    header = (_build.INCLUDE_DIR / "sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in src
    for needle in ('extern "C" int flash_mask_f32_sm90(',
                   'extern "C" int flash_mask_f32_sm90_info(',
                   "__grid_constant__", "setmaxnreg_inc", "setmaxnreg_dec"):
        assert needle in src
    for call in ("wgmma_ss_tf32_n64", "wgmma_ss_tf32_n32",
                 "wgmma_rs_tf32_n64", "wgmma_rs_tf32_n128", "tma_load_2d",
                 "mbar_wait", "mbar_arrive_expect_tx", "fence_proxy_async"):
        assert f"sm90::{call}(" in src
    for ptx in ("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32",
                "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                "cp.async.bulk.tensor.2d", "mbarrier.try_wait",
                "fence.proxy.async.shared::cta", "cuTensorMapEncodeTiled"):
        assert ptx in header
    assert "tc::mma_" not in src and "mma.sync" not in src.split(
        "#include")[1]


def test_flush_intervals_divide_the_steps():
    fqk, fpv, wide = (constant(n) for n in ("FLUSH_QK", "FLUSH_PV",
                                            "FLUSH_PV_WIDE"))
    assert chunk_keys(64) == 64 and chunk_keys(128) == 32
    assert (64 // 8) % fqk == 0 and (128 // 8) % fqk == 0
    assert (chunk_keys(64) // 8) % fpv == 0
    assert (chunk_keys(128) // 8) % wide == 0


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def wgmma_sum(terms, k: int, flush: int, acc=None):
    """acc + sum_i A_i @ B_i as the kernel runs it: per k8 step one
    truncating wgmma per term, in order, into a partial that starts from
    zero every ``flush`` steps and is then added to ``acc`` with
    round-to-nearest (the first partial is ``acc`` when it is None)."""
    part = None
    steps = k // 8
    for s in range(steps):
        ks = slice(8 * s, 8 * s + 8)
        for a, b in terms:
            p = a[..., ks].double() @ b[..., ks, :].double()
            part = f32_toward_zero(p if part is None else part.double() + p)
        if (s + 1) % flush == 0 or s == steps - 1:
            acc = part if acc is None else (acc.double()
                                            + part.double()).float()
            part = None
    return acc


def split_raw(x):
    """The raw-word split as the tensor cores read it: hi = x truncated to
    tf32 (its low 13 bits dropped), lo = rna(x - hi)."""
    hi = (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, tf32_rna(x - hi)


def kernel_scheme(q, k, v, *, fqk: int, fpv: int, chunk: int, raw: bool,
                  blk: int = 128, passes: int = 3, o_in_tensor_cores=False):
    """Causal flash attention as the f32 Hopper kernel computes it: a
    q-block of ``blk`` rows walks its kv chunks of ``chunk`` keys, the
    online softmax per chunk, both products in ``passes`` tf32 passes
    (3: lo.hi, hi.lo, hi.hi; 1: hi.hi) through ``wgmma_sum``, every split
    the raw-word one (``raw``) or the rounded one (``split_rna``).
    ``o_in_tensor_cores``: p.v accumulates onto O * alpha in the tensor
    cores, chunk after chunk, instead of in flushed partials."""
    s_len, d = q.shape[-2:]
    scale = d ** -0.5
    out = torch.empty_like(q)
    split = split_raw if raw else split_rna
    qh, ql = split(q)

    def terms(ah, al, bh, bl):
        return [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]

    for qb in range(s_len // blk):
        rows = slice(qb * blk, (qb + 1) * blk)
        m = torch.full(q.shape[:-2] + (blk, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape[:-2] + (blk, d))
        qg = torch.arange(blk)[:, None] + qb * blk
        for c in range((qb + 1) * blk // chunk):
            keys = slice(c * chunk, (c + 1) * chunk)
            kh, kl = (x.transpose(-1, -2) for x in split(k[..., keys, :]))
            s = wgmma_sum(terms(qh[..., rows, :], ql[..., rows, :], kh, kl),
                          d, fqk) * scale
            ok = torch.arange(chunk)[None, :] + c * chunk <= qg
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = terms(*split(p), *split(v[..., keys, :]))
            acc = acc * alpha
            if o_in_tensor_cores:
                for st in range(chunk // 8):
                    ks = slice(8 * st, 8 * st + 8)
                    for a, b in pv:
                        acc = f32_toward_zero(
                            acc.double()
                            + a[..., ks].double() @ b[..., ks, :].double())
            else:
                acc = wgmma_sum(pv, chunk, fpv, acc=acc)
            m = m_new
        out[..., rows, :] = acc / l
    return out


def exact(q, k, v):
    """Causal softmax attention in float64."""
    q, k, v = q.double(), k.double(), v.double()
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    n = s.shape[-1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                      float("-inf"))
    return torch.softmax(s, -1) @ v


@pytest.fixture(scope="module", params=[(1, 0), (2, 1)],
                ids=["1-head", "2-heads"])
def f32_case(request):
    """S 256, D 64, causal, f32 q, k, v of 0.5 randn (full f32
    precision), and the float64 output."""
    heads, seed = request.param
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((heads, 256, 64)) * 0.5,
                               dtype=torch.float32) for _ in range(3))
    return q, k, v, exact(q, k, v)


def scheme(**kw):
    return dict(fqk=constant("FLUSH_QK"), fpv=constant("FLUSH_PV"),
                chunk=chunk_keys(64), raw=raw_hi(), **kw)


def test_the_kernel_scheme_keeps_f32_accuracy(f32_case):
    """The flushed 3xTF32 scheme, as built, holds the card's 2e-6
    normwise and the sweep's 2e-5 elementwise against float64 with
    margin (5x and 10x)."""
    q, k, v, want = f32_case
    got = kernel_scheme(q, k, v, **scheme()).double()
    assert float((got - want).norm() / want.norm()) <= 2e-6 / 5
    assert torch.allclose(got, want, rtol=2e-5 / 10, atol=2e-5 / 10)


def test_o_in_the_tensor_cores_misses_the_gate(f32_case):
    """Letting O accumulate in the tensor cores across chunks (truncating
    every add) drifts past the same normwise gate."""
    q, k, v, want = f32_case
    got = kernel_scheme(q, k, v, **scheme(o_in_tensor_cores=True)).double()
    assert float((got - want).norm() / want.norm()) > 2e-6 / 5


def test_one_tf32_pass_misses_the_gate(f32_case):
    q, k, v, want = f32_case
    got = kernel_scheme(q, k, v, **scheme(passes=1)).double()
    assert float((got - want).norm() / want.norm()) > 2e-6 * 10
    assert not torch.allclose(got, want, rtol=2e-5, atol=2e-5)
