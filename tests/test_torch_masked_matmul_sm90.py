"""The Hopper tile SDDMM's dispatch and numerics, on the CPU.

``kernel.masked_matmul_sm90_takes`` sends a masked_matmul launch to
``csrc/masked_matmul_sm90.cu`` (TMA + mbarriers, ``wgmma``) at 128 x 128
blocks with f32 or bf16 operands, contiguous, 16-byte aligned, with rows of
a multiple of 16 bytes; every other shape stays on masked_matmul.cu's
``mma.sync`` kernel, ``variant="sm90"`` on such a shape raises,
``"mma_sync"`` forces the old kernel and an unknown variant raises.  On the
CPU the wrapper runs the plain version and counts no launch, whatever the
variant.

The kernel's f32 products are 3xTF32 on tf32 wgmma, whose f32 sums
truncate (tests/test_torch_tc_numerics.py): each consumer sums FLUSH k8
steps (three wgmma each) in a partial from zero and adds it to its f32
accumulator with IEEE rounding; the hi of each operand's split is rna(x),
or with RAW_HI_A / RAW_HI_B the raw f32 word, which tf32 wgmma reads
truncated, and lo = rna(x - hi).  ``kernel_scheme`` emulates that, with
the interval and the hi schemes read from the source, on 4 tiles of
128 x 128 at K = 256 (sddmm-8192's depth): within 2e-6 / 5 normwise of
float64 (the card's gate, with margin) and 1e-5 / 10 of sum_k |a b|
elementwise, exact on integers, where one partial over all of K misses
2e-6 / 5; and at tests/test_torch_cuda.py's 128-block case with K = 384,
which holds every output to rtol = atol = 1e-5 of float64, no output
beyond that, where the raw-word hi (as flash_mask_f32_sm90.cu splits)
flushed once per 32-deep stage leaves 12 (5 on the card).  No kernel runs
here: its agreement with the plain version is in tests/test_torch_cuda.py
and chip_smoke.py phase 8.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_matmul import kernel, ops
from test_torch_tc_numerics import f32_toward_zero, split_tf32

SOURCE = Path(kernel.__file__).parent / "csrc" / "masked_matmul_sm90.cu"
#: the card's normwise gate against float64, with the emulation's margin
GATE = 2e-6 / 5


def constant(name: str) -> int:
    """A ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text()).group(1))


def raw_hi(operand: str) -> bool:
    """The source's ``RAW_HI_A`` or ``RAW_HI_B``: the hi of that operand's
    split is the raw f32 word, which tf32 wgmma reads truncated to its
    upper 19 bits (else rna(x))."""
    return re.search(rf"constexpr bool RAW_HI_{operand} = (true|false);",
                     SOURCE.read_text()).group(1) == "true"


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def operands(m=256, k=256, n=256, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-4, 5, (m, k), generator=g).to(dtype)
    b = torch.randint(-4, 5, (k, n), generator=g).to(dtype)
    return a, b


def misaligned(rows, cols, dtype=torch.float32) -> torch.Tensor:
    """A contiguous matrix whose base pointer is one element past 16
    bytes."""
    flat = torch.zeros(rows * cols + 1, dtype=dtype)
    x = flat[1:].view(rows, cols)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [256, 384, 64, 8])
def test_path_shapes_go_to_sm90(dtype, k):
    a, b = operands(k=k, dtype=dtype)
    assert kernel.masked_matmul_sm90_takes(a, b, 128, 128)
    for variant in (None, "sm90"):
        assert kernel.choose_masked_matmul_variant(variant, a, b, 128,
                                                   128) == "sm90"
    assert kernel.choose_masked_matmul_variant("mma_sync", a, b, 128,
                                               128) == "mma_sync"


@pytest.mark.parametrize("case", [
    "blocks 8", "blocks 16", "blocks 64", "blocks 256", "blocks 128 x 64",
    "f32 K 6", "f32 N 130", "bf16 K 4", "bf16 N 132", "float64",
    "mixed dtypes", "transposed a", "misaligned a", "misaligned b"])
def test_other_shapes_stay_on_mma_sync(case):
    a, b = operands()
    bm = bn = 128
    if case.startswith("blocks"):
        sizes = [int(w) for w in case.split()[1:] if w.isdigit()]
        bm, bn = sizes[0], sizes[-1]
    elif case == "f32 K 6":
        a, b = operands(k=6)
    elif case == "f32 N 130":
        a, b = operands(n=130)
    elif case == "bf16 K 4":
        a, b = operands(k=4, dtype=torch.bfloat16)
    elif case == "bf16 N 132":
        a, b = operands(n=132, dtype=torch.bfloat16)
    elif case == "float64":
        a, b = a.double(), b.double()
    elif case == "mixed dtypes":
        b = b.bfloat16()
    elif case == "transposed a":
        a = a.t()
    elif case == "misaligned a":
        a = misaligned(256, 256)
    elif case == "misaligned b":
        b = misaligned(256, 256)
    assert not kernel.masked_matmul_sm90_takes(a, b, bm, bn), case
    assert kernel.choose_masked_matmul_variant(None, a, b, bm,
                                               bn) == "mma_sync", case
    with pytest.raises(ValueError, match="sm90 masked_matmul kernel takes"):
        kernel.choose_masked_matmul_variant("sm90", a, b, bm, bn)


def test_unknown_variant_raises():
    a, b = operands()
    with pytest.raises(ValueError, match="unknown masked_matmul variant"):
        kernel.choose_masked_matmul_variant("wgmma", a, b, 128, 128)
    bi = bj = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown masked_matmul variant"):
        ops.masked_matmul(a, b, bi, bj, bm=128, bn=128, bk=128,
                          variant="tma")


@pytest.mark.parametrize("blk", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", [None, "sm90", "mma_sync"])
def test_the_cpu_path_never_launches(blk, dtype, variant):
    """The CPU path runs the plain version whatever kernel is asked for,
    refuses what a card would refuse, and counts no launch."""
    a, b = operands(dtype=dtype)
    bi = torch.tensor([0, 1, 1], dtype=torch.int32)
    bj = torch.tensor([1, 0, 1], dtype=torch.int32)
    counts = (kernel.MASKED_MATMUL_LAUNCHES,
              kernel.MASKED_MATMUL_SM90_LAUNCHES)
    if variant == "sm90" and blk != 128:
        with pytest.raises(ValueError, match="sm90 masked_matmul"):
            ops.masked_matmul(a, b, bi, bj, bm=blk, bn=blk, bk=blk,
                              variant=variant)
    else:
        got = ops.masked_matmul(a, b, bi, bj, bm=blk, bn=blk, bk=blk,
                                variant=variant)
        want = kernel.masked_matmul_plain(a, b, bi, bj, bm=blk, bn=blk)
        assert torch.equal(got, want)
        assert torch.equal(got[0], (a.float()[:blk] @ b.float())[
            :, blk:2 * blk])
    assert (kernel.MASKED_MATMUL_LAUNCHES,
            kernel.MASKED_MATMUL_SM90_LAUNCHES) == counts


def test_the_source_is_built_and_issues_wgmma_behind_tma():
    """The Hopper kernel is a source of the package's build, and it runs
    tf32 and bf16 ``wgmma`` on tiles that TMA loads behind mbarriers (the
    primitives of the shared header), with no mma.sync product."""
    assert _build.SOURCES["masked_matmul_sm90"] == SOURCE
    src = SOURCE.read_text()
    header = (_build.INCLUDE_DIR / "sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in src
    for call in ("wgmma_rs_tf32_n128", "wgmma_ss_bt_n64", "tma_load_2d",
                 "tma_store_2d", "mbar_wait", "mbar_arrive_expect_tx",
                 "fence_proxy_async", "setmaxnreg_inc", "map_2d"):
        assert f"sm90::{call}(" in src or f"sm90::{call}<" in src, call
    for ptx in ("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity"):
        assert ptx in header
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    assert "mma.sync" not in code and "tc::mma_" not in code
    assert 'extern "C" int masked_matmul_sm90(' in src
    assert 'extern "C" int masked_matmul_sm90_info(' in src


# ---------------------------------------------------------------------------
# the f32 scheme, emulated
# ---------------------------------------------------------------------------


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """What tf32 wgmma reads of a raw f32 word: its upper 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def kernel_split(x, operand: str, raw: bool = None):
    """The kernel's split of operand "A" or "B": (hi as the tensor cores
    read it, lo)."""
    if not (raw_hi(operand) if raw is None else raw):
        return split_tf32(x)
    hi = trunc_tf32(x)
    return hi, split_tf32(x - hi)[0]


def wgmma_sum(terms, k: int, flush: int) -> torch.Tensor:
    """sum_i A_i @ B_i as the kernel runs it: per k8 step one truncating
    wgmma per term, in order, into a partial sum that starts from zero
    every ``flush`` steps and is then added to the f32 accumulator with
    round-to-nearest."""
    acc = part = None
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


def kernel_scheme(a, b, flush: int, raw: bool = None) -> torch.Tensor:
    """The kernel's f32 product (``raw``: force the hi scheme of both)."""
    (ah, al), (bh, bl) = kernel_split(a, "A", raw), kernel_split(b, "B", raw)
    return wgmma_sum([(al, bh), (ah, bl), (ah, bh)], a.shape[-1], flush)


def tiles(seed: int, ints: bool, n: int = 4, bs: int = 128, k: int = 256):
    """n mask tiles' row panels of A and column panels of B."""
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-4, 5, s)) if ints
            else rng.standard_normal)
    return (torch.as_tensor(draw((n, bs, k)), dtype=torch.float32),
            torch.as_tensor(draw((n, k, bs)), dtype=torch.float32))


def normwise(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


def test_the_flush_interval_is_one_stage_or_less():
    assert constant("FLUSH") in (1, 2, 4)      # k8 steps; a stage is 4


@pytest.mark.parametrize("seed", [0, 1])
def test_flushed_3xtf32_keeps_f32_accuracy(seed):
    a, b = tiles(seed, ints=False)
    want = a.double() @ b.double()
    got = kernel_scheme(a, b, constant("FLUSH")).double()
    assert normwise(got, want) <= GATE
    scale = a.abs().double() @ b.abs().double()
    assert float(((got - want).abs() / scale).max()) <= 1e-5 / 10


@pytest.mark.parametrize("seed", [0, 1])
def test_flushed_3xtf32_is_exact_on_integers(seed):
    a, b = tiles(seed, ints=True)
    assert not kernel_split(a, "A")[1].any()
    assert not kernel_split(b, "B")[1].any()
    got = kernel_scheme(a, b, constant("FLUSH"))
    assert torch.equal(got.double(), a.double() @ b.double())


@pytest.mark.parametrize("seed", [0, 1])
def test_one_partial_over_k_misses_the_gate(seed):
    a, b = tiles(seed, ints=False)
    want = a.double() @ b.double()
    assert normwise(kernel_scheme(a, b, a.shape[-1] // 8), want) > GATE


def gpu_test_case():
    """tests/test_torch_cuda.py's f32 case at 128-blocks, K = 384
    (test_masked_matmul_kernel_matches_plain, seed 256): the mask's tiles'
    A row panels and B column panels."""
    rng = np.random.default_rng(256)
    a = torch.as_tensor(rng.standard_normal((512, 384)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((384, 384)), dtype=torch.float32)
    ok = rng.random((4, 3)) < 0.5
    ok[0, 0] = True
    bi, bj = np.nonzero(ok)
    return (torch.stack([a[128 * i:128 * i + 128] for i in bi]),
            torch.stack([b[:, 128 * j:128 * j + 128] for j in bj]))


def beyond_1e5(got, exact) -> int:
    return int((~torch.isclose(got.double(), exact, rtol=1e-5,
                               atol=1e-5)).sum())


def test_the_scheme_keeps_the_gpu_tests_elementwise_gate():
    a, b = gpu_test_case()
    exact = a.double() @ b.double()
    assert beyond_1e5(kernel_scheme(a, b, constant("FLUSH")), exact) == 0
    # the raw word as hi, one partial per 32-deep stage, misses it
    assert beyond_1e5(kernel_scheme(a, b, 4, raw=True), exact) > 0
