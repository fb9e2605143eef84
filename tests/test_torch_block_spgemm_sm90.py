"""The Hopper block product's dispatch and numerics, on the CPU.

``kernel.sm90_takes`` sends a block_spgemm launch to
``csrc/block_spgemm_sm90.cu`` (wgmma + TMA) at block size 128 with f32
operands and bf16 patterns, contiguous and 16-byte aligned; every other
shape stays on the ``mma.sync`` kernel, ``variant="sm90"`` on such a shape
raises and an unknown variant raises.  On the CPU the wrappers run their
plain versions and count no launch, whatever the variant.

The kernel's values are 3xTF32 on wgmma, whose f32 sums truncate (as
``mma.sync``'s do, tests/test_torch_tc_numerics.py): each consumer sums
FLUSH k8 steps (three wgmma each) in a partial accumulator from zero, then
adds it to its f32 accumulator with IEEE rounding.  ``wgmma_sum`` emulates
that scheme (with test_torch_tc_numerics.py's tf32 rounding and truncating
sums) with the interval read from the source, at one output block of
6 pairs of bs 128 (K = 768): normal data stays within 2e-6 / 5 normwise of
float64 (the card's gate, with margin), integer data is exact, and one
partial over the whole segment misses the gate.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.masked_matmul import kernel
from test_torch_tc_numerics import f32_toward_zero, split_tf32

SOURCE = (Path(kernel.__file__).parent / "csrc" / "block_spgemm_sm90.cu")


def constant(name: str) -> int:
    """A ``constexpr int`` of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text()).group(1))


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


def segment(seed: int, ints: bool, pairs: int = 6, bs: int = 128):
    """One output block's segment as (bs, pairs * bs) @ (pairs * bs, bs)."""
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(1, 5, s)) if ints
            else rng.standard_normal)
    a = torch.as_tensor(draw((pairs, bs, bs)), dtype=torch.float32)
    b = torch.as_tensor(draw((pairs, bs, bs)), dtype=torch.float32)
    return (a.permute(1, 0, 2).reshape(bs, pairs * bs),
            b.reshape(pairs * bs, bs))


def three_tf32(a, b, flush: int) -> torch.Tensor:
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return wgmma_sum([(al, bh), (ah, bl), (ah, bh)], a.shape[1], flush)


def normwise(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


def test_the_flush_interval_is_one_stage_or_less():
    flush, kc = constant("FLUSH"), constant("KC")
    assert kc == 32 and flush in (1, 2, 4) and (kc // 8) % flush == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_flushed_3xtf32_keeps_f32_accuracy(seed):
    a, b = segment(seed, ints=False)
    want = a.double() @ b.double()
    assert normwise(three_tf32(a, b, constant("FLUSH")), want) <= 2e-6 / 5


@pytest.mark.parametrize("seed", [0, 1])
def test_flushed_3xtf32_is_exact_on_integers(seed):
    a, b = segment(seed, ints=True)
    got = three_tf32(a, b, constant("FLUSH"))
    assert torch.equal(got.double(), a.double() @ b.double())


@pytest.mark.parametrize("seed", [0, 1])
def test_one_partial_over_the_segment_misses_the_gate(seed):
    a, b = segment(seed, ints=False)
    want = a.double() @ b.double()
    assert normwise(three_tf32(a, b, a.shape[1] // 8), want) > 2e-6


def blocks(nnzb: int, bs: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 3, (nnzb, bs, bs), generator=g).float()


def misaligned(nnzb: int, bs: int) -> torch.Tensor:
    """Contiguous f32 blocks whose base pointer is 4 bytes past 16."""
    flat = torch.zeros(nnzb * bs * bs + 1)
    x = flat[1:].view(nnzb, bs, bs)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    return x


@pytest.mark.parametrize("case, takes", [
    ("bs 128", True),
    ("bs 128 with bf16 patterns", True),
    ("bs 128 with f32 patterns", False),
    ("bs 32", False),
    ("bs 8", False),
    ("bs 64", False),
    ("float64 values", False),
    ("transposed blocks", False),
    ("misaligned base", False),
    ("misaligned pattern", False),
])
def test_sm90_takes(case, takes):
    a, b = blocks(3, 128), blocks(2, 128)
    pats = ()
    if case == "bs 128 with bf16 patterns":
        pats = (a.bfloat16(), b.bfloat16())
    elif case == "bs 128 with f32 patterns":
        pats = (a.clone(), b.clone())
    elif case.startswith("bs ") and case != "bs 128":
        bs = int(case.split()[1])
        a, b = blocks(3, bs), blocks(2, bs)
    elif case == "float64 values":
        a, b = a.double(), b.double()
    elif case == "transposed blocks":
        a = a.transpose(1, 2)
    elif case == "misaligned base":
        a = misaligned(3, 128)
    elif case == "misaligned pattern":
        p = torch.zeros(2 * 128 * 128 + 1, dtype=torch.bfloat16)[1:]
        assert p.data_ptr() % 16 == 2
        pats = (a.bfloat16(), p.view(2, 128, 128))
    assert kernel.sm90_takes(a, b, *pats) is takes
    want = "sm90" if takes else "mma_sync"
    assert kernel.choose_variant(None, a, b, *pats) == want
    assert kernel.choose_variant("mma_sync", a, b, *pats) == "mma_sync"
    if takes:
        assert kernel.choose_variant("sm90", a, b, *pats) == "sm90"
    else:
        with pytest.raises(ValueError, match="sm90 block_spgemm kernel"):
            kernel.choose_variant("sm90", a, b, *pats)


def test_unknown_variant_raises():
    a = blocks(1, 128)
    with pytest.raises(ValueError, match="unknown block_spgemm variant"):
        kernel.choose_variant("wgmma", a, a)


def worklist(bs: int):
    """Two ranks: rank 0 zero + add + write over two pairs, rank 1 a
    zero-fill entry, then an all-flags-off entry."""
    rank = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    pa = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    pb = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    flags = torch.tensor([3, 6, 5, 0], dtype=torch.int32)
    return rank, pa, pb, flags


@pytest.mark.parametrize("bs", [8, 32, 128])
@pytest.mark.parametrize("variant", [None, "sm90", "mma_sync"])
def test_the_cpu_path_never_launches(bs, variant):
    a, b = blocks(2, bs, seed=1), blocks(2, bs, seed=2)
    a_pat, b_pat = (a != 0).float(), (b != 0).float()
    wl = worklist(bs)
    counts = (kernel.LAUNCHES, kernel.FUSED_LAUNCHES, kernel.SM90_LAUNCHES)
    if variant == "sm90" and bs != 128:
        with pytest.raises(ValueError, match="sm90"):
            kernel.block_spgemm_kernel(a, b, *wl, 2, variant=variant)
        with pytest.raises(ValueError, match="sm90"):
            kernel.block_spgemm_with_structure_kernel(
                a, b, a_pat, b_pat, *wl, 2, variant=variant)
    else:
        got = kernel.block_spgemm_kernel(a, b, *wl, 2, variant=variant)
        vals, cnts = kernel.block_spgemm_with_structure_kernel(
            a, b, a_pat, b_pat, *wl, 2, variant=variant)
        want = a[0] @ b[1] + a[1] @ b[0]
        assert torch.equal(got[0], want) and torch.equal(vals, got)
        assert not got[1].any()
        assert torch.equal(cnts[0], a_pat[0] @ b_pat[1] + a_pat[1] @ b_pat[0])
    assert (kernel.LAUNCHES, kernel.FUSED_LAUNCHES,
            kernel.SM90_LAUNCHES) == counts


def test_unknown_variant_raises_on_the_cpu_too():
    a = blocks(2, 128)
    with pytest.raises(ValueError, match="unknown block_spgemm variant"):
        kernel.block_spgemm_kernel(a, a, *worklist(128), 2, variant="x")
    with pytest.raises(ValueError, match="unknown block_spgemm variant"):
        kernel.block_spgemm_with_structure_kernel(
            a, a, a, a, *worklist(128), 2, variant="x")


def test_the_source_is_built_and_issues_wgmma_behind_tma():
    """The Hopper kernel is a source of the package's build, and it runs
    tf32 and bf16 ``wgmma`` on tiles that TMA loads behind mbarriers (the
    primitives of the shared header)."""
    from repro_torch.kernels import _build
    assert _build.SOURCES["block_spgemm_sm90"] == SOURCE
    src = SOURCE.read_text()
    header = (_build.INCLUDE_DIR / "sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in src
    for call in ("wgmma_rs_tf32_n128", "wgmma_ss_at_n128", "tma_load_2d",
                 "mbar_wait", "mbar_arrive_expect_tx", "fence_proxy_async"):
        assert f"sm90::{call}(" in src
    for ptx in ("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.2d", "fence.proxy.async.shared::cta"):
        assert ptx in header
    assert "tc::mma_" not in src               # no mma.sync product
