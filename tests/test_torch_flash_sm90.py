"""The Hopper bf16 flash kernel's host-side rules, on the CPU: the dispatch
predicate that sends a bf16 launch to ``csrc/flash_mask_sm90.cu`` or keeps
it on the ``mma.sync`` kernel, the ``variant`` argument, and the "full
tile" test that lets the kernels skip the element mask, held exhaustively
against the dense mask ``ref.mask_allowed``.  The f32 shapes' dispatch is
in tests/test_torch_flash_f32_sm90.py.  No kernel runs here: the
kernels' agreement with the plain version is in tests/test_torch_cuda.py
and chip_smoke.py phase 9.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_mask import kernel as flash
from repro_torch.kernels.flash_mask.ref import mask_allowed

#: the mask patterns of chip_smoke.py's phase 9 sweep
PATTERNS = [dict(causal=True, window=0, prefix=0),
            dict(causal=True, window=16, prefix=0),
            dict(causal=True, window=16, prefix=8),
            dict(causal=False, window=0, prefix=0)]
PATTERN_IDS = ["causal", "window", "window+prefix", "dense"]
#: and one whose window and prefix span whole 64- and 128-tiles, so that
#: the predicate's window and prefix clauses decide some tiles
WIDE = dict(causal=True, window=384, prefix=128)


def operands(d, dtype=torch.bfloat16, s=128, hq=2, hkv=1):
    return (torch.zeros((1, hq, s, d), dtype=dtype),
            torch.zeros((1, hkv, s, d), dtype=dtype),
            torch.zeros((1, hkv, s, d), dtype=dtype))


@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
def test_hopper_shapes_go_to_sm90(bq, bk, d):
    q, k, v = operands(d)
    assert flash.sm90_takes(q, k, v, bq, bk)
    assert flash.choose_variant(None, q, k, v, bq, bk) == "sm90"
    assert flash.choose_variant("sm90", q, k, v, bq, bk) == "sm90"
    assert flash.choose_variant("mma_sync", q, k, v, bq, bk) == "mma_sync"


@pytest.mark.parametrize("dtype,bq,bk,d,why", [
    (torch.bfloat16, 16, 16, 64, "the reduced configs' attn_block 16"),
    (torch.bfloat16, 8, 8, 16, "the reference sweep's small blocks"),
    (torch.bfloat16, 1, 128, 64, "decode at bq = 1"),
    (torch.bfloat16, 32, 128, 64, "bq 32"),
    (torch.bfloat16, 128, 32, 64, "bk 32"),
    (torch.bfloat16, 128, 128, 20, "D not a multiple of 16"),
    (torch.bfloat16, 128, 128, 8, "D below 16"),
])
def test_other_shapes_stay_on_mma_sync(dtype, bq, bk, d, why):
    q, k, v = operands(d, dtype)
    assert not flash.sm90_takes(q, k, v, bq, bk), why
    assert flash.choose_variant(None, q, k, v, bq, bk) == "mma_sync", why
    with pytest.raises(ValueError, match="sm90 flash kernel takes"):
        flash.choose_variant("sm90", q, k, v, bq, bk)


def test_layout_rules():
    """Non-contiguous or misaligned operands keep mma.sync."""
    q, k, v = operands(64)
    qt = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert not qt.is_contiguous()
    assert not flash.sm90_takes(qt, k, v, 128, 128)
    assert flash.sm90_takes(qt.contiguous(), k, v, 128, 128)
    # a contiguous view 2 bytes into its storage is not 16-byte aligned
    flat = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 128, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    assert not flash.sm90_takes(shifted, k, v, 128, 128)
    assert not flash.sm90_takes(q, k, shifted[:, :1], 128, 128)


def test_variant_names():
    q, k, v = operands(64)
    assert flash.VARIANTS == ("sm90", "mma_sync")
    with pytest.raises(ValueError, match="unknown flash_mask variant"):
        flash.choose_variant("wgmma", q, k, v, 128, 128)


def test_wrapper_checks_the_variant_on_the_cpu():
    """The CPU path runs the plain version whatever kernel is asked for,
    but refuses what a card would refuse, and counts no launch."""
    q, k, v = operands(64)
    wl = [torch.as_tensor(x) for x in flash.build_schedule(
        128, 128, bq=128, bk=128, causal=True, window=0, prefix=0,
        q_offset=0)]
    kw = dict(scale=0.125, causal=True, window=0, prefix=0, q_offset=0)
    before = (flash.LAUNCHES, flash.TC_LAUNCHES, flash.SM90_LAUNCHES)
    for variant in (None, "sm90", "mma_sync"):
        out = flash.flash_mask_kernel(q, k, v, *wl, bq=128, bk=128,
                                      variant=variant, **kw)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sm90 flash kernel takes"):
        small = [torch.as_tensor(x) for x in flash.build_schedule(
            128, 128, bq=16, bk=16, causal=True, window=0, prefix=0,
            q_offset=0)]
        flash.flash_mask_kernel(q, k, v, *small, bq=16, bk=16,
                                variant="sm90", **kw)
    with pytest.raises(ValueError, match="unknown flash_mask variant"):
        flash.flash_mask_kernel(q, k, v, *wl, bq=128, bk=128,
                                variant="cuda", **kw)
    assert (flash.LAUNCHES, flash.TC_LAUNCHES, flash.SM90_LAUNCHES) == before


def test_hopper_source_is_registered():
    src = _build.SOURCES["flash_mask_sm90"]
    text = src.read_text()
    header = (_build.INCLUDE_DIR / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg"):
        assert needle in header
    for needle in ("extern \"C\" int flash_mask_sm90(",
                   "extern \"C\" int flash_mask_sm90_info(",
                   "cuTensorMapEncodeTiled", "__grid_constant__"):
        assert needle in text
    # every library's name follows the new header too
    assert "sm90.cuh" in {p.name for p in _build.INCLUDE_DIR.iterdir()}


@pytest.mark.parametrize("pattern", PATTERNS + [WIDE],
                         ids=PATTERN_IDS + ["wide window+prefix"])
@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
def test_full_tile_predicate_is_sound(pattern, bq, bk):
    """No tile that ``tile_is_full`` calls full holds a masked element:
    per warpgroup (64 rows) as the Hopper kernel asks, and per warp (16
    rows) as the mma.sync kernel does, over every tile of worklists at
    several sequence lengths and query offsets."""
    full_tiles = 0
    for s_q, s_k in ((128, 128), (256, 512), (512, 512), (1024, 1024)):
        if s_q % bq or s_k % bk:
            continue
        for q_offset in sorted({0, 64, 200, s_k - s_q}):
            ok = mask_allowed(s_q, s_k, q_offset=q_offset, **pattern)
            qi, ki, _ = flash.build_schedule(s_q, s_k, bq=bq, bk=bk,
                                             q_offset=q_offset, **pattern)
            for r, c in zip(qi.tolist(), ki.tolist()):
                for rows in (64, 16):
                    for r0 in range(r * bq, (r + 1) * bq, rows):
                        k0 = c * bk
                        if flash.tile_is_full(r0 + q_offset, rows, k0, bk,
                                              **pattern):
                            full_tiles += 1
                            assert ok[r0:r0 + rows, k0:k0 + bk].all(), (
                                r0, k0, rows, q_offset)
    # a window of 16 leaves no 16-row tile of 64 or 128 keys whole
    assert (full_tiles > 0) == (pattern["window"] != 16)


@pytest.mark.parametrize("pattern", PATTERNS + [WIDE],
                         ids=PATTERN_IDS + ["wide window+prefix"])
def test_full_tile_predicate_exhaustive(pattern):
    """Every 64-row query tile against every kv tile (not only the
    worklist's) at S 1,024: the predicate never calls a tile with a masked
    element full, and it calls every interior tile full where the mask is
    a plain causal or dense one."""
    s = 1024
    for q_offset in (0, 64, 512):
        ok = mask_allowed(s, s, q_offset=q_offset, **pattern)
        for bk in (64, 128):
            view = ok.reshape(s // 64, 64, s // bk, bk)
            whole = view.all(axis=(1, 3))
            said = np.array([[flash.tile_is_full(i * 64 + q_offset, 64,
                                                 j * bk, bk, **pattern)
                              for j in range(s // bk)]
                             for i in range(s // 64)])
            assert not (said & ~whole).any()
            if pattern["window"] == 0:
                assert (said == whole).all()

