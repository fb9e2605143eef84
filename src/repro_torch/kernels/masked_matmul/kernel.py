"""Masked BCSR x BCSR block product: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/block_spgemm.cu``) replaces the TPU kernel
``repro/kernels/masked_matmul/kernel.py::block_spgemm_kernel``.  It replays
a rank-sorted worklist ``(rank, pa, pb, flags)``: flag bit 1 zeroes the f32
accumulator, bit 2 adds ``A[pa] @ B[pb]``, bit 4 writes the accumulator to
``out[rank]``.  One CTA per (output rank, output sub-tile) walks that rank's
worklist segment, so the result needs no atomics and is deterministic; the
note at the top of the source gives its bound on an H100.

``block_spgemm_kernel`` launches the kernel for CUDA tensors (or raises) and
runs ``block_spgemm_plain`` for CPU tensors; ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import torch

#: peak f32 elements the plain version materializes per worklist chunk
#: (~64 MB); the row route's batch budget reuses it
_XLA_CHUNK_ELEMS = 1 << 24

#: number of times the CUDA kernel was launched in this process
LAUNCHES = 0

_lib = None


def _load():
    """Build (first use only) and load the kernel's library."""
    global _lib
    if _lib is None:
        import ctypes
        from repro_torch.kernels import _build
        lib = ctypes.CDLL(str(_build.build("block_spgemm")))
        fn = lib.block_spgemm_f32
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(a_blocks, b_blocks, rank, pa, pb, flags, nnzb_out):
    for name, x in (("a_blocks", a_blocks), ("b_blocks", b_blocks)):
        if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (nnzb, bs, bs) "
                             f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    bs = a_blocks.shape[1]
    if a_blocks.shape[2] != bs or b_blocks.shape[1:] != (bs, bs):
        raise ValueError(f"block shapes differ: {tuple(a_blocks.shape)} vs "
                         f"{tuple(b_blocks.shape)}")
    W = rank.shape[0]
    for name, x in (("rank", rank), ("pa", pa), ("pb", pb),
                    ("flags", flags)):
        if (x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != W
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({W},) int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    dev = a_blocks.device
    if any(x.device != dev for x in (b_blocks, rank, pa, pb, flags)):
        raise ValueError("all operands must lie on one device")
    if nnzb_out < 0:
        raise ValueError(f"nnzb_out must be >= 0, got {nnzb_out}")
    return bs


def block_spgemm_plain(a_blocks, b_blocks, rank, pa, pb, flags,
                       nnzb_out: int) -> torch.Tensor:
    """Plain version: gather, batched f32 matmul, rank segment-add weighted
    by the real bit, chunked at ``_XLA_CHUNK_ELEMS``.

    Chunks are independent partial sums into the same output (the
    segment-add is associative), so the first/last flags are irrelevant:
    an entry without the real bit adds nothing, and a rank no entry writes
    stays zero.
    """
    bs = a_blocks.shape[1]
    out = torch.zeros((nnzb_out, bs, bs), dtype=torch.float32,
                      device=a_blocks.device)
    W = int(rank.shape[0])
    chunk = max(1, _XLA_CHUNK_ELEMS // (bs * bs))
    for s in range(0, W, chunk):
        e = min(W, s + chunk)
        real = ((flags[s:e] >> 1) & 1).to(torch.float32)
        prods = torch.bmm(a_blocks[pa[s:e].long()],
                          b_blocks[pb[s:e].long()])
        out.index_add_(0, rank[s:e].long(), prods * real[:, None, None])
    return out


def block_spgemm_kernel(a_blocks, b_blocks, rank, pa, pb, flags,
                        nnzb_out: int) -> torch.Tensor:
    """Masked BCSR product from a worklist sorted by rank.

    a_blocks: (nnzb_a, bs, bs) f32; b_blocks: (nnzb_b, bs, bs) f32.
    rank/pa/pb/flags: (W,) int32 — output block rank, A/B block positions,
    and the flag bitfield (1 = zero the accumulator, 2 = real product,
    4 = write the accumulator).  Returns (nnzb_out, bs, bs) f32.

    CPU tensors run ``block_spgemm_plain``.  CUDA tensors launch the kernel
    on the current stream without synchronising, or raise.  Positions out
    of range are skipped by the kernel instead of faulting; callers
    validate them on the host.
    """
    global LAUNCHES
    bs = _check(a_blocks, b_blocks, rank, pa, pb, flags, nnzb_out)
    dev = a_blocks.device
    if dev.type == "cpu":
        return block_spgemm_plain(a_blocks, b_blocks, rank, pa, pb, flags,
                                  nnzb_out)
    if dev.type != "cuda":
        raise ValueError(f"no block_spgemm kernel for device {dev}")
    out = torch.zeros((nnzb_out, bs, bs), dtype=torch.float32, device=dev)
    if nnzb_out == 0:
        return out
    # segment offsets of the rank-sorted worklist, on the device
    seg_ptr = torch.searchsorted(
        rank, torch.arange(nnzb_out + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.block_spgemm_f32(
            a_blocks.data_ptr(), b_blocks.data_ptr(), pa.data_ptr(),
            pb.data_ptr(), flags.data_ptr(), seg_ptr.data_ptr(),
            out.data_ptr(), nnzb_out, bs, a_blocks.shape[0],
            b_blocks.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"block_spgemm kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
