"""Block-masked flash attention: the host worklist, the CUDA kernel's wrapper
and its plain PyTorch version.

Each kernel (``csrc/*.cu``) replaces the TPU kernel
``repro/kernels/flash_mask/kernel.py::flash_mask_kernel`` and, in the same
launch, the batch/head/GQA vmap around it: one CTA per (q-block,
batch * head) walks that q-block's segment of the qi-sorted worklist
``(qi, ki, flags)`` with an online softmax (flag bit 1 = first visit of the
q-block: reset; bit 2 = last visit: normalise and write).  The note at the
top of each source gives its bound on an H100.

Four kernels, all on tensor cores.  Two are for Hopper (TMA loads behind
mbarriers, a producer warpgroup, consumer warpgroups on ``wgmma``), for
blocks of 64 or 128 (``sm90_takes``): ``csrc/flash_mask_sm90.cu`` is bf16,
for head dims that are multiples of 16 up to 128, with p.v in two bf16
terms; ``csrc/flash_mask_f32_sm90.cu`` is f32 in 3xTF32 (each operand split
into two tf32 terms, once, by the warps that load it), for head dims 64,
112 and 128 (every f32 prefill of the LM configs at full width).
``csrc/flash_mask.cu`` holds the ``mma.sync`` kernels with k/v in a
``cp.async`` ring, picked by dtype in its C entry point, for every other
shape (small blocks, decode at bq = 1, other head dims): bf16, and f32 in
3xTF32.

``flash_mask_kernel`` launches a kernel for CUDA tensors (or raises) and
runs ``flash_mask_plain`` for CPU tensors; ``LAUNCHES`` counts launches,
``TC_LAUNCHES`` those of them that ran a tensor-core kernel (all of them),
``SM90_LAUNCHES`` those that ran a Hopper kernel (bf16 or f32) and
``F32_LAUNCHES`` those that ran an f32 one (Hopper or ``mma.sync``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: largest q/kv block and head dim the kernel's tile configs cover
MAX_BLOCK = 128
MAX_HEAD_DIM = 128

#: number of times the CUDA kernel was launched in this process
LAUNCHES = 0
#: of those, the launches of a tensor-core kernel (bf16 or f32)
TC_LAUNCHES = 0
#: of those, the launches of an f32 (3xTF32) kernel
F32_LAUNCHES = 0
#: of those, the launches of a Hopper kernel (wgmma + TMA, bf16 or f32)
SM90_LAUNCHES = 0

#: the kernels a caller may ask for by name (``variant=``): the Hopper
#: kernel of the dtype, or flash_mask.cu's mma.sync kernel of the dtype
VARIANTS = ("sm90", "mma_sync")
#: the head dims of the f32 Hopper kernel: llama3.2-1b's and
#: seamless-m4t's 64, zamba2-7b's 112, moonshot's 128
SM90_F32_HEAD_DIMS = (64, 112, 128)

#: C signature: 7 pointers, 8 ints, the scale, 5 ints, the stream
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])
#: the Hopper kernels' (bf16 and f32): 7 pointers, 8 ints, the scale, 4
#: ints, the stream
_SM90_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def sm90_takes(q, k, v, bq: int, bk: int) -> bool:
    """Whether a Hopper kernel takes these operands, as the kernel receives
    them: bq and bk each 64 or 128; bfloat16 with a head dim that is a
    multiple of 16 in [16, 128], or float32 with a head dim in
    ``SM90_F32_HEAD_DIMS``; and q, k, v contiguous with 16-byte aligned
    base pointers (the output, which the wrapper allocates, is both)."""
    d = q.shape[-1]
    if q.dtype == torch.bfloat16:
        dims = d % 16 == 0 and 16 <= d <= MAX_HEAD_DIM
    elif q.dtype == torch.float32:
        dims = d in SM90_F32_HEAD_DIMS
    else:
        dims = False
    return (dims and bq in (64, 128) and bk in (64, 128)
            and all(x.is_contiguous() and x.data_ptr() % 16 == 0
                    for x in (q, k, v)))


def choose_variant(variant, q, k, v, bq: int, bk: int) -> str:
    """The kernel a launch runs: ``variant`` if given (one of ``VARIANTS``;
    "sm90" on operands that ``sm90_takes`` refuses raises), else "sm90"
    where ``sm90_takes`` holds and "mma_sync" elsewhere."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown flash_mask variant {variant!r}; expected "
                         f"one of {VARIANTS} or None")
    fits = sm90_takes(q, k, v, bq, bk)
    if variant == "sm90" and not fits:
        d = q.shape[-1]
        raise ValueError(
            f"the sm90 flash kernel takes bq, bk in (64, 128) with bfloat16 "
            f"and D a multiple of 16 in [16, {MAX_HEAD_DIM}] or float32 and "
            f"D in {SM90_F32_HEAD_DIMS}, contiguous and 16-byte aligned; got "
            f"{q.dtype}, bq={bq}, bk={bk}, D={d}")
    if variant is None:
        return "sm90" if fits else "mma_sync"
    return variant


def tile_is_full(q_lo: int, rows: int, k_lo: int, keys: int, *, causal: bool,
                 window: int, prefix: int) -> bool:
    """The kernels' test for skipping the element mask: every element of
    the tile of queries q_lo .. q_lo + rows - 1 (absolute positions) and
    keys k_lo .. k_lo + keys - 1 is allowed when the tile lies wholly on or
    below the causal diagonal and wholly inside the window or the prefix.
    The Hopper kernel asks it per warpgroup (64 rows), the mma.sync kernel
    per warp (16 rows)."""
    k_hi = k_lo + keys - 1
    return ((not causal or k_hi <= q_lo)
            and (window <= 0 or q_lo + rows - 1 - k_lo < window
                 or k_hi < prefix))


def build_schedule(s_q: int, s_k: int, *, bq: int, bk: int, causal: bool,
                   window: int, prefix: int, q_offset: int):
    """Host-side symbolic phase: the (q_block, kv_block) worklist.

    A pair enters the worklist iff ANY element of its tile is allowed —
    tile-granular mask structure, exactly BCSR-of-the-mask.  Returns int32
    arrays ``(qi, ki, flags)`` sorted by ``qi``; flags bit 1 marks the first
    visit of a q-block, bit 2 the last.
    """
    nq, nk = s_q // bq, s_k // bk
    i = np.arange(nq)[:, None]
    j = np.arange(nk)[None, :]
    q_lo, q_hi = i * bq + q_offset, (i + 1) * bq - 1 + q_offset
    k_lo, k_hi = j * bk, (j + 1) * bk - 1
    # interval test: the tile holds diffs (q-k) in [q_lo-k_hi, q_hi-k_lo]
    ok = np.ones((nq, nk), bool)
    if causal:
        ok &= k_lo <= q_hi
    if window > 0:
        in_win = (q_lo - k_hi) < window
        if causal:
            in_win &= (q_hi - k_lo) >= 0
        else:
            in_win &= (k_lo - q_hi) < window
        ok &= in_win | np.broadcast_to(k_lo < prefix, in_win.shape)
    # degenerate rows (can't happen for our patterns): keep one tile so the
    # accumulator init/flush protocol stays intact
    ok[~ok.any(axis=1), 0] = True

    qi, ki, flags = [], [], []
    for row in range(nq):
        cols = np.nonzero(ok[row])[0]
        f = np.zeros(len(cols), np.int32)
        f[0] |= 1
        f[-1] |= 2
        qi.extend([row] * len(cols)); ki.extend(cols); flags.extend(f)
    return (np.asarray(qi, np.int32), np.asarray(ki, np.int32),
            np.asarray(flags, np.int32))


def _check(q, k, v, qi, ki, flags, bq, bk):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s_q, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Hkv, T, {d}) for q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    hkv, s_k = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (1 <= bq <= MAX_BLOCK and 1 <= bk <= MAX_BLOCK):
        raise ValueError(f"blocks must lie in [1, {MAX_BLOCK}], got "
                         f"bq={bq} bk={bk}")
    if s_q % bq or s_k % bk:
        raise ValueError(f"S = {s_q} and T = {s_k} must be multiples of "
                         f"bq = {bq} and bk = {bk}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    P = qi.shape[0]
    for name, x in (("qi", qi), ("ki", ki), ("flags", flags)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != P:
            raise ValueError(f"{name} must be a ({P},) int32 tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if any(x.device != q.device for x in (k, v, qi, ki, flags)):
        raise ValueError("all operands must lie on one device")


def flash_mask_plain(q, k, v, qi, ki, flags, *, bq: int, bk: int,
                     scale: float, causal: bool, window: int, prefix: int,
                     q_offset: int) -> torch.Tensor:
    """Plain version: replays the worklist entry by entry with the kernel's
    arithmetic, batched over (batch, head).  q: (B, Hq, S, D); k, v:
    (B, Hkv, T, D).  Returns (B, Hq, S, D) in q.dtype."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    g, nq = hq // hkv, s_q // bq
    dev = q.device
    qf = q.float().reshape(b, hkv, g, nq, bq, d)
    kf = k.float().reshape(b, hkv, s_k // bk, bk, d)
    vf = v.float().reshape(b, hkv, s_k // bk, bk, d)
    m = torch.full((b, hkv, g, nq, bq, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, nq, bq, 1), device=dev)
    acc = torch.zeros((b, hkv, g, nq, bq, d), device=dev)
    out = torch.zeros((b, hkv, g, nq, bq, d), dtype=q.dtype, device=dev)
    rows = torch.arange(bq, device=dev)[:, None]
    cols = torch.arange(bk, device=dev)[None, :]
    for r, c, f in zip(qi.tolist(), ki.tolist(), flags.tolist()):
        if f & 1:
            m[:, :, :, r] = NEG_INF
            l[:, :, :, r] = 0.0
            acc[:, :, :, r] = 0.0
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, r],
                         kf[:, :, c]) * scale
        qg = r * bq + rows + q_offset
        kg = c * bk + cols
        ok = torch.ones((bq, bk), dtype=torch.bool, device=dev)
        if causal:
            ok &= kg <= qg
        if window > 0:
            ok &= ((qg - kg) < window) | (kg < prefix)
        s = torch.where(ok, s, NEG_INF)
        m_prev = m[:, :, :, r]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_prev - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l[:, :, :, r] = l[:, :, :, r] * alpha + p.sum(dim=-1, keepdim=True)
        acc[:, :, :, r] = acc[:, :, :, r] * alpha + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vf[:, :, c])
        m[:, :, :, r] = m_new
        if f & 2:
            lr = l[:, :, :, r]
            out[:, :, :, r] = torch.where(
                lr > 0, acc[:, :, :, r] / torch.clamp(lr, min=1e-30),
                0.0).to(q.dtype)
    return out.reshape(b, hq, s_q, d)


def flash_mask_kernel(q, k, v, qi, ki, flags, *, bq: int, bk: int,
                      scale: float, causal: bool, window: int, prefix: int,
                      q_offset: int, variant: str = None) -> torch.Tensor:
    """Masked flash attention over the worklist ``(qi, ki, flags)``.

    q: (B, Hq, S, D) and k, v: (B, Hkv, T, D) with Hq % Hkv == 0 (query
    head h reads kv head h // (Hq // Hkv)); float32 or bfloat16.
    qi/ki/flags: (P,) int32 from ``build_schedule``.  Returns
    (B, Hq, S, D) in q.dtype.

    CPU tensors run ``flash_mask_plain``.  CUDA tensors launch one kernel
    for every (batch, head) on the current stream without synchronising,
    or raise: ``choose_variant`` picks it (``variant`` None: the Hopper
    kernel of the dtype where ``sm90_takes`` holds, else flash_mask.cu's
    mma.sync kernel for the dtype; "mma_sync" forces the latter; "sm90" on
    operands it does not take raises, on the CPU too).  A q-block the
    worklist never visits comes out as zeros; a kv-block index out of range
    reads as fully masked.
    """
    global LAUNCHES, TC_LAUNCHES, F32_LAUNCHES, SM90_LAUNCHES
    _check(q, k, v, qi, ki, flags, bq, bk)
    dev = q.device
    kw = dict(bq=bq, bk=bk, scale=scale, causal=causal, window=window,
              prefix=prefix, q_offset=q_offset)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if dev.type == "cpu":
        choose_variant(variant, q, k, v, bq, bk)
        return flash_mask_plain(q, k, v, qi, ki, flags, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no flash_mask kernel for device {dev}")
    b, hq, s_q, d = q.shape
    if max(b * hq, s_q // bq) > 65535:
        raise ValueError(f"B * Hq = {b * hq} or S / bq = {s_q // bq} "
                         f"exceeds the grid's 65535")
    ki, flags = ki.contiguous(), flags.contiguous()
    chosen = choose_variant(variant, q, k, v, bq, bk)
    # the Hopper kernels write every element (zeros where no flush
    # reaches); the mma.sync kernels leave those rows as they find them
    out = (torch.empty_like(q, memory_format=torch.contiguous_format)
           if chosen == "sm90" else torch.zeros_like(q))
    nq = s_q // bq
    # segment offsets of the qi-sorted worklist, on the device
    seg_ptr = torch.searchsorted(
        qi.contiguous(), torch.arange(nq + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ki.data_ptr(),
            flags.data_ptr(), seg_ptr.data_ptr(), out.data_ptr())
    dims = (b * hq, hq, k.shape[1], s_q, k.shape[2], d, bq, bk)
    mask = (int(bool(causal)), int(window), int(prefix), int(q_offset))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if chosen == "sm90":
            lib = ("flash_mask_f32_sm90" if q.dtype == torch.float32
                   else "flash_mask_sm90")
            fn = _build.load(lib, lib, _SM90_ARGS)
            err = fn(*ptrs, *dims, float(scale), *mask, stream)
        else:
            fn = _build.load("flash_mask", "flash_mask", _ARGS)
            err = fn(*ptrs, *dims, float(scale), *mask,
                     0 if q.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_mask kernel ({chosen}) launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    TC_LAUNCHES += 1
    if chosen == "sm90":
        SM90_LAUNCHES += 1
    if q.dtype == torch.float32:
        F32_LAUNCHES += 1
    return out
