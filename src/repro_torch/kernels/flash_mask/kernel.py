"""Block-masked flash attention: the host worklist, the CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (``csrc/flash_mask.cu``) replaces the TPU kernel
``repro/kernels/flash_mask/kernel.py::flash_mask_kernel`` and, in the same
launch, the batch/head/GQA vmap around it: one CTA per (q-block,
batch * head) walks that q-block's segment of the qi-sorted worklist
``(qi, ki, flags)`` with an online softmax (flag bit 1 = first visit of the
q-block: reset; bit 2 = last visit: normalise and write).  The note at the
top of the source gives its bound on an H100.

The source holds two kernels, picked by dtype in its C entry point, both on
tensor cores (``mma.sync``, k/v in a ``cp.async`` ring): bf16 with p.v in
two bf16 terms, f32 in 3xTF32 (each operand split into two tf32 terms).

``flash_mask_kernel`` launches the kernel for CUDA tensors (or raises) and
runs ``flash_mask_plain`` for CPU tensors; ``LAUNCHES`` counts launches,
``TC_LAUNCHES`` those of them that ran a tensor-core kernel (all of them)
and ``F32_LAUNCHES`` those that ran the f32 one.
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
#: of those, the launches of the f32 (3xTF32) tensor-core kernel
F32_LAUNCHES = 0

#: C signature: 7 pointers, 8 ints, the scale, 5 ints, the stream
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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
                      q_offset: int) -> torch.Tensor:
    """Masked flash attention over the worklist ``(qi, ki, flags)``.

    q: (B, Hq, S, D) and k, v: (B, Hkv, T, D) with Hq % Hkv == 0 (query
    head h reads kv head h // (Hq // Hkv)); float32 or bfloat16.
    qi/ki/flags: (P,) int32 from ``build_schedule``.  Returns
    (B, Hq, S, D) in q.dtype.

    CPU tensors run ``flash_mask_plain``.  CUDA tensors launch the kernel
    once for every (batch, head) on the current stream without
    synchronising, or raise: the bf16 tensor-core kernel for bfloat16, the
    3xTF32 one for float32.  A q-block the worklist never visits comes
    out as zeros; a kv-block index out of range reads as fully masked.
    """
    global LAUNCHES, TC_LAUNCHES, F32_LAUNCHES
    _check(q, k, v, qi, ki, flags, bq, bk)
    dev = q.device
    kw = dict(bq=bq, bk=bk, scale=scale, causal=causal, window=window,
              prefix=prefix, q_offset=q_offset)
    if dev.type == "cpu":
        return flash_mask_plain(q, k, v, qi, ki, flags, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no flash_mask kernel for device {dev}")
    b, hq, s_q, d = q.shape
    if max(b * hq, s_q // bq) > 65535:
        raise ValueError(f"B * Hq = {b * hq} or S / bq = {s_q // bq} "
                         f"exceeds the grid's 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ki, flags = ki.contiguous(), flags.contiguous()
    out = torch.zeros_like(q)
    nq = s_q // bq
    # segment offsets of the qi-sorted worklist, on the device
    seg_ptr = torch.searchsorted(
        qi.contiguous(), torch.arange(nq + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    fn = _build.load("flash_mask", "flash_mask", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ki.data_ptr(),
            flags.data_ptr(), seg_ptr.data_ptr(), out.data_ptr(), b * hq, hq,
            k.shape[1], s_q, k.shape[2], d, bq, bk, float(scale),
            int(bool(causal)), int(window), int(prefix), int(q_offset),
            0 if q.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_mask kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    TC_LAUNCHES += 1
    if q.dtype == torch.float32:
        F32_LAUNCHES += 1
    return out
