#!/usr/bin/env python3
"""Host-to-device copy rates of the tile route's uploads on one GPU.

    python3 tools/upload_rates.py        # from the repository root

The tile-8192 call (``chip_smoke.py``) spends most of its time copying the
host CSR arrays to the card.  This times, on the largest of them (the
mask's int64 column indices, 39,845,888 entries, 319 MB), three ways to
copy a numpy array to the device, each ended by a synchronise, in turns:

  * pageable: ``torch.as_tensor(x, device=dev)``;
  * pinned: ``torch.from_numpy(x).pin_memory().to(dev, non_blocking=True)``
    (a host copy into page-locked memory, then DMA; the caching host
    allocator keeps the buffer for the next call);
  * staged: the array in 32 MB chunks through two reused page-locked
    buffers, each chunk's host copy overlapping the previous chunk's DMA;
  * staged int32: the same, each chunk narrowed to int32 as it is copied
    into the page-locked buffer, half the bytes to transfer (the indices
    fit), widened back to int64 on the device.

Prints the median milliseconds and GB/s of each over five turns.  Then
the whole warm tile-8192 call (``masked_spgemm`` as ``chip_smoke.py``
drives it) with the package's uploads (staged) paired against each other
way, ten pairs each, the first of each pair alternating: pageable copies,
and staged copies with the int64 index arrays narrowed to int32.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core.masked_spgemm import masked_spgemm  # noqa: E402

CHUNK = 32 << 20


def pageable(x, dev):
    return torch.as_tensor(x, device=dev)


def pinned(x, dev):
    return torch.from_numpy(x).pin_memory().to(dev, non_blocking=True)


class Staged:
    """Copies through two page-locked buffers of ``CHUNK`` bytes, in
    ``dtype`` (the array's own, or narrower), widened back on the
    device."""

    def __init__(self, dtype):
        n = CHUNK // torch.empty(0, dtype=dtype).element_size()
        self.bufs = [torch.empty(n, dtype=dtype, pin_memory=True)
                     for _ in range(2)]
        self.done = [None, None]

    def __call__(self, x, dev):
        src = torch.from_numpy(x)
        out = torch.empty(src.shape, dtype=self.bufs[0].dtype, device=dev)
        n = self.bufs[0].numel()
        for i, at in enumerate(range(0, src.numel(), n)):
            buf, part = self.bufs[i % 2], src[at:at + n]
            if self.done[i % 2] is not None:
                self.done[i % 2].synchronize()
            buf[:part.numel()].copy_(part)
            out[at:at + part.numel()].copy_(buf[:part.numel()],
                                           non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.done[i % 2] = ev
        return out.to(src.dtype)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 8192, 39_845_888, dtype=np.int64)
    ways = {"pageable": pageable, "pinned": pinned,
            "staged": Staged(torch.int64),
            "staged int32": Staged(torch.int32)}
    want = torch.from_numpy(x)
    for name, fn in ways.items():          # first calls: allocations
        assert torch.equal(fn(x, dev).cpu(), want), name
    times = {name: [] for name in ways}
    for turn in range(5):
        for name in (list(ways) if turn % 2 == 0 else list(ways)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ways[name](x, dev)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(f"{name}: {ms:.1f} ms median of 5 ({x.nbytes / ms / 1e6:.2f} "
              f"GB/s); turns " + ", ".join(f"{t:.1f}" for t in ts))
    print(f"host threads: torch {torch.get_num_threads()}")

    a, b, m = (F.block_sparse(8192, 128, 0.3, 0.9, seed=1),
               F.block_sparse(8192, 128, 0.3, 0.9, seed=2),
               F.block_sparse(8192, 128, 0.6, 1.0, seed=3, mask=True))
    A, B, M = (F.csr_from_dense(x) for x in (a, b, m))
    staged = F._to_device
    narrow = Staged(torch.int32)

    def int32(x, device):
        if x.dtype == np.int64 and x.nbytes >= F._STAGE_MIN_BYTES:
            return narrow(x, device)
        return staged(x, device)

    def call(to_device):
        F._to_device = to_device
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masked_spgemm(A, B, M, device=dev)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        finally:
            F._to_device = staged

    for name, other in (("pageable", pageable), ("staged int32", int32)):
        for fn in (staged, other):          # planning, allocations
            call(fn)
        times = {"staged": [], name: []}
        for pair in range(10):
            order = ((staged, "staged"), (other, name))
            for fn, key in (order if pair % 2 == 0 else order[::-1]):
                times[key].append(call(fn))
        wins = sum(x < y for x, y in zip(times["staged"], times[name]))
        for key, ts in times.items():
            q = statistics.quantiles(ts, n=4)
            print(f"tile call, {key} uploads: median "
                  f"{statistics.median(ts):.1f} ms, quartiles {q[0]:.1f} / "
                  f"{q[2]:.1f}; pairs " + ", ".join(f"{t:.1f}" for t in ts))
        print(f"tile call: staged faster than {name} in {wins} of 10 pairs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
