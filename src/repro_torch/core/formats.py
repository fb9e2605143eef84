"""Sparse matrix storage formats (host numpy + torch device tensors).

Three layers, as in the paper's CPU formats adapted to a batched device:

  * ``CSR``                    -- host-side (numpy) element format, used to
                                  build problems and as ground truth.
  * ``PaddedCSR`` (ELL-like)   -- device element format: every row is
                                  padded to a static width so the paper's
                                  row-parallel algorithms run as one batch.
  * ``BCSR``                   -- Block-CSR with dense (bs x bs) tiles; the
                                  tile route's block product runs on these.

All element formats keep column indices sorted within each row (the paper
assumes sorted inputs for MCA and Heap).  Stored index tensors are int32;
torch gathers want int64, so consumers convert at the point of use.

The host code and the generators' numpy draw order are identical to the
JAX package's ``repro.core.formats``, so both build bit-identical problems
from one seed.
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Host-side element CSR (numpy; problem setup + oracles)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CSR:
    """Host-side CSR. indptr:(m+1,) indices:(nnz,) data:(nnz,) shape:(m,n)."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        out[_expand_rows(self.indptr), self.indices] = self.data
        return out

    def transpose(self) -> "CSR":
        """CSR of the transpose (== CSC view of self)."""
        return csr_from_coo(
            self.indices,
            _expand_rows(self.indptr),
            self.data,
            (self.shape[1], self.shape[0]),
        )

    def sorted_rows(self) -> "CSR":
        rows = _expand_rows(self.indptr)
        order = np.lexsort((self.indices, rows))
        return CSR(self.indptr, self.indices[order], self.data[order],
                   self.shape)


def _expand_rows(indptr: np.ndarray) -> np.ndarray:
    """Row index of every nonzero, from indptr."""
    counts = np.diff(indptr)
    return np.repeat(np.arange(len(counts), dtype=np.int64), counts)


def csr_from_coo(rows, cols, vals, shape, sum_dups: bool = True) -> CSR:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_dups and len(rows):
        key = rows * shape[1] + cols
        uniq, inv = np.unique(key, return_inverse=True)
        new_vals = np.zeros(len(uniq), dtype=vals.dtype)
        np.add.at(new_vals, inv, vals)
        rows, cols, vals = uniq // shape[1], uniq % shape[1], new_vals
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr, cols.astype(np.int64), vals, shape)


def csr_from_dense(a: np.ndarray) -> CSR:
    rows, cols = np.nonzero(a)
    return csr_from_coo(rows, cols, a[rows, cols], a.shape, sum_dups=False)


# --------------------------------------------------------------------------
# Edge-batch deltas: incremental CSR updates for dynamic graphs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSRDelta:
    """A batch of edge mutations against one CSR operand.

    Records are applied in order (last write to a coordinate wins):
    ``delete[e]`` removes ``(rows[e], cols[e])`` if present (``vals[e]`` is
    ignored), otherwise the record upserts — overwriting an existing entry's
    value or inserting a new structural nonzero.
    """

    rows: np.ndarray      # (e,) int64
    cols: np.ndarray      # (e,) int64
    vals: np.ndarray      # (e,) value per record (ignored for deletes)
    delete: np.ndarray    # (e,) bool

    def __post_init__(self):
        object.__setattr__(self, "rows", np.asarray(self.rows, np.int64))
        object.__setattr__(self, "cols", np.asarray(self.cols, np.int64))
        object.__setattr__(self, "vals", np.asarray(self.vals))
        object.__setattr__(self, "delete", np.asarray(self.delete, bool))
        n = len(self.rows)
        if not (len(self.cols) == len(self.vals) == len(self.delete) == n):
            raise ValueError("CSRDelta fields must have equal length")

    @classmethod
    def upserts(cls, rows, cols, vals) -> "CSRDelta":
        rows = np.asarray(rows, np.int64)
        return cls(rows, cols, vals, np.zeros(len(rows), bool))

    @classmethod
    def deletes(cls, rows, cols) -> "CSRDelta":
        rows = np.asarray(rows, np.int64)
        return cls(rows, cols, np.zeros(len(rows), np.float32),
                   np.ones(len(rows), bool))

    @classmethod
    def concat(cls, deltas: Sequence["CSRDelta"]) -> "CSRDelta":
        return cls(np.concatenate([d.rows for d in deltas]),
                   np.concatenate([d.cols for d in deltas]),
                   np.concatenate([d.vals for d in deltas]),
                   np.concatenate([d.delete for d in deltas]))

    @property
    def changed_rows(self) -> np.ndarray:
        return np.unique(self.rows)

    def __len__(self) -> int:
        return len(self.rows)


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """Outcome of ``apply_csr_delta``: the post-delta CSR, which rows
    changed, whether the sparsity structure survived (values-only delta),
    and the incrementally maintained delta signature."""

    csr: CSR
    changed_rows: np.ndarray   # sorted unique rows any record touched
    values_only: bool          # True iff no row's column set changed
    signature: tuple           # incremental_signature(csr), updated in O(Δ)


_ISIG_MASK = (1 << 64) - 1


def _row_sig(i: int, cols: np.ndarray) -> int:
    """Salted 64-bit hash of one row's column set: the CRC of the columns,
    seeded with the CRC of the row index, spread to 64 bits by a splitmix
    finalizer (so the order-insensitive XOR across rows stays
    collision-resistant)."""
    crc = zlib.crc32(np.ascontiguousarray(cols, dtype=np.int64).tobytes(),
                     zlib.crc32(np.int64(i).tobytes()))
    z = (crc + 0x9E3779B97F4A7C15) & _ISIG_MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _ISIG_MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _ISIG_MASK
    return (z ^ (z >> 31)) & _ISIG_MASK


def incremental_signature(x: CSR) -> tuple:
    """Delta-maintainable structural identity: XOR of salted per-row hashes.

    Unlike ``planner.structure_signature`` (a whole-array CRC that any
    change recomputes from scratch), this form updates in O(changed rows):
    ``new = old ^ H(old changed rows) ^ H(new changed rows)``.  Equal
    signatures => equal sparsity structure (up to hash collision).
    """
    acc = 0
    for i in range(x.shape[0]):
        s, e = x.indptr[i], x.indptr[i + 1]
        acc ^= _row_sig(i, x.indices[s:e])
    return ("icsr", x.shape, x.nnz, acc)


def _rows_ascending(x: CSR) -> bool:
    """True when every row's columns are non-decreasing (the layout
    ``csr_from_coo`` builds): the columns may fall only where a row
    starts."""
    falls = np.flatnonzero(x.indices[1:] < x.indices[:-1]) + 1
    return bool(np.isin(falls, x.indptr).all())


def apply_csr_delta(a: CSR, delta: CSRDelta,
                    old_signature: Optional[tuple] = None) -> DeltaResult:
    """Apply an edge batch functionally: a new CSR with the unchanged rows'
    entries, the changed-row set, and the delta signature updated
    incrementally from ``old_signature`` (recomputed when absent).

    The result's arrays are ``csr_from_coo``'s (rows sorted by column).
    When ``a``'s rows already are, the changed rows are spliced into a copy
    of ``a`` in O(nnz) instead of re-sorting every entry.
    """
    m, n = a.shape
    if len(delta) and (delta.rows.min() < 0 or delta.rows.max() >= m
                       or delta.cols.min() < 0 or delta.cols.max() >= n):
        raise ValueError(f"delta coordinates outside shape {a.shape}")
    changed = delta.changed_rows
    if old_signature is not None and old_signature[:2] != ("icsr", a.shape):
        raise ValueError("old_signature does not match the operand")

    # per changed row: fold the record stream into the existing entries
    new_cols: dict = {}
    new_vals: dict = {}
    values_only = True
    for r in changed:
        cols0, vals0 = a.row(int(r))
        entries = dict(zip(cols0.tolist(), vals0.tolist()))
        sel = delta.rows == r
        for c, v, dele in zip(delta.cols[sel].tolist(),
                              delta.vals[sel].tolist(),
                              delta.delete[sel].tolist()):
            if dele:
                entries.pop(c, None)
            else:
                entries[c] = v
        cols1 = np.fromiter(sorted(entries), dtype=np.int64,
                            count=len(entries))
        new_cols[int(r)] = cols1
        new_vals[int(r)] = np.array([entries[c] for c in cols1],
                                    dtype=a.data.dtype)
        if values_only and not np.array_equal(cols0, cols1):
            values_only = False

    if _rows_ascending(a):
        counts = np.diff(a.indptr)
        counts[changed] = [len(new_cols[int(r)]) for r in changed]
        indptr = np.zeros(m + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        indices = np.empty(int(indptr[-1]), np.int64)
        data = np.empty(int(indptr[-1]), a.data.dtype)
        # the unchanged rows in runs between changed rows, then each
        # changed row
        for r0, r1 in zip(np.concatenate([[0], changed + 1]),
                          np.concatenate([changed, [m]])):
            s0, e0, s1 = a.indptr[r0], a.indptr[r1], indptr[r0]
            indices[s1:s1 + e0 - s0] = a.indices[s0:e0]
            data[s1:s1 + e0 - s0] = a.data[s0:e0]
        for r in changed:
            s, e = indptr[r], indptr[r + 1]
            indices[s:e] = new_cols[int(r)]
            data[s:e] = new_vals[int(r)]
        out = CSR(indptr, indices, data, a.shape)
    else:
        er = _expand_rows(a.indptr)
        touched = np.zeros(m, bool)
        touched[changed] = True
        keep = ~touched[er]
        all_rows = np.concatenate(
            [er[keep]] + [np.full(len(new_cols[int(r)]), r, np.int64)
                          for r in changed])
        all_cols = np.concatenate(
            [a.indices[keep]] + [new_cols[int(r)] for r in changed])
        all_vals = np.concatenate(
            [a.data[keep]] + [new_vals[int(r)] for r in changed])
        out = csr_from_coo(all_rows, all_cols, all_vals, a.shape,
                           sum_dups=False)
        out.data = out.data.astype(a.data.dtype, copy=False)

    if old_signature is not None:
        acc = old_signature[3]
        for r in changed:
            acc ^= _row_sig(int(r), a.row(int(r))[0])
            acc ^= _row_sig(int(r), new_cols[int(r)])
        sig = ("icsr", a.shape, out.nnz, acc)
    else:
        sig = incremental_signature(out)
    return DeltaResult(csr=out, changed_rows=changed,
                       values_only=values_only, signature=sig)


def _canonical_dtype(dtype: np.dtype) -> torch.dtype:
    """The device dtype of a host array: 64-bit floats and ints narrow to
    32 bits, as in the reference, so both packages hold equal blocks."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        dtype = np.dtype(np.float32)
    elif dtype == np.int64:
        dtype = np.dtype(np.int32)
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a torch tensor (copied off the device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# Device-side PaddedCSR (ELL): rows padded to a static width
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PaddedCSR:
    """ELL-style padded rows: cols:(m, w) int32, vals:(m, w), lens:(m,) int32.

    Padding columns hold ``ncols`` (an out-of-range sentinel that sorts after
    every real column, which keeps merge-based algorithms branch-free).
    """

    cols: torch.Tensor  # (m, w) int32, sorted ascending per row, pad = ncols
    vals: torch.Tensor  # (m, w)
    lens: torch.Tensor  # (m,) int32
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def valid(self) -> torch.Tensor:
        return self.cols < self.shape[1]

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n + 1), dtype=self.vals.dtype,
                          device=self.vals.device)
        contrib = torch.where(self.valid(), self.vals, 0)
        # padding lands in the dropped column n; real cols are unique per row
        out.scatter_add_(1, self.cols.long(), contrib)
        return out[:, :n]


def padded_from_csr(a: CSR, width: Optional[int] = None,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> PaddedCSR:
    """Pad ``a``'s rows to ``width`` (default: the widest row, at least 1)
    on ``device``: columns sorted within each row, entries beyond the
    width dropped.  One upload of ``a``; the sort and scatter run there."""
    d = _upload(a, device)
    w = _pad_width(a, width)
    cols, vals = _padded(d, d.rows(), w, with_vals=True)
    lens = torch.clamp(d.indptr[1:] - d.indptr[:-1], max=w).to(torch.int32)
    return PaddedCSR(cols, vals.to(dtype), lens, a.shape)


# --------------------------------------------------------------------------
# Device-side construction from a host CSR (one upload per CSR)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _DeviceCSR:
    """A host CSR's arrays on a device: int64 ``indptr``/``indices`` and
    ``data`` (None when only the structure was uploaded)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: Optional[torch.Tensor]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def rows(self) -> torch.Tensor:
        """Row index of every entry (``_expand_rows`` on the device)."""
        m = self.shape[0]
        return torch.repeat_interleave(
            torch.arange(m, device=self.indptr.device),
            self.indptr[1:] - self.indptr[:-1], output_size=self.nnz)


def _upload(a: CSR, device, data: bool = True) -> _DeviceCSR:
    """Copy ``a``'s index arrays (and, with ``data``, its values, in their
    host dtype) to ``device`` once."""
    def put(x):
        return _to_device(x, device)
    return _DeviceCSR(put(a.indptr).long(), put(a.indices).long(),
                      put(a.data) if data else None, a.shape)


class _Staging:
    """Copies host arrays to a CUDA device in ``chunk``-byte pieces through
    two reused page-locked buffers, each piece's host copy overlapping the
    previous piece's transfer.  On an NVIDIA H100 80GB HBM3 host this moved
    20-26 GB/s where a copy from pageable memory moved 5.3-6.3
    (``tools/upload_rates.py``)."""

    def __init__(self, chunk: int = 32 << 20):
        self.chunk = chunk
        self.lock = threading.Lock()
        self.bufs = None
        self.done = [None, None]      # each buffer's last transfer

    def __call__(self, x: np.ndarray, device: torch.device) -> torch.Tensor:
        src = torch.from_numpy(x.reshape(-1).view(np.uint8))
        out = torch.empty(x.shape, dtype=torch.from_numpy(x[:0]).dtype,
                          device=device)
        dst = out.view(-1).view(torch.uint8)
        with self.lock, torch.cuda.device(device):
            if self.bufs is None:
                self.bufs = [torch.empty(self.chunk, dtype=torch.uint8,
                                         pin_memory=True) for _ in range(2)]
            for i, at in enumerate(range(0, src.numel(), self.chunk)):
                part, j = src[at:at + self.chunk], i % 2
                if self.done[j] is not None:
                    self.done[j].synchronize()
                buf = self.bufs[j][:part.numel()]
                buf.copy_(part)
                dst[at:at + part.numel()].copy_(buf, non_blocking=True)
                self.done[j] = torch.cuda.Event()
                self.done[j].record()
        return out


_STAGING = _Staging()
#: host arrays at least this large go to a CUDA device through ``_STAGING``
_STAGE_MIN_BYTES = 1 << 20


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)``, staged through page-locked
    memory for large copies to a CUDA device."""
    x = np.ascontiguousarray(x)
    device = torch.device(device)
    if device.type == "cuda" and x.nbytes >= _STAGE_MIN_BYTES:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _STAGING(x, device)
    return torch.as_tensor(x, device=device)


def _pad_width(a: CSR, width: Optional[int]) -> int:
    return int(width if width is not None
               else max(1, int(a.row_nnz().max(initial=0))))


def _slots(d: _DeviceCSR, rows: torch.Tensor, w: int) -> torch.Tensor:
    """Flat position ``row * w + slot`` of every entry in a (m, w) padded
    array, the slot being its offset within its row; entries at a slot
    beyond ``w`` go to the spare position m * w, which callers drop."""
    slot = torch.arange(d.nnz, device=rows.device) - d.indptr[rows]
    return torch.where(slot < w, rows * w + slot, d.shape[0] * w)


def _padded(d: _DeviceCSR, rows: torch.Tensor, w: int, *,
            with_vals: bool, dest: Optional[torch.Tensor] = None):
    """(cols, vals) of ``padded_from_csr``: (m, w) int32 columns, padded
    with ncols, and, ``with_vals``, (m, w) float32 values (else None).
    Rows whose columns are not ascending are sorted first, stably, which
    is ``np.lexsort((indices, rows))``'s order; ``dest`` is ``_slots``'s
    (computed here unless given)."""
    m, n = d.shape
    dev = rows.device
    cols_in, vals_in = d.indices, d.data
    key = rows * n + cols_in
    if not bool((key[1:] >= key[:-1]).all()):
        order = torch.sort(key, stable=True).indices
        cols_in = cols_in[order]
        vals_in = vals_in[order] if with_vals else None
    if dest is None:
        dest = _slots(d, rows, w)
    cols = torch.full((m * w + 1,), n, dtype=torch.int32, device=dev)
    cols[dest] = cols_in.to(torch.int32)
    vals = None
    if with_vals:
        vals = torch.zeros(m * w + 1, dtype=torch.float32, device=dev)
        vals[dest] = vals_in.to(torch.float32)
        vals = vals[:-1].view(m, w)
    return cols[:-1].view(m, w), vals


# --------------------------------------------------------------------------
# Block-CSR: dense (bs x bs) tiles
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BCSR:
    """Block-CSR: indptr:(Mb+1,), indices:(nnzb,), blocks:(nnzb, bs, bs).

    ``indptr``/``indices`` live on the host (numpy) because they drive
    schedule construction (the symbolic phase); ``blocks`` is a tensor on
    the device the product runs on, or None in a structure-only BCSR (the
    tile route's mask, whose values nothing reads).
    """

    indptr: np.ndarray  # host
    indices: np.ndarray  # host, sorted per block-row
    blocks: Optional[torch.Tensor]  # (nnzb, bs, bs), None: structure only
    shape: Tuple[int, int]  # element shape
    block_size: int

    @property
    def nnzb(self) -> int:
        return int(self.indices.shape[0])

    @property
    def block_rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def block_cols(self) -> int:
        return -(-self.shape[1] // self.block_size)

    def block_row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]: self.indptr[i + 1]]

    def to_dense(self) -> np.ndarray:
        if self.blocks is None:
            raise ValueError("a structure-only BCSR has no values")
        bs = self.block_size
        mb, nb = self.block_rows, self.block_cols
        blocks = to_numpy(self.blocks)
        out = np.zeros((mb, nb, bs, bs), dtype=blocks.dtype)
        brow = np.repeat(np.arange(mb, dtype=np.int64), np.diff(self.indptr))
        out[brow, self.indices] = blocks
        out = out.transpose(0, 2, 1, 3).reshape(mb * bs, nb * bs)
        return out[: self.shape[0], : self.shape[1]]


def bcsr_from_dense(a: np.ndarray, block_size: int, prune_zero: bool = True,
                    device="cuda") -> BCSR:
    a = np.asarray(a)
    m, n = a.shape
    bs = block_size
    mb, nb = -(-m // bs), -(-n // bs)
    padded = np.zeros((mb * bs, nb * bs), dtype=a.dtype)
    padded[:m, :n] = a
    tiles = padded.reshape(mb, bs, nb, bs).transpose(0, 2, 1, 3)
    nz = (np.abs(tiles).sum(axis=(2, 3)) != 0 if prune_zero
          else np.ones((mb, nb), bool))
    rows, cols = np.nonzero(nz)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    blocks = tiles[rows, cols] if len(rows) else np.zeros((0, bs, bs), a.dtype)
    dev = torch.as_tensor(np.ascontiguousarray(blocks),
                          dtype=_canonical_dtype(blocks.dtype), device=device)
    return BCSR(indptr, cols.astype(np.int64), dev, (m, n), bs)


def bcsr_from_csr(a: CSR, block_size: int, dtype=None,
                  device="cuda") -> BCSR:
    """Direct CSR -> BCSR: scatter entries into only the occupied blocks.

    Never materializes the dense matrix — memory is O(nnzb * bs^2), bounded
    by the input's block structure.  Rows/cols beyond the last full block
    are padded into partial edge blocks (zero filled), same layout as
    ``bcsr_from_dense``.  Assumes ``a`` has no duplicate entries (every
    ``csr_from_coo``-built CSR satisfies this).  The blocks are built on
    ``device`` from one upload of ``a``; only the block structure
    (``indptr``, ``indices``) comes back to the host.
    """
    d = _upload(a, device)
    rows = d.rows()
    uniq, inv = _block_keys(d, rows, block_size)
    dt = _canonical_dtype(a.data.dtype) if dtype is None else dtype
    blocks = _scatter_blocks(len(uniq), block_size, dt, _block_offsets(
        d, rows, inv, block_size), d.data.to(dt))
    return _bcsr_of_keys(uniq, blocks, a.shape, block_size)


def _block_keys(d: _DeviceCSR, rows: torch.Tensor, bs: int):
    """(sorted unique block keys ``block_row * nb + block_col``, the
    position of every entry's block among them)."""
    nb = -(-d.shape[1] // bs)
    key = (rows // bs) * nb + d.indices // bs
    return torch.unique(key, sorted=True, return_inverse=True)


def _block_offsets(d: _DeviceCSR, rows, inv, bs: int) -> torch.Tensor:
    """Flat offset of every entry in a (nnzb, bs, bs) block array."""
    return (inv * bs + rows % bs) * bs + d.indices % bs


def _scatter_blocks(nnzb: int, bs: int, dtype, flat, src) -> torch.Tensor:
    """Zero (nnzb, bs, bs) blocks with ``src`` (a tensor or a scalar) put
    at the flat offsets (no accumulation: the entries are distinct)."""
    blocks = torch.zeros(nnzb * bs * bs, dtype=dtype, device=flat.device)
    blocks[flat] = src
    return blocks.view(nnzb, bs, bs)


def _bcsr_of_keys(uniq: torch.Tensor, blocks, shape, bs: int) -> BCSR:
    """A BCSR whose host ``indptr``/``indices`` come from the sorted block
    keys; ``blocks`` None makes it structure only."""
    m, n = shape
    mb, nb = -(-m // bs), -(-n // bs)
    indptr = torch.searchsorted(
        uniq, torch.arange(mb + 1, device=uniq.device) * nb)
    return BCSR(indptr.cpu().numpy(), (uniq % nb).cpu().numpy(), blocks,
                shape, bs)


def _bcsr_with_pattern(d: _DeviceCSR, bs: int) -> Tuple[BCSR, torch.Tensor]:
    """f32 ``bcsr_from_csr`` blocks of ``d`` and, from the same key pass,
    its bf16 stored-entry pattern blocks: 1 at every CSR entry, an
    explicitly stored 0.0 included (it is structural to the row
    kernels)."""
    rows = d.rows()
    uniq, inv = _block_keys(d, rows, bs)
    flat = _block_offsets(d, rows, inv, bs)
    del rows, inv
    values = _scatter_blocks(len(uniq), bs, torch.float32, flat,
                             d.data.to(torch.float32))
    pattern = _scatter_blocks(len(uniq), bs, torch.bfloat16, flat, 1)
    return _bcsr_of_keys(uniq, values, d.shape, bs), pattern


def _bcsr_structure(d: _DeviceCSR, rows: torch.Tensor, bs: int
                    ) -> Tuple[BCSR, torch.Tensor]:
    """The block structure of ``d`` without value blocks (a BCSR whose
    ``blocks`` is None), and the position of every entry's block."""
    uniq, inv = _block_keys(d, rows, bs)
    return _bcsr_of_keys(uniq, None, d.shape, bs), inv


def bcsr_apply_delta(b: BCSR, new: CSR, changed_rows: np.ndarray) -> BCSR:
    """Update a BCSR mirror of ``new`` after a delta touching
    ``changed_rows``, on the device ``b.blocks`` lives on.  The result is
    ``bcsr_from_csr(new)`` (the reference rebuilds only the affected block
    rows; on the card one key pass over every entry is faster than
    splicing the changed block rows into the old blocks).  A
    structure-only ``b`` (``blocks`` None) stays structure only.
    """
    if b.shape != new.shape:
        raise ValueError("BCSR/CSR shape mismatch")
    if len(changed_rows) == 0:
        return b
    bs = b.block_size
    if b.blocks is None:
        d = _upload(new, "cpu", data=False)
        return _bcsr_structure(d, d.rows(), bs)[0]
    return bcsr_from_csr(new, bs, dtype=b.blocks.dtype,
                         device=b.blocks.device)


def bcsr_to_csr(a: BCSR, prune_zero: bool = True) -> CSR:
    """Inverse of ``bcsr_from_csr``: element CSR of the stored blocks.

    With ``prune_zero`` (default) only numerically nonzero elements are
    kept — the result-extraction contract of the tile pipeline, where the
    output's element structure is the nonzeros the masked product actually
    produced.  Elements in the zero-padded edge region (beyond ``shape``)
    are always dropped.
    """
    bs = a.block_size
    m, n = a.shape
    blocks = to_numpy(a.blocks)
    brow = np.repeat(np.arange(a.block_rows, dtype=np.int64),
                     np.diff(a.indptr))
    if prune_zero:
        p, r, c = np.nonzero(blocks)
    else:
        p, r, c = (x.ravel() for x in np.indices(blocks.shape))
    rows = brow[p] * bs + r
    cols = a.indices[p] * bs + c
    keep = (rows < m) & (cols < n)
    return csr_from_coo(rows[keep], cols[keep], blocks[p, r, c][keep],
                        (m, n), sum_dups=False)


def bcsr_block_positions(a: BCSR, bi: np.ndarray, bj: np.ndarray
                         ) -> np.ndarray:
    """Positions in ``a.blocks`` of blocks (bi[t], bj[t]); -1 when absent.

    Relies on the BCSR invariant that blocks are stored in row-major
    (block-row, block-col) order, so a single searchsorted resolves every
    query.
    """
    nb = a.block_cols
    brow = np.repeat(np.arange(a.block_rows, dtype=np.int64),
                     np.diff(a.indptr))
    keys = brow * nb + a.indices
    q = np.asarray(bi, dtype=np.int64) * nb + np.asarray(bj, dtype=np.int64)
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, max(0, len(keys) - 1))
    ok = ((pos < len(keys)) & (keys[pos_c] == q) if len(keys)
          else np.zeros(len(q), dtype=bool))
    return np.where(ok, pos, -1)


def bcsr_structure_transpose(a: BCSR
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Column-major view of the block structure: (indptr_T, rows_T, pos_T).

    ``pos_T[p]`` is the position in ``a.blocks`` of the p-th block when
    traversing column-by-column.  Used to build pull-based schedules.
    """
    mb = a.block_rows
    nb = a.block_cols
    rows = np.repeat(np.arange(mb, dtype=np.int64), np.diff(a.indptr))
    cols = a.indices
    pos = np.arange(a.nnzb, dtype=np.int64)
    order = np.lexsort((rows, cols))
    rows_t, cols_t, pos_t = rows[order], cols[order], pos[order]
    indptr_t = np.zeros(nb + 1, dtype=np.int64)
    np.add.at(indptr_t, cols_t + 1, 1)
    return np.cumsum(indptr_t), rows_t, pos_t


# --------------------------------------------------------------------------
# BCSR panel helpers (the distributed ring: row panels and K-slabs)
# --------------------------------------------------------------------------


def bcsr_pad_block_rows(a: BCSR, target_block_rows: int) -> BCSR:
    """Append empty block rows so ``a`` has exactly ``target_block_rows``.

    The element shape grows with the padding (the new rows are structurally
    empty), so downstream panel splits see equal shards.
    """
    mb = a.block_rows
    if target_block_rows < mb:
        raise ValueError(f"cannot shrink {mb} block rows to "
                         f"{target_block_rows}")
    if target_block_rows == mb:
        return a
    indptr = np.concatenate([
        a.indptr,
        np.full(target_block_rows - mb, a.indptr[-1], dtype=a.indptr.dtype)])
    return BCSR(indptr, a.indices, a.blocks,
                (target_block_rows * a.block_size, a.shape[1]), a.block_size)


def bcsr_row_panels(a: BCSR, nparts: int) -> Tuple[BCSR, ...]:
    """Split ``a`` into ``nparts`` equal block-row panels.

    Requires ``a.block_rows % nparts == 0`` (pad first via
    ``bcsr_pad_block_rows``).  Each panel's ``indptr`` is rebased to start
    at 0 and stays on the host; its ``blocks`` is a view (slice) of the
    parent's device tensor (None for a structure-only BCSR), so
    panel-local schedule positions index the panel directly.
    """
    mb = a.block_rows
    if mb % nparts:
        raise ValueError(f"{mb} block rows do not split into {nparts} panels")
    rows_per = mb // nparts
    out = []
    for d in range(nparts):
        lo, hi = d * rows_per, (d + 1) * rows_per
        s, e = int(a.indptr[lo]), int(a.indptr[hi])
        out.append(BCSR(a.indptr[lo:hi + 1] - a.indptr[lo],
                        a.indices[s:e],
                        None if a.blocks is None else a.blocks[s:e],
                        (rows_per * a.block_size, a.shape[1]),
                        a.block_size))
    return tuple(out)


def bcsr_concat_row_panels(panels: Sequence[BCSR]) -> BCSR:
    """Inverse of ``bcsr_row_panels``: stack block-row panels vertically
    (the blocks concatenated on the first panel's device; None when the
    panels are structure only)."""
    if not panels:
        raise ValueError("no panels")
    bs = panels[0].block_size
    ncols = panels[0].shape[1]
    indptrs = [panels[0].indptr]
    offset = panels[0].indptr[-1]
    for p in panels[1:]:
        if p.block_size != bs or p.shape[1] != ncols:
            raise ValueError("panels differ in block size or columns")
        indptrs.append(p.indptr[1:] + offset)
        offset = offset + p.indptr[-1]
    blocks = None
    if panels[0].blocks is not None:
        dev = panels[0].blocks.device
        blocks = torch.cat([p.blocks.to(dev) for p in panels])
    return BCSR(np.concatenate(indptrs),
                np.concatenate([p.indices for p in panels]),
                blocks, (sum(p.shape[0] for p in panels), ncols), bs)


# --------------------------------------------------------------------------
# Random sparse generators (paper Sec. 7: Erdos-Renyi and R-MAT/Graph500)
# --------------------------------------------------------------------------


def erdos_renyi(n: int, avg_degree: float, seed: int = 0,
                values: str = "uniform") -> CSR:
    """ER(n, d): each row has ~Poisson(d) nonzeros at uniform columns."""
    rng = np.random.default_rng(seed)
    nnz = rng.poisson(avg_degree, size=n)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz)
    cols = rng.integers(0, n, size=int(nnz.sum()), dtype=np.int64)
    if values == "ones":
        vals = np.ones(len(rows), dtype=np.float32)
    else:
        vals = rng.uniform(0.5, 1.5, size=len(rows)).astype(np.float32)
    return csr_from_coo(rows, cols, vals, (n, n))


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         symmetric: bool = True, remove_self_loops: bool = True) -> CSR:
    """R-MAT generator with Graph500 parameters (a,b,c,d)=(.57,.19,.19,.05)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(m)
        ab = a + b
        abc = a + b + c
        go_right = ((r >= a) & (r < ab)) | (r >= abc)
        go_down = r >= ab
        rows |= go_down.astype(np.int64) << lvl
        cols |= go_right.astype(np.int64) << lvl
    if remove_self_loops:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    vals = np.ones(len(rows), dtype=np.float32)
    out = csr_from_coo(rows, cols, vals, (n, n))
    out.data[:] = 1.0  # binarize: duplicate edges must not create weights
    return out


def er_mask(n: int, d: float, seed: int) -> CSR:
    """ER-pattern mask: ~Poisson(d) ones per row at uniform columns (the
    mask family of the paper's Fig. 7 density sweep)."""
    rng = np.random.default_rng(seed)
    nnz = rng.poisson(d, size=n)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz)
    cols = rng.integers(0, n, size=int(nnz.sum()), dtype=np.int64)
    return csr_from_coo(rows, cols, np.ones(len(rows), np.float32), (n, n))


def block_sparse(n: int, bs: int, tile_density: float,
                 within_density: float, seed: int,
                 mask: bool = False) -> np.ndarray:
    """Block-structured sparse matrix as a DENSE (n, n) float32 array:
    (bs x bs) tiles occupied w.p. ``tile_density``, elements inside an
    occupied tile w.p. ``within_density``; integer values in [1, 5)
    unless ``mask`` (then 0/1).  The draw order is the reference's.
    """
    rng = np.random.default_rng(seed)
    nb = n // bs
    tiles = rng.random((nb, nb)) < tile_density
    if not tiles.any():
        tiles[0, 0] = True
    dense = np.kron(tiles, np.ones((bs, bs))) * (rng.random((n, n))
                                                 < within_density)
    if mask:
        return dense.astype(np.float32)
    return (dense * rng.integers(1, 5, (n, n))).astype(np.float32)


def tril(a: CSR, strict: bool = True) -> CSR:
    rows = _expand_rows(a.indptr)
    keep = a.indices < rows if strict else a.indices <= rows
    return csr_from_coo(rows[keep], a.indices[keep], a.data[keep], a.shape,
                        sum_dups=False)
