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
from typing import Optional, Tuple

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
    a = a.sorted_rows()
    m, n = a.shape
    row_nnz = a.row_nnz()
    w = int(width if width is not None
            else max(1, int(row_nnz.max(initial=0))))
    cols = np.full((m, w), n, dtype=np.int32)
    vals = np.zeros((m, w), dtype=np.float32)
    # slot of entry e is its offset within its row; entries beyond the
    # requested width are dropped
    rows = _expand_rows(a.indptr)
    slots = np.arange(a.nnz, dtype=np.int64) - a.indptr[rows]
    keep = slots < w
    cols[rows[keep], slots[keep]] = a.indices[keep]
    vals[rows[keep], slots[keep]] = a.data[keep]
    return PaddedCSR(
        torch.as_tensor(cols, device=device),
        torch.as_tensor(vals, dtype=dtype, device=device),
        torch.as_tensor(np.minimum(row_nnz, w).astype(np.int32),
                        device=device),
        (m, n))


# --------------------------------------------------------------------------
# Block-CSR: dense (bs x bs) tiles
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BCSR:
    """Block-CSR: indptr:(Mb+1,), indices:(nnzb,), blocks:(nnzb, bs, bs).

    ``indptr``/``indices`` live on the host (numpy) because they drive
    schedule construction (the symbolic phase); ``blocks`` is a tensor on
    the device the product runs on.
    """

    indptr: np.ndarray  # host
    indices: np.ndarray  # host, sorted per block-row
    blocks: torch.Tensor  # (nnzb, bs, bs)
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
    ``csr_from_coo``-built CSR satisfies this).
    """
    bs = block_size
    m, n = a.shape
    mb, nb = -(-m // bs), -(-n // bs)
    rows = _expand_rows(a.indptr)
    cols = a.indices
    key = (rows // bs) * nb + cols // bs
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((len(uniq), bs, bs), dtype=a.data.dtype)
    blocks[inv, rows % bs, cols % bs] = a.data
    ubr, ubc = uniq // nb, uniq % nb
    indptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(indptr, ubr + 1, 1)
    dev = torch.as_tensor(
        blocks, dtype=_canonical_dtype(blocks.dtype) if dtype is None
        else dtype, device=device)
    return BCSR(np.cumsum(indptr), ubc.astype(np.int64), dev, (m, n), bs)


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
