"""Distributed Masked SpGEMM over a mesh of devices (beyond-paper scale-out).

The paper is a shared-memory study; its row-parallel decomposition extends
naturally across a mesh:

* ``row_parallel_masked_spgemm`` — 1D: rows of A and M are sharded over the
  mesh, B is replicated.  No communication in the numeric phase (the
  paper's OpenMP loop, across devices): the regime for nnz(B) small
  against the mesh's memory, typical graph masks.

* ``ring_sparse_masked_spgemm`` — 1.5D sparse ring-SUMMA on BCSR operands
  for a B too large to replicate: A/M row-block panels are sharded, B's
  occupied BCSR K-slabs rotate around the ring (each slab = its value and
  stored-entry pattern blocks, padded to the ring-wide maximum).  Each
  stage replays a host-built K-slab worklist on the fused ``block_spgemm``
  kernel (values and structural counts in one launch); no dense ``(k, n)``
  or ``(m, n)`` array exists anywhere on this path.

* ``ring_masked_matmul`` — the dense 1.5D ring (tile-granular skipping),
  kept for dense-operand workloads and as the baseline the sparse ring is
  measured against.

``distributed_masked_spgemm`` is the user's entry point: it takes
host CSR operands plus a mesh and elects row-parallel or the sparse ring
through the planner's distributed cost model (``planner.plan_distributed``).
``python -m repro_torch.tune --only dist`` refits that model's
``DIST_COST`` constants from measured probes on a mesh.

The mesh.  The reference runs its p shards in one process under jax's
``shard_map``.  The port's ``Mesh`` is a one-process mesh too: one named
axis over a list of ``torch.device``s, repeats allowed, so p shards can
share one card.  Shard d's work is issued on ``mesh.devices[d]``; a ring
rotation is ``tensor.to(next_device, non_blocking=True)``, which copies
nothing where the next shard lies on the same device (a real ring's link
traffic is the ring state's ``link_bytes()`` all the same).  Results
are gathered on ``mesh.devices[0]``.  A ``torch.distributed`` backend (one
process per card) waits for a host with more than one GPU.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import caches, obs

from .formats import (BCSR, CSR, PaddedCSR, _DeviceCSR, _pad_width, _padded,
                      _to_device, _upload, bcsr_row_panels, padded_from_csr)
from .masked_spgemm import MaskedSpGEMMResult, _masked_spgemm_padded
from .semiring import Semiring, PLUS_TIMES

# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class Mesh:
    """A one-process device mesh along one named axis: shard d runs on
    ``devices[d]``; a device may appear more than once.

    ``shape`` maps the axis name to the shard count and ``devices`` is a
    numpy object array, as on a jax mesh, so ``int(mesh.shape[axis])``
    and ``serving.batcher.mesh_key`` read it unchanged.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = (
            "data",)):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        names = tuple(axis_names)
        if len(names) != 1:
            raise ValueError(f"the mesh has one axis, got axis names "
                             f"{names}")
        self.axis_names = names
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.shape = {names[0]: len(devs)}


def make_mesh(p: int, device="cuda", axis: str = "data") -> Mesh:
    """A ``p``-shard mesh.  On ``"cuda"`` the shards cycle over the visible
    cards (on a one-card host every shard shares card 0); any other device,
    ``"cpu"`` or ``"cuda:1"``, holds every shard."""
    if p < 1:
        raise ValueError(f"a mesh needs p >= 1 shards, got {p}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: device 'cuda' requested but CUDA "
                               "is not available")
        return Mesh([torch.device("cuda", i % count) for i in range(p)],
                    (axis,))
    return Mesh([dev] * p, (axis,))


def _axis_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return int(np.prod([int(mesh.shape[a]) for a in axes]))


def _rotate(held: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Shard d's tensor moves to shard d + 1 (mod p): a copy where that
    shard lies on another device, the same tensor where it does not."""
    p = len(held)
    return [held[(d - 1) % p].to(devices[d], non_blocking=True)
            for d in range(p)]


def _gather_rows(parts: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """The shards' row blocks stacked on ``dev``."""
    return torch.cat([x.to(dev) for x in parts])


# ---------------------------------------------------------------------------
# 1D row-parallel: the paper's decomposition across the mesh
# ---------------------------------------------------------------------------


def _padded_on(x: PaddedCSR, dev, rows: slice = slice(None)) -> PaddedCSR:
    """Rows ``rows`` of ``x`` on ``dev`` (no copy where they are there)."""
    cols = x.cols[rows].to(dev)
    return PaddedCSR(cols, x.vals[rows].to(dev), x.lens[rows].to(dev),
                     (cols.shape[0], x.shape[1]))


def row_parallel_masked_spgemm(A: PaddedCSR, B: PaddedCSR, M: PaddedCSR,
                               mesh: Mesh, *, algorithm: str = "msa",
                               semiring: Semiring = PLUS_TIMES,
                               complement: bool = False,
                               n_inspect: Optional[int] = None,
                               axes: Sequence[str] = ("data",)):
    """C = M (.) (A B), rows of A/M sharded over ``axes``, B replicated.

    Shard d's rows of A and M go to ``mesh.devices[d]`` with a copy of B
    (one per distinct device) and run the row program there.  Returns
    (vals, present) mask-aligned; where the reference returns an array
    sharded like the mask rows, the port concatenates the shards on
    ``mesh.devices[0]``.  The row count must split evenly (see
    ``pad_rows_to``).  For ``algorithm="inner"`` pass B already transposed
    (PaddedCSR of B^T, the single-device call's contract); the output
    shape comes from the mask, so a transposed B never skews it.
    """
    p = _axis_size(mesh, axes)
    m, n = M.shape
    if m % p:
        raise ValueError(f"{m} rows do not split into {p} shards; pad them "
                         f"with pad_rows_to")
    rows = m // p
    replicas = {}
    vals, present = [], []
    for d, dev in enumerate(mesh.devices):
        if str(dev) not in replicas:
            replicas[str(dev)] = _padded_on(B, dev)
        shard = slice(d * rows, (d + 1) * rows)
        v, pr = _masked_spgemm_padded(
            _padded_on(M, dev, shard), _padded_on(A, dev, shard),
            replicas[str(dev)], algorithm=algorithm, sr=semiring,
            complement=complement, n_inspect=n_inspect, shape=(rows, n),
            kdim=A.shape[1])
        vals.append(v)
        present.append(pr)
    dev0 = mesh.devices[0]
    return _gather_rows(vals, dev0), _gather_rows(present, dev0)


# ---------------------------------------------------------------------------
# 1.5D ring-SUMMA masked matmul (tile-granular, dense panels)
# ---------------------------------------------------------------------------


def _check_f32_matmuls(precision, devices) -> None:
    """f32 products stay f32: one TF32 pass is far outside f32 accuracy."""
    if precision not in (None, "highest"):
        raise ValueError(f"precision must be None or 'highest' (IEEE f32 "
                         f"products), got {precision!r}")
    if (any(torch.device(d).type == "cuda" for d in devices)
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the "
                           "dense ring keeps f32 products in f32: switch it "
                           "off")


def _needed_runs(needed: torch.Tensor) -> List[Tuple[int, int]]:
    """[start, end) runs of consecutive True tile columns (host lists)."""
    runs, start = [], None
    for j, on in enumerate(needed.tolist() + [False]):
        if on and start is None:
            start = j
        elif not on and start is not None:
            runs.append((start, j))
            start = None
    return runs


def ring_masked_matmul(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                       mesh: Mesh, *, axis: str = "data", block: int = 128,
                       precision=None) -> torch.Tensor:
    """C = mask (.) (A B) with A row-sharded and B K-sharded over ``axis``.

    a: (m, k); b: (k, n); mask: (m, n) {0, 1}; m and k split evenly over
    the axis.  Shard d takes rows d of a and mask and K-panel d of b onto
    ``mesh.devices[d]``.

    Tile-granular skipping, per stage: each shard computes its mask's
    block-level occupancy once (any nonzero per ``block x block`` tile);
    every ring stage issues the local product only over runs of output
    column panels that hold an allowed tile.  After the loop, disallowed
    output tiles are zeroed at block granularity and the element mask
    applied once.  The last stage is peeled, so a call makes p - 1
    rotations of one B panel per shard.  Products accumulate in f32 (the
    reference's preferred element type); f32 operands multiply in IEEE
    f32, never TF32 (``precision`` None or ``"highest"``).

    Returns the (m, n) result, in a's dtype, on ``mesh.devices[0]``.
    """
    p = int(mesh.shape[axis])
    devs = list(mesh.devices)
    _check_f32_matmuls(precision, devs)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or tuple(mask.shape) != (m, n):
        raise ValueError(f"shapes do not chain: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, mask {tuple(mask.shape)}")
    if m % p or k % p:
        raise ValueError(f"m = {m} and k = {k} must split evenly over "
                         f"{p} shards")
    m_loc, k_per = m // p, k // p
    tm, tn = min(block, m_loc), min(block, n)
    pad_m, pad_n = -m_loc % tm, -n % tn
    tiles_m, tiles_n = (m_loc + pad_m) // tm, (n + pad_n) // tn

    masks, occ, runs, a_pad, acc, panels = [], [], [], [], [], []
    for d, dev in enumerate(devs):
        rows = slice(d * m_loc, (d + 1) * m_loc)
        m_blk = mask[rows].to(dev)
        o = torch.nn.functional.pad(m_blk != 0, (0, pad_n, 0, pad_m))
        o = o.reshape(tiles_m, tm, tiles_n, tn).any(dim=3).any(dim=1)
        masks.append(m_blk)
        occ.append(o)
        runs.append(_needed_runs(o.any(dim=0)))
        a_pad.append(torch.nn.functional.pad(
            a[rows].to(dev, torch.float32), (0, 0, 0, pad_m)))
        acc.append(torch.zeros((m_loc + pad_m, n + pad_n),
                               dtype=torch.float32, device=dev))
        panels.append(torch.nn.functional.pad(
            b[d * k_per:(d + 1) * k_per].to(dev, torch.float32),
            (0, pad_n)))
    for s in range(p):
        for d in range(p):
            src = (d - s) % p            # whose K-panel shard d now holds
            a_slice = a_pad[d][:, src * k_per:(src + 1) * k_per]
            for j0, j1 in runs[d]:
                cols = slice(j0 * tn, j1 * tn)
                acc[d][:, cols].addmm_(a_slice, panels[d][:, cols])
        if s < p - 1:
            panels = _rotate(panels, devs)

    out = []
    for d in range(p):
        occ_elem = occ[d].repeat_interleave(tm, 0).repeat_interleave(tn, 1)
        c = torch.where(occ_elem, acc[d], 0.0)[:m_loc, :n]
        out.append(torch.where(masks[d] != 0, c, 0.0).to(a.dtype))
    return _gather_rows(out, devs[0])


# ---------------------------------------------------------------------------
# 1.5D sparse ring-SUMMA on BCSR panels (densify-free distributed tile route)
# ---------------------------------------------------------------------------


def _panel_scatter(d: _DeviceCSR, bs: int, p: int):
    """Per-entry scatter coordinates into a (p, W, bs, bs) stacked panel
    array plus the panel block structure, from one key pass on ``d``'s
    device.

    Returns ``(indptr_pad, indices, panel, local, r, c, w)``: entry e of
    the CSR lands in ``stacked[panel[e], local[e], r[e], c[e]]`` (int64
    tensors on the device); the padded block structure ``indptr_pad`` /
    ``indices`` comes back to the host for the schedules; ``w`` is the
    max panel nnzb (the ring-wide pad).  Pure structure: values are
    scattered per call.  Panels are block-row ranges and CSR entries come
    in row order, so ``panel`` is nondecreasing.
    """
    m, n = d.shape
    nb = -(-n // bs)
    mb = -(-m // bs)
    mb_pad = -(-mb // p) * p
    rows = d.rows()
    uniq, inv = torch.unique((rows // bs) * nb + d.indices // bs,
                             sorted=True, return_inverse=True)
    indptr = torch.searchsorted(
        uniq, torch.arange(mb_pad + 1, device=uniq.device) * nb)
    rows_per = mb_pad // p
    panel_of_block = (uniq // nb) // rows_per
    local_of_block = (torch.arange(len(uniq), device=uniq.device)
                      - indptr[panel_of_block * rows_per])
    w = max(1, int(torch.bincount(panel_of_block, minlength=p).max()))
    return (indptr.cpu().numpy(), (uniq % nb).cpu().numpy(),
            panel_of_block[inv], local_of_block[inv], rows % bs,
            d.indices % bs, w)


def _struct_panels(indptr: np.ndarray, indices: np.ndarray, p: int, bs: int,
                   ncols: int) -> Tuple[BCSR, ...]:
    """Structure-only BCSR row panels (``blocks`` None: the schedule build
    never reads them)."""
    full = BCSR(indptr, indices, None, ((len(indptr) - 1) * bs, ncols), bs)
    return bcsr_row_panels(full, p)


@dataclasses.dataclass
class _Shard:
    """One shard's structure on its device: where its A and B entries land
    in its zero-padded (w, bs, bs) panels (``a_rows``/``b_rows`` are its
    CSR entry ranges), its stored-entry pattern panels, its (p, 4, Ws)
    worklists and its extraction addressing (flat sources in the output
    blocks, flat destinations in its (rows_loc, pm) result rows)."""

    device: torch.device
    a_rows: Tuple[int, int]
    a_flat: torch.Tensor
    a_pat: torch.Tensor
    b_rows: Tuple[int, int]
    b_flat: torch.Tensor
    b_pat: torch.Tensor
    sched: torch.Tensor
    ex_src: torch.Tensor
    ex_dst: torch.Tensor


@dataclasses.dataclass
class _RingState:
    """What a ring call needs besides the operands' values: per-shard
    device structure, the padded sizes and the mask's padded columns on
    the gathering device."""

    shards: List[_Shard]
    bs: int
    wa: int
    wb: int
    wm_blocks: int
    rows_loc: int
    pm: int
    mask_cols: torch.Tensor

    def nbytes(self) -> int:
        """Bytes the state holds on its devices (what the cache bounds)."""
        return self.mask_cols.nbytes + sum(
            getattr(sh, f.name).nbytes for sh in self.shards
            for f in dataclasses.fields(sh)
            if isinstance(getattr(sh, f.name), torch.Tensor))

    def link_bytes(self) -> int:
        """Bytes a call's rotations put on links: every shard sends its
        slab (f32 values and bf16 pattern) on p - 1 times, also where the
        neighbour shares its device and nothing is copied."""
        p = len(self.shards)
        return p * (p - 1) * self.wb * self.bs * self.bs * (4 + 2)


def _flat(loc, r, c, bs: int, limit: int) -> torch.Tensor:
    """Flat offsets into a (w, bs, bs) array, int32 where ``limit`` (the
    array's size) allows."""
    flat = (loc * bs + r) * bs + c
    return flat.to(torch.int32) if limit < 2 ** 31 else flat


def _pattern(flat: torch.Tensor, w: int, bs: int) -> torch.Tensor:
    pat = torch.zeros(w * bs * bs, dtype=torch.bfloat16, device=flat.device)
    pat[flat] = 1
    return pat.view(w, bs, bs)


def _ring_prep(A: CSR, B: CSR, M: CSR, bs: int, devices: Sequence,
               wm: Optional[int]) -> _RingState:
    """The sparse ring's prep, pure structure: each CSR's indices uploaded
    once to ``devices[0]`` and panelized there (``_panel_scatter``), the
    (p, p, 4, Ws) ring schedules built on the host from the block
    structures, and the mask-aligned extraction addressing; each shard's
    part then moves to its own device (no copy where that is the same).

    Shard d holds the reference's arrays of panel d: its A (B) entries'
    (local, r, c) coordinates as flat offsets, its ``sched[d]``, its
    pattern panels, and its ``ex_*`` extraction entries without their
    per-panel padding, in CSR order.
    """
    from repro_torch.kernels.masked_matmul.ops import build_ring_schedules

    p = len(devices)
    m, k = A.shape
    n = B.shape[1]
    Ad = _upload(A, devices[0], data=False)
    Bd = _upload(B, devices[0], data=False)
    Md = _upload(M, devices[0], data=False)
    a_ptr, a_idx, _, a_loc, a_r, a_c, wa = _panel_scatter(Ad, bs, p)
    b_ptr, b_idx, _, b_loc, b_r, b_c, wb = _panel_scatter(Bd, bs, p)
    m_ptr, m_idx, m_pan, m_loc, m_r, m_c, wmb = _panel_scatter(Md, bs, p)
    sched = build_ring_schedules(_struct_panels(a_ptr, a_idx, p, bs, k),
                                 _struct_panels(b_ptr, b_idx, p, bs, n),
                                 _struct_panels(m_ptr, m_idx, p, bs, n),
                                 out_pad=wmb)
    if sched.shape[-1] and (sched[:, :, 1].max() >= wa
                            or sched[:, :, 2].max() >= wb
                            or sched[:, :, 0].max() >= wmb):
        raise ValueError("ring worklist positions out of range")

    # extraction: every mask element lives in exactly one row panel; the
    # shard that owns it writes it into its (rows_loc, pm) output rows
    rows_loc = (len(m_ptr) - 1) // p * bs
    m_rows = Md.rows()
    pm = _pad_width(M, wm)
    mask_cols, _ = _padded(Md, m_rows, pm, with_vals=False)
    slot = torch.arange(M.nnz, device=m_rows.device) - Md.indptr[m_rows]
    ex_src = _flat(m_loc, m_r, m_c, bs, wmb * bs * bs)
    ex_dst = (m_rows - m_pan * rows_loc) * pm + slot
    ex_dst = ex_dst.to(torch.int32) if rows_loc * pm < 2 ** 31 else ex_dst
    a_flat = _flat(a_loc, a_r, a_c, bs, wa * bs * bs)
    b_flat = _flat(b_loc, b_r, b_c, bs, wb * bs * bs)

    def cuts(x: CSR, rows: int) -> np.ndarray:
        """Each panel's CSR entry range: its rows' entries."""
        return x.indptr[np.minimum(np.arange(p + 1) * rows, x.shape[0])]

    a_cut = cuts(A, rows_loc)
    b_cut = cuts(B, (len(b_ptr) - 1) // p * bs)
    m_cut = cuts(M, rows_loc)
    shards = []
    for d, dev in enumerate(devices):
        a_f = a_flat[a_cut[d]:a_cut[d + 1]].to(dev)
        b_f = b_flat[b_cut[d]:b_cut[d + 1]].to(dev)
        # a mask entry beyond the padded width wm is dropped, as the
        # reference's out-of-bounds scatter drops it
        keep = slot[m_cut[d]:m_cut[d + 1]] < pm
        shards.append(_Shard(
            device=dev,
            a_rows=(int(a_cut[d]), int(a_cut[d + 1])), a_flat=a_f,
            a_pat=_pattern(a_f, wa, bs),
            b_rows=(int(b_cut[d]), int(b_cut[d + 1])), b_flat=b_f,
            b_pat=_pattern(b_f, wb, bs),
            sched=torch.as_tensor(sched[d], device=dev),
            ex_src=ex_src[m_cut[d]:m_cut[d + 1]][keep].to(dev),
            ex_dst=ex_dst[m_cut[d]:m_cut[d + 1]][keep].to(dev)))
    return _RingState(shards=shards, bs=bs, wa=wa, wb=wb, wm_blocks=wmb,
                      rows_loc=rows_loc, pm=pm, mask_cols=mask_cols)


def _ring_state(A: CSR, B: CSR, M: CSR, bs: int, mesh: Mesh, axis: str,
                wm: Optional[int]) -> _RingState:
    """``_ring_prep`` through the ring-prep cache."""
    from repro_torch.core.planner import structure_signature

    devices = tuple(mesh.devices)
    key = (structure_signature(A), structure_signature(B),
           structure_signature(M), bs, int(mesh.shape[axis]), wm,
           tuple(map(str, devices)))
    # the prep is pure structure arithmetic (panelization, scatter maps,
    # ring schedules) on the mesh's devices: it embeds no cost-model
    # decision, so a calibration change cannot stale it
    hit = _ring_prep_cache.get(key)  # lint: plan-key-ok(structure-pure prep)
    if hit is not None:
        return hit
    state = _ring_prep(A, B, M, bs, devices, wm)
    _ring_prep_cache.put(key, state)  # lint: plan-key-ok(structure-pure prep)
    return state


#: the sparse ring's prep, keyed on operand *structure* (CRC signatures),
#: block size, wm and the mesh's devices: schedules, scatter coordinates,
#: patterns and extraction addressing are all structure-pure, so repeated
#: structures (the serving case; every plan-cache hit) go straight to the
#: value scatter and the kernels.  The entries live on the devices, sized
#: by the operands, so the cache holds at most 32 of them
#: ($REPRO_RING_PREP_CAP or ``repro_torch.caches.set_capacity("ring-prep",
#: n)``) and at most 4 GiB of them ($REPRO_RING_PREP_BYTES), the newest
#: entry always kept
_ring_prep_cache = caches.LRUCache("ring-prep", 32,
                                   env_var="REPRO_RING_PREP_CAP",
                                   nbytes=_RingState.nbytes,
                                   max_bytes=4 * 2 ** 30,
                                   bytes_env_var="REPRO_RING_PREP_BYTES")


def clear_ring_prep_cache() -> None:
    _ring_prep_cache.clear()


def ring_prep_cache_info() -> dict:
    return _ring_prep_cache.info()


def _panel_values(data: torch.Tensor, flat: torch.Tensor, w: int,
                  bs: int) -> torch.Tensor:
    out = torch.zeros(w * bs * bs, dtype=torch.float32, device=flat.device)
    out[flat] = data.to(torch.float32)
    return out.view(w, bs, bs)


def ring_sparse_masked_spgemm(A: CSR, B: CSR, M: CSR, mesh: Mesh, *,
                              axis: str = "data",
                              block_size: Optional[int] = None,
                              wm: Optional[int] = None) -> MaskedSpGEMMResult:
    """C = M (.) (A B) on a sparse BCSR ring: A/M row panels sharded over
    ``axis``, B's occupied K-slabs rotating from shard to shard.

    Densify-free end to end: each shard holds its row panel of A (values
    and stored-entry pattern blocks) and one rotating B slab, padded to the
    ring maximum, and at every stage replays that stage's host-built
    worklist on the fused ``block_spgemm`` kernel, which gives the values
    and the structural counts in one launch, and adds both into its
    running accumulators.  A call launches the fused kernel p² times (the
    plain version on CPU tensors).  ``present`` comes from the counts, so
    results are bitwise the single-device ``masked_spgemm`` semantics,
    including cancellation and explicitly stored zeros, wherever the sums
    are exact (the ring adds the stages' partial sums in another order).

    The prep (schedules, scatter coordinates, patterns, extraction
    addressing) is pure structure and cached by structural signature and
    mesh, so repeated structures pay only the upload and scatter of the
    values (on the shards' devices) and the kernels.  Returns a
    mask-aligned result on ``mesh.devices[0]``.

    Only ``plus_times`` with an explicit mask is supported (the kernel
    accumulates with a dense block product); ``distributed_masked_spgemm``
    routes other products to the row-parallel path.
    """
    from repro_torch.kernels.masked_matmul.kernel import \
        block_spgemm_with_structure_kernel

    m, k = A.shape
    k2, n = B.shape
    if k != k2 or M.shape != (m, n):
        raise ValueError(f"shapes do not chain: A {A.shape}, B {B.shape}, "
                         f"M {M.shape}")
    p = int(mesh.shape[axis])
    dev0 = mesh.devices[0]

    if M.nnz == 0:
        M_p = padded_from_csr(M, wm, device=dev0)
        z = torch.zeros((m, M_p.width), dtype=torch.float32, device=dev0)
        return MaskedSpGEMMResult(z, torch.zeros_like(z, dtype=torch.bool),
                                  M_p.cols, (m, n))
    if block_size is None:
        from .planner import ring_block_candidates
        block_size = ring_block_candidates(m, k, n)[0]
    bs = block_size

    st = _ring_state(A, B, M, bs, mesh, axis, wm)
    a_vals, held = [], []
    for sh in st.shards:
        a_vals.append(_panel_values(
            _to_device(A.data[sh.a_rows[0]:sh.a_rows[1]], sh.device),
            sh.a_flat, st.wa, bs))
        held.append((_panel_values(
            _to_device(B.data[sh.b_rows[0]:sh.b_rows[1]], sh.device),
            sh.b_flat, st.wb, bs), sh.b_pat))
    vals: List[Optional[torch.Tensor]] = [None] * p
    cnts: List[Optional[torch.Tensor]] = [None] * p
    for s in range(p):
        for d, sh in enumerate(st.shards):
            wl = sh.sched[s]
            v, c = block_spgemm_with_structure_kernel(
                a_vals[d], held[d][0], sh.a_pat, held[d][1],
                wl[0], wl[1], wl[2], wl[3], st.wm_blocks)
            if vals[d] is None:
                vals[d], cnts[d] = v, c
            else:
                vals[d] += v
                cnts[d] += c
        if s < p - 1:
            # the last stage is peeled: its rotation would only restore
            # the starting layout, so p - 1 rotations move
            devs = [sh.device for sh in st.shards]
            held = list(zip(_rotate([h[0] for h in held], devs),
                            _rotate([h[1] for h in held], devs)))

    # panel-local extraction: each shard writes its own mask elements
    out_v, out_p = [], []
    for d, sh in enumerate(st.shards):
        ov = torch.zeros(st.rows_loc * st.pm, dtype=torch.float32,
                         device=sh.device)
        op = torch.zeros(st.rows_loc * st.pm, dtype=torch.bool,
                         device=sh.device)
        ov[sh.ex_dst] = vals[d].view(-1)[sh.ex_src]
        op[sh.ex_dst] = cnts[d].view(-1)[sh.ex_src] > 0
        out_v.append(ov.view(st.rows_loc, st.pm))
        out_p.append(op.view(st.rows_loc, st.pm))
    return MaskedSpGEMMResult(_gather_rows(out_v, dev0)[:m],
                              _gather_rows(out_p, dev0)[:m],
                              st.mask_cols.clone(), (m, n))


# ---------------------------------------------------------------------------
# The entry point: route election across the mesh
# ---------------------------------------------------------------------------


def distributed_masked_spgemm(A: CSR, B: CSR, M: CSR, mesh: Mesh, *,
                              algorithm: str = "auto", axis: str = "data",
                              semiring: Semiring = PLUS_TIMES,
                              complement: bool = False,
                              block_size: Optional[int] = None,
                              row_algorithm: Optional[str] = None
                              ) -> MaskedSpGEMMResult:
    """C = M (.) (A B) across ``mesh``: the distributed counterpart of
    ``masked_spgemm``.

    ``algorithm``:
      * ``"auto"`` — the planner's distributed cost model weighs
        replicating B (row-parallel, no numeric-phase communication)
        against rotating B's occupied BCSR K-slabs around the ring (sparse
        ring-SUMMA, memory O(nnzb/p) per shard), plus each route's compute
        cost (``planner.plan_distributed``, signature-cached).
      * ``"row"``  — force the 1D row-parallel path (B replicated).
      * ``"ring"`` — force the sparse BCSR ring (plus_times, explicit mask).

    Host CSR operands only.  CPU devices run the block product's plain
    version, CUDA devices its kernel.  Returns a mask-aligned
    ``MaskedSpGEMMResult`` on ``mesh.devices[0]``, identical (bitwise,
    under exact values) to single-device ``masked_spgemm`` on the same
    operands.
    """
    if not isinstance(A, CSR) or not isinstance(B, CSR) \
            or not isinstance(M, CSR):
        raise NotImplementedError(
            "distributed_masked_spgemm needs host CSR operands")
    if complement:
        raise NotImplementedError(
            "complemented masks are not mask-bounded; shard "
            "row_parallel_masked_spgemm directly for that regime")
    if algorithm not in ("auto", "row", "ring"):
        raise ValueError(f"unknown distributed algorithm {algorithm!r}")

    from repro_torch.kernels.masked_matmul.ops import tile_path_supported
    ring_ok = tile_path_supported(semiring.name, complement)
    p = int(mesh.shape[axis])

    if algorithm == "ring" and not ring_ok:
        raise NotImplementedError(
            "sparse ring requires plus_times and an explicit mask")
    if algorithm == "auto":
        from .planner import plan_distributed
        dplan = plan_distributed(A, B, M, p, complement=complement,
                                 semiring=semiring)
        algorithm = dplan.route
        if block_size is None and dplan.tile_block:
            block_size = dplan.tile_block
        if row_algorithm is None:
            row_algorithm = dplan.row_algorithm

    if algorithm == "ring":
        with obs.span("spgemm.dist", route="ring", p=p,
                      block=block_size or 0):
            return ring_sparse_masked_spgemm(
                A, B, M, mesh, axis=axis, block_size=block_size)

    # row-parallel: replicate B, shard A/M rows, run the row kernels
    if row_algorithm is None:
        from .planner import collect_stats, decide
        stats = collect_stats(A, B, M, complement=complement,
                              semiring=semiring)
        row_algorithm = decide(stats, allow_tile=False).algorithm
    m, n = M.shape
    dev0 = mesh.devices[0]
    with obs.span("spgemm.dist", route="row", p=p,
                  algorithm=row_algorithm):
        with obs.span("spgemm.host_prep", algorithm=row_algorithm):
            B_p = padded_from_csr(
                B.transpose() if row_algorithm == "inner" else B,
                device=dev0)
            A_p = padded_from_csr(A, device=dev0)
            M_p = padded_from_csr(M, device=dev0)
            A_p, M_p = pad_rows_to(p, A_p, M_p)
        vals, present = row_parallel_masked_spgemm(
            A_p, B_p, M_p, mesh, algorithm=row_algorithm,
            semiring=semiring, complement=complement, axes=(axis,))
    return MaskedSpGEMMResult(vals[:m], present[:m], M_p.cols[:m], (m, n))


# ---------------------------------------------------------------------------
# helpers for building sharded problems
# ---------------------------------------------------------------------------


def pad_rows_to(mesh_axis_size: int, *mats: PaddedCSR
                ) -> Tuple[PaddedCSR, ...]:
    """Pad the row count to a multiple of the mesh axis so shards are
    equal: padding rows hold the sentinel column n, value 0 and length 0."""
    out = []
    for x in mats:
        m, n = x.shape
        target = -(-m // mesh_axis_size) * mesh_axis_size
        if target == m:
            out.append(x)
            continue
        pad = target - m
        dev = x.cols.device
        cols = torch.cat([x.cols, torch.full((pad, x.width), n,
                                             dtype=x.cols.dtype,
                                             device=dev)])
        vals = torch.cat([x.vals, torch.zeros((pad, x.width),
                                              dtype=x.vals.dtype,
                                              device=dev)])
        lens = torch.cat([x.lens, torch.zeros((pad,), dtype=x.lens.dtype,
                                              device=dev)])
        out.append(PaddedCSR(cols, vals, lens, (target, n)))
    return tuple(out)
