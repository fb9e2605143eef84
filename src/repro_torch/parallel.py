"""Process groups and collectives for sharded training: one process per
rank under ``torch.distributed``.

The reference has no counterpart module: GSPMD inserts its collectives
from the shardings.  Here each rank is a process, the (pod, data, model)
mesh is a ``DeviceMesh`` of those processes (``repro_torch.launch.mesh``),
and the layers call the collectives below where GSPMD would put them.

* ``init_ranks(backend, device)`` starts the rank's process group from
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (as ``torchrun`` sets them)
  or from an explicit ``store``, ``rank`` and ``world_size``, and picks
  the rank's device: ``cuda:{LOCAL_RANK % device_count()}``, or the CPU
  only when ``device="cpu"`` is asked for.  The backend is an argument and
  never changes on its own: ``nccl`` takes one card per rank and raises,
  naming ``--backend gloo``, when this host runs more ranks than it has
  cards; ``gloo`` lets ranks share a card.
* ``mesh_axes(mesh)`` resolves a ``DeviceMesh`` into ``Axis`` objects
  (group, size, this rank's index): ``pod``, ``data``, ``model`` and
  ``dp``, the data-parallel product ``pod x data`` over which a batch is
  split and gradients are reduced.  An axis of size 1 has no group and its
  collectives return their input.
* The Megatron pairs as ``torch.autograd.Function``s: ``copy_to`` (identity
  forward, all-reduce of the gradient backward: a replicated tensor
  entering a rank's partial branch) and ``reduce_from`` (all-reduce
  forward, identity backward: a branch's partial result leaving it), and
  the two all-gathers of a sharded weight: ``gather_replicated`` (its
  consumer computes the same on every rank, so the backward keeps the
  local slice of the gradient) and ``gather_partial`` (its consumer is a
  partial branch, so the backward sums the gradient over the axis, then
  keeps the slice).  ``all_gather_uneven`` gathers blocks of unequal
  sizes (each padded to the largest on the link; a rank's q heads where
  they do not divide the axis).  ``regroup`` hands each rank a range of
  its own of a dim split into equal shards by one uneven all-to-all,
  each rank sending only the parts of its shard that another rank's
  range holds (a rank's q heads' columns of ``wq`` where the heads do not
  divide the axis); its backward is the inverse exchange, the gradients
  of a part that several ranks read (K/V heads) summed at its shard.
  ``sum_partials`` sums a partial statistic that every rank's part reads
  whole (a norm's sum of squares over channels split over the axis):
  all-reduced forward and backward.
  ``all_reduce(..., op="max")`` is the vocab-parallel loss's maximum and
  the context-parallel decode's score maximum (no gradient).
* ``LINK_BYTES`` counts, by (collective, backend), the bytes each rank
  would put on its links for the collectives it ran, as a ring moves them:
  ``2 (p - 1) / p`` of the buffer for an all-reduce and ``(p - 1) / p`` of
  the gathered result for an all-gather, what it sends to the other
  ranks for an all-to-all; ``LINK_SECONDS`` the host seconds
  spent in those calls (blocking calls, so on gloo they include its device
  copies and waiting for the other ranks).  ``reset_link_bytes()`` zeroes
  both.

Gloo and CUDA tensors.  On the card's torch (2.11.0+cu128) gloo takes
CUDA tensors in every collective used here (all-reduce of f32 and int32
by sum and max, all-gather, and ``all_to_all_single`` with uneven and
empty splits in f32 and bf16), with ranks sharing ``cuda:0``
(``chip_smoke.py`` phases 19 and 22 run each of them so).  So no
collective is staged through host buffers: gloo copies to the host
inside the call.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")

#: link bytes and host seconds by (collective, backend) since the last
#: ``reset_link_bytes``
LINK_BYTES: Dict[Tuple[str, str], int] = {}
LINK_SECONDS: Dict[Tuple[str, str], float] = {}


def reset_link_bytes() -> None:
    LINK_BYTES.clear()
    LINK_SECONDS.clear()


def _count(name: str, axis: "Axis", nbytes: float, call) -> None:
    """Run the blocking collective ``call()``, counting its bytes and
    host seconds."""
    key = (name, axis.backend)
    t = time.perf_counter()
    call()
    LINK_SECONDS[key] = LINK_SECONDS.get(key, 0.0) + time.perf_counter() - t
    LINK_BYTES[key] = LINK_BYTES.get(key, 0) + int(nbytes)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the world: global ``rank`` of ``world``,
    ``local_rank`` on its host, the ``backend`` and the rank's
    ``device``."""
    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device


def rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda:{local_rank % device_count()}`` for ``"cuda"``, the CPU for
    ``"cpu"``; no card and ``"cuda"`` raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device {device!r}: a rank runs on cuda or cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("--device cuda: no CUDA device is visible (pass "
                           "--device cpu to run the ranks on the CPU)")
    return torch.device("cuda", local_rank % n)


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def check_backend(backend: str, device: str, local_world: int) -> None:
    """Refuse a backend that cannot serve ``local_world`` ranks on this
    host: an unknown name, ``nccl`` on the CPU, and ``nccl`` with more ranks
    than cards (NCCL takes one card per rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("--backend nccl runs on cuda devices; pass "
                         "--backend gloo for CPU ranks")
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise ValueError(
            f"--backend nccl: {local_world} ranks on this host and {cards} "
            f"CUDA device(s); NCCL takes one card per rank, so pass "
            f"--backend gloo to let ranks share a card")


def init_ranks(backend: str, device: str = "cuda", *,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               local_rank: Optional[int] = None, store=None) -> Ranks:
    """Join the default process group on ``backend`` and return this
    rank's ``Ranks``.  Without a ``store`` the group starts from the
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets
    them); ``rank``, ``world_size`` and ``local_rank`` default to ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (else 0, 1 and the rank).  The
    backend check runs before the group starts, so a refused configuration
    raises before anything else."""
    rank = _env_int("RANK", 0) if rank is None else rank
    world = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local = _env_int("LOCAL_RANK", rank) if local_rank is None \
        else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    check_backend(backend, device, local_world)
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world)
    if store is not None:
        kw["store"] = store
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return Ranks(rank, world, local, backend, dev)


def shutdown() -> None:
    """Leave the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its ``name``, the process
    ``group`` along it (None when ``size`` is 1), its ``size``, this rank's
    ``index`` along it and the group's ``backend``."""
    name: str
    group: Optional[object]
    size: int
    index: int
    backend: str


def mesh_axes(mesh) -> Dict[str, Axis]:
    """``{"pod", "data", "model", "dp"}`` axes of a ``DeviceMesh`` whose
    dim names are among ``("pod", "data", "model")``; an absent name is an
    axis of size 1, and ``dp`` is ``pod x data`` (``data`` alone without a
    pod axis).  Collective for a mesh with a pod axis: the mesh makes the
    flattened group at the first call and keeps it."""
    names = tuple(mesh.mesh_dim_names)
    unknown = [n for n in names if n not in ("pod", "data", "model")]
    if unknown:
        raise ValueError(f"mesh axes {names}: only pod, data and model")
    backend = dist.get_backend()
    sizes = dict(zip(names, mesh.mesh.shape))
    axes = {}
    for name in ("pod", "data", "model"):
        n = sizes.get(name, 1)
        axes[name] = Axis(name, mesh.get_group(name) if n > 1 else None, n,
                          mesh.get_local_rank(name) if name in sizes else 0,
                          backend)
    pod, data = axes["pod"], axes["data"]
    if pod.size > 1:
        flat = mesh["pod", "data"]._flatten("dp")
        axes["dp"] = Axis("dp", flat.get_group(), pod.size * data.size,
                          pod.index * data.size + data.index, backend)
    else:
        axes["dp"] = dataclasses.replace(data, name="dp")
    return axes


# ---------------------------------------------------------------------------
# collectives (each counts its link bytes)
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, axis: Axis, op: str = "sum"
               ) -> torch.Tensor:
    """``t`` reduced over ``axis`` in place (``op`` "sum" or "max");
    returns ``t``."""
    if axis.size == 1:
        return t
    _count("all_reduce", axis,
           2 * (axis.size - 1) / axis.size * t.numel() * t.element_size(),
           lambda: dist.all_reduce(t, op=_OPS[op], group=axis.group))
    return t


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], axis: Axis,
                         bucket_bytes: int = 256 << 20) -> None:
    """Sum each tensor over ``axis`` in place, packed into flat buckets of
    at most ``bucket_bytes`` (one collective per bucket, not per
    tensor); tensors of one dtype per bucket."""
    if axis.size == 1:
        return
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce(flat, axis)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        bucket, size = [], 0

    for t in tensors:
        nb = t.numel() * t.element_size()
        if bucket and (size + nb > bucket_bytes
                       or t.dtype != bucket[0].dtype):
            flush()
        bucket.append(t)
        size += nb
    flush()


def all_gather_cat(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The shards of ``axis``, this one ``t``, concatenated along ``dim``
    in axis order."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    _count("all_gather", axis,
           (axis.size - 1) * t.numel() * t.element_size(),
           lambda: dist.all_gather(parts, t, group=axis.group))
    return torch.cat(parts, dim=dim)


def all_gather_uneven(t: torch.Tensor, axis: Axis, dim: int,
                      sizes: Sequence[int]) -> torch.Tensor:
    """The blocks of ``axis``, this one ``t`` of ``sizes[axis.index]`` along
    ``dim``, concatenated in axis order: each block padded to the largest
    size, ``all_gather_cat``, the padding dropped (equal sizes:
    ``all_gather_cat`` itself).  The backward gives this rank the gradient
    of its own block (a consumer that every rank computes alike)."""
    if axis.size == 1:
        return t
    if t.shape[dim] != sizes[axis.index]:
        raise ValueError(f"block of {t.shape[dim]} along dim {dim}, rank "
                         f"{axis.index} of sizes {list(sizes)}")
    return _GatherUneven.apply(t, axis, dim, tuple(sizes))


def local_slice(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``t`` along ``dim`` (a view)."""
    if axis.size == 1:
        return t
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


Ranges = Tuple[Tuple[int, int], ...]


def _overlap(lo: int, hi: int, start: int, n: int) -> Tuple[int, int]:
    """(offset in the shard, length) of [lo, hi) within the shard [start,
    start + n) (length 0 where they do not meet)."""
    a, b = max(lo, start), min(hi, start + n)
    return a - start, max(0, b - a)


def regroup_plan(n: int, want: Ranges, index: int):
    """What rank ``index`` of shards of ``n`` along a dim (shard j holds
    [j n, (j + 1) n)) sends and receives when each rank j takes
    ``want[j]`` = [lo, hi) of that dim: ``send[j]`` (offset in its shard,
    length) of rank j's part, ``recv[j]`` the length of its part of shard
    j (its own part both), and whether any rank's part crosses to
    another."""
    size = len(want)
    send = [_overlap(*want[j], index * n, n) for j in range(size)]
    recv = [_overlap(*want[index], j * n, n)[1] for j in range(size)]
    crosses = any(_overlap(*want[j], i * n, n)[1]
                  for i in range(size) for j in range(size) if i != j)
    return send, recv, crosses


def _exchange(x: torch.Tensor, axis: Axis, send: Sequence[Tuple[int, int]],
              recv: Sequence[int]) -> torch.Tensor:
    """One ``all_to_all_single`` along dim 0 of ``x``: rank j gets the rows
    ``send[j]`` of it, and the rows received from rank j are ``recv[j]``
    long; this rank's own part is no message.  Returns what was received,
    in rank order, this rank's own part in its place."""
    me = axis.index
    ins = [0 if j == me else n for j, (_, n) in enumerate(send)]
    outs = [0 if j == me else n for j, n in enumerate(recv)]
    parts = [x.narrow(0, s, n) for j, (s, n) in enumerate(send)
             if j != me and n]
    inp = torch.cat(parts) if parts else x.new_empty((0,) + x.shape[1:])
    got = x.new_empty((sum(outs),) + x.shape[1:])
    _count("all_to_all", axis, inp.numel() * inp.element_size(),
           lambda: dist.all_to_all_single(got, inp, outs, ins,
                                          group=axis.group))
    got = list(got.split(outs))
    got[me] = x.narrow(0, *send[me])
    pieces = [p for p, n in zip(got, recv) if n] or [x[:0]]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _regroup_forward(w: torch.Tensor, axis: Axis, dim: int,
                     want: Ranges) -> torch.Tensor:
    send, recv, crosses = regroup_plan(w.shape[dim], want, axis.index)
    if not crosses:
        return w.narrow(dim, *send[axis.index])
    # back in the shard's row-major layout, not the exchange's transposed
    # one, so that a product reads the block as it reads a shard
    return _exchange(w.movedim(dim, 0), axis, send, recv).movedim(
        0, dim).contiguous()


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, partial):
        ctx.axis, ctx.dim, ctx.partial = axis, dim, partial
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(g.contiguous().clone(), ctx.axis)
        return local_slice(g, ctx.axis, ctx.dim).contiguous(), None, None, \
            None


class _GatherUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, sizes):
        ctx.axis, ctx.dim, ctx.sizes = axis, dim, sizes
        top = max(sizes)
        if min(sizes) == top:
            return all_gather_cat(x, axis, dim)
        if x.shape[dim] < top:
            pad = list(x.shape)
            pad[dim] = top - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        blocks = all_gather_cat(x, axis, dim).split(top, dim=dim)
        return torch.cat([b.narrow(dim, 0, n)
                          for b, n in zip(blocks, sizes)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        start = sum(ctx.sizes[:ctx.axis.index])
        return g.narrow(ctx.dim, start, ctx.sizes[ctx.axis.index]
                        ).contiguous(), None, None, None


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, dim, want):
        ctx.axis, ctx.dim, ctx.want, ctx.n = axis, dim, want, w.shape[dim]
        out = _regroup_forward(w, axis, dim, want)
        base = w if w._base is None else w._base
        return out.clone() if out._base is base else out

    @staticmethod
    def backward(ctx, g):
        """The inverse exchange: each part of ``g`` goes back to the shard
        it came from, and the parts of this shard that several ranks read
        are added in rank order (onto zeros)."""
        send, recv, crosses = regroup_plan(ctx.n, ctx.want, ctx.axis.index)
        got = g = g.movedim(ctx.dim, 0)
        if crosses:         # what came from rank j goes back to it
            starts = itertools.accumulate(recv, initial=0)
            got = _exchange(g.contiguous(), ctx.axis,
                            list(zip(starts, recv)), [n for _, n in send])
        out = g.new_zeros((ctx.n,) + g.shape[1:])
        at = 0
        for s, n in send:
            if n:
                out[s:s + n] += got[at:at + n]
                at += n
        return out.movedim(0, ctx.dim).contiguous(), None, None, None


def regroup(w: torch.Tensor, axis: Optional[Axis], dim: int,
            want: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """This rank's range ``want[axis.index]`` = [lo, hi) of a dim that
    ``axis`` splits into equal shards (``w`` this rank's, shard j [j n,
    (j + 1) n) of it), every rank j taking ``want[j]``: one uneven
    ``all_to_all_single`` moves to each rank the parts of the others'
    shards in its range (this rank's own part is a slice, no message;
    where no part crosses between ranks there is no collective, and the
    result is a view of ``w``).  Differentiable: the backward is the
    inverse exchange, the gradients of a part that several ranks read
    added at its shard."""
    if axis is None or axis.size == 1:
        return w
    want = tuple((int(lo), int(hi)) for lo, hi in want)
    if len(want) != axis.size or not all(
            0 <= lo <= hi <= w.shape[dim] * axis.size for lo, hi in want):
        raise ValueError(f"ranges {list(want)} of a dim of {axis.size} "
                         f"shards of {w.shape[dim]}")
    if torch.is_grad_enabled() and w.requires_grad:
        return _Regroup.apply(w, axis, dim, want)
    return _regroup_forward(w, axis, dim, want)


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Identity forward, gradient summed over ``axis`` backward: a tensor
    that every rank holds whole, entering a computation of which each rank
    does a part (Megatron's f)."""
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over ``axis`` forward, identity backward: the parts leaving
    such a computation, after which every rank computes the same
    (Megatron's g)."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


def gather_replicated(w: torch.Tensor, axis: Optional[Axis],
                      dim: int) -> torch.Tensor:
    """All-gather of a sharded ``w`` along ``dim`` for a consumer that every
    rank computes alike: the backward keeps this rank's slice."""
    if axis is None or axis.size == 1:
        return w
    return _Gather.apply(w, axis, dim, False)


def gather_partial(w: torch.Tensor, axis: Optional[Axis],
                   dim: int) -> torch.Tensor:
    """All-gather of a sharded ``w`` along ``dim`` for a consumer of which
    each rank does a part: the backward sums the gradient over the axis,
    then keeps this rank's slice."""
    if axis is None or axis.size == 1:
        return w
    return _Gather.apply(w, axis, dim, True)


def sum_partials(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over ``axis`` forward and backward: a partial statistic (each
    rank's share of a sum) that each rank's part of a computation then
    reads whole, so its gradient is the sum of every rank's."""
    if axis is None or axis.size == 1:
        return x
    return copy_to(reduce_from(x, axis), axis)
