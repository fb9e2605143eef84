"""Meshes of ranks (the reference's ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the processes of the
world, one rank a process, with the reference's axis names: ``data`` and
``model``, and ``pod`` in front of them for the multi-pod layout.  It is
built after ``repro_torch.parallel.init_ranks`` and is collective (every
rank calls the same function).  ``make_production_mesh`` is the
reference's TPU pod, (16, 16) or (2, 16, 16) ranks; ``make_elastic_mesh``
is the arithmetic of a degraded restart, and ``make_elastic_device_mesh``
builds that mesh.

The device type of the mesh follows the backend: ``cpu`` for gloo (its
groups take host and CUDA tensors alike, so ranks may share a card) and
``cuda`` for NCCL (one card per rank).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch.distributed as dist


def make_device_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over the world's ranks in order, its
    dims named ``names``; raises unless the world holds exactly
    ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the world "
                         f"has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's pod: ``{"data": 16, "model": 16}``, with ``"pod":
    2`` in front for the multi-pod layout."""
    shape = {"data": 16, "model": 16}
    return {"pod": 2, **shape} if multi_pod else shape


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)``; raises unless the world has 256 (512) ranks."""
    shape = production_shape(multi_pod=multi_pod)
    return make_device_mesh(tuple(shape.values()), tuple(shape))


def make_elastic_mesh(n_devices: int, *,
                      model_parallel: int = 16) -> Dict[str, int]:
    """The largest (data, model) mesh shape for a degraded device set (an
    elastic restart after failures): keep TP, halving it until it divides
    ``n_devices``, and DP = n_devices / TP.  Returns ``{"data": dp,
    "model": tp}``, as the reference's mesh's ``shape`` reads."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got "
                         f"{n_devices}")
    tp = model_parallel
    while tp > 1 and n_devices % tp:
        tp //= 2
    return {"data": n_devices // tp, "model": tp}


def make_elastic_device_mesh(n_devices: int, *, model_parallel: int = 16):
    """``make_elastic_mesh``'s shape as a ``DeviceMesh`` over the world's
    ``n_devices`` ranks."""
    shape = make_elastic_mesh(n_devices, model_parallel=model_parallel)
    return make_device_mesh((shape["data"], shape["model"]),
                            ("data", "model"))
