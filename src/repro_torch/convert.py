"""Carry objects of the JAX reference package over into this package.

Each function reads the reference object's attributes as numpy arrays
(``np.asarray`` of a JAX array needs no JAX import here) and builds the
port's counterpart, so both packages can compute on identical operands and
a plan elected by the reference planner can drive the port
(``masked_spgemm(plan=plan_from_reference(p))``).  Nothing of the
reference is imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BCSR, CSR, PaddedCSR
from repro_torch.core.planner import Plan, PlanStats


def csr_from_reference(obj) -> CSR:
    """A host CSR (``indptr``, ``indices``, ``data``, ``shape``)."""
    return CSR(np.asarray(obj.indptr).copy(), np.asarray(obj.indices).copy(),
               np.asarray(obj.data).copy(), tuple(obj.shape))


def padded_from_reference(obj, device="cuda") -> PaddedCSR:
    """A padded row format (``cols``, ``vals``, ``lens``, ``shape``)."""
    return PaddedCSR(torch.as_tensor(np.array(obj.cols), device=device),
                     torch.as_tensor(np.array(obj.vals), device=device),
                     torch.as_tensor(np.array(obj.lens), device=device),
                     tuple(obj.shape))


def bcsr_from_reference(obj, device="cuda") -> BCSR:
    """A block-CSR (host ``indptr``/``indices``, device ``blocks``)."""
    return BCSR(np.asarray(obj.indptr).copy(), np.asarray(obj.indices).copy(),
                torch.as_tensor(np.array(obj.blocks), device=device),
                tuple(obj.shape), int(obj.block_size))


def _stats(obj) -> PlanStats:
    return PlanStats(**{f.name: getattr(obj, f.name)
                        for f in dataclasses.fields(PlanStats)})


def plan_from_reference(obj):
    """A ``Plan`` (with its ``PlanStats``) or a bare ``PlanStats``."""
    if not hasattr(obj, "algorithm"):
        return _stats(obj)
    return Plan(algorithm=obj.algorithm,
                widths=tuple(int(w) for w in obj.widths),
                two_phase=bool(obj.two_phase),
                n_inspect=obj.n_inspect,
                tile_eligible=bool(obj.tile_eligible),
                tile_block=int(obj.tile_block),
                costs=tuple((str(name), float(c)) for name, c in obj.costs),
                stats=_stats(obj.stats),
                trialed=tuple(obj.trialed))
