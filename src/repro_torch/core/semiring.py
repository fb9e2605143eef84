"""GraphBLAS-style semirings for masked sparse products, on torch tensors.

The paper's algorithms are defined over an arbitrary semiring (Sec. 2); the
graph apps use PLUS_TIMES (triangle counting / k-truss support counts) and
PLUS_FIRST / boolean semirings (BFS-like traversals in betweenness
centrality).  A semiring is (add, mul, zero); ``add`` must be associative and
commutative with identity ``zero``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    add: Callable
    mul: Callable
    zero: float

    def mul_add(self, acc: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        """``add(acc, mul(x, y))``.  Under plus_times this is one fused
        multiply-add (``addcmul`` rounds once), as the reference's compiled
        accumulator folds are: the row kernels' per-slot sums then agree
        bit for bit."""
        if self.name == "plus_times":
            return torch.addcmul(acc, x, y)
        return self.add(acc, self.mul(x, y))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Dense *structural* matmul under this semiring: (m,k) x (k,n).

        Entries equal to literal 0 in a/b are treated as structurally absent
        (contributing the semiring zero, not mul(0, .)), matching sparse
        semantics where only stored nonzeros generate products.
        """
        if self.name == "plus_times":
            return a @ b
        # generic (slow) path: broadcast over k, mask absent products
        both = (a != 0)[:, :, None] & (b != 0)[None, :, :]
        prod = torch.where(both, self.mul(a[:, :, None], b[None, :, :]),
                           self.zero)  # (m, k, n)
        out = prod[:, 0, :]
        for i in range(1, prod.shape[1]):
            out = self.add(out, prod[:, i, :])
        return out


def _or_and_mul(x, y):
    return torch.minimum(torch.sign(torch.abs(x)), torch.sign(torch.abs(y)))


PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, 0.0)
# OR-AND over {0,1} floats
OR_AND = Semiring("or_and", torch.maximum, _or_and_mul, 0.0)
# min-plus (tropical): zero is +inf
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, float("inf"))
# plus_first: mul(a, b) = a  (used for frontier expansion where B is pattern)
PLUS_FIRST = Semiring("plus_first", torch.add, lambda x, y: x, 0.0)
# plus_second: mul(a, b) = b
PLUS_SECOND = Semiring("plus_second", torch.add, lambda x, y: y, 0.0)

REGISTRY = {s.name: s for s in
            (PLUS_TIMES, OR_AND, MIN_PLUS, PLUS_FIRST, PLUS_SECOND)}
