"""Dense oracles for the masked tile products."""
from __future__ import annotations

import numpy as np
import torch


def masked_matmul_ref(a, b, bi, bj, *, bm, bn):
    """Tile-MCA SDDMM oracle: dense C = A @ B, then gather allowed tiles.

    a: (M, K), b: (K, N), bi/bj: (nnzb,) block coords of allowed tiles.
    Returns (nnzb, bm, bn) float32.
    """
    a = torch.as_tensor(a).float()
    c = a @ torch.as_tensor(b, device=a.device).float()
    out = [c[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
           for i, j in zip(np.asarray(bi), np.asarray(bj))]
    return (torch.stack(out) if out
            else torch.zeros((0, bm, bn), dtype=torch.float32,
                             device=a.device))


def block_spgemm_ref(a_dense, b_dense, mask_bi, mask_bj, *, bs):
    """BCSR x BCSR masked SpGEMM oracle, tile-granular mask.

    Returns (nnzb_m, bs, bs) float32: the dense product gathered at the mask's
    allowed blocks (blocks the product never touches come out zero — paper
    Fig. 1's "mask entry with no output").
    """
    a = torch.as_tensor(a_dense).float()
    b = torch.as_tensor(b_dense, device=a.device).float()
    c = a @ b
    out = [c[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
           for i, j in zip(np.asarray(mask_bi), np.asarray(mask_bj))]
    return (torch.stack(out) if out
            else torch.zeros((0, bs, bs), dtype=torch.float32,
                             device=a.device))
