"""Masked tile products: the ``block_spgemm`` and ``masked_matmul`` CUDA
kernels and the block product's worklist schedule."""
from .kernel import (block_spgemm_kernel, block_spgemm_plain,
                     block_spgemm_with_structure_kernel,
                     block_spgemm_with_structure_plain, masked_matmul_kernel,
                     masked_matmul_plain)
from .ops import (block_spgemm, block_spgemm_from_csr,
                  block_spgemm_with_structure, build_spgemm_schedule,
                  masked_matmul, tile_path_supported)

__all__ = ["block_spgemm_kernel", "block_spgemm_plain",
           "block_spgemm_with_structure_kernel",
           "block_spgemm_with_structure_plain",
           "masked_matmul_kernel", "masked_matmul_plain", "block_spgemm",
           "block_spgemm_from_csr", "block_spgemm_with_structure",
           "build_spgemm_schedule", "masked_matmul", "tile_path_supported"]
