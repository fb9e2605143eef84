"""Masked block products: the ``block_spgemm`` CUDA kernel and its
worklist schedule."""
from .kernel import block_spgemm_kernel, block_spgemm_plain
from .ops import (block_spgemm, block_spgemm_from_csr,
                  block_spgemm_with_structure, build_spgemm_schedule,
                  tile_path_supported)

__all__ = ["block_spgemm_kernel", "block_spgemm_plain", "block_spgemm",
           "block_spgemm_from_csr", "block_spgemm_with_structure",
           "build_spgemm_schedule", "tile_path_supported"]
