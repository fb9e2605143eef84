"""Block-masked flash attention: the ``flash_mask`` CUDA kernel, its host
worklist and the batched, GQA-aware op."""
from .kernel import build_schedule, flash_mask_kernel, flash_mask_plain
from .ops import flash_mask_attention
from .ref import flash_mask_ref, mask_allowed

__all__ = ["build_schedule", "flash_mask_kernel", "flash_mask_plain",
           "flash_mask_attention", "flash_mask_ref", "mask_allowed"]
