"""PyTorch/CUDA port of the Masked SpGEMM system (``repro`` is the JAX
reference it is held against).

Entry point: ``repro_torch.core.masked_spgemm(A, B, M)`` with host CSR
operands; it runs on ``device="cuda"`` unless the caller names another
device.  The tile route's block product is a CUDA kernel built from
``kernels/masked_matmul/csrc/`` with ``nvcc`` at first use.
"""
