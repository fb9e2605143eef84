"""Hand-written CUDA kernels (``*/csrc/*.cu``) with their wrappers, plain
PyTorch versions and host-side schedules."""
