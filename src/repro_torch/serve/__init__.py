"""Serving: batched generation over the KV cache."""
from .decode import generate, make_serve_step

__all__ = ["generate", "make_serve_step"]
