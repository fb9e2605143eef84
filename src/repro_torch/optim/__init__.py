"""Optimizers: the reference's AdamW with its warmup-cosine schedule."""
