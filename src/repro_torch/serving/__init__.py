"""Masked SpGEMM query serving on the port.

``QueryEngine`` turns one-shot ``masked_spgemm`` calls into a served
stream: structure-bucketed batching (one cached plan per bucket, served by
a burst program, the batched row driver or the tile route), sync and
async-future submission with bounded-queue backpressure, a content-keyed
bounded result cache, and per-bucket metrics.  The engine runs on
``device`` (default ``"cuda"``).
"""
from .batcher import Batcher, Request, bucket_key, merge_planned
from .burst import BurstProgram, burst_eligible, get_program
from .cache import ResultCache, content_fingerprint, value_fingerprint
from .clock import SystemClock, VirtualClock
from .engine import QueryEngine, Ticket
from .metrics import ServeMetrics

__all__ = [
    "Batcher", "BurstProgram", "QueryEngine", "Request", "ResultCache",
    "ServeMetrics", "SystemClock", "Ticket", "VirtualClock", "bucket_key",
    "burst_eligible", "content_fingerprint", "get_program", "merge_planned",
    "value_fingerprint",
]
