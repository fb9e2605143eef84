"""Masked SpGEMM query serving on the port.

``QueryEngine`` turns one-shot ``masked_spgemm`` calls into a served
stream: structure-bucketed batching (one cached plan per bucket, served by
a burst program, the batched row driver or the tile route), sync and
async-future submission with bounded-queue backpressure, a content-keyed
bounded result cache, and per-bucket metrics.  ``submit_delta`` folds
edge-delta batches into the served operands incrementally (plan
revalidation, burst lane patching, row-scoped result-cache invalidation),
and ``trace`` captures a request stream and replays it deterministically.
The engine runs on ``device`` (default ``"cuda"``).
"""
from .batcher import Batcher, Request, bucket_key, merge_planned
from .burst import (BurstProgram, burst_eligible, get_program,
                    patch_program, peek_program, record_lineage)
from .cache import (ResultCache, content_fingerprint, result_key,
                    row_bitmap, value_fingerprint)
from .clock import SystemClock, VirtualClock
from .engine import DeltaOutcome, QueryEngine, Ticket
from .metrics import ServeMetrics
from .trace import (ReplayReport, RotatingTraceSink, Trace, TraceError,
                    TraceRecorder, golden_trace_path, load_rotated,
                    replay_trace, synthesize_trace)

__all__ = [
    "Batcher", "BurstProgram", "DeltaOutcome", "QueryEngine",
    "ReplayReport", "Request", "ResultCache", "RotatingTraceSink",
    "ServeMetrics", "SystemClock", "Ticket", "Trace", "TraceError",
    "TraceRecorder", "VirtualClock", "bucket_key", "burst_eligible",
    "content_fingerprint", "get_program", "golden_trace_path",
    "load_rotated", "merge_planned", "patch_program", "peek_program",
    "record_lineage", "replay_trace", "result_key", "row_bitmap",
    "synthesize_trace", "value_fingerprint",
]
