"""Cost-model identity for the planner's plan cache.

The planner keys cached plans on :func:`active_version` plus a fingerprint
of its LIVE constant tables (``fingerprint_tables``), so mutating a table in
place can never serve a plan decided under the old constants.  Only the
builtin (shipped) constants exist in this package so far: calibration
profiles, their registry and ``activate`` come with a fitted H100 profile.

Stdlib only: the planner imports this module at its top.
"""
from __future__ import annotations

import json
import zlib

#: version token of the shipped module-literal constants
BUILTIN_VERSION = "builtin"


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def fingerprint_tables(cost_constants, tile_cost, tile_gates,
                       dist_cost) -> str:
    """Stable content hash of the four constant tables (8 hex chars)."""
    payload = _canonical({
        "cost_constants": cost_constants, "tile_cost": tile_cost,
        "tile_gates": tile_gates, "dist_cost": dist_cost})
    return format(zlib.crc32(payload.encode()), "08x")


def active_version() -> str:
    """Cache token component identifying the active constants."""
    return BUILTIN_VERSION
