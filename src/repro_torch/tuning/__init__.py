"""Planner calibration: the cost-model identity the plan cache keys on."""
from .profile import BUILTIN_VERSION, active_version, fingerprint_tables

__all__ = ["BUILTIN_VERSION", "active_version", "fingerprint_tables"]
