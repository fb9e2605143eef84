"""Backend calibration subsystem: fit the planner's cost model, don't
hand-tune it.

    python -m repro_torch.tune --smoke          # fit a quick profile
    python -m repro_torch.tune --only row,tile  # re-fit selected families
    python -m repro_torch.tune --out my.json    # fit, skip the registry
    python -m repro_torch.autotune              # serving knobs, replayed

The pipeline: :mod:`repro_torch.tuning.probes` times the row kernels and
the BCSR tile route on small synthetic grids (the reference's generators
and points) on a device, CUDA by default; :mod:`repro_torch.tuning.fit`
solves the existing cost-hook functional forms for their constants by
weighted non-negative least squares with a prior toward the shipped
values; the result is a :class:`~repro_torch.tuning.profile.
CalibrationProfile` registered under ``results/profiles/`` by backend
signature (the reference package's registry) and installed with
:func:`activate` (or the ``REPRO_TUNE_PROFILE`` env var for child
processes).  Nothing activates a profile by default.

This ``__init__`` must stay import-light: ``repro_torch.core.planner``
imports ``repro_torch.tuning.profile`` at module top, which executes this
file first — so probes/fit/cli/autotune (which import the core and torch)
load lazily via __getattr__.
"""
from __future__ import annotations

from .profile import (BUILTIN_VERSION, CalibrationProfile, ProfileError,
                      activate, activate_from_env, active_profile,
                      active_version, backend_signature, lookup,
                      profile_dir, profile_key, profile_path, register,
                      snapshot)

__all__ = [
    "BUILTIN_VERSION", "CalibrationProfile", "ProfileError", "activate",
    "activate_from_env", "active_profile", "active_version",
    "backend_signature", "lookup", "profile_dir", "profile_key",
    "profile_path", "register", "snapshot",
    # lazy submodules
    "probes", "fit", "cli", "autotune",
]

_LAZY_SUBMODULES = ("probes", "fit", "cli", "autotune")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
