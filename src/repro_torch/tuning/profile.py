"""Calibration profiles: the planner's cost constants as data, not code.

A :class:`CalibrationProfile` bundles every table the adaptive planner
consults — the row-kernel cost-hook constants (``accumulators.
COST_CONSTANTS``), the tile-route model (``planner.TILE_COST``) and its
eligibility gates (``TILE_MIN_*``), and the distributed model
(``planner.DIST_COST``) — together with the backend it was fit on and the
fit residuals.  Profiles serialize to JSON and live in an on-disk registry
keyed by backend signature (platform, device kind, device count) under
``results/profiles/``; the shipped CPU constants are committed there as
``default.json``.  The port reads the same registry as the reference
package: a profile fitted on an H100 sits beside the CPU default, keyed
``gpu_<device name>_<count>``.

``activate(profile)`` installs a profile into the live planner/accumulator
tables.  The planner keys its plan caches on :func:`active_version` plus a
fingerprint of the live tables, so activating a new profile (or mutating
the tables by hand, the legacy ROADMAP workflow) can never serve a plan
decided under the old constants.

This module must stay import-light (stdlib only at module scope): the
planner imports it at module top, so importing anything from
``repro_torch.core`` (or torch) here would cycle or slow every import.
Core modules and torch are imported lazily inside functions.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import zlib
from typing import Any, Dict, Optional, Tuple

#: registry directory; override with the REPRO_PROFILE_DIR env var
PROFILE_DIR_ENV = "REPRO_PROFILE_DIR"
DEFAULT_PROFILE_DIR = os.path.join("results", "profiles")
#: env var naming a profile JSON to activate at planner import
PROFILE_ENV = "REPRO_TUNE_PROFILE"
#: the registry's fallback profile (the committed CPU calibration)
DEFAULT_PROFILE_NAME = "default"

#: serialization schema version (bump on incompatible field changes)
SCHEMA_VERSION = 1

#: gate names — owned here (``activate`` is their only writer)
TILE_GATE_KEYS = ("min_density", "min_occupancy", "min_hit_rate")


def required_table_keys() -> Tuple[Dict[str, Tuple[str, ...]],
                                   Tuple[str, ...], Tuple[str, ...]]:
    """``(cost_constant_keys, tile_cost_keys, dist_cost_keys)`` — the
    constant names each table must carry, derived from the SAME feature
    decompositions the cost hooks dot against (``accumulators.
    COST_FEATURES``, ``planner.tile_cost_features`` / ``ring_cost_
    features``), so validation can never drift from what ``plan()`` will
    actually read.  Lazy core imports keep this module import-light.
    """
    import importlib
    acc = importlib.import_module("repro_torch.core.accumulators")
    planner = importlib.import_module("repro_torch.core.planner")
    probe = dict(n=2, wa=1, wb=1, wbt=1, pm=1)
    cost_keys = {alg: tuple(fn(**probe))
                 for alg, fn in acc.COST_FEATURES.items()}
    stats = planner.PlanStats(m=8, k=8, n=8, nnz_a=1, nnz_b=1, nnz_m=1,
                              wa=1, wb=1, wbt=1, pm=1, complement=False)
    tile_keys = tuple(planner.tile_cost_features(stats, 8))
    comm_keys = tuple(planner.ring_cost_features(stats, 2, 8)[1])
    return cost_keys, tile_keys, ("per_bcast_elem",) + comm_keys


class ProfileError(ValueError):
    """A profile failed validation or (de)serialization."""


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def fingerprint_tables(cost_constants, tile_cost, tile_gates,
                       dist_cost) -> str:
    """Stable content hash of the four constant tables (8 hex chars)."""
    payload = _canonical({
        "cost_constants": cost_constants, "tile_cost": tile_cost,
        "tile_gates": tile_gates, "dist_cost": dist_cost})
    return format(zlib.crc32(payload.encode()), "08x")


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """One backend's fitted planner constants, plus provenance.

    ``version`` is the cache token the planner keys its plan caches on:
    two profiles with different versions never share cached plans, even
    if their constants happen to coincide.  ``residuals`` records the
    relative RMS fit error per probe family (``row``/``tile``/``dist``) —
    all entries must be finite for the profile to validate.
    """

    name: str
    backend: Dict[str, Any]           # platform / device_kind / device_count
    cost_constants: Dict[str, Dict[str, float]]
    tile_cost: Dict[str, float]
    tile_gates: Dict[str, float]
    dist_cost: Dict[str, float]
    residuals: Dict[str, float] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: str = ""

    def __post_init__(self):
        if not self.version:
            object.__setattr__(self, "version", self.fingerprint())

    def fingerprint(self) -> str:
        return fingerprint_tables(self.cost_constants, self.tile_cost,
                                  self.tile_gates, self.dist_cost)

    # -- validation ---------------------------------------------------------

    def validate(self) -> "CalibrationProfile":
        """Raise :class:`ProfileError` unless every table is complete and
        every constant/residual is a finite, non-negative number."""
        import math

        def check_table(label, table, keys):
            missing = [k for k in keys if k not in table]
            if missing:
                raise ProfileError(f"{label}: missing keys {missing}")
            for k, v in table.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool) \
                        or not math.isfinite(v) or v < 0:
                    raise ProfileError(
                        f"{label}[{k!r}] = {v!r}: want finite number >= 0")

        cost_keys, tile_keys, dist_keys = required_table_keys()
        for alg, keys in cost_keys.items():
            if alg not in self.cost_constants:
                raise ProfileError(f"cost_constants: missing {alg!r}")
            check_table(f"cost_constants[{alg!r}]",
                        self.cost_constants[alg], keys)
        check_table("tile_cost", self.tile_cost, tile_keys)
        check_table("tile_gates", self.tile_gates, TILE_GATE_KEYS)
        check_table("dist_cost", self.dist_cost, dist_keys)
        for fam, r in self.residuals.items():
            if not math.isfinite(float(r)):
                raise ProfileError(f"residuals[{fam!r}] = {r!r}: not finite")
        if not self.version:
            raise ProfileError("empty version token")
        return self

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "schema": SCHEMA_VERSION,
            "name": self.name,
            "version": self.version,
            "backend": self.backend,
            "cost_constants": self.cost_constants,
            "tile_cost": self.tile_cost,
            "tile_gates": self.tile_gates,
            "dist_cost": self.dist_cost,
            "residuals": self.residuals,
            "meta": self.meta,
        }, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        try:
            raw = json.loads(text)
        except json.JSONDecodeError as e:
            raise ProfileError(f"not valid JSON: {e}") from e
        if not isinstance(raw, dict):
            raise ProfileError("profile JSON must be an object")
        schema = raw.get("schema")
        if schema != SCHEMA_VERSION:
            raise ProfileError(f"unsupported profile schema {schema!r} "
                               f"(this build reads {SCHEMA_VERSION})")
        try:
            return cls(
                name=str(raw["name"]),
                backend=dict(raw["backend"]),
                cost_constants={k: dict(v)
                                for k, v in raw["cost_constants"].items()},
                tile_cost=dict(raw["tile_cost"]),
                tile_gates=dict(raw["tile_gates"]),
                dist_cost=dict(raw["dist_cost"]),
                residuals=dict(raw.get("residuals", {})),
                meta=dict(raw.get("meta", {})),
                version=str(raw.get("version", "")),
            ).validate()
        except (KeyError, TypeError) as e:
            raise ProfileError(f"malformed profile: {e!r}") from e

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Backend signature + registry
# ---------------------------------------------------------------------------


def backend_signature(device="cuda") -> Dict[str, Any]:
    """Identity of the accelerator behind ``device``: the registry key.
    Deliberately coarse — platform, device kind, device count — so one
    calibration serves every same-shaped host.

    A CUDA device reports ``{"platform": "gpu", "device_kind": <its
    name>, "device_count": <visible cards>}``; ``"cpu"`` reports what the
    reference package reports on a CPU, so both key it ``cpu_cpu_1``.
    Asking for CUDA where there is no card raises.
    """
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return {"platform": "cpu", "device_kind": "cpu", "device_count": 1}
    if dev.type != "cuda":
        raise ValueError(f"no backend signature for device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(idx),
        "device_count": torch.cuda.device_count(),
    }


def device_meta(device="cuda") -> Dict[str, Any]:
    """Provenance of a measurement on ``device``: the device, torch and
    CUDA versions, and on a CUDA device the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them (a card set
    below its maximum power runs slower under load)."""
    import subprocess

    import torch
    meta = {"device": str(device), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if torch.device(device).type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
            card = out.stdout.strip().splitlines()
        except (OSError, subprocess.SubprocessError):
            card = []
        meta["card"] = card[0] if card else "not measured"
    return meta


def _checkout_profile_dir() -> str:
    """The committed registry of THIS checkout, anchored to the package
    location (…/src/repro_torch/tuning/profile.py -> <repo>/results/profiles, the
    registry the reference package reads too)
    rather than the process cwd."""
    root = os.path.abspath(__file__)
    for _ in range(4):                      # tuning -> repro_torch -> src -> repo
        root = os.path.dirname(root)
    return os.path.join(root, "results", "profiles")


def profile_dir() -> str:
    """Registry resolution: $REPRO_PROFILE_DIR if set, else a
    ``results/profiles`` under the cwd if one exists (running from a repo
    root), else the checkout's committed registry — so ``lookup()`` finds
    the default profile no matter where the process was started."""
    env = os.environ.get(PROFILE_DIR_ENV)
    if env:
        return env
    if os.path.isdir(DEFAULT_PROFILE_DIR):
        return DEFAULT_PROFILE_DIR
    return _checkout_profile_dir()


def profile_key(backend: Dict[str, Any]) -> str:
    """Registry filename stem for a backend signature."""
    raw = "_".join(str(backend.get(k, "unknown"))
                   for k in ("platform", "device_kind", "device_count"))
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", raw)


def profile_path(backend: Dict[str, Any], directory: Optional[str] = None
                 ) -> str:
    return os.path.join(directory or profile_dir(),
                        profile_key(backend) + ".json")


def register(profile: CalibrationProfile,
             directory: Optional[str] = None) -> str:
    """Write a validated profile into the registry under its backend key."""
    profile.validate()
    return profile.save(profile_path(profile.backend, directory))


def lookup(backend: Optional[Dict[str, Any]] = None,
           directory: Optional[str] = None
           ) -> Tuple[CalibrationProfile, bool]:
    """Find the profile for ``backend`` (default: the current process's).

    Returns ``(profile, exact)``: ``exact`` is False when the backend had
    no fitted profile and the committed default was returned instead.
    Raises FileNotFoundError when neither exists.
    """
    directory = directory or profile_dir()
    backend = backend or backend_signature()
    path = profile_path(backend, directory)
    if os.path.exists(path):
        return CalibrationProfile.load(path), True
    fallback = os.path.join(directory, DEFAULT_PROFILE_NAME + ".json")
    if os.path.exists(fallback):
        return CalibrationProfile.load(fallback), False
    raise FileNotFoundError(
        f"no profile for backend {backend} under {directory!r} and no "
        f"{DEFAULT_PROFILE_NAME}.json fallback")


# ---------------------------------------------------------------------------
# Active profile: what the planner reads through
# ---------------------------------------------------------------------------

_active: Optional[CalibrationProfile] = None

#: version token reported before any profile has been activated — the
#: shipped module-literal constants
BUILTIN_VERSION = "builtin"


def active_profile() -> Optional[CalibrationProfile]:
    """The last profile passed to :func:`activate` (None = shipped
    constants)."""
    return _active


def active_version() -> str:
    """Cache token component identifying the active profile."""
    return _active.version if _active is not None else BUILTIN_VERSION


def snapshot(name: str = "snapshot",
             backend: Optional[Dict[str, Any]] = None,
             **meta) -> CalibrationProfile:
    """Capture the LIVE planner/accumulator tables as a profile.

    This is how the shipped constants become the committed default
    profile, and how callers checkpoint hand-tuned tables before
    experimenting.
    """
    import importlib
    acc = importlib.import_module("repro_torch.core.accumulators")
    planner = importlib.import_module("repro_torch.core.planner")

    return CalibrationProfile(
        name=name,
        backend=backend if backend is not None else backend_signature(),
        cost_constants={k: dict(v) for k, v in acc.COST_CONSTANTS.items()},
        tile_cost=dict(planner.TILE_COST),
        tile_gates={
            "min_density": planner.TILE_MIN_DENSITY,
            "min_occupancy": planner.TILE_MIN_OCCUPANCY,
            "min_hit_rate": planner.TILE_MIN_HIT_RATE,
        },
        dist_cost=dict(planner.DIST_COST),
        meta=dict(meta),
    ).validate()


def activate(profile: CalibrationProfile) -> CalibrationProfile:
    """Install ``profile`` as the planner's cost model.

    Writes the profile's tables into the live module-level tables
    (in place, so every existing reader — cost hooks, tile/ring models,
    hand-tuning workflows — sees them) and records the profile as active.
    Previously cached plans are NOT served afterwards: the planner's cache
    keys include :func:`active_version` + a table fingerprint, so old
    entries simply stop matching.
    """
    global _active
    profile.validate()
    # importlib (not ``from repro_torch.core import ...``): this runs from the
    # bottom of planner.py's own module body when $REPRO_TUNE_PROFILE is
    # set, where the half-initialized module is only visible in
    # sys.modules, not yet as an attribute of the repro_torch.core package
    import importlib
    acc = importlib.import_module("repro_torch.core.accumulators")
    planner = importlib.import_module("repro_torch.core.planner")

    for alg, table in profile.cost_constants.items():
        acc.COST_CONSTANTS.setdefault(alg, {}).clear()
        acc.COST_CONSTANTS[alg].update(table)
    planner.TILE_COST.clear()
    planner.TILE_COST.update(profile.tile_cost)
    planner.DIST_COST.clear()
    planner.DIST_COST.update(profile.dist_cost)
    planner.TILE_MIN_DENSITY = profile.tile_gates["min_density"]
    planner.TILE_MIN_OCCUPANCY = profile.tile_gates["min_occupancy"]
    planner.TILE_MIN_HIT_RATE = profile.tile_gates["min_hit_rate"]
    _active = profile
    return profile


def activate_from_env() -> Optional[CalibrationProfile]:
    """Activate the profile named by ``$REPRO_TUNE_PROFILE``, if any.

    Called once from the bottom of ``planner.py`` (after its tables are
    defined), so child processes — benchmarks, CI jobs, the distributed
    bench's forced-device interpreter — inherit a fitted profile through
    the environment without code changes.  A missing var is a no-op; a
    bad path/profile raises (a requested calibration that silently fails
    to apply would invalidate every measurement made under it).
    """
    path = os.environ.get(PROFILE_ENV)
    if not path:
        return None
    return activate(CalibrationProfile.load(path))
