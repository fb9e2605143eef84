"""``python -m repro_torch.tune`` — calibrate the planner for a device.

    python -m repro_torch.tune                      # full probes, register
    python -m repro_torch.tune --smoke              # minute-scale CI fit
    python -m repro_torch.tune --only row,tile      # refit selected families
    python -m repro_torch.tune --out my.json        # write here, no registry
    python -m repro_torch.tune --validate p.json    # load + validate only
    python -m repro_torch.tune --export-defaults p.json  # snapshot tables
    python -m repro_torch.tune --device cpu         # probe the host

The probes run on ``--device`` (default ``cuda``).  The default probes
``row,tile`` and inherits ``DIST_COST`` from the base profile: the ``dist``
probes run their meshes on ``--device``, and on a one-card host every shard
shares the card, so their rotations cross no link; ``--only dist`` fits
them all the same.  The fitted profile is registered under
``results/profiles/`` keyed by the device's backend signature (unless
``--out`` redirects it) and is installed with
``repro_torch.tuning.activate(profile)`` in-process or the
``REPRO_TUNE_PROFILE`` env var for whole process trees.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from . import profile as profile_mod
from .probes import FAMILIES

#: what the port probes when ``--only`` is not given
DEFAULT_FAMILIES = ("row", "tile")


def _parse_families(spec: str) -> Sequence[str]:
    fams = [f.strip() for f in spec.split(",") if f.strip()]
    unknown = sorted(set(fams) - set(FAMILIES))
    if unknown:
        raise SystemExit(
            f"repro_torch.tune: unknown --only families {unknown}; "
            f"valid names: {', '.join(FAMILIES)}")
    if not fams:
        raise SystemExit("repro_torch.tune: --only given but no families "
                         "named")
    return fams


def _summarize(p: profile_mod.CalibrationProfile, base) -> str:
    lines = [f"profile {p.name!r} version={p.version} "
             f"backend={p.backend}"]
    for fam in FAMILIES:
        r = p.residuals.get(fam)
        lines.append(f"  {fam:4s} residual: "
                     + (f"{r:.3f} rel RMS" if r is not None else "inherited"))
    changed = sum(
        1 for alg, tbl in p.cost_constants.items()
        for k, v in tbl.items() if v != base.cost_constants[alg][k])
    lines.append(f"  row constants changed: {changed}; "
                 f"tile cost: {p.tile_cost}; tile gates: {p.tile_gates}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="fit a device's planner cost-model profile")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny probe grids + 1 timed iteration (CI)")
    ap.add_argument("--only", default="",
                    help=f"comma-separated probe families to refit "
                         f"(subset of: {','.join(FAMILIES)}; default: "
                         f"{','.join(DEFAULT_FAMILIES)}); the rest are "
                         f"inherited from the active profile")
    ap.add_argument("--out", default=None,
                    help="write the fitted profile JSON here instead of "
                         "registering it under results/profiles/")
    ap.add_argument("--name", default=None,
                    help="profile name (default: backend key)")
    ap.add_argument("--validate", metavar="PATH", default=None,
                    help="load + validate a profile JSON and exit")
    ap.add_argument("--export-defaults", metavar="PATH", default=None,
                    help="snapshot the live (shipped or activated) "
                         "constant tables as a profile JSON and exit")
    ap.add_argument("--device", default="cuda",
                    help="device the probes run on and the profile is "
                         "keyed by (default: cuda)")
    args = ap.parse_args(argv)

    if args.validate:
        p = profile_mod.CalibrationProfile.load(args.validate)
        print(f"OK: {args.validate} validates "
              f"(name={p.name!r}, version={p.version})")
        return 0

    backend = profile_mod.backend_signature(args.device)
    if args.export_defaults:
        snap = profile_mod.snapshot(
            name=args.name or profile_mod.DEFAULT_PROFILE_NAME,
            backend=backend,
            note="snapshot of the shipped planner constants")
        path = snap.save(args.export_defaults)
        print(f"wrote {path} (version={snap.version})")
        return 0

    families = (_parse_families(args.only) if args.only
                else DEFAULT_FAMILIES)

    import repro_torch.core.planner  # noqa: F401
    from .fit import fit_profile
    from .probes import run_probes

    # base = whatever the process currently plans with (shipped constants,
    # or an already-activated profile) — unprobed families inherit it.
    # The planner installs $REPRO_TUNE_PROFILE when it is imported (above),
    # so a profile named there is the base, under its own name.
    base = profile_mod.active_profile() or profile_mod.snapshot(
        name="builtin", backend=backend)
    meta = profile_mod.device_meta(args.device)
    print(f"[tune] backend: {backend}")
    if "card" in meta:
        print(f"[tune] card: {meta['card']}")
    print(f"[tune] probing families: {', '.join(families)}"
          + (" (smoke grids)" if args.smoke else ""))
    ms = run_probes(families, smoke=args.smoke, device=args.device)
    print(f"[tune] {len(ms)} measurements; fitting...")
    fitted = fit_profile(
        ms, base, families=families,
        name=args.name or profile_mod.profile_key(backend),
        backend=backend, smoke=bool(args.smoke), **meta)

    if args.out:
        path = fitted.save(args.out)
    else:
        path = profile_mod.register(fitted)
    print(_summarize(fitted, base))
    print(f"[tune] wrote {path}")
    print(f"[tune] activate with repro_torch.tuning.activate("
          f"CalibrationProfile.load({path!r})) or "
          f"REPRO_TUNE_PROFILE={path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
