"""``python -m repro_torch.tune``: fit a device's planner calibration
profile (probe -> least-squares fit -> registry).  See
``repro_torch/tuning/cli.py`` for the flags and
``repro_torch/tuning/__init__.py`` for the subsystem overview."""
from repro_torch.tuning.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
