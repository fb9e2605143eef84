"""``python -m repro_torch.autotune`` — serving-knob autotuning entry point.

Thin shim over :mod:`repro_torch.tuning.autotune` (mirrors
``repro_torch.tune`` / ``repro_torch.tuning.cli``): replay a recorded
traffic trace deterministically on a device, search the ``QueryEngine``
knob grid, pin the winner under ``results/profiles/``.
"""
from repro_torch.tuning.autotune import main

if __name__ == "__main__":
    raise SystemExit(main())
