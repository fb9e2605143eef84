"""The port stands alone: every module of repro_torch, and chip_smoke.py,
imports with JAX blocked and loads no module of the reference package."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
assert not [m for m in sys.modules if sys.modules[m] is not None
            and (m == "jax" or m.startswith("jax."))]
print(len(names), "modules")
"""


def test_port_imports_without_jax_or_reference():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 96
