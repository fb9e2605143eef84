"""Elastic / fault-tolerant orchestration (the reference's
``repro/launch/elastic.py``).

* Failure detection: workers touch a heartbeat file each step; a stale or
  missing one marks the worker's devices unhealthy (``Heartbeat``).
* Restart: the remaining workers relaunch with the same entry point; the
  mesh is rebuilt by ``make_elastic_mesh(n_healthy)`` (TP kept, DP
  shrunk), the checkpoint holds full arrays, and the stateless data
  stream replays from the checkpointed step, so nothing is lost beyond
  the last checkpoint interval (``plan_restart``).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.launch.mesh import make_elastic_mesh


@dataclasses.dataclass
class Heartbeat:
    """File-based heartbeat: workers ``beat``, the coordinator checks the
    age against ``timeout_s``."""
    path: str
    timeout_s: float = 60.0

    def beat(self):
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def healthy(self) -> bool:
        try:
            with open(self.path) as f:
                return time.time() - float(f.read()) < self.timeout_s
        except (OSError, ValueError):
            return False


def plan_restart(n_healthy: int, *, model_parallel: int = 16):
    """Mesh plan for a degraded restart: ``{"mesh_shape": {"data": dp,
    "model": tp}, "dp": dp, "tp": tp}``."""
    shape = make_elastic_mesh(n_healthy, model_parallel=model_parallel)
    return {"mesh_shape": dict(shape), "dp": shape["data"],
            "tp": shape["model"]}
