"""Online cost-model drift detection from modeled-vs-measured residuals.

The planner elects kernels from fitted cost constants
(``repro_torch.tuning``); the paper's point — density, mask structure and
cache behavior dominate — means those constants go stale as traffic or
hardware shifts.  Every ``serve.exec`` span carries the planner's
``modeled_ms`` beside its measured duration, which on a CUDA device ends
in a synchronise (the engine's exec span times the device work, not its
dispatch); this module folds the residual
``measured / (modeled * bucket_size)`` into streaming statistics and
flags when calibration has drifted past a multiplicative **band**.

Statistics are kept per ``(family, algorithm, regime)`` key:

* ``family`` — the probe family ``repro_torch.tune --only`` refits
  (``row`` for the row-wise kernels, ``tile``, ``dist``), so a flag
  maps directly onto the retune command that fixes it;
* ``algorithm`` — the elected kernel (msa/hash/...);
* ``regime`` — :func:`repro_torch.core.planner.feature_regime`'s coarse
  log-bucketed feature signature, because a model can be calibrated at
  one density and wrong at another.

Residuals are folded in **log space** (a model 4x high and 4x low are
equally wrong) through two estimators: Welford's online mean/variance
(exact, all-time) and an EWMA (recent-weighted) — the EWMA drives
flagging so a one-off cold-start outlier decays instead of
poisoning the verdict, while Welford's variance reports confidence.

Flags carry a concrete recommendation keyed by
``planner.cost_model_token()``: when the token changes (the table was
retuned or hand-edited) all statistics reset — residuals measured
against the old model say nothing about the new one.

Route discipline: ``route="burst"`` spans are skipped — the burst
executor replays a compiled program whose cost the per-query model
does not price.  Bucketed spans measure the whole bucket, so the
modeled single-query cost is scaled by the ``size`` attr.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["DriftDetector", "DriftFlag", "DriftReport", "KernelStats",
           "family_of"]

#: elected-algorithm -> ``repro_torch.tune`` probe family
_ALGO_FAMILY = {
    "msa": "row", "hash": "row", "mca": "row", "heap": "row",
    "heapdot": "row", "inner": "row",
    "tile": "tile", "block": "tile",
    "dist": "dist", "distributed": "dist", "spsumma": "dist",
}


def family_of(algorithm: Optional[str]) -> str:
    """Map an elected algorithm to its retune probe family."""
    return _ALGO_FAMILY.get(str(algorithm), "row")


def _default_token() -> Optional[str]:
    # deferred: repro_torch.core.planner imports repro_torch.obs at import
    from repro_torch.core import planner
    try:
        return planner.cost_model_token()
    except Exception:
        return None


class KernelStats:
    """Welford + EWMA over log residuals for one (family, algo, regime)."""

    __slots__ = ("count", "mean", "_m2", "ewma", "alpha")

    def __init__(self, alpha: float = 0.2):
        self.count = 0
        self.mean = 0.0        # Welford mean of log residuals
        self._m2 = 0.0
        self.ewma = 0.0        # recent-weighted log residual
        self.alpha = alpha

    def update(self, log_residual: float) -> None:
        self.count += 1
        delta = log_residual - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (log_residual - self.mean)
        if self.count == 1:
            self.ewma = log_residual
        else:
            self.ewma += self.alpha * (log_residual - self.ewma)

    @property
    def variance(self) -> float:
        return self._m2 / (self.count - 1) if self.count > 1 else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)

    @property
    def mean_residual(self) -> float:
        """Geometric-mean measured/modeled ratio (1.0 = calibrated)."""
        return math.exp(self.mean)

    @property
    def ewma_residual(self) -> float:
        """Recent-weighted measured/modeled ratio."""
        return math.exp(self.ewma)


@dataclasses.dataclass(frozen=True)
class DriftFlag:
    """One (family, algorithm, regime) whose calibration drifted."""

    family: str
    algorithm: str
    regime: str
    ewma_residual: float
    mean_residual: float
    count: int
    band: float
    reason: str

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Detector summary: flags plus the retune command that fixes them."""

    flags: Tuple[DriftFlag, ...]
    families: Tuple[str, ...]
    command: str
    token: Optional[str]

    def as_dict(self) -> Dict:
        return {"flags": [f.as_dict() for f in self.flags],
                "families": list(self.families),
                "command": self.command, "token": self.token}


class DriftDetector:
    """Streams residuals into per-kernel statistics and flags drift.

    ``band`` is the flag threshold as a multiplicative factor: a key is
    flagged when its EWMA residual leaves ``[1/band, band]`` after at
    least ``min_count`` observations.  ``token_fn`` supplies the cost
    table identity (defaults to ``planner.cost_model_token``); a token
    change resets all statistics.
    """

    def __init__(self, *, band: float = 4.0, min_count: int = 8,
                 alpha: float = 0.2,
                 token_fn: Callable[[], Optional[str]] = _default_token):
        if band <= 1.0:
            raise ValueError(f"band must be > 1.0, got {band}")
        self.band = float(band)
        self.min_count = int(min_count)
        self.alpha = float(alpha)
        self._token_fn = token_fn
        self._token: Optional[str] = None
        self._stats: Dict[Tuple[str, str, str], KernelStats] = {}

    # -- ingest -------------------------------------------------------------

    def _check_token(self) -> None:
        tok = self._token_fn()
        if tok != self._token:
            if self._token is not None and self._stats:
                self._stats.clear()    # new model: old residuals are void
            self._token = tok

    def observe(self, algorithm: Optional[str], regime: Optional[str],
                residual: float) -> None:
        """Fold one normalized residual (measured/modeled ratio)."""
        if not (residual > 0.0) or not math.isfinite(residual):
            return
        self._check_token()
        key = (family_of(algorithm), str(algorithm), str(regime or "-"))
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = KernelStats(self.alpha)
        st.update(math.log(residual))

    def observe_record(self, rec: Dict) -> None:
        """Sink-side ingest: folds a ``serve.exec`` span record carrying
        ``modeled_ms`` (other records are ignored)."""
        # cheap pre-filter: this sits on the per-record emit path, and
        # almost every record (submits, counters, queue waits) is not an
        # exec span — don't pay residual_record's dict build for those
        if rec.get("name") != "serve.exec" or "counter" in rec:
            return
        from .export import residual_record
        r = residual_record(rec)
        if r is None or r.get("route") == "burst":
            return
        self.observe(r.get("algorithm"), r.get("regime"), r["residual"])

    def ingest(self, spans: List[Dict]) -> int:
        """Fold a batch of captured span records; returns #observed."""
        before = sum(s.count for s in self._stats.values())
        for rec in spans or ():
            self.observe_record(rec)
        return sum(s.count for s in self._stats.values()) - before

    # -- reads --------------------------------------------------------------

    @property
    def token(self) -> Optional[str]:
        return self._token

    def stats(self) -> Dict[Tuple[str, str, str], KernelStats]:
        return dict(self._stats)

    def flags(self) -> List[DriftFlag]:
        log_band = math.log(self.band)
        out: List[DriftFlag] = []
        for (family, algo, regime), st in sorted(self._stats.items()):
            if st.count < self.min_count or abs(st.ewma) <= log_band:
                continue
            direction = ("measured >> modeled" if st.ewma > 0
                         else "modeled >> measured")
            out.append(DriftFlag(
                family=family, algorithm=algo, regime=regime,
                ewma_residual=st.ewma_residual,
                mean_residual=st.mean_residual, count=st.count,
                band=self.band,
                reason=(f"cost-model drift: {algo} (family {family}, "
                        f"regime {regime}) residual "
                        f"{st.ewma_residual:.3g}x over {st.count} obs "
                        f"({direction}, band {self.band:g}x)")))
        return out

    def report(self) -> DriftReport:
        flags = tuple(self.flags())
        families = tuple(sorted({f.family for f in flags}))
        command = ""
        if families:
            command = ("re-run `python -m repro_torch.tune --only "
                       f"{','.join(families)}` (cost table "
                       f"{self._token or 'unknown'})")
        return DriftReport(flags, families, command, self._token)

    def snapshot(self) -> Dict[str, Dict]:
        """Flat per-key statistics for /metrics gauge export."""
        out: Dict[str, Dict] = {}
        for (family, algo, regime), st in sorted(self._stats.items()):
            out[f"{family}/{algo}/{regime}"] = {
                "family": family, "algorithm": algo, "regime": regime,
                "count": st.count, "mean_residual": st.mean_residual,
                "ewma_residual": st.ewma_residual,
                "log_stddev": st.stddev,
            }
        return out
