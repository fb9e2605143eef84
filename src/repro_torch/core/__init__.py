"""Masked SpGEMM core: formats, semirings, row accumulators, the planner
and the entry points."""
from .masked_spgemm import (ALGORITHMS, MaskedSpGEMMResult, dense_oracle,
                            masked_spgemm, masked_spgemm_batched,
                            symbolic_phase)
from .planner import (Plan, PlanStats, clear_plan_cache, collect_stats,
                      cost_model_token, decide, explain, explain_cached,
                      feature_regime, plan, plan_batch, plan_cache_info,
                      rank_algorithms)

__all__ = [
    "ALGORITHMS", "MaskedSpGEMMResult", "dense_oracle", "masked_spgemm",
    "masked_spgemm_batched", "symbolic_phase", "Plan", "PlanStats",
    "clear_plan_cache", "collect_stats", "cost_model_token", "decide",
    "explain", "explain_cached", "feature_regime", "plan", "plan_batch",
    "plan_cache_info", "rank_algorithms",
]
