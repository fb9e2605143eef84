"""Masked SpGEMM core: formats, semirings, row accumulators, the planner
and the entry points."""
from .masked_spgemm import (ALGORITHMS, MaskedSpGEMMResult, dense_oracle,
                            masked_spgemm, symbolic_phase)
from .planner import (Plan, PlanStats, clear_plan_cache, collect_stats,
                      cost_model_token, decide, plan, plan_cache_info,
                      rank_algorithms)

__all__ = [
    "ALGORITHMS", "MaskedSpGEMMResult", "dense_oracle", "masked_spgemm",
    "symbolic_phase", "Plan", "PlanStats", "clear_plan_cache",
    "collect_stats", "cost_model_token", "decide", "plan",
    "plan_cache_info", "rank_algorithms",
]
