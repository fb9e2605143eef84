"""Masked SpGEMM core: formats, semirings, row accumulators, the planner,
the entry points and their distributed counterparts."""
from .distributed import (Mesh, distributed_masked_spgemm, make_mesh,
                          ring_masked_matmul, ring_sparse_masked_spgemm,
                          row_parallel_masked_spgemm)
from .masked_spgemm import (ALGORITHMS, MaskedSpGEMMResult, dense_oracle,
                            masked_spgemm, masked_spgemm_batched,
                            symbolic_phase)
from .planner import (DistPlan, Plan, PlanStats, clear_plan_cache,
                      collect_stats, cost_model_token, decide,
                      decide_distributed, distributed_costs, explain,
                      explain_cached, feature_regime, plan, plan_batch,
                      plan_cache_info, plan_distributed, rank_algorithms)

__all__ = [
    "ALGORITHMS", "MaskedSpGEMMResult", "dense_oracle", "masked_spgemm",
    "masked_spgemm_batched", "symbolic_phase", "distributed_masked_spgemm",
    "ring_masked_matmul", "ring_sparse_masked_spgemm",
    "row_parallel_masked_spgemm", "Mesh", "make_mesh", "DistPlan", "Plan",
    "PlanStats", "clear_plan_cache", "collect_stats", "cost_model_token",
    "decide", "decide_distributed", "distributed_costs", "explain",
    "explain_cached", "feature_regime", "plan", "plan_batch",
    "plan_cache_info", "plan_distributed", "rank_algorithms",
]
