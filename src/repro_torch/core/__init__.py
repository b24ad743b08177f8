"""Core sparse engine: the paper's contribution as PyTorch modules."""
from .formats import CSR
from .semiring import (Semiring, SEMIRINGS, resolve_semiring, PLUS_TIMES,
                       BOOLEAN, MIN_PLUS, PLUS_FIRST)
from .spgemm import (spgemm, spgemm_dense, spgemm_esc, spgemm_heap,
                     spgemm_hash_jnp, symbolic, symbolic_flops, finalize)
from .schedule import (flops_per_row, rows_to_bins, bin_flop,
                       make_schedule_eager, lowbnd, lowest_p2, lowest_p2_arr,
                       bin_table_sizes, max_flop_per_bin_row,
                       masked_row_bound, guard_i32_flop)
from .recipe import (SpGEMMStats, measure_stats, model_costs, recommend,
                     choose_algorithm, choose_algorithm_from_stats)
from .plan import (SpGEMMPlan, plan_spgemm, structure_key, plan_cache_stats,
                   clear_plan_cache, PLAN_KINDS)

__all__ = [
    "CSR",
    "Semiring", "SEMIRINGS", "resolve_semiring", "PLUS_TIMES", "BOOLEAN",
    "MIN_PLUS", "PLUS_FIRST",
    "spgemm", "spgemm_dense", "spgemm_esc", "spgemm_heap", "spgemm_hash_jnp",
    "symbolic", "symbolic_flops", "finalize",
    "flops_per_row", "rows_to_bins", "bin_flop", "make_schedule_eager",
    "lowbnd", "lowest_p2", "lowest_p2_arr", "bin_table_sizes",
    "max_flop_per_bin_row", "masked_row_bound", "guard_i32_flop",
    "SpGEMMStats", "measure_stats", "model_costs", "recommend",
    "choose_algorithm", "choose_algorithm_from_stats",
    "SpGEMMPlan", "plan_spgemm", "structure_key", "plan_cache_stats",
    "clear_plan_cache", "PLAN_KINDS",
]
