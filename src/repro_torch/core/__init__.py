"""Core sparse engine: the paper's contribution as PyTorch modules."""
from .formats import CSR, BCSR, csr_to_bcsr, bcsr_to_csr, csr_transpose
from .semiring import (Semiring, SEMIRINGS, resolve_semiring, PLUS_TIMES,
                       BOOLEAN, MIN_PLUS, PLUS_FIRST)
from .spgemm import (spgemm, spgemm_dense, spgemm_esc, spgemm_heap,
                     spgemm_hash_jnp, spmm, symbolic, symbolic_flops,
                     finalize)
from .schedule import (flops_per_row, rows_to_bins, bin_flop,
                       make_schedule_eager, lowbnd, lowest_p2, lowest_p2_arr,
                       bin_table_sizes, max_flop_per_bin_row,
                       masked_row_bound, guard_i32_flop, chained_flop_bound)
from .recipe import (SpGEMMStats, measure_stats, model_costs, recommend,
                     choose_algorithm, choose_algorithm_from_stats,
                     aggregate_stats)
from .plan import (SpGEMMPlan, plan_spgemm, structure_key, plan_cache_stats,
                   clear_plan_cache, PLAN_KINDS)
from .bcsr import BCSRPlan, plan_bcsr, bcsr_structure_key
from .pb import PBPlan, plan_pb
from .chain import (ChainPlan, plan_chain, plan_galerkin, galerkin,
                    plan_power, GramPlan, plan_gram, gram,
                    BatchedPowerPlan, plan_batch_power)
from .batch import BatchClass, BatchedPlan, plan_batch, spgemm_batch

__all__ = [
    "CSR", "BCSR", "csr_to_bcsr", "bcsr_to_csr", "csr_transpose",
    "Semiring", "SEMIRINGS", "resolve_semiring", "PLUS_TIMES", "BOOLEAN",
    "MIN_PLUS", "PLUS_FIRST",
    "spgemm", "spgemm_dense", "spgemm_esc", "spgemm_heap", "spgemm_hash_jnp",
    "spmm", "symbolic", "symbolic_flops", "finalize",
    "flops_per_row", "rows_to_bins", "bin_flop", "make_schedule_eager",
    "lowbnd", "lowest_p2", "lowest_p2_arr", "bin_table_sizes",
    "max_flop_per_bin_row", "masked_row_bound", "guard_i32_flop",
    "chained_flop_bound",
    "SpGEMMStats", "measure_stats", "model_costs", "recommend",
    "choose_algorithm", "choose_algorithm_from_stats", "aggregate_stats",
    "SpGEMMPlan", "plan_spgemm", "structure_key", "plan_cache_stats",
    "clear_plan_cache", "PLAN_KINDS",
    "BCSRPlan", "plan_bcsr", "bcsr_structure_key",
    "PBPlan", "plan_pb",
    "ChainPlan", "plan_chain", "plan_galerkin", "galerkin", "plan_power",
    "GramPlan", "plan_gram", "gram", "BatchedPowerPlan", "plan_batch_power",
    "BatchClass", "BatchedPlan", "plan_batch", "spgemm_batch",
]
