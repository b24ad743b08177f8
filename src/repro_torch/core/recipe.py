"""The paper's recipe (sections 4.2.4 + 5.7, Table 4): pick the SpGEMM
algorithm from matrix statistics and the sortedness requirement.

Port of ``repro.core.recipe``.  Cost models (paper Eq. 1 / Eq. 2):

  T_heap = sum_i flop(c_i*) * log2 nnz(a_i*)
  T_hash = flop * c + [sorted] sum_i nnz(c_i*) * log2 nnz(c_i*)
  T_esc  = flop * log2(flop)
  T_pb   = 2 * flop + nnz(C)

The decision table and its thresholds are copied verbatim: they are
Table 4's, calibrated on KNL, and the reference's block-density and
propagation-blocking rows stay in place so both packages choose alike.
:func:`aggregate_stats` folds a fleet's member statistics into the one
the batched planner (``core.batch``) chooses from.  The measured
(autotune) mode is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .formats import CSR
from . import schedule as sched

#: Average probe count under linear probing at the paper's <=50% load
#: factor; c in Eq. 2.
HASH_COLLISION_FACTOR = 1.5


@dataclass(frozen=True)
class SpGEMMStats:
    """Inputs to the recipe -- everything Table 4 keys on."""
    n_rows: int
    n_cols: int
    nnz_a: float
    flop: float
    nnz_c_est: float
    max_row_flop: float
    mean_row_nnz_a: float
    row_skew: float            # max_row_flop / mean_row_flop (G500 vs ER)
    compression_ratio: float   # flop / nnz(C)  (paper section 5.4.4)
    density_ef: float          # nnz_a / n_rows == edge factor
    #: mean occupancy of occupied 8x8 tiles (the ``bcsr`` gate)
    block_density: float = 0.0
    #: nnz(mask) / (m * n), complement applied; 1.0 when unmasked
    mask_density: float = 1.0
    has_mask: bool = False
    #: exact Eq. 1 term ``sum_i flop(c_i*) * log2(max(nnz(a_i*), 2))``;
    #: 0.0 means "not collected" (the cost model then uses the mean)
    eq1_heap_log: float = 0.0
    #: exact Eq. 2 sort term ``sum_i nnz(c_i*) * log2(max(nnz(c_i*), 2))``
    eq2_hash_sort: float = 0.0


#: minimum mean tile occupancy for the block path to beat scalar hash
MXU_MIN_TILE_DENSITY = 0.25
#: cell-count ceiling for the automatic block-density probe
AUTO_PROBE_CELLS = 1 << 20
#: compression-factor ceiling for the propagation-blocking lane
PB_MAX_COMPRESSION = 1.25
#: mask density below which the hash family wins the masked use case
MASKED_HASH_DENSITY = 0.25
_PROBE_TILE = (8, 8)


def block_density_of(a: CSR, tile=_PROBE_TILE) -> float:
    """Mean occupancy of occupied tiles, from the sparse structure (the
    reference densifies; both count nonzero-valued cells and pad ragged
    shapes up to the tile grid)."""
    bm, bn = tile
    _, n = a.shape
    gn = -(-n // bn)
    nnz = int(a.nnz)
    ip = a.indptr.cpu().numpy().astype(np.int64)
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(ip))[:nnz]
    cols = a.indices[:nnz].cpu().numpy().astype(np.int64)
    live = a.data[:nnz].cpu().numpy() != 0
    rows, cols = rows[live], cols[live]
    if not rows.size:
        return 0.0
    n_occ = np.unique((rows // bm) * gn + cols // bn).size
    return float(rows.size) / (n_occ * bm * bn)


def measure_stats(a: CSR, b: CSR, row_nnz_c=None,
                  probe_blocks: bool = False,
                  mask: CSR | None = None,
                  complement_mask: bool = False,
                  a_row_nnz=None) -> SpGEMMStats:
    """Host-side statistics.  ``a_row_nnz`` (a chain intermediate's
    recorded per-row counts) replaces A's count statistics; the flop side
    always comes from :func:`schedule.flops_per_row`."""
    flop = sched.flops_per_row(a, b)
    total_flop = float(flop.to(torch.int64).sum())
    if a_row_nnz is not None:
        row_nnz_a = torch.as_tensor(a_row_nnz, device=flop.device)
        nnz_a = float(row_nnz_a.to(torch.int64).sum())
    else:
        row_nnz_a = a.row_nnz()
        nnz_a = float(a.nnz)
    if row_nnz_c is None:
        # cheap upper bound; the exact counts come from core.spgemm.symbolic
        row_c = torch.clamp(flop, max=b.n_cols)
        if mask is not None:
            row_c = sched.masked_row_bound(row_c, mask, complement_mask)
    else:
        row_c = torch.as_tensor(row_nnz_c, device=flop.device)
    nnz_c = float(row_c.to(torch.int64).sum())
    # Eq. 1 / Eq. 2 log terms are per-row sums (log2 is concave, so a
    # mean substitute inverts rankings on skewed inputs)
    log2_a = torch.log2(torch.clamp(row_nnz_a.to(torch.float64), min=2.0))
    eq1 = float((flop.to(torch.float64) * log2_a).sum())
    rc = row_c.to(torch.float64)
    eq2 = float((rc * torch.log2(torch.clamp(rc, min=2.0))).sum())
    max_flop = float(flop.max()) if flop.numel() else 0.0
    mean_flop = total_flop / max(a.n_rows, 1)
    cells = max(a.n_rows * b.n_cols, 1)
    if mask is None:
        mask_density = 1.0
    else:
        frac = float(mask.nnz) / cells
        mask_density = (1.0 - frac) if complement_mask else frac
    return SpGEMMStats(
        n_rows=a.n_rows, n_cols=b.n_cols, nnz_a=nnz_a, flop=total_flop,
        nnz_c_est=max(nnz_c, 1.0), max_row_flop=max_flop,
        mean_row_nnz_a=nnz_a / max(a.n_rows, 1),
        row_skew=max_flop / max(mean_flop, 1e-9),
        compression_ratio=total_flop / max(nnz_c, 1.0),
        density_ef=nnz_a / max(a.n_rows, 1),
        block_density=(block_density_of(a) if probe_blocks else 0.0),
        mask_density=mask_density, has_mask=mask is not None,
        eq1_heap_log=eq1, eq2_hash_sort=eq2)


def aggregate_stats(stats_list) -> SpGEMMStats:
    """Fleet-level statistics for a batch of products (``core.batch``).

    Counts (``n_rows``, ``nnz_a``, ``flop``, ``nnz_c_est`` and the Eq. 1 /
    Eq. 2 row sums) add up across the fleet, which runs as stacked rows of
    one logical product; bounds (``max_row_flop``, ``n_cols``) take the
    max; the ratios are recomputed from the aggregates, so one heavy
    product dominates as one heavy row does within a product.
    ``has_mask`` is true if any member is masked, ``mask_density`` is the
    member mean, and ``block_density`` stays 0: the block path does not
    run batched.
    """
    stats_list = list(stats_list)
    assert stats_list, "aggregate_stats needs at least one member"
    n_rows = sum(s.n_rows for s in stats_list)
    nnz_a = sum(s.nnz_a for s in stats_list)
    flop = sum(s.flop for s in stats_list)
    nnz_c = sum(s.nnz_c_est for s in stats_list)
    max_row_flop = max(s.max_row_flop for s in stats_list)
    mean_flop = flop / max(n_rows, 1)
    return SpGEMMStats(
        n_rows=n_rows, n_cols=max(s.n_cols for s in stats_list),
        nnz_a=nnz_a, flop=flop, nnz_c_est=max(nnz_c, 1.0),
        max_row_flop=max_row_flop,
        mean_row_nnz_a=nnz_a / max(n_rows, 1),
        row_skew=max_row_flop / max(mean_flop, 1e-9),
        compression_ratio=flop / max(nnz_c, 1.0),
        density_ef=nnz_a / max(n_rows, 1), block_density=0.0,
        mask_density=(sum(s.mask_density for s in stats_list)
                      / len(stats_list)),
        has_mask=any(s.has_mask for s in stats_list),
        eq1_heap_log=sum(s.eq1_heap_log for s in stats_list),
        eq2_hash_sort=sum(s.eq2_hash_sort for s in stats_list))


# ---------------------------------------------------------------------------
# Theoretical cost model (Eq. 1 / Eq. 2)
# ---------------------------------------------------------------------------

def cost_heap(stats: SpGEMMStats) -> float:
    """Eq. 1; the exact per-row sum when collected, else the mean."""
    if stats.eq1_heap_log > 0.0:
        return stats.eq1_heap_log
    return stats.flop * max(1.0, math.log2(max(stats.mean_row_nnz_a, 2.0)))


def cost_hash(stats: SpGEMMStats, sorted_output: bool) -> float:
    """Eq. 2, with the sort term only for sorted output."""
    t = stats.flop * HASH_COLLISION_FACTOR
    if sorted_output:
        if stats.eq2_hash_sort > 0.0:
            t += stats.eq2_hash_sort
        else:
            mean_row_c = stats.nnz_c_est / max(stats.n_rows, 1)
            t += stats.nnz_c_est * max(1.0, math.log2(max(mean_row_c, 2.0)))
    return t


def cost_esc(stats: SpGEMMStats) -> float:
    return stats.flop * max(1.0, math.log2(max(stats.flop, 2.0)))


def cost_pb(stats: SpGEMMStats) -> float:
    """Propagation blocking: two streaming passes plus the output."""
    return 2.0 * stats.flop + stats.nnz_c_est


def model_costs(stats: SpGEMMStats, sorted_output: bool) -> dict:
    """Eq. 1/Eq. 2 scores per algorithm family (lower wins)."""
    return {"heap": cost_heap(stats),
            "hash": cost_hash(stats, sorted_output),
            "esc": cost_esc(stats),
            "pb": cost_pb(stats)}


# ---------------------------------------------------------------------------
# Empirical decision table (Table 4)
# ---------------------------------------------------------------------------

def choose_algorithm_from_stats(stats: SpGEMMStats, sorted_output: bool,
                                use_case: str = "AxA",
                                semiring: str = "plus_times") -> str:
    """Table 4 (+ section 4.2.4), exactly as the reference decides.

    use_case: "AxA" | "LxU" | "tall_skinny" | "masked" | "batch" | "dist".
    """
    high_cr = stats.compression_ratio > 2.0
    dense_ef = stats.density_ef > 8.0
    skewed = stats.row_skew > 8.0

    if use_case == "batch":
        if sorted_output:
            return "esc" if high_cr else "heap"
        return "hash"

    if (stats.block_density >= MXU_MIN_TILE_DENSITY
            and semiring == "plus_times"
            and not stats.has_mask
            and use_case not in ("masked", "batch", "dist")):
        return "bcsr"

    if (stats.compression_ratio <= PB_MAX_COMPRESSION
            and sorted_output
            and semiring == "plus_times"
            and not stats.has_mask
            and use_case == "AxA"):
        return "pb"

    # boolean semirings with relaxed sortedness: hash family, per C8
    if semiring in ("boolean", "any_pair") and not sorted_output:
        return "hash_vector" if dense_ef else "hash"

    if use_case == "masked":
        if stats.mask_density <= MASKED_HASH_DENSITY or high_cr:
            return "hash"
        return "heap"

    if use_case == "LxU":
        # Fig 17: heap best at low CR, hash otherwise
        return "hash" if high_cr else "heap"
    if use_case == "tall_skinny":
        return "hash_vector" if (dense_ef and sorted_output) else "hash"
    # AxA, Table 4a/4b
    if not dense_ef and not skewed:
        return "heap" if sorted_output else "hash_vector"
    if dense_ef and skewed:
        return "hash"
    if high_cr and not sorted_output:
        return "hash_vector"
    return "hash"


def _resolve_probe_blocks(probe_blocks, a: CSR, semiring: str, mask,
                          use_case: str, a_row_nnz=None) -> bool:
    """``probe_blocks="auto"``: probe only bcsr-eligible requests whose
    cell count is below :data:`AUTO_PROBE_CELLS`, as the reference."""
    if probe_blocks != "auto":
        return bool(probe_blocks)
    if semiring != "plus_times" or mask is not None \
            or use_case in ("masked", "batch", "dist") \
            or a_row_nnz is not None:
        return False
    return a.n_rows * a.n_cols <= AUTO_PROBE_CELLS


def recommend(a: CSR, b: CSR, sorted_output: bool = False,
              use_case: str = "AxA",
              probe_blocks: bool | str = "auto",
              semiring: str = "plus_times",
              mask: CSR | None = None,
              complement_mask: bool = False,
              row_nnz_c=None, a_row_nnz=None,
              mode: str = "heuristic") -> tuple[str, SpGEMMStats]:
    """Measure stats and choose -- returns ``(algorithm, stats)``.

    ``row_nnz_c`` takes the symbolic phase's exact per-row counts (the
    planner passes them); ``a_row_nnz`` is the mid-chain hook.
    """
    if mode != "heuristic":
        raise NotImplementedError(
            f"recipe mode {mode!r} (autotune) is not ported yet")
    probe_blocks = _resolve_probe_blocks(probe_blocks, a, semiring, mask,
                                         use_case, a_row_nnz)
    stats = measure_stats(a, b, row_nnz_c=row_nnz_c,
                          probe_blocks=probe_blocks, mask=mask,
                          complement_mask=complement_mask,
                          a_row_nnz=a_row_nnz)
    return choose_algorithm_from_stats(stats, sorted_output, use_case,
                                       semiring=semiring), stats


def choose_algorithm(a: CSR, b: CSR, sorted_output: bool = False,
                     use_case: str = "AxA",
                     probe_blocks: bool | str = "auto",
                     semiring: str = "plus_times",
                     mask: CSR | None = None,
                     complement_mask: bool = False) -> str:
    """:func:`recommend` without the stats -- what ``spgemm(algorithm=
    "auto")`` calls."""
    algo, _ = recommend(a, b, sorted_output=sorted_output, use_case=use_case,
                        probe_blocks=probe_blocks, semiring=semiring,
                        mask=mask, complement_mask=complement_mask)
    return algo
