"""The hash SpGEMM pipeline around the CUDA kernels (paper Fig. 7).

Port of ``repro.kernels.spgemm_hash.ops``:

  1. ``RowsToThreads`` (``core.schedule``): flop per row -> equal-flop bins;
  2. table sizing (Fig. 7 lines 9-12): the static table allocation is
     ``lowest_p2(min(N_col, max_row_flop) + 1)`` and each bin carries its
     own power-of-two size ``bin_tsize[b]``;
  3. symbolic kernel -> exact row nnz -> ``indptr_c``;
  4. numeric kernel -> (indices, values), unsorted within rows (C8).

The planned path (``core.plan``) passes ``schedule=(offsets, bin_tsize)``
and ``indptr_c=``, so a structure-identical repeat product runs the numeric
kernel alone.

Rounding contract: the kernels round each product and add it atomically,
in an order that changes from run to run; the reference kernel fuses the
multiply-add, and the sort-based fallback and the plain versions add in
expansion order.  Pattern, row pointers and the set of columns per row
agree bitwise always; values agree bitwise on exactly representable
(dyadic) arithmetic and to 1 ulp per accumulated product otherwise.

Requests with a non-default semiring or a mask run the sort-based fallback
(``core.spgemm.spgemm_hash_jnp``), which keeps the same contract.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import CSR, prefix_sum
import repro_torch.core.schedule as sched
from . import kernel as K
from .kernel import KERNEL_CALLS


def reset_kernel_calls() -> None:
    """Zero the launch counters."""
    for k in KERNEL_CALLS:
        KERNEL_CALLS[k] = 0


def kernel_call_counts() -> dict:
    """Snapshot of :data:`KERNEL_CALLS`."""
    return dict(KERNEL_CALLS)


def _static_table_size(flop: torch.Tensor, n: int,
                       table_size: int | None) -> int:
    if table_size is None:
        max_flop = int(flop.max()) if flop.numel() else 0
        table_size = sched.lowest_p2(min(max_flop, n) + 1)
    return max(table_size, K.CHUNK)


def hash_schedule(a: CSR, b: CSR, n_bins: int,
                  table_size: int | None = None):
    """Fig. 6 + Fig. 7 lines 9-12: ``(offsets, bin_tsize, table_size)``,
    everything the kernels need besides the CSR payloads."""
    flop, offsets, tsize = sched.make_schedule_eager(a, b, n_bins)
    table_size = _static_table_size(flop, b.n_cols, table_size)
    bin_tsize = sched.bin_table_sizes(tsize, b.n_cols, table_size,
                                      floor=K.CHUNK)
    return offsets, bin_tsize, table_size


def _resolve_schedule(a, b, n_bins, table_size, schedule):
    if schedule is None:
        return hash_schedule(a, b, n_bins, table_size)
    if table_size is None:
        raise ValueError("a precomputed schedule needs its static table_size")
    offsets, bin_tsize = schedule
    return offsets, bin_tsize, max(table_size, K.CHUNK)


def _operands(a: CSR, b: CSR):
    return (a.indptr, b.indptr, a.indices, a.data.to(torch.float32),
            b.indices, b.data.to(torch.float32))


def spgemm_hash(a: CSR, b: CSR, cap_c: int, *, n_bins: int = 8,
                vector: bool = False, table_size: int | None = None,
                semiring="plus_times", mask: CSR | None = None,
                complement_mask: bool = False, schedule=None,
                indptr_c: torch.Tensor | None = None) -> CSR:
    """C = A @ B via the hash kernels; returns a CSR with
    ``sorted_cols=False``.

    ``schedule=(offsets, bin_tsize)`` skips the Fig. 6 inspection (pass
    ``table_size`` alongside); ``indptr_c=`` also skips the symbolic
    kernel -- the planned execute runs the numeric kernel only.
    """
    from repro_torch.core.semiring import resolve_semiring
    if resolve_semiring(semiring).name != "plus_times" or mask is not None:
        from repro_torch.core.spgemm import spgemm_hash_jnp
        return spgemm_hash_jnp(a, b, cap_c, semiring=semiring, mask=mask,
                               complement_mask=complement_mask)
    m, n = a.n_rows, b.n_cols
    offsets, bin_tsize, table_size = _resolve_schedule(a, b, n_bins,
                                                       table_size, schedule)
    ip_a, ip_b, a_idx, a_val, b_idx, b_val = _operands(a, b)
    if indptr_c is None:
        row_nnz = K.symbolic_call(offsets, bin_tsize, ip_a, ip_b, a_idx,
                                  a_val, b_idx, b_val, table_size=table_size,
                                  vector=vector)
        indptr_c = prefix_sum(row_nnz).to(torch.int32)
    cols_c, vals_c = K.numeric_call(offsets, bin_tsize, ip_a, ip_b, indptr_c,
                                    a_idx, a_val, b_idx, b_val, cap_c=cap_c,
                                    table_size=table_size, vector=vector)
    nnz_c = indptr_c[-1]
    return CSR(indptr_c, cols_c, vals_c.to(a.dtype), nnz_c, (m, n),
               sorted_cols=False)


def spgemm_hash_symbolic(a: CSR, b: CSR, *, n_bins: int = 8,
                         vector: bool = False, table_size: int | None = None,
                         schedule=None) -> torch.Tensor:
    """Symbolic phase only: exact nnz(C) per row, ``(m,) int32``."""
    offsets, bin_tsize, table_size = _resolve_schedule(a, b, n_bins,
                                                       table_size, schedule)
    ip_a, ip_b, a_idx, a_val, b_idx, b_val = _operands(a, b)
    return K.symbolic_call(offsets, bin_tsize, ip_a, ip_b, a_idx, a_val,
                           b_idx, b_val, table_size=table_size,
                           vector=vector)
