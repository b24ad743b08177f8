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
kernel alone.  :func:`spgemm_hash_batched` is the same numeric phase for a
fleet of products (``core.batch``), through the batched kernel.

Value fleets: the two phases go through the custom ops
``repro_torch::spgemm_hash_symbolic`` (:func:`symbolic_op`) and
``repro_torch::spgemm_hash_numeric`` (:func:`numeric_op`), whose
``register_vmap`` rules are the counterparts of the reference's
``custom_vmap`` rules.  ``torch.func.vmap`` over a planned execute (new
values on one frozen structure: A's, B's or both) fires the numeric rule
once; over the planless :func:`spgemm_hash` with values batched, or with
stacked per-member structures and a stacked ``schedule=``, it fires the
symbolic rule and then the numeric rule once each.  A rule runs the
batched kernels of ``kernel.py`` over every member -- one classifying
launch, then one launch per table class, each over every member's rows
of its class: a batched argument with its member stride, an unbatched
one (the plan's schedule and index arrays, a shared operand) read in
place.  A call outside vmap runs the single-product kernels once per
phase.

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
from repro_torch.kernels import _build
from repro_torch.verify.census import kernel_scope
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
        if any(torch._C._functorch.is_batchedtensor(t)
               for t in (a.indptr, a.indices, b.indptr, b.indices)):
            raise ValueError(
                "under torch.func.vmap over the operands' structure, pass "
                "schedule=(offsets, bin_tsize) and table_size= (the "
                "inspection runs on one structure)")
        return hash_schedule(a, b, n_bins, table_size)
    if table_size is None:
        raise ValueError("a precomputed schedule needs its static table_size")
    offsets, bin_tsize = schedule
    return offsets, bin_tsize, max(table_size, K.CHUNK)


def _operands(a: CSR, b: CSR):
    return (a.indptr, b.indptr, a.indices, a.data.to(torch.float32),
            b.indices, b.data.to(torch.float32))


@torch.library.custom_op("repro_torch::spgemm_hash_symbolic",
                         mutates_args=())
def symbolic_op(offsets: torch.Tensor, bin_tsize: torch.Tensor,
                indptr_a: torch.Tensor, indptr_b: torch.Tensor,
                a_idx: torch.Tensor, a_val: torch.Tensor, b_idx: torch.Tensor,
                b_val: torch.Tensor, table_size: int, vector: bool,
                n_cols: int) -> torch.Tensor:
    """:func:`kernel.symbolic_call` as a custom op, so that
    ``torch.func.vmap`` reaches its rule (:func:`_symbolic_vmap`); the
    ``errors`` read-back stays inside.  ``n_cols``: B's width."""
    return K.symbolic_call(offsets, bin_tsize, indptr_a, indptr_b, a_idx,
                           a_val, b_idx, b_val, table_size=table_size,
                           vector=vector, n_cols=n_cols)


@symbolic_op.register_vmap
def _symbolic_vmap(info, in_dims, offsets, bin_tsize, indptr_a, indptr_b,
                   a_idx, a_val, b_idx, b_val, table_size, vector, n_cols):
    """The batched symbolic kernels over ``info.batch_size`` members, once
    per vmapped call (arguments as :func:`_build.members_first` lays them
    out; the schedule is read back for its largest table)."""
    args = _build.members_first((offsets, bin_tsize, indptr_a, indptr_b,
                                 a_idx, a_val, b_idx, b_val), in_dims)
    return K.batched_symbolic_call(
        *args, n_members=info.batch_size, table_size=table_size,
        vector=vector, n_cols=n_cols), 0


@torch.library.custom_op("repro_torch::spgemm_hash_numeric",
                         mutates_args=())
def numeric_op(offsets: torch.Tensor, bin_tsize: torch.Tensor,
               indptr_a: torch.Tensor, indptr_b: torch.Tensor,
               indptr_c: torch.Tensor, a_idx: torch.Tensor,
               a_val: torch.Tensor, b_idx: torch.Tensor, b_val: torch.Tensor,
               cap_c: int, table_size: int,
               vector: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`kernel.numeric_call` as a custom op (rule:
    :func:`_numeric_vmap`)."""
    return K.numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                          a_idx, a_val, b_idx, b_val, cap_c=cap_c,
                          table_size=table_size, vector=vector)


@numeric_op.register_vmap
def _numeric_vmap(info, in_dims, offsets, bin_tsize, indptr_a, indptr_b,
                  indptr_c, a_idx, a_val, b_idx, b_val, cap_c, table_size,
                  vector):
    """The batched numeric kernels over ``info.batch_size`` members, once
    per vmapped call."""
    args = _build.members_first((offsets, bin_tsize, indptr_a, indptr_b,
                                 indptr_c, a_idx, a_val, b_idx, b_val),
                                in_dims)
    out = K.batched_numeric_call(*args, n_members=info.batch_size,
                                 cap_c=cap_c, table_size=table_size,
                                 vector=vector)
    return out, (0, 0)


def spgemm_hash(a: CSR, b: CSR, cap_c: int, *, n_bins: int = 8,
                vector: bool = False, table_size: int | None = None,
                semiring="plus_times", mask: CSR | None = None,
                complement_mask: bool = False, schedule=None,
                indptr_c: torch.Tensor | None = None) -> CSR:
    """C = A @ B via the hash kernels; returns a CSR with
    ``sorted_cols=False``.

    ``schedule=(offsets, bin_tsize)`` skips the Fig. 6 inspection (pass
    ``table_size`` alongside); ``indptr_c=`` also skips the symbolic
    kernel -- the planned execute runs the numeric kernel only.  Runs under
    ``torch.func.vmap`` over the values of A, of B or both, and over
    stacked structures with a stacked ``schedule=`` (the batched kernels,
    through the ops' rules).
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
        row_nnz = symbolic_op(offsets, bin_tsize, ip_a, ip_b, a_idx, a_val,
                              b_idx, b_val, table_size, vector, n)
        indptr_c = prefix_sum(row_nnz).to(torch.int32)
    cols_c, vals_c = numeric_op(offsets, bin_tsize, ip_a, ip_b, indptr_c,
                                a_idx, a_val, b_idx, b_val, cap_c,
                                table_size, vector)
    nnz_c = indptr_c[-1]
    return CSR(indptr_c, cols_c, vals_c.to(a.dtype), nnz_c, (m, n),
               sorted_cols=False)


def spgemm_hash_symbolic(a: CSR, b: CSR, *, n_bins: int = 8,
                         vector: bool = False, table_size: int | None = None,
                         schedule=None) -> torch.Tensor:
    """Symbolic phase only: exact nnz(C) per row, ``(m,) int32``."""
    offsets, bin_tsize, table_size = _resolve_schedule(a, b, n_bins,
                                                       table_size, schedule)
    return symbolic_op(offsets, bin_tsize, *_operands(a, b), table_size,
                       vector, b.n_cols)


def spgemm_hash_batched(a: CSR, b: CSR, cap_c: int, *, vector: bool,
                        table_size: int, schedule, indptr_c: torch.Tensor,
                        largest: int | None = None):
    """``A_e @ B_e`` for every member e of a fleet through the batched
    numeric kernel: ``(cols, vals)``, each ``(n, cap_c)``, vals float32.

    The counterpart of the reference's ``_numeric_entry`` vmap rule, as a
    plain function over stacked members: ``core.batch`` stacks its class
    members itself and calls it directly, not through ``torch.func.vmap``
    (:func:`numeric_op`'s ``register_vmap`` rule is the vmap form).
    ``a`` and ``b`` are stacked CSRs, every array with a leading member
    axis (``core.batch._stack_csr``), or plain CSRs that all members share:
    a shared operand goes to the kernel as it is, with member stride 0,
    where the reference broadcasts it.  ``schedule=(offsets, bin_tsize)``
    and ``indptr_c`` are stacked ``(n, ...)`` plan arrays, ``table_size``
    the class table (``BatchClass.table_size``, used as it is), and
    ``largest`` their largest bin table (``K.fleet_table``), which a plan
    computes once.

    Not a custom op, so the call is one kernel entry of a layer-1 census
    (:func:`repro_torch.verify.census.kernel_scope`): the ops inside it,
    the plain version's on CPU tensors, are the kernel's, never the
    executor's.
    """
    offsets, bin_tsize = schedule
    with kernel_scope("spgemm_hash_batched"):
        return K.batched_numeric_call(
            offsets, bin_tsize, a.indptr, b.indptr, indptr_c, a.indices,
            a.data.to(torch.float32), b.indices, b.data.to(torch.float32),
            n_members=offsets.shape[0], cap_c=cap_c, table_size=table_size,
            vector=vector, largest=largest)
