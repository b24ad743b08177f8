"""The BCSR SpGEMM pipeline around the CUDA kernels (port of
``repro.kernels.spgemm_bcsr.ops``).

The paper's two phases at block granularity: the symbolic phase runs the
scalar hash symbolic kernel on the block-occupancy *patterns* of A and B,
and the numeric phase is the block-row hash kernel of ``kernel.py``.

Inspector-executor path (``core.bcsr``): :func:`bcsr_inspect` is the whole
Fig. 6/7 inspection at block granularity -- equal-flop block-row bins,
static and per-bin table sizes, and the exact block row pointer of C.
``plan_bcsr`` runs it once and freezes the result; ``spgemm_bcsr(...,
schedule=(offsets, bin_tsize), indptr_cb=...)`` then skips it, so a
structure-identical repeat product runs the numeric kernel alone.

Value fleets: the numeric phase goes through the custom op
``repro_torch::spgemm_bcsr_numeric`` (:func:`numeric_op`), whose
``register_vmap`` rule is the counterpart of the reference's
``custom_vmap`` rule.  ``torch.func.vmap`` over a planned execute -- new
tile values on one frozen block structure, DBCSR's repeated products --
fires the rule once, and the rule runs ``kernel.batched_numeric_call``
over every member: a batched argument with its member stride, an
unbatched one (the plan's integer arrays, a shared B) read in place --
with every index array shared, a block row of a group of members is one
work item of the kernel's classes.

``KERNEL_CALLS["symbolic"]`` counts inspections, ``numeric`` /
``numeric_vector`` the numeric kernel's calls and ``plain`` its plain
version's runs, ``batched_numeric`` / ``batched_numeric_vector`` the
fleet calls (one classification and the class launches each, counted in
``kernel.CLASS_CALLS``) and ``batched_plain`` its plain version's runs;
the hash symbolic launches of an inspection show in
``repro_torch.kernels.spgemm_hash.ops.KERNEL_CALLS``.

Rounding contract: one rounding per scalar product and per add, the
inner index of a tile product in order and the tile products of an
output block in expansion order -- the plain version's order on the CPU.
The reference's kernel may fuse multiply-adds, so values agree with it
bitwise on dyadic inputs and to 1 ulp per accumulated product otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BCSR, CSR, prefix_sum
import repro_torch.core.schedule as sched
from repro_torch.kernels import _build
from repro_torch.kernels.spgemm_hash import kernel as HK
from . import kernel as K
from .kernel import KERNEL_CALLS


def reset_kernel_calls() -> None:
    """Zero the launch counters."""
    for k in KERNEL_CALLS:
        KERNEL_CALLS[k] = 0


def kernel_call_counts() -> dict:
    """Snapshot of :data:`KERNEL_CALLS`."""
    return dict(KERNEL_CALLS)


def _pattern_csr(a: BCSR) -> CSR:
    """Block-occupancy pattern of a BCSR as a scalar CSR over the block
    grid (values 1 on live slots, 0 on the tail)."""
    gm, gn = a.grid
    ones = a.valid_mask().to(torch.float32)
    return CSR(a.indptr, a.indices, ones, a.nnzb, (gm, gn), sorted_cols=True)


def bcsr_inspect(a: BCSR, b: BCSR, *, n_bins: int = 8, vector: bool = False,
                 table_size: int | None = None):
    """Block-granularity inspection on the occupancy patterns of A and B:
    Fig. 6 schedule, Fig. 7 table sizing and the symbolic block count.

    Returns ``(flop, offsets, bin_tsize, table_size, row_nnzb,
    indptr_cb)``; ``flop`` is the per-block-row *block* flop (block pairs).
    """
    KERNEL_CALLS["symbolic"] += 1
    pa, pb = _pattern_csr(a), _pattern_csr(b)
    flop, offsets, tsize = sched.make_schedule_eager(pa, pb, n_bins)
    if table_size is None:
        max_flop = int(flop.max()) if flop.numel() else 0
        table_size = sched.lowest_p2(min(max_flop, pb.n_cols) + 1)
    table_size = max(table_size, HK.CHUNK)
    bin_tsize = sched.bin_table_sizes(tsize, pb.n_cols, table_size,
                                      floor=HK.CHUNK)
    # symbolic phase: exact blocks per block row of C, by the scalar hash
    # symbolic kernel on the block patterns
    row_nnzb = HK.symbolic_call(offsets, bin_tsize, pa.indptr, pb.indptr,
                                pa.indices, pa.data, pb.indices, pb.data,
                                table_size=table_size, vector=vector,
                                n_cols=pb.n_cols)
    indptr_cb = prefix_sum(row_nnzb).to(torch.int32)
    return flop, offsets, bin_tsize, table_size, row_nnzb, indptr_cb


@torch.library.custom_op("repro_torch::spgemm_bcsr_numeric",
                         mutates_args=())
def numeric_op(offsets: torch.Tensor, bin_tsize: torch.Tensor,
               indptr_a: torch.Tensor, indptr_b: torch.Tensor,
               indptr_c: torch.Tensor, a_bcol: torch.Tensor,
               a_blk: torch.Tensor, b_bcol: torch.Tensor,
               b_blk: torch.Tensor, bcap_c: int, table_size: int,
               vector: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`kernel.numeric_call` as a custom op, so that
    ``torch.func.vmap`` reaches its rule (:func:`_numeric_vmap`); the
    ``errors`` read-back stays inside."""
    return K.numeric_call(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                          a_bcol, a_blk, b_bcol, b_blk, bcap_c=bcap_c,
                          table_size=table_size, vector=vector)


@numeric_op.register_vmap
def _numeric_vmap(info, in_dims, offsets, bin_tsize, indptr_a, indptr_b,
                  indptr_c, a_bcol, a_blk, b_bcol, b_blk, bcap_c,
                  table_size, vector):
    """The kernel over ``info.batch_size`` members, once per vmapped
    call (arguments as :func:`_build.members_first` lays them out)."""
    args = _build.members_first((offsets, bin_tsize, indptr_a, indptr_b,
                                 indptr_c, a_bcol, a_blk, b_bcol, b_blk),
                                in_dims)
    out = K.batched_numeric_call(*args, n_members=info.batch_size,
                                 bcap_c=bcap_c, table_size=table_size,
                                 vector=vector)
    return out, (0, 0)


def spgemm_bcsr(a: BCSR, b: BCSR, bcap_c: int, *, n_bins: int = 8,
                vector: bool = False, table_size: int | None = None,
                schedule=None, indptr_cb: torch.Tensor | None = None) -> BCSR:
    """C = A @ B on BCSR operands; block rows of C are unsorted (C8).

    ``schedule=(offsets, bin_tsize)`` with ``indptr_cb=`` (both from
    :func:`bcsr_inspect`, with its static ``table_size``) skips the
    inspection: the planned execute runs the numeric kernel alone, and
    runs under ``torch.func.vmap`` over the tiles of A, of B or both (the
    kernel over every member at once).
    """
    bm, bk = a.block
    bk2, bn = b.block
    if bk != bk2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block-inner mismatch: {a.shape}x{a.block} @ "
                         f"{b.shape}x{b.block}")
    if schedule is None or indptr_cb is None:
        if schedule is not None or indptr_cb is not None:
            raise ValueError("pass schedule and indptr_cb together (both "
                             "from bcsr_inspect)")
        _, offsets, bin_tsize, table_size, _, indptr_cb = bcsr_inspect(
            a, b, n_bins=n_bins, vector=vector, table_size=table_size)
    else:
        offsets, bin_tsize = schedule
        if table_size is None:
            raise ValueError("a precomputed schedule needs its static "
                             "table_size")
        table_size = max(table_size, HK.CHUNK)
    bcols_c, blocks_c = numeric_op(
        offsets, bin_tsize, a.indptr, b.indptr, indptr_cb, a.indices,
        a.blocks.to(torch.float32), b.indices, b.blocks.to(torch.float32),
        bcap_c, table_size, vector)
    # the valid-tail mask: slots past nnzb(C) are zero (indptr_cb is the
    # structure's, never batched, so the host read is one value)
    nnzb_c = indptr_cb[-1]
    live = int(nnzb_c)
    bcols_c[live:] = 0
    blocks_c[live:] = 0
    return BCSR(indptr_cb, bcols_c, blocks_c.to(a.dtype), nnzb_c,
                (a.shape[0], b.shape[1]), (bm, bn))
