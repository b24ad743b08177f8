"""Inspector-executor planner for block-sparse (BCSR) SpGEMM (port of
``repro.core.bcsr``).

The scalar planner (:mod:`repro_torch.core.plan`) freezes the paper's
Fig. 6/7 inspection at row granularity; this module freezes the same
inspection at block granularity, for matrices that are sparse in dense
tiles rather than in scalars (DBCSR-class linear-scaling DFT products,
block-sparse MoE weights).  One inspection -- block flop per block row,
equal-flop block-row bins, static and per-bin power-of-two table sizes,
the exact symbolic block count of C -- becomes a frozen
:class:`BCSRPlan`; ``plan.execute(a, b)`` then runs only the hand-written
numeric kernel (:mod:`repro_torch.kernels.spgemm_bcsr`).  Zero
re-inspection on repeat executes shows in
``kernels.spgemm_bcsr.ops.KERNEL_CALLS["symbolic"]``.

Plans are cached in the shared LRU of :mod:`repro_torch.core.plan` under
the ``"bcsr"`` kind, keyed by the operands' block structure: values never
enter the key, so re-weighted tiles hit the cached plan.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .formats import BCSR, memo_on_versions
from .plan import cache_lookup, cache_store


def bcsr_structure_key(a: BCSR) -> bytes:
    """Digest of a BCSR's block structure (pattern and static layout), not
    its values; the bytes hashed are the reference's, so both packages key
    a structure alike.  Memoized on the instance until ``indptr``,
    ``indices`` or ``nnzb`` is written in place."""
    def digest():
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((a.shape, a.block, a.bcap, int(a.nnzb))).encode())
        h.update(a.indptr.cpu().numpy().astype(np.int32).tobytes())
        h.update(a.indices.cpu().numpy().astype(np.int32).tobytes())
        return h.digest()
    return memo_on_versions(a, "_structure_digest",
                            (a.indptr, a.indices, a.nnzb), digest)


@dataclass(frozen=True)
class BCSRPlan:
    """Frozen block-product recipe for one (A, B) block-structure pair: the
    block flop profile and bins (Fig. 6 over the block grid), per-bin table
    sizes and the static table allocation (Fig. 7 lines 9-12, keys = block
    columns), and the exact block row pointer and capacity of C."""
    key: tuple = dataclasses.field(repr=False)
    block_a: Tuple[int, int]
    block_b: Tuple[int, int]
    shape_a: Tuple[int, int]
    shape_b: Tuple[int, int]
    bcap_a: int
    bcap_b: int
    nnzb_a: int
    nnzb_b: int
    n_bins: int
    vector: bool
    flop: torch.Tensor = dataclasses.field(repr=False)  # block flop/block row
    total_flop: int          # total block flop (block pairs)
    offsets: torch.Tensor = dataclasses.field(repr=False)    # (n_bins + 1,)
    bin_tsize: torch.Tensor = dataclasses.field(repr=False)  # (n_bins,) p2
    table_size: int          # static table allocation (bin max, p2)
    row_nnzb_c: torch.Tensor = dataclasses.field(repr=False)
    indptr_cb: torch.Tensor = dataclasses.field(repr=False)
    nnzb_c: int
    bcap_c: int              # exact nnzb(C) as a static capacity
    provenance: str = "planned"

    @property
    def block_c(self) -> Tuple[int, int]:
        return (self.block_a[0], self.block_b[1])

    def check_structure(self, a: BCSR, b: BCSR) -> None:
        """Cheap block-structure guard (shapes, blocks, capacities, nnzb);
        executing against another structure would use wrong capacities."""
        if a.shape != self.shape_a or b.shape != self.shape_b:
            raise ValueError(f"plan is for {self.shape_a}x{self.shape_b}, "
                             f"got {a.shape}x{b.shape}")
        if a.block != self.block_a or b.block != self.block_b:
            raise ValueError(f"plan is for blocks {self.block_a}x"
                             f"{self.block_b}, got {a.block}x{b.block}")
        if a.bcap != self.bcap_a or b.bcap != self.bcap_b:
            raise ValueError("operand block capacities differ from the "
                             "planned structure")
        if int(a.nnzb) != self.nnzb_a or int(b.nnzb) != self.nnzb_b:
            raise ValueError("operand block nnz differs from the planned "
                             "structure (replan or clear_plan_cache)")

    def execute(self, a: BCSR, b: BCSR) -> BCSR:
        """Numeric phase only: the block-row hash kernel with this plan's
        frozen schedule, no re-inspection.  Block rows of C are unsorted
        (C8)."""
        self.check_structure(a, b)
        from repro_torch.kernels.spgemm_bcsr import ops as bcsr_ops
        return bcsr_ops.spgemm_bcsr(
            a, b, self.bcap_c, vector=self.vector,
            table_size=self.table_size,
            schedule=(self.offsets, self.bin_tsize),
            indptr_cb=self.indptr_cb)

    __call__ = execute


def plan_bcsr(a: BCSR, b: BCSR, *, n_bins: int = 8, vector: bool = False,
              cache: bool = True) -> BCSRPlan:
    """Run the block-granularity inspection once and freeze a
    :class:`BCSRPlan` on the operands' device.

    With ``cache=True`` a block-structure-identical repeat request returns
    the cached plan and inspects nothing.
    """
    bm, bk = a.block
    bk2, bn = b.block
    if bk != bk2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block-inner mismatch: {a.shape}x{a.block} @ "
                         f"{b.shape}x{b.block}")
    key = ("bcsr", bcsr_structure_key(a), bcsr_structure_key(b), n_bins,
           vector)
    if cache:
        hit = cache_lookup(key, a.device)
        if hit is not None:
            return hit

    from repro_torch.kernels.spgemm_bcsr import ops as bcsr_ops
    flop, offsets, bin_tsize, table_size, row_nnzb, indptr_cb = \
        bcsr_ops.bcsr_inspect(a, b, n_bins=n_bins, vector=vector)
    nnzb_c = int(row_nnzb.to(torch.int64).sum())
    plan = BCSRPlan(
        key=key, block_a=a.block, block_b=b.block, shape_a=a.shape,
        shape_b=b.shape, bcap_a=a.bcap, bcap_b=b.bcap, nnzb_a=int(a.nnzb),
        nnzb_b=int(b.nnzb), n_bins=n_bins, vector=vector, flop=flop,
        total_flop=int(flop.to(torch.int64).sum()), offsets=offsets,
        bin_tsize=bin_tsize, table_size=table_size, row_nnzb_c=row_nnzb,
        indptr_cb=indptr_cb, nnzb_c=nnzb_c, bcap_c=max(nnzb_c, 1))
    if cache:
        cache_store(key, a.device, plan)
    return plan
