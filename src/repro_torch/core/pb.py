"""Inspector-executor planner for propagation-blocking SpGEMM (port of
``repro.core.pb``).

The inspection expands every partial product ``A[r, k] * B[k, c]`` once,
buckets it by a column segment (``schedule.pb_bucket_layout``) and
resolves its slot in the column-sorted CSR of C.  What freezes into a
:class:`PBPlan` is gather/scatter geometry:

  src_a[g, i], src_b[g, i]  -- operand value slots of lane i of bucket g
  seg[g, i]                 -- its output slot in C (pad lanes: cap_c)
  bucket_nnz[g]             -- live lanes per bucket

so a repeat execute runs the two numeric kernels (scatter, then merge)
with no re-inspection (``KERNEL_CALLS["inspect"]``).  A bucket owns a
contiguous column range, so every product of one output coordinate lands
in one bucket: buckets write disjoint output slots.

The inspection runs in torch on the operands' device, where the reference
runs numpy on the host; every plan array is bitwise equal to the
reference's.  ``np.lexsort`` becomes stable sorts: one on the int64 key
``r * n + c`` (duplicate (r, c) products keep their expansion order), then
one on the bucket of that sequence.  Masks are pruned here, structurally,
so the executor stays mask-free.  Plans are cached in the shared LRU of
:mod:`repro_torch.core.plan` under the ``"pb"`` kind, keyed by operand
structure, never values.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import schedule as sched
from .formats import CSR, prefix_sum
from .plan import cache_lookup, cache_store, structure_key
from .semiring import resolve_semiring
from .spgemm import _check_mask


def _pad8(n: int) -> int:
    """Round a capacity up to a multiple of 8 (the reference's rule)."""
    return -(-int(n) // 8) * 8


def _expand_products(a: CSR, b: CSR):
    """Every partial product of ``A @ B`` in A-slot order, int64:
    ``(jj, tt, r, c)`` -- the value slots in A and B and the output
    coordinate of each."""
    dev = a.device
    ip_a, ip_b = a.indptr.long(), b.indptr.long()
    live_a = int(ip_a[-1])
    rows_a = torch.repeat_interleave(
        torch.arange(a.n_rows, device=dev), ip_a.diff(), output_size=live_a)
    k_of = a.indices[:live_a].long()
    cnt = ip_b[k_of + 1] - ip_b[k_of]
    sched.guard_i32_flop(cnt, "plan_pb")
    total = int(cnt.sum())
    jj = torch.repeat_interleave(torch.arange(live_a, device=dev), cnt,
                                 output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    tt = ip_b[k_of[jj]] + torch.arange(total, device=dev) - first[jj]
    return jj, tt, rows_a[jj], b.indices.long()[tt]


def _mask_keep(mask: CSR, r, c, n: int, complement: bool):
    """Structural membership of each (r, c) in the mask pattern."""
    mip = mask.indptr.long()
    mlive = int(mip[-1])
    mrows = torch.repeat_interleave(
        torch.arange(mask.n_rows, device=mip.device), mip.diff(),
        output_size=mlive)
    mkeys, _ = torch.sort(mrows * n + mask.indices[:mlive].long())
    keys = r * n + c
    if mkeys.numel() == 0:
        member = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    else:
        pos = torch.searchsorted(mkeys, keys).clamp(max=mkeys.numel() - 1)
        member = mkeys[pos] == keys
    return ~member if complement else member


def pad_output(c: CSR, cap_c: int) -> CSR:
    """``c`` with its index and value arrays zero-padded to ``cap_c``."""
    pad = cap_c - c.cap
    if pad <= 0:
        return c
    return CSR(c.indptr, torch.nn.functional.pad(c.indices, (0, pad)),
               torch.nn.functional.pad(c.data, (0, pad)), c.nnz, c.shape,
               c.sorted_cols)


@dataclass(frozen=True)
class PBPlan:
    """Frozen propagation-blocking recipe for one (A, B) structure pair:
    the bucket geometry, the gather/scatter arrays and C's exact
    column-sorted structure, on the operands' device."""
    key: tuple = dataclasses.field(repr=False)
    shape_a: Tuple[int, int]
    shape_b: Tuple[int, int]
    cap_a: int
    cap_b: int
    nnz_a: int
    nnz_b: int
    semiring: str
    has_mask: bool
    complement_mask: bool
    n_buckets: int
    bucket_w: int            # columns per bucket (power of two)
    bucket_cap: int          # lanes per bucket (max live lanes, padded to 8)
    total_flop: int          # products after structural mask pruning
    src_a: torch.Tensor = dataclasses.field(repr=False)   # (n_buckets, cap)
    src_b: torch.Tensor = dataclasses.field(repr=False)   # (n_buckets, cap)
    seg: torch.Tensor = dataclasses.field(repr=False)     # (n_buckets, cap)
    bucket_nnz: torch.Tensor = dataclasses.field(repr=False)  # (n_buckets,)
    cols_c: torch.Tensor = dataclasses.field(repr=False)  # (cap_c,)
    indptr_c: torch.Tensor = dataclasses.field(repr=False)
    row_nnz_c: torch.Tensor = dataclasses.field(repr=False)
    nnz_c: int = 0
    cap_c: int = 1

    def check_structure(self, a: CSR, b: CSR) -> None:
        """Cheap structure guard (shapes, capacities, nnz): executing
        another structure would gather from the wrong slots."""
        if a.shape != self.shape_a or b.shape != self.shape_b:
            raise ValueError(f"plan is for {self.shape_a}x{self.shape_b}, "
                             f"got {a.shape}x{b.shape}")
        if a.cap != self.cap_a or b.cap != self.cap_b:
            raise ValueError(
                "operand capacities differ from the planned structure")
        if int(a.nnz) != self.nnz_a or int(b.nnz) != self.nnz_b:
            raise ValueError("operand nnz differs from the planned structure "
                             "(replan or clear_plan_cache)")

    def execute(self, a: CSR, b: CSR) -> CSR:
        """Numeric phases only, over the frozen geometry; C has sorted
        columns.  plus_times runs the scatter and merge kernels; every
        other semiring runs the plain general-semiring twin.

        Runs under ``torch.func.vmap`` over the values of A, of B or both
        (members of new values on this structure): plus_times then runs
        the batched kernels once per phase, through the ops' vmap rules.
        The structure check reads only the operands' structure, which is
        never batched, and C's structure is the plan's."""
        self.check_structure(a, b)
        if self.semiring == "plus_times":
            from repro_torch.kernels.spgemm_pb import ops as pb_ops
            return pb_ops.spgemm_pb(
                a, b, self.cap_c, src_a=self.src_a, src_b=self.src_b,
                seg=self.seg, bucket_nnz=self.bucket_nnz,
                indptr_c=self.indptr_c, cols_c=self.cols_c)
        from repro_torch.kernels.spgemm_pb.ref import pb_numeric_ref
        nnz_c = self.indptr_c[-1]
        data = pb_numeric_ref(
            a.data, b.data, self.src_a, self.src_b, self.seg,
            self.bucket_nnz, self.cap_c, nnz_c,
            semiring=self.semiring).to(a.dtype)
        return CSR(self.indptr_c, self.cols_c, data, nnz_c,
                   (self.shape_a[0], self.shape_b[1]), sorted_cols=True)

    __call__ = execute


def plan_pb(a: CSR, b: CSR, *, semiring: str = "plus_times",
            mask: Optional[CSR] = None, complement_mask: bool = False,
            n_buckets: Optional[int] = None,
            budget: int = sched.PB_BUCKET_BUDGET,
            cache: bool = True) -> PBPlan:
    """Run the propagation-blocking inspection once and freeze a
    :class:`PBPlan` on the operands' device.

    With ``cache=True`` the shared plan LRU is consulted first under the
    ``"pb"`` kind: a structure-identical repeat request returns the cached
    plan and skips the expansion.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dim mismatch: {a.shape} @ {b.shape}")
    sr = resolve_semiring(semiring)
    _check_mask(a, b, mask)
    key = ("pb", structure_key(a), structure_key(b),
           structure_key(mask) if mask is not None else None,
           sr.name, complement_mask, n_buckets, budget)
    if cache:
        hit = cache_lookup(key, a.device)
        if hit is not None:
            return hit

    from repro_torch.kernels.spgemm_pb.kernel import KERNEL_CALLS
    KERNEL_CALLS["inspect"] += 1
    m, n = a.n_rows, b.n_cols
    dev = a.device

    jj, tt, r, c = _expand_products(a, b)
    if mask is not None:
        keep = _mask_keep(mask, r, c, n, complement_mask)
        jj, tt, r, c = jj[keep], tt[keep], r[keep], c[keep]
    total = int(r.shape[0])

    bucket_w, nb = sched.pb_bucket_layout(n, n_buckets, total_flop=total,
                                          budget=budget)

    # Exact output structure: products stably sorted by (row, col), runs
    # collapsed; every product learns its output slot in sorted C.
    rc = r * n + c
    uo = torch.argsort(rc, stable=True)
    rcs = rc[uo]
    del rc
    new = torch.ones(total, dtype=torch.bool, device=dev)
    new[1:] = rcs[1:] != rcs[:-1]
    slot = torch.empty(total, dtype=torch.int64, device=dev)
    slot[uo] = torch.cumsum(new, 0) - 1
    nnz_c = int(new.sum())
    cap_c = max(nnz_c, 1)
    rc_c = rcs[new]
    del rcs
    row_nnz_c = torch.bincount(rc_c // n, minlength=m).to(torch.int32)
    indptr_c = prefix_sum(row_nnz_c)
    cols_c = torch.zeros(cap_c, dtype=torch.int32, device=dev)
    cols_c[:nnz_c] = (rc_c % n).to(torch.int32)
    del rc_c, new

    # Bucket packing: bucket-major, (row, col) within a bucket -- the
    # order the merge accumulates in.  A stable sort on the bucket of the
    # (row, col)-sorted sequence is np.lexsort((c, r, bucket)).
    bucket_uo = (c[uo] // bucket_w).to(torch.int32)
    order = uo[torch.argsort(bucket_uo, stable=True)]
    del uo, bucket_uo
    bseq = c[order] // bucket_w
    bucket_nnz = torch.bincount(bseq, minlength=nb).to(torch.int32)
    bucket_cap = _pad8(max(int(bucket_nnz.max()), 1)) if total else 8
    starts = prefix_sum(bucket_nnz.long())
    lane = torch.arange(total, device=dev) - starts[bseq]
    src_a = torch.zeros((nb, bucket_cap), dtype=torch.int32, device=dev)
    src_b = torch.zeros((nb, bucket_cap), dtype=torch.int32, device=dev)
    seg = torch.full((nb, bucket_cap), cap_c, dtype=torch.int32, device=dev)
    if total:
        src_a[bseq, lane] = jj[order].to(torch.int32)
        src_b[bseq, lane] = tt[order].to(torch.int32)
        seg[bseq, lane] = slot[order].to(torch.int32)

    plan = PBPlan(
        key=key, shape_a=a.shape, shape_b=b.shape, cap_a=a.cap,
        cap_b=b.cap, nnz_a=int(a.nnz), nnz_b=int(b.nnz), semiring=sr.name,
        has_mask=mask is not None, complement_mask=complement_mask,
        n_buckets=nb, bucket_w=bucket_w, bucket_cap=bucket_cap,
        total_flop=total, src_a=src_a, src_b=src_b, seg=seg,
        bucket_nnz=bucket_nnz, cols_c=cols_c,
        indptr_c=indptr_c, row_nnz_c=row_nnz_c,
        nnz_c=nnz_c, cap_c=cap_c)
    if cache:
        cache_store(key, a.device, plan)
    return plan
