"""Public entry points of the propagation-blocking kernels (port of
``repro.kernels.spgemm_pb.ops``).

All inspection happens in ``core.pb.plan_pb`` (counted as ``"inspect"``);
the two numeric phases -- bucket scatter and per-bucket merge -- run over
frozen plan arrays only.  ``pb_scatter`` and ``pb_merge`` stay two public
ops because a distributed product exchanges the partial-product buffers
between them; ``spgemm_pb`` composes them for one device.

Value fleets: the two phases go through the custom ops
``repro_torch::spgemm_pb_scatter`` (:func:`scatter_op`) and
``repro_torch::spgemm_pb_merge`` (:func:`merge_op`), whose
``register_vmap`` rules are the counterparts of the reference's
``custom_vmap`` rules.  ``torch.func.vmap`` over a planned execute -- new
values on one frozen structure (A's, B's or both) -- fires each rule once,
and the rule runs the batched kernel of ``kernel.py`` over every member:
a batched argument with its member stride, an unbatched one (the plan's
index arrays, a shared operand) read in place; the merge rule's output
is stored slot-major (``kernel.batched_merge_call``).  A call outside
vmap runs the same kernels at one member, once per phase.

Rounding contract: one rounding per product and one per add, in the
frozen bucket-major lane order, on the card as in the reference; values
agree with the reference bitwise on dyadic inputs and to 1 ulp per
accumulated product otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import CSR
from repro_torch.kernels import _build
from . import kernel as K
from .kernel import KERNEL_CALLS


def reset_kernel_calls() -> None:
    """Zero the launch counters."""
    for k in KERNEL_CALLS:
        KERNEL_CALLS[k] = 0


def kernel_call_counts() -> dict:
    """Snapshot of :data:`KERNEL_CALLS`."""
    return dict(KERNEL_CALLS)


@torch.library.custom_op("repro_torch::spgemm_pb_scatter", mutates_args=())
def scatter_op(bucket_nnz: torch.Tensor, src_a: torch.Tensor,
               src_b: torch.Tensor, a_data: torch.Tensor,
               b_data: torch.Tensor) -> torch.Tensor:
    """:func:`kernel.scatter_call` as a custom op, so that
    ``torch.func.vmap`` reaches its rule (:func:`_scatter_vmap`)."""
    return K.scatter_call(bucket_nnz, src_a, src_b, a_data, b_data)


@scatter_op.register_vmap
def _scatter_vmap(info, in_dims, bucket_nnz, src_a, src_b, a_data, b_data):
    """The batched scatter over ``info.batch_size`` members, once per
    vmapped call (arguments as :func:`_build.members_first` lays them
    out)."""
    args = _build.members_first(
        (bucket_nnz, src_a, src_b, a_data, b_data), in_dims)
    return K.batched_scatter_call(*args, n_members=info.batch_size), 0


@torch.library.custom_op("repro_torch::spgemm_pb_merge", mutates_args=())
def merge_op(bucket_nnz: torch.Tensor, seg: torch.Tensor, pp: torch.Tensor,
             cap_c: int) -> torch.Tensor:
    """:func:`kernel.merge_call` as a custom op (rule:
    :func:`_merge_vmap`)."""
    return K.merge_call(bucket_nnz, seg, pp, cap_c)


@merge_op.register_vmap
def _merge_vmap(info, in_dims, bucket_nnz, seg, pp, cap_c):
    """The batched merge over ``info.batch_size`` members, once per
    vmapped call."""
    args = _build.members_first((bucket_nnz, seg, pp), in_dims)
    return K.batched_merge_call(*args, cap_c,
                                n_members=info.batch_size), 0


def pb_scatter(a_data, b_data, src_a, src_b, bucket_nnz) -> torch.Tensor:
    """Propagate phase: partial products in bucket-major order,
    ``(n_buckets, bucket_cap)`` float32 with pad lanes 0."""
    return scatter_op(bucket_nnz, src_a, src_b, a_data.to(torch.float32),
                      b_data.to(torch.float32))


def pb_merge(pp, seg, bucket_nnz, cap_c: int) -> torch.Tensor:
    """Merge phase: each bucket reduced into its disjoint output slots,
    ``(cap_c,)`` float32."""
    return merge_op(bucket_nnz, seg, pp, cap_c)


def spgemm_pb(a: CSR, b: CSR, cap_c: int, *, src_a, src_b, seg, bucket_nnz,
              indptr_c, cols_c) -> CSR:
    """Planned propagation-blocking SpGEMM (plus_times), numeric only: every
    structural decision comes frozen in the plan arrays.  The output has
    sorted columns.  Runs under ``torch.func.vmap`` over the values of A,
    of B or both (the batched kernels, through the ops' rules)."""
    pp = pb_scatter(a.data, b.data, src_a, src_b, bucket_nnz)
    data = pb_merge(pp, seg, bucket_nnz, cap_c)
    nnz_c = indptr_c[-1]
    valid = torch.arange(cap_c, dtype=torch.int32, device=data.device) < nnz_c
    data = torch.where(valid, data, 0.0).to(a.dtype)
    cols = torch.where(valid, cols_c, 0)
    return CSR(indptr_c, cols, data, nnz_c, (a.n_rows, b.n_cols),
               sorted_cols=True)
