"""Public entry points of the propagation-blocking kernels (port of
``repro.kernels.spgemm_pb.ops``).

All inspection happens in ``core.pb.plan_pb`` (counted as ``"inspect"``);
the two numeric phases -- bucket scatter and per-bucket merge -- run over
frozen plan arrays only.  ``pb_scatter`` and ``pb_merge`` stay two public
ops because a distributed product exchanges the partial-product buffers
between them; ``spgemm_pb`` composes them for one device.

Rounding contract: one rounding per product and one per add, in the
frozen bucket-major lane order, on the card as in the reference; values
agree with the reference bitwise on dyadic inputs and to 1 ulp per
accumulated product otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import CSR
from . import kernel as K
from .kernel import KERNEL_CALLS


def reset_kernel_calls() -> None:
    """Zero the launch counters."""
    for k in KERNEL_CALLS:
        KERNEL_CALLS[k] = 0


def kernel_call_counts() -> dict:
    """Snapshot of :data:`KERNEL_CALLS`."""
    return dict(KERNEL_CALLS)


def pb_scatter(a_data, b_data, src_a, src_b, bucket_nnz) -> torch.Tensor:
    """Propagate phase: partial products in bucket-major order,
    ``(n_buckets, bucket_cap)`` float32 with pad lanes 0."""
    return K.scatter_call(bucket_nnz, src_a, src_b,
                          a_data.to(torch.float32), b_data.to(torch.float32))


def pb_merge(pp, seg, bucket_nnz, cap_c: int) -> torch.Tensor:
    """Merge phase: each bucket reduced into its disjoint output slots,
    ``(cap_c,)`` float32."""
    return K.merge_call(bucket_nnz, seg, pp, cap_c)


def spgemm_pb(a: CSR, b: CSR, cap_c: int, *, src_a, src_b, seg, bucket_nnz,
              indptr_c, cols_c) -> CSR:
    """Planned propagation-blocking SpGEMM (plus_times), numeric only: every
    structural decision comes frozen in the plan arrays.  The output has
    sorted columns."""
    pp = pb_scatter(a.data, b.data, src_a, src_b, bucket_nnz)
    data = pb_merge(pp, seg, bucket_nnz, cap_c)
    nnz_c = indptr_c[-1]
    valid = torch.arange(cap_c, dtype=torch.int32, device=data.device) < nnz_c
    data = torch.where(valid, data, 0.0).to(a.dtype)
    cols = torch.where(valid, cols_c, 0)
    return CSR(indptr_c, cols, data, nnz_c, (a.n_rows, b.n_cols),
               sorted_cols=True)
