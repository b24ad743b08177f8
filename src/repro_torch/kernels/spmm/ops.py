"""Public entry point of the SpMM kernel (port of
``repro.kernels.spmm.ops``).

:func:`spmm_kernel` is the counterpart of the reference's ``spmm_pallas``
(``repro/kernels/spmm/ops.py``): ``y = A @ X`` for a CSR ``A`` and a
dense ``X`` of shape ``(n, k)``, ``y`` of shape ``(m, k)`` in X's dtype.
The reference balances its sequential TPU grid over equal-nnz row bins;
the CUDA kernel needs none (one warp per row), so no schedule is built.
The reference's unused ``make_schedule(a, a, n_bins)`` call, an A·A flop
count it throws away, is not ported.

Rounding contract: float32 accumulation in each row's nonzero order, one
rounding per product and one per add, stored cast to X's dtype -- the
CUDA kernel and the plain version agree bitwise on any values.
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


def spmm_kernel(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ X``: X dense ``(n, k)``, returns ``(m, k)`` in X's dtype.
    CUDA tensors launch the hand-written kernel; CPU tensors run its plain
    version."""
    if x.dim() != 2 or x.shape[0] != a.n_cols:
        raise ValueError(f"x must be ({a.n_cols}, k) for A of shape "
                         f"{a.shape}, got {tuple(x.shape)}")
    return K.spmm_call(a.indptr, a.indices, a.data.to(torch.float32),
                       x.contiguous(), a.nnz.to(torch.int32).reshape(()))
