"""Public entry point of the SpMM kernel (port of
``repro.kernels.spmm.ops``).

:func:`spmm_kernel` is the counterpart of the reference's ``spmm_pallas``
(``repro/kernels/spmm/ops.py``): ``y = A @ X`` for a CSR ``A`` and a
dense ``X`` of shape ``(n, k)``, ``y`` of shape ``(m, k)`` in X's dtype.
The reference balances its sequential TPU grid over equal-nnz row bins.
On the card, rows run in parallel and the schedule is a device-side list
of rows by live length (``kernel.classify``): rows of at most 256
nonzeros take one warp each, longer rows a whole block each, longest
first.  :func:`row_classes` memoizes the lists on the CSR,
keyed on the version counters of its row pointer and ``nnz``
(``formats.memo_on_versions``), so repeated products with one structure
(the hops of a BFS) classify once.  The reference's unused
``make_schedule(a, a, n_bins)`` call, an A·A flop count it throws away, is
not ported.

Rounding contract: float32 accumulation in each row's nonzero order, one
rounding per product and one per add, stored cast to X's dtype -- the
CUDA kernel and the plain version agree bitwise on any values.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import CSR, memo_on_versions
from . import kernel as K
from .kernel import COPY_PATHS, KERNEL_CALLS


def reset_kernel_calls() -> None:
    """Zero the launch counters and the copy-path counters."""
    for d in (KERNEL_CALLS, COPY_PATHS):
        for k in d:
            d[k] = 0


def kernel_call_counts() -> dict:
    """Snapshot of :data:`KERNEL_CALLS`."""
    return dict(KERNEL_CALLS)


def _nnz(a: CSR) -> torch.Tensor:
    if a.nnz.dtype == torch.int32 and a.nnz.dim() == 0:
        return a.nnz
    return a.nnz.to(torch.int32).reshape(())


def row_classes(a: CSR):
    """The row lists of ``a`` on a card (``kernel.RowClasses``), memoized
    on ``a``: the classifying kernel runs on the first call and after a
    write in place to ``a.indptr`` or ``a.nnz``.  None for a CPU CSR."""
    if a.indptr.device.type != "cuda":
        return None
    return memo_on_versions(a, "_spmm_row_classes", (a.indptr, a.nnz),
                            lambda: K.classify(a.indptr, _nnz(a), a.cap))


def spmm_kernel(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ X``: X dense ``(n, k)``, returns ``(m, k)`` in X's dtype.
    CUDA tensors launch the hand-written kernel (and the classifying
    kernel on a CSR not classified yet); CPU tensors run its plain
    version."""
    if x.dim() != 2 or x.shape[0] != a.n_cols:
        raise ValueError(f"x must be ({a.n_cols}, k) for A of shape "
                         f"{a.shape}, got {tuple(x.shape)}")
    x = x.contiguous()
    classes = row_classes(a) if x.is_cuda else None
    data = a.data if a.data.dtype == torch.float32 else a.data.float()
    return K.spmm_call(a.indptr, a.indices, data, x, _nnz(a),
                       classes=classes)
