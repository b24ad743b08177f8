"""Plain PyTorch version of the SpMM kernel.

:func:`spmm_plain` takes the kernel's arguments (see ``kernel.py``) and
computes what ``_spmm_kernel`` of ``repro/kernels/spmm/kernel.py`` does:
``y[i, :] = sum_j data[j] * x[indices[j], :]`` over row ``i``'s slots,
accumulated in float32 in the row's nonzero order from 0, stored cast to
``x``'s dtype.  It walks position ``p`` of every row at once (one step per
slot of the longest row), vectorised over rows and over ``k``, with the
multiply and the add as separate ops, so each value is rounded exactly as
the CUDA kernel rounds it (``__fmul_rn`` then ``__fadd_rn``): the two agree
bitwise on any values.  The CPU path runs it; on the card it is the
yardstick the kernel is checked against.

:func:`row_classes_plain` is the function of the kernel's classifying
step (``classify_kernel`` of ``csrc/spmm.cu``): each row's live length
and its length class.
"""
from __future__ import annotations

import torch

#: class c's upper length bound: class 0 holds rows of at most
#: CLASS_BOUNDS[0] live nonzeros (empty rows too), class c >= 1 rows of
#: (CLASS_BOUNDS[c - 1], CLASS_BOUNDS[c]], the last class every longer row.
#: On the card classes 0-3 (at most 256) take a warp a row, the others a
#: whole block a row.
CLASS_BOUNDS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
N_CLASSES = len(CLASS_BOUNDS) + 1


def class_rooms(m: int, cap: int) -> list:
    """The room of each class's row list on the card: class 0 every row,
    class c >= 1 ``min(m, cap // (CLASS_BOUNDS[c - 1] + 1))`` -- as many
    rows of that length as ``cap`` slots can hold under a row pointer that
    never decreases."""
    return [m] + [min(m, cap // (b + 1)) for b in CLASS_BOUNDS]


def live_lengths(indptr, nnz, cap: int) -> torch.Tensor:
    """``(m,) int64``: each row's slots below ``min(nnz, cap)``,
    ``min(indptr[i + 1], min(nnz, cap)) - indptr[i]`` clamped at 0."""
    live = torch.clamp(torch.as_tensor(nnz, device=indptr.device)
                       .to(torch.int64), max=cap)
    start = indptr[:-1].to(torch.int64)
    return (torch.minimum(indptr[1:].to(torch.int64), live)
            - start).clamp(min=0)


def row_classes_plain(indptr, nnz, cap: int):
    """The classifying kernel's function: ``(counts (N_CLASSES,) int32,
    rows)``, ``rows[c]`` the ascending int32 ids of the rows whose live
    length (:func:`live_lengths`) falls in class c."""
    length = live_lengths(indptr, nnz, cap)
    bounds = torch.tensor(CLASS_BOUNDS, dtype=torch.int64,
                          device=indptr.device)
    cls = torch.searchsorted(bounds, length)
    ids = torch.arange(length.shape[0], device=indptr.device,
                       dtype=torch.int32)
    rows = [ids[cls == c] for c in range(N_CLASSES)]
    counts = torch.tensor([r.shape[0] for r in rows], dtype=torch.int32,
                          device=indptr.device)
    return counts, rows


def spmm_plain(indptr, indices, data, x, nnz) -> torch.Tensor:
    """``(m, k)`` in ``x``'s dtype for ``m = len(indptr) - 1``.

    Slots at or past ``min(nnz, len(indices))`` count as 0 (padding);
    column ids are clipped to ``[0, n)``, as the reference's gather does.
    """
    m, k = indptr.shape[0] - 1, x.shape[1]
    dev = x.device
    live = torch.clamp(torch.as_tensor(nnz, device=dev).to(torch.int64),
                       max=indices.shape[0])
    start = indptr[:-1].to(torch.int64)
    count = (torch.minimum(indptr[1:].to(torch.int64), live)
             - start).clamp(min=0)
    # rows by decreasing length: the rows that still have a p-th slot are
    # a prefix, so step p touches only those
    count_s, order = torch.sort(count, descending=True, stable=True)
    start_s = start[order]
    active = torch.searchsorted(count_s.flip(0),
                                torch.arange(int(count_s[0]) if m else 0,
                                             device=dev), right=True)
    cols = indices.to(torch.int64).clamp(0, max(x.shape[0] - 1, 0))
    vals = data.to(torch.float32)
    xf = x.to(torch.float32)
    acc = torch.zeros((m, k), dtype=torch.float32, device=dev)
    for p, rows in enumerate((m - active).tolist()):
        pos = start_s[:rows] + p
        prod = vals[pos][:, None] * xf[cols[pos]]
        acc[:rows] += prod
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    y[order] = acc
    return y.to(x.dtype)
