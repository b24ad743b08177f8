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
"""
from __future__ import annotations

import torch


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
