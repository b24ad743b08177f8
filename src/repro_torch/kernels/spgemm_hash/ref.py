"""Plain PyTorch versions of the hash SpGEMM kernels.

They take the kernels' own arguments (see ``kernel.py``) and compute the
same functions without a hash table: expand every product with the row
pointers, stable-sort on the int64 key ``row << 31 | col``, reduce each
segment in expansion order (one rounding per product) and emit each row
in sorted column order.  The per-bin table sizes only shape the kernels'
internal layout, so the plain versions accept and ignore them.

The semantic contract of the kernels (per phase):
  * symbolic: exact nnz per output row;
  * numeric:  (indices, values) at ``indptr_c``, where each row holds the
    right {col: sum of products} set in *some* order (unsorted, C8).

The CPU path runs these functions; on the card they serve only as the
yardstick the kernels are checked against.
"""
from __future__ import annotations

import torch

_COL_BITS = 31


def _expand_keys(indptr_a, indptr_b, a_idx, b_idx):
    """``(key, j, b_slot)`` of every product of ``A @ B`` in A-slot order."""
    dev = a_idx.device
    m = indptr_a.shape[0] - 1
    nnz_a = int(indptr_a[-1])
    k = a_idx[:nnz_a].long()
    pnz = (indptr_b[k + 1] - indptr_b[k]).long()
    total = int(pnz.sum())
    j = torch.repeat_interleave(torch.arange(nnz_a, device=dev), pnz,
                                output_size=total)
    off = torch.cumsum(pnz, 0) - pnz
    b_slot = indptr_b.long()[k[j]] + torch.arange(total, device=dev) - off[j]
    row_of_slot = torch.repeat_interleave(
        torch.arange(m, device=dev), (indptr_a[1:] - indptr_a[:-1]).long(),
        output_size=nnz_a)
    key = (row_of_slot[j] << _COL_BITS) | b_idx.long()[b_slot]
    return key, j, b_slot


def _segments(key):
    """Stable sort of ``key`` and the first-of-segment flags."""
    key_s, order = torch.sort(key, stable=True)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return key_s, order, first


def symbolic_plain(offsets, bin_tsize, indptr_a, indptr_b, a_idx, a_val,
                   b_idx, b_val, *, table_size, vector):
    """Exact distinct-column count per output row, ``(m,) int32``."""
    m = indptr_a.shape[0] - 1
    key, _, _ = _expand_keys(indptr_a, indptr_b, a_idx, b_idx)
    key_s, _, first = _segments(key)
    rows = key_s[first] >> _COL_BITS
    return torch.bincount(rows, minlength=m)[:m].to(torch.int32)


def numeric_plain(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx,
                  a_val, b_idx, b_val, *, cap_c, table_size, vector):
    """``(cols, vals)`` of capacity ``cap_c``: each row at ``indptr_c`` in
    sorted column order, values summed per product in expansion order."""
    dev = a_idx.device
    m = indptr_a.shape[0] - 1
    key, j, b_slot = _expand_keys(indptr_a, indptr_b, a_idx, b_idx)
    prod = a_val[j].float() * b_val[b_slot].float()
    del j, b_slot
    key_s, order, first = _segments(key)
    seg = torch.cumsum(first.long(), 0) - 1
    n_seg = int(first.sum())
    vals = torch.zeros(n_seg, dtype=torch.float32, device=dev)
    vals.index_add_(0, seg, prod[order])
    ukey = key_s[first]
    rows = ukey >> _COL_BITS
    cols = (ukey & ((1 << _COL_BITS) - 1)).to(torch.int32)
    per_row = torch.bincount(rows, minlength=m)[:m]
    row_first_seg = torch.cumsum(per_row, 0) - per_row
    pos = indptr_c.long()[rows] + torch.arange(n_seg, device=dev) \
        - row_first_seg[rows]
    keep = pos < cap_c
    out_cols = torch.zeros(cap_c, dtype=torch.int32, device=dev)
    out_vals = torch.zeros(cap_c, dtype=torch.float32, device=dev)
    out_cols[pos[keep]] = cols[keep]
    out_vals[pos[keep]] = vals[keep]
    return out_cols, out_vals


def products_per_entry(indptr_a, indptr_b, indptr_c, a_idx, b_idx, cap_c):
    """How many products each output slot of :func:`numeric_plain` sums,
    ``(cap_c,) int64`` -- the ``k`` of the "1 ulp per accumulated
    product" bound on non-dyadic values."""
    dev = a_idx.device
    m = indptr_a.shape[0] - 1
    key, _, _ = _expand_keys(indptr_a, indptr_b, a_idx, b_idx)
    ukey, counts = torch.unique_consecutive(torch.sort(key).values,
                                            return_counts=True)
    rows = ukey >> _COL_BITS
    per_row = torch.bincount(rows, minlength=m)[:m]
    row_first_seg = torch.cumsum(per_row, 0) - per_row
    pos = indptr_c.long()[rows] + torch.arange(ukey.shape[0], device=dev) \
        - row_first_seg[rows]
    keep = pos < cap_c
    out = torch.zeros(cap_c, dtype=torch.int64, device=dev)
    out[pos[keep]] = counts[keep]
    return out
