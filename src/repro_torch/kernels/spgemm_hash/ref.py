"""Plain PyTorch versions of the hash SpGEMM kernels.

They take the kernels' own arguments (see ``kernel.py``) and compute the
same functions without a hash table: expand every product with the row
pointers, stable-sort on the int64 key ``row << 31 | col``, reduce each
segment in expansion order (one rounding per product) and emit each row
in sorted column order.  The per-bin table sizes only shape the kernels'
internal layout, so the plain versions accept and ignore them.

The kernels size each row's table from its own need, at most its bin's
(:func:`row_table_sizes_plain`), and both phases, single product or
fleet, run rows by table class (:func:`row_classes_plain` and
:func:`batched_row_classes_plain`, the classifying kernel's function; the
symbolic phase counts its largest rows in a bitmap of B's columns,
:func:`bitmap_above`); none of it changes what the kernels compute.

The semantic contract of the kernels (per phase):
  * symbolic: exact nnz per output row;
  * numeric:  (indices, values) at ``indptr_c``, where each row holds the
    right {col: sum of products} set in *some* order (unsorted, C8);
  * batched symbolic and numeric: each phase for every member of a
    fleet, every argument stacked along a leading member axis or shared.

The CPU path runs these functions; on the card they serve only as the
yardstick the kernels are checked against.
"""
from __future__ import annotations

import torch

from .._build import member_view

_COL_BITS = 31

#: The numeric kernel's table classes: the largest table (slots) of each
#: but the last, which holds every larger one (``kernel.CLASS_NAMES``).
CLASS_SLOTS = (1024, 4096, 16384, 32768, 65536, 131072)
#: the smallest table a row gets (the chunked probe's width)
_MIN_TABLE = 8
#: The symbolic phase's bitmap class (``kernel.BITMAP_CLASS``): the rows
#: whose table passes BITMAP_ABOVE slots (and the bitmap's words, so that
#: a row never clears more bitmap than it would table), when B has at most
#: BITMAP_COLS columns (a 200 KB bitmap in one block's shared memory).
BITMAP_ABOVE = 4096
BITMAP_COLS = 51200 * 32


def bitmap_above(n_cols: int) -> int:
    """The table above which a symbolic row goes to the bitmap class, for
    a B of ``n_cols`` columns: the larger of :data:`BITMAP_ABOVE` and the
    largest power of two within the bitmap's 32-bit words (a row's table
    is a power of two, so every bitmap row's table holds at least as many
    slots as its bitmap words); 0 (no bitmap class) past
    :data:`BITMAP_COLS`, where the bitmap does not fit one block."""
    if n_cols < 0:
        raise ValueError(f"B's width must be at least 0, got {n_cols}")
    if n_cols > BITMAP_COLS:
        return 0
    words = -(-n_cols // 32)
    return max(BITMAP_ABOVE, 1 << max(words.bit_length() - 1, 0))


def need_width(n_cols) -> int:
    """``n_cols`` of a symbolic classification, which cannot go without
    it: B's width decides the bitmap class."""
    if n_cols is None:
        raise TypeError("the symbolic phase's classes need B's width "
                        "(n_cols)")
    return n_cols


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


def batched_symbolic_plain(offsets, bin_tsize, indptr_a, indptr_b, a_idx,
                           a_val, b_idx, b_val, *, n_members, table_size,
                           vector):
    """The batched symbolic kernel's function: :func:`symbolic_plain` for
    each of ``n_members`` members, ``(n, m) int32``.  Every argument has a
    leading member axis or is 1-D and shared by all members."""
    args = (offsets, bin_tsize, indptr_a, indptr_b, a_idx, a_val, b_idx,
            b_val)
    return torch.stack([
        symbolic_plain(*(member_view(t, 1, e) for t in args),
                       table_size=table_size, vector=vector)
        for e in range(n_members)])


def batched_numeric_plain(offsets, bin_tsize, indptr_a, indptr_b, indptr_c,
                          a_idx, a_val, b_idx, b_val, *, n_members, cap_c,
                          table_size, vector):
    """The batched numeric kernel's function: :func:`numeric_plain` for
    each of ``n_members`` members, ``(cols, vals)``, each ``(n, cap_c)``.
    Every argument has a leading member axis or is 1-D and shared by all
    members (a plan's schedule and ``indptr_c`` under a value fleet)."""
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx, a_val,
            b_idx, b_val)
    dev = a_idx.device
    out_cols = torch.zeros(n_members, cap_c, dtype=torch.int32, device=dev)
    out_vals = torch.zeros(n_members, cap_c, dtype=torch.float32, device=dev)
    for e in range(n_members):
        out_cols[e], out_vals[e] = numeric_plain(
            *(member_view(t, 1, e) for t in args), cap_c=cap_c,
            table_size=table_size, vector=vector)
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


def _bin_caps(offsets, bin_tsize, table_size, m):
    """Each row's plan table, ``min(bin_tsize[b], table_size)`` of the bin
    b that holds it, 0 for a row outside every bin; ``(m,) int64``."""
    dev = offsets.device
    off = offsets.long()
    rows = torch.arange(m, device=dev)
    b = torch.searchsorted(off, rows, right=True) - 1
    n_bins = bin_tsize.shape[0]
    inside = (b >= 0) & (b < n_bins)
    bc = b.clamp(0, max(n_bins - 1, 0))
    inside &= rows < off[(bc + 1).clamp(max=off.shape[0] - 1)]
    cap = bin_tsize.long()[bc].clamp(max=table_size) if n_bins else \
        torch.zeros(m, dtype=torch.long, device=dev)
    return torch.where(inside, cap, torch.zeros_like(cap))


def row_table_sizes_plain(offsets, bin_tsize, need, *, table_size):
    """Each row's table, ``(m,) int32``: ``min(cap, lowest_p2(max(2 *
    need, 8)))`` with ``cap`` its bin's table (:func:`_bin_caps`), 0 where
    ``need`` (output count for numeric, product count for symbolic) or
    ``cap`` is 0."""
    need = need.long()
    cap = _bin_caps(offsets, bin_tsize, table_size, need.shape[0])
    want = torch.clamp(2 * torch.minimum(need, cap), min=_MIN_TABLE)
    e = torch.ceil(torch.log2(want.double())).long()
    p2 = torch.ones_like(want) << e
    p2 = torch.where(p2 < want, p2 * 2, p2)
    tsz = torch.minimum(cap, p2)
    return torch.where((need > 0) & (cap > 0), tsz,
                       torch.zeros_like(tsz)).to(torch.int32)


def row_classes_plain(offsets, bin_tsize, indptr_c, *, table_size):
    """The classifying kernel's function: ``(counts (7,) int32, rows,
    row_tsz (m,) int32)``: each numeric row's table
    (:func:`row_table_sizes_plain` of its output count), ``rows[c]`` the
    ascending ids of the rows whose table falls in class c (the first
    :data:`CLASS_SLOTS` entry it fits, else the last class), empty rows in
    none."""
    need = indptr_c[1:].long() - indptr_c[:-1].long()
    row_tsz = row_table_sizes_plain(offsets, bin_tsize, need,
                                    table_size=table_size)
    bounds = torch.tensor(CLASS_SLOTS, dtype=torch.int32,
                          device=row_tsz.device)
    cls = torch.searchsorted(bounds, row_tsz)
    listed = row_tsz > 0
    ids = torch.arange(row_tsz.shape[0], device=row_tsz.device,
                       dtype=torch.int32)
    rows = [ids[listed & (cls == c)] for c in range(len(CLASS_SLOTS) + 1)]
    counts = torch.tensor([r.shape[0] for r in rows], dtype=torch.int32,
                          device=row_tsz.device)
    return counts, rows, row_tsz


def row_flop_plain(indptr_a, indptr_b, a_idx):
    """Each row's product count (the sum of the lengths of the B rows its
    A row selects), ``(m,) int64``: the symbolic phase's need."""
    m = indptr_a.shape[0] - 1
    nnz_a = int(indptr_a[-1])
    lens = (indptr_b[1:] - indptr_b[:-1]).long()
    per_entry = lens[a_idx[:nnz_a].long()]
    rows = torch.repeat_interleave(
        torch.arange(m, device=a_idx.device),
        (indptr_a[1:] - indptr_a[:-1]).long(), output_size=nnz_a)
    return torch.zeros(m, dtype=torch.int64,
                       device=a_idx.device).index_add_(0, rows, per_entry)


def batched_row_classes_plain(offsets, bin_tsize, indptr_a, indptr_b,
                              indptr_c, a_idx, *, n_members, table_size,
                              numeric=True, n_cols: int | None = None):
    """The classifying kernel's function over a fleet, either phase:
    ``(counts (k,) int32, pairs, row_tsz (n, m) int32)``.  Member e's row
    i gets :func:`row_table_sizes_plain` of its need -- its output count
    (numeric, from ``indptr_c``) or its product count (symbolic,
    :func:`row_flop_plain`; ``indptr_c`` ignored) -- and ``pairs[c]`` holds
    the ``(member, row)`` pairs whose table falls in class c, ascending,
    as an ``(k, 2)`` int64 tensor; pairs without a table join none.  The
    symbolic phase needs B's width ``n_cols``; where :func:`bitmap_above`
    of it is not 0 it has k = 8 classes: the pairs whose table passes
    ``bitmap_above`` go to the last, the bitmap class, and no other class
    holds a larger table; else k = 7.  Every argument has a leading member axis or is 1-D and
    shared by all members; ``m`` is the rows of ``indptr_a`` (numeric:
    and of ``indptr_c``, the fewer)."""
    above = 0 if numeric else bitmap_above(need_width(n_cols))
    m = indptr_a.shape[-1] - 1
    if numeric:
        m = min(m, indptr_c.shape[-1] - 1)
    dev = a_idx.device
    tables = []
    for e in range(n_members):
        off, bts = member_view(offsets, 1, e), member_view(bin_tsize, 1, e)
        if numeric:
            ic = member_view(indptr_c, 1, e)[:m + 1].long()
            need = ic[1:] - ic[:-1]
        else:
            need = row_flop_plain(member_view(indptr_a, 1, e)[:m + 1],
                                  member_view(indptr_b, 1, e),
                                  member_view(a_idx, 1, e))
        tables.append(row_table_sizes_plain(off, bts, need,
                                            table_size=table_size))
    row_tsz = torch.stack(tables) if tables else \
        torch.zeros(0, m, dtype=torch.int32, device=dev)
    bounds = torch.tensor(CLASS_SLOTS, dtype=torch.int32, device=dev)
    cls = torch.searchsorted(bounds, row_tsz)
    n_cls = len(CLASS_SLOTS) + 1
    if above:
        cls = torch.where(row_tsz > above, n_cls, cls)
        n_cls += 1
    listed = row_tsz > 0
    pairs = [torch.nonzero(listed & (cls == c)) for c in range(n_cls)]
    counts = torch.tensor([x.shape[0] for x in pairs], dtype=torch.int32,
                          device=dev)
    return counts, pairs, row_tsz
