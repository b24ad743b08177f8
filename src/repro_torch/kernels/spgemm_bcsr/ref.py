"""Plain PyTorch version of the BCSR numeric kernel.

:func:`numeric_plain` takes the kernel's own arguments (see ``kernel.py``)
and computes the same function without a hash table: expand every block
pair (A block ``j`` of block row ``i``, B block ``t`` of block row
``a_bcol[j]``), form each tile product with one rounding per scalar
product, summed over the inner index in order, stable-sort the pairs on
the int64 key ``brow << 31 | bcol``, add each output block's tile
products in expansion order, and write each block row at ``indptr_c`` in
sorted block-column order with a zero tail.  The per-bin table sizes only
shape the kernel's internal layout, so the plain version accepts and
ignores them.

:func:`batched_numeric_plain` is the batched kernel's function: the same
for every member of a fleet, each argument stacked along a member axis or
shared by all members.

The kernel's contract: each block row holds the right {bcol: tile} set in
*some* order (hash order, C8).  ``index_add_`` adds in expansion order on
the CPU, the kernel's order; on the card it adds with atomics in some
order, so values agree bitwise on dyadic inputs and to 1 ulp per
accumulated product otherwise.  The CPU path runs this function; on the
card it serves only as the yardstick the kernel is checked against.
"""
from __future__ import annotations

import torch

from .._build import member_view

_COL_BITS = 31

def _expand_pairs(indptr_a, indptr_b, a_bcol, b_bcol):
    """``(key, j, t)`` of every block pair of ``A @ B`` in A-slot order."""
    dev = a_bcol.device
    gm = indptr_a.shape[0] - 1
    nnzb_a = int(indptr_a[-1])
    k = a_bcol[:nnzb_a].long()
    pnz = (indptr_b[k + 1] - indptr_b[k]).long()
    total = int(pnz.sum())
    j = torch.repeat_interleave(torch.arange(nnzb_a, device=dev), pnz,
                                output_size=total)
    off = torch.cumsum(pnz, 0) - pnz
    t = indptr_b.long()[k[j]] + torch.arange(total, device=dev) - off[j]
    brow_of_slot = torch.repeat_interleave(
        torch.arange(gm, device=dev), (indptr_a[1:] - indptr_a[:-1]).long(),
        output_size=nnzb_a)
    key = (brow_of_slot[j] << _COL_BITS) | b_bcol.long()[t]
    return key, j, t


def _row_positions(ukey, indptr_c, gm):
    """Slot of each sorted unique key in the block-row layout of
    ``indptr_c``."""
    rows = ukey >> _COL_BITS
    per_row = torch.bincount(rows, minlength=gm)[:gm]
    row_first = torch.cumsum(per_row, 0) - per_row
    rank = torch.arange(ukey.shape[0], device=ukey.device) - row_first[rows]
    return indptr_c.long()[rows] + rank


def _tile_products(a_tiles, b_tiles):
    """``a_tiles[p] @ b_tiles[p]`` for every pair ``p``, float32, one
    rounding per scalar product and per add, inner index in order."""
    a = a_tiles.float()
    b = b_tiles.float()
    out = a[:, :, 0, None] * b[:, None, 0, :]
    for kk in range(1, a.shape[2]):
        out = out + a[:, :, kk, None] * b[:, None, kk, :]
    return out


def numeric_plain(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol,
                  a_blk, b_bcol, b_blk, *, bcap_c, table_size, vector):
    """``(out_bcol (bcap_c,) int32, out_blk (bcap_c, bm, bn) float32)``:
    each block row at ``indptr_c`` in sorted block-column order."""
    dev = a_bcol.device
    gm = indptr_a.shape[0] - 1
    bm, bn = a_blk.shape[1], b_blk.shape[2]
    key, j, t = _expand_pairs(indptr_a, indptr_b, a_bcol, b_bcol)
    prod = _tile_products(a_blk[j], b_blk[t])
    del j, t
    key_s, order = torch.sort(key, stable=True)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    n_seg = int(first.sum())
    tiles = torch.zeros((n_seg, bm, bn), dtype=torch.float32, device=dev)
    tiles.index_add_(0, seg, prod[order])
    ukey = key_s[first]
    pos = _row_positions(ukey, indptr_c, gm)
    keep = pos < bcap_c
    out_bcol = torch.zeros(bcap_c, dtype=torch.int32, device=dev)
    out_blk = torch.zeros((bcap_c, bm, bn), dtype=torch.float32, device=dev)
    out_bcol[pos[keep]] = (ukey[keep] & ((1 << _COL_BITS) - 1)).to(
        torch.int32)
    out_blk[pos[keep]] = tiles[keep]
    return out_bcol, out_blk


def batched_numeric_plain(offsets, bin_tsize, indptr_a, indptr_b,
                          indptr_c, a_bcol, a_blk, b_bcol, b_blk, *,
                          n_members, bcap_c, table_size, vector):
    """:func:`numeric_plain` of each of ``n_members`` members:
    ``(out_bcol (n, bcap_c) int32, out_blk (n, bcap_c, bm, bn) float32)``.
    Each argument is stacked along a leading member axis or has
    :func:`numeric_plain`'s shape and is shared (an integer array 1-D, a
    tile array 3-D)."""
    args = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol, a_blk,
            b_bcol, b_blk)
    dev = a_bcol.device
    bm, bn = a_blk.shape[-2], b_blk.shape[-1]
    out_bcol = torch.zeros(n_members, bcap_c, dtype=torch.int32, device=dev)
    out_blk = torch.zeros((n_members, bcap_c, bm, bn), dtype=torch.float32,
                          device=dev)
    for e in range(n_members):
        out_bcol[e], out_blk[e] = numeric_plain(
            *(member_view(t, 3 if t.is_floating_point() else 1, e)
              for t in args),
            bcap_c=bcap_c, table_size=table_size, vector=vector)
    return out_bcol, out_blk


def products_per_block(indptr_a, indptr_b, indptr_c, a_bcol, b_bcol,
                       bcap_c):
    """How many block pairs each output slot of :func:`numeric_plain`
    sums, ``(bcap_c,) int64``; times ``bk`` it is the ``k`` of the "1 ulp
    per accumulated product" bound on non-dyadic values."""
    dev = a_bcol.device
    gm = indptr_a.shape[0] - 1
    key, _, _ = _expand_pairs(indptr_a, indptr_b, a_bcol, b_bcol)
    ukey, counts = torch.unique_consecutive(torch.sort(key).values,
                                            return_counts=True)
    pos = _row_positions(ukey, indptr_c, gm)
    keep = pos < bcap_c
    out = torch.zeros(bcap_c, dtype=torch.int64, device=dev)
    out[pos[keep]] = counts[keep]
    return out


def sort_block_rows(indptr_c, bcol, blk):
    """Sort block columns within each block row, carrying the tiles: the
    kernel's hash-order rows in :func:`numeric_plain`'s order.  Slots past
    ``indptr_c[-1]`` stay where they are."""
    nnzb = int(indptr_c[-1])
    gm = indptr_c.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(gm, device=bcol.device),
        (indptr_c[1:] - indptr_c[:-1]).long(), output_size=nnzb)
    order = torch.argsort((rows << _COL_BITS) | bcol[:nnzb].long())
    out_c, out_b = bcol.clone(), blk.clone()
    out_c[:nnzb] = bcol[:nnzb][order]
    out_b[:nnzb] = blk[:nnzb][order]
    return out_c, out_b
