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

The kernel sizes each block row's table from its own output count and
runs work items by class (:func:`row_classes_plain` for one product and
:func:`batched_row_classes_plain` for a fleet, the classifying kernels'
function: the item's shared-memory bytes, then its row's A-block count).
Where a fleet shares every index array, an item is a block row of a group
of members (:func:`group_size`), else one member's block row.  None of
that changes what the kernel computes.

The kernel's contract: each block row holds the right {bcol: tile} set in
*some* order (C8; the kernel's is the order of first appearance in the
expansion).  ``index_add_`` adds in expansion order on the CPU, the
kernel's order; on the card it adds with atomics in some
order, so values agree bitwise on dyadic inputs and to 1 ulp per
accumulated product otherwise.  The CPU path runs this function; on the
card it serves only as the yardstick the kernel is checked against.
"""
from __future__ import annotations

import bisect
import functools

import torch

from .._build import member_view
from ..spgemm_hash.ref import _bin_caps, row_table_sizes_plain

_COL_BITS = 31

#: The single-product kernel's row classes (``kernel.CLASS_NAMES``): a
#: block's dynamic shared memory in each staged class (7 / 4 / 2 / 1
#: blocks an SM), then the direct class (tables in device memory).
CLASS_SMEM = (30 * 1024, 54 * 1024, 111 * 1024, 225 * 1024)
CLASS_NAMES = ("smem_30k", "smem_54k", "smem_111k", "smem_225k", "direct")
#: A-block count classes within a row class: ``[2^L, 2^(L + 1))``, the last
#: open; a class's rows run longest bucket first.
LEN_BUCKETS = 16
#: B tiles a staged row's stage buffers are sized for at least: STAGE_MIN,
#: or as many as STAGE_FLOATS lanes hold for large tiles, or the row's
#: output count when smaller (no B row is longer than the row's output).
STAGE_MIN = 8
STAGE_FLOATS = 2048
#: Stage buffers of a staged row: BUFFERS, or 3 when A's and B's tiles
#: together pass STAGE_FLOATS lanes.
BUFFERS = 4
#: Members an item of a fleet with shared index arrays takes at most, and
#: the shared memory its group may fill (:func:`group_size`).
MAX_GROUP = 4
GROUP_BYTES = 225 * 1024


def _r16(x):
    return (x + 15) // 16 * 16


def table_bytes(tsz, need, tile):
    """A staged row's table in shared memory: keys and slot-to-tile map
    (``tsz`` each) and ``need`` tiles of ``tile`` float32 lanes."""
    return _r16(8 * tsz + 4 * tile * need)


def half_bytes(n, bm, bk, bn, ga=1, gb=1):
    """One stage buffer of ``n`` B tiles: ``ga`` of A's tiles, the block
    columns (with room for their 16-byte aligned cover) and ``gb`` runs of
    the B tiles, each 16-byte aligned."""
    return _r16(4 * bm * bk * ga) + _r16(4 * n) + 16 + \
        _r16(4 * bk * bn * n * gb)


def stage_buffers(bm, bk, bn):
    """Stage buffers of a staged row."""
    return 3 if bm * bk + bk * bn > STAGE_FLOATS else BUFFERS


def stage_min(need, bk, bn):
    """The B tiles a staged row's stage buffers are sized for (``need``
    an int or an int64 tensor)."""
    s = min(STAGE_MIN, max(1, STAGE_FLOATS // (bk * bn)))
    return need.clamp(max=s) if torch.is_tensor(need) else min(need, s)


def row_bytes(tsz, need, bm, bk, bn, members=1, batched=(True, True)):
    """Shared memory a staged item asks for: its table, with the tiles of
    its ``members``, and :func:`stage_buffers` buffers of
    :func:`stage_min` tiles, each with one of A's tiles per member where
    ``batched[0]`` (else one for all) and B's likewise (ints or int64
    tensors)."""
    ga = members if batched[0] else 1
    gb = members if batched[1] else 1
    return table_bytes(tsz, need * members, bm * bn) + \
        stage_buffers(bm, bk, bn) * \
        half_bytes(stage_min(need, bk, bn), bm, bk, bn, ga, gb)


def group_size(n, tsz, need, block, batched):
    """Members an item takes, for rows of tables ``tsz`` and outputs
    ``need`` (int64 tensors) of a fleet of ``n`` members that shares its
    index arrays, ``batched`` saying whether A's and B's tiles are per
    member: the most ``g <= MAX_GROUP`` whose item fits
    :data:`GROUP_BYTES`, evened out over the ``ceil(n / g)`` items the
    row then needs; 1 where even two members do not fit (and for the
    rows that run direct)."""
    cap = torch.ones_like(need)
    for g in range(min(n, MAX_GROUP), 1, -1):
        fits = row_bytes(tsz, need, *block, g, batched) <= GROUP_BYTES
        cap = torch.where((cap == 1) & fits, torch.full_like(cap, g), cap)
    items = (n + cap - 1) // cap
    return (n + items - 1) // items


def class_of_bytes(nbytes):
    """The row class of a row asking for ``nbytes`` (an int, or an int64
    tensor of them): the first staged class whose shared memory holds it,
    else the direct class."""
    if not torch.is_tensor(nbytes):
        return bisect.bisect_left(CLASS_SMEM, nbytes)
    bounds = torch.tensor(CLASS_SMEM, dtype=torch.int64)
    return torch.searchsorted(bounds, nbytes.long().cpu())


def len_bucket(na):
    """The A-block count class of rows with ``na >= 1`` A blocks."""
    na = torch.as_tensor(na).long()
    return (torch.floor(torch.log2(na.double())).long()).clamp(
        max=LEN_BUCKETS - 1)


def row_classes_plain(offsets, bin_tsize, indptr_a, indptr_c, *,
                      table_size, vector, block):
    """The classifying kernels' function: ``(counts (classes, LEN_BUCKETS)
    int32, rows, row_tsz (m,) int32)``.  ``row_tsz`` is each row's table
    (``row_table_sizes_plain`` of its output count, 0 for a row with no
    output), ``rows[c]`` the ids of class c's rows in the order the class
    pops them: longest A-block bucket first, ascending ids within a bucket
    (the kernels' order within a bucket is free).  Rows whose table cannot
    hold their output (outside every bin, a table that is not a power of
    two or, ``vector``, below 8 slots, output past the table, no A block),
    and every row where the bins run past the rows, join no class: the
    kernels count them as errors.  ``block`` is ``(bm, bk, bn)``."""
    bm, bk, bn = block
    dev = indptr_c.device
    need = (indptr_c[1:].long() - indptr_c[:-1].long()).cpu()
    na = (indptr_a[1:].long() - indptr_a[:-1].long()).cpu()
    m = need.shape[0]
    off = offsets.cpu()
    cap = _bin_caps(off, bin_tsize.cpu(), table_size, m)
    tsz = row_table_sizes_plain(off, bin_tsize.cpu(), need,
                                table_size=table_size).long()
    ok = (need > 0) & (cap >= 1) & ((cap & (cap - 1)) == 0) & \
        (need <= cap) & (na >= 1) & bool(off[0] >= 0 and off[-1] <= m)
    if vector:
        ok &= cap >= 8
    cls = class_of_bytes(row_bytes(tsz, need, bm, bk, bn))
    bucket = len_bucket(na.clamp(min=1))
    n_cls = len(CLASS_NAMES)
    counts = torch.zeros(n_cls, LEN_BUCKETS, dtype=torch.int32)
    rows = []
    ids = torch.arange(m)
    for c in range(n_cls):
        mine = ok & (cls == c)
        counts[c] = torch.bincount(bucket[mine], minlength=LEN_BUCKETS)
        order = torch.argsort(-bucket[mine] * (m + 1) + ids[mine])
        rows.append(ids[mine][order].to(torch.int32).to(dev))
    row_tsz = torch.where(ok, tsz, torch.zeros_like(tsz))
    return counts.to(dev), rows, row_tsz.to(torch.int32).to(dev)


def batched_row_classes_plain(offsets, bin_tsize, indptr_a, indptr_b,
                              indptr_c, a_bcol, a_blk, b_bcol, b_blk, *,
                              n_members, table_size, vector):
    """The classifying kernels' function over a fleet: ``(counts
    (classes, LEN_BUCKETS) int32, items, unit_tsz (n, m) int32)``, the
    arguments as for :func:`batched_numeric_plain`.

    Where every index array is shared (1-D), an item is a block row of a
    group of members: each row's table, A-block bucket and whether it is
    listed as :func:`row_classes_plain` of the shared arrays says, its
    group :func:`group_size`, its class by :func:`row_bytes` of an item of
    that group (A's and B's tiles per member where they are stacked), and
    its members split into ``ceil(n / group)`` items of ``group`` members,
    the last the rest.  Else an item is one member's block row, as
    :func:`row_classes_plain` of that member's arrays alone lists it.
    ``items[c]`` holds class c's items as ``(k, 3)`` int64 rows ``(first
    member, members, row)``: longest A-block bucket first, then by unit (a
    shared row; else member, then row), a row's items by first member (the
    kernels' order within a bucket is free).  ``unit_tsz`` is each
    member's row tables; ``counts`` counts items."""
    n = n_members
    dev = a_bcol.device
    block = (a_blk.shape[-2], a_blk.shape[-1], b_blk.shape[-1])
    index = (offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_bcol,
             b_bcol)
    grouped = all(t.dim() == 1 for t in index)
    batched = (a_blk.dim() == 4, b_blk.dim() == 4)
    m = indptr_a.shape[-1] - 1
    parts, tables = [], []
    for e in range(1 if grouped else n):
        v = [member_view(t, 1, e).cpu() for t in (offsets, bin_tsize,
                                                   indptr_a, indptr_c)]
        _, rows, tsz = row_classes_plain(*v, table_size=table_size,
                                         vector=vector, block=block)
        tables.append(tsz)
        row = torch.cat(rows).long()
        need = (v[3][row + 1] - v[3][row]).long()
        na = (v[2][row + 1] - v[2][row]).long()
        g = group_size(n, tsz.long()[row], need, block, batched) \
            if grouped else torch.ones_like(row)
        cls = class_of_bytes(row_bytes(tsz.long()[row], need, *block, g,
                                       batched))
        bucket = len_bucket(na)
        for x in range(n if grouped else 1):
            take = x * g < n
            first = x * g[take] if grouped else torch.full_like(row, e)
            parts.append(torch.stack((
                cls[take], bucket[take], first,
                torch.minimum(g[take], n - first), row[take],
                row[take] if grouped else e * m + row)))
    cls, bucket, first, members, row, unit = torch.cat(parts, 1)
    n_cls = len(CLASS_NAMES)
    counts = torch.zeros(n_cls, LEN_BUCKETS, dtype=torch.int32)
    items = []
    for c in range(n_cls):
        mine = cls == c
        counts[c] = torch.bincount(bucket[mine], minlength=LEN_BUCKETS)
        key = (-bucket[mine] * (n * m + 1) + unit[mine]) * n + first[mine]
        order = torch.argsort(key)
        items.append(torch.stack((first[mine], members[mine], row[mine]),
                                 1)[order].to(dev))
    unit_tsz = torch.stack(tables * n if grouped else tables)
    return counts.to(dev), items, unit_tsz.to(torch.int32).to(dev)


def _lowest_p2(x):
    """The lowest power of two at least ``x`` (an int64 tensor >= 1)."""
    p = torch.ones_like(x) << torch.ceil(torch.log2(x.double())).long()
    return torch.where(p < x, p * 2, p)


@functools.lru_cache(maxsize=256)
def launch_classes(block, table_size, bcap_c, members=1,
                   batched=(True, True)) -> tuple:
    """The classes that can hold an item of a product with ``block``
    ``(bm, bk, bn)`` tiles, tables of at most ``table_size`` slots and
    ``bcap_c`` output blocks, known on the host, largest first: the order
    of the kernel's launches.  One member an item: from the smallest
    row's class (one output, an 8-slot table) to the largest's
    (``min(table_size, bcap_c)`` outputs in a ``table_size``-slot table).
    Items of groups (a fleet of ``members`` that shares its index arrays,
    ``batched`` as for :func:`row_bytes`): from the smallest to the
    largest class of an item over every output count and table a row can
    have."""
    bm, bk, bn = block
    t = max(int(table_size), 1)
    top_need = max(1, min(t, int(bcap_c)))
    if members <= 1:
        lo = int(class_of_bytes(row_bytes(min(t, 8), 1, bm, bk, bn)))
        hi = int(class_of_bytes(row_bytes(t, top_need, bm, bk, bn)))
        return tuple(range(hi, lo - 1, -1))
    need = torch.arange(1, top_need + 1)
    # a row's table: a power of two from its output count up to row_table's
    top = torch.clamp(_lowest_p2(torch.clamp(2 * need, min=8)), max=t)
    tsz, found = _lowest_p2(need), []
    while bool((tsz <= top).any()):
        ok = tsz <= top
        g = group_size(members, tsz[ok], need[ok], block, batched)
        found.append(class_of_bytes(row_bytes(tsz[ok], need[ok], *block, g,
                                              batched)))
        tsz = tsz * 2
    found = torch.cat(found)
    return tuple(range(int(found.max()), int(found.min()) - 1, -1))

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
