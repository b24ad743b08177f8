"""The BCSR block kernel's work items over a fleet (the plain version of its
classifying kernels, ``ref.batched_row_classes_plain``, which
``kernel.batched_row_classes`` runs on CPU tensors) against the
reference's plans.

A fleet runs as work items: where every index array is shared (a value
fleet on one plan), an item is a block row of a group of members, whose
table holds every member's tiles; else an item is one member's block row.
Each item's table, group and class are counted here again with numpy from
each member's own row classes (``ref.row_classes_plain`` of its arrays
alone): the group is the most members, up to 4, whose item fits 225 KB,
evened out over the items the row needs, and the class is the first of
30 / 54 / 111 / 225 KB that holds the item's bytes, its group's tiles
counted.  Schedules come from ``repro.core.plan_bcsr`` on R-MAT block
patterns and from the reference's inspection of ``_bcsr_ladder.py``'s
rungs.  On a card, ``test_torch_cuda.py`` holds the classifying kernels
against this plain version.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.kernels.spgemm_bcsr import ops as jops  # noqa: E402
from repro_torch.data.rmat import rmat_edges  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import ref  # noqa: E402
from _bcsr_ladder import (LADDER, LADDER_CLASSES, LADDER_LARGE,  # noqa: E402
                          LADDER_LARGE_CLASSES, ladder)

#: the classes' shared memory, the stage's sizing and the group rule,
#: restated
SMEM = (30 * 1024, 54 * 1024, 111 * 1024, 225 * 1024)
STAGE_MIN, STAGE_FLOATS, BUFFERS = 8, 2048, 4
MAX_GROUP, GROUP_BYTES = 4, 225 * 1024


def r16(x):
    return (x + 15) // 16 * 16


def item_bytes(tsz, need, block, g, batched):
    """Shared memory of an item of ``g`` members, numpy."""
    bm, bk, bn = block
    ga = g if batched[0] else 1
    gb = g if batched[1] else 1
    stage = min(need, STAGE_MIN, max(1, STAGE_FLOATS // (bk * bn)))
    half = r16(4 * bm * bk * ga) + r16(4 * stage) + 16 + \
        r16(4 * bk * bn * stage * gb)
    nbuf = 3 if bm * bk + bk * bn > STAGE_FLOATS else BUFFERS
    return r16(8 * tsz + 4 * bm * bn * need * g) + nbuf * half


def group_of(n, tsz, need, block, batched):
    cap = 1
    for g in range(min(n, MAX_GROUP), 1, -1):
        if item_bytes(tsz, need, block, g, batched) <= GROUP_BYTES:
            cap = g
            break
    items = -(-n // cap)
    return -(-n // items)


def class_of(nbytes):
    return int(np.searchsorted(np.asarray(SMEM), nbytes, side="left"))


def bucket_of(na):
    return min(int(np.floor(np.log2(na))), ref.LEN_BUCKETS - 1)


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def reference_plan(preset, scale, seed):
    """An R-MAT block pattern (8x8 tiles) and the reference's
    ``plan_bcsr`` of its square: ``(indptr, indices, offsets, bin_tsize,
    table_size, indptr_cb)`` as numpy arrays."""
    g = 1 << scale
    br, bc = rmat_edges(scale, 8, preset, seed)
    key = np.unique(br.astype(np.int64) * g + bc)
    br, bc = key // g, key % g
    indptr = np.zeros(g + 1, np.int32)
    np.cumsum(np.bincount(br, minlength=g), out=indptr[1:])
    blocks = np.ones((key.shape[0], 8, 8), np.float32)
    a = J.BCSR(jnp.asarray(indptr), jnp.asarray(bc.astype(np.int32)),
               jnp.asarray(blocks), jnp.asarray(key.shape[0], jnp.int32),
               (g * 8, g * 8), (8, 8))
    p = J.plan_bcsr(a, a, cache=False)
    return (indptr, bc.astype(np.int32), np.asarray(p.offsets),
            np.asarray(p.bin_tsize), int(p.table_size),
            np.asarray(p.indptr_cb))


@functools.lru_cache(maxsize=None)
def ladder_plan(large, seed):
    """``_bcsr_ladder``'s A and B and the reference's inspection of their
    product: ``(indptr_a, a_bcol, indptr_b, b_bcol, offsets, bin_tsize,
    table_size, indptr_cb)``."""
    rungs, block = (LADDER_LARGE, (64, 64, 64)) if large else \
        (LADDER, (8, 8, 8))
    a, b = ladder(rungs, block, dyadic=True, seed=seed)

    def jb(parts, blk):
        indptr, indices, tiles, shape = parts
        return J.BCSR(jnp.asarray(indptr), jnp.asarray(indices),
                      jnp.asarray(tiles), jnp.asarray(indices.shape[0],
                                                      jnp.int32), shape, blk)

    _, off, bts, table, _, icb = jops.bcsr_inspect(
        jb(a, block[:2]), jb(b, block[1:]), eager=True)
    return (a[0], a[1], b[0], b[1], np.asarray(off), np.asarray(bts),
            int(table), np.asarray(icb))


def pad(arrays):
    """Stack 1-D arrays, padding with zeros to the longest."""
    width = max(x.shape[0] for x in arrays)
    return np.stack([np.pad(x, (0, width - x.shape[0])) for x in arrays])


def fleet_args(members, n, layout, block):
    """``batched_row_classes``' arguments for ``n`` members, each member
    ``(indptr_a, a_bcol, indptr_b, b_bcol, offsets, bin_tsize,
    indptr_cb)``: ``shared`` uses member 0's arrays for all with A's tiles
    per member, ``stacked`` stacks every member's.  Tiles are one per
    member (A) or shared (B); only their shapes matter."""
    bm, bk, bn = block
    a_blk = torch.zeros((n, 1, bm, bk))
    b_blk = torch.zeros((1, bk, bn))
    if layout == "shared":
        ia, ac, ib, bc, off, bts, icb = members[0]
        idx = [t32(x) for x in (off, bts, ia, ib, icb, ac)] + [t32(bc)]
    else:
        cols = list(zip(*members[:n]))
        ia, ac, ib, bc, off, bts, icb = (
            np.stack(c) if i not in (1, 3) else pad(c)
            for i, c in enumerate(cols))
        idx = [t32(x) for x in (off, bts, ia, ib, icb, ac)] + [t32(bc)]
    off, bts, ia, ib, icb, ac, bc = idx
    return (off, bts, ia, ib, icb, ac, a_blk, bc, b_blk)


def check_items(args, n, table, block, vector):
    """``K.batched_row_classes`` (its plain version on the CPU) against
    each member's own ``ref.row_classes_plain`` and the numpy group and
    class of each item; returns ``{(member, row): (class, group)}``."""
    off, bts, ia, ib, icb, ac, a_blk, bc, b_blk = args
    grouped = all(t.dim() == 1 for t in (off, bts, ia, ib, icb, ac, bc))
    batched = (a_blk.dim() == 4, b_blk.dim() == 4)
    counts, items, unit_tsz = K.batched_row_classes(
        *args, n_members=n, table_size=table, vector=vector)
    m = ia.shape[-1] - 1
    assert unit_tsz.shape == (n, m)

    def member(t, e):
        return t if t.dim() == 1 else t[e]

    single = [ref.row_classes_plain(
        member(off, e), member(bts, e), member(ia, e), member(icb, e),
        table_size=table, vector=vector, block=block) for e in range(n)]
    want_cls = {}
    for e, (_, rows, tsz) in enumerate(single):
        assert torch.equal(unit_tsz[e], tsz), e
        for c, r in enumerate(rows):
            for i in r.tolist():
                want_cls[(e, i)] = (c, int(tsz[i]))
    seen = {}
    want_counts = np.zeros((len(ref.CLASS_NAMES), ref.LEN_BUCKETS), np.int64)
    for c, it in enumerate(items):
        it = it.numpy()
        buckets = []
        for first, members, i in it:
            ipc, ipa = member(icb, first).numpy(), member(ia, first).numpy()
            need = int(ipc[i + 1] - ipc[i])
            tsz = want_cls[(first, i)][1]
            g = group_of(n, tsz, need, block, batched) if grouped else 1
            assert members == min(g, n - first) and first % g == 0
            assert c == class_of(item_bytes(tsz, need, block, g, batched))
            b = bucket_of(int(ipa[i + 1] - ipa[i]))
            buckets.append(b)
            want_counts[c, b] += 1
            for e in range(first, first + members):
                assert (e, i) not in seen and (e, i) in want_cls
                seen[(e, i)] = (c, g)
        # longest A-block bucket first
        assert all(x >= y for x, y in zip(buckets, buckets[1:])), c
    assert set(seen) == set(want_cls)
    assert np.array_equal(counts.numpy(), want_counts)
    return seen


@pytest.mark.parametrize("n", (1, 3, 8))
@pytest.mark.parametrize("layout", ("shared", "stacked"))
@pytest.mark.parametrize("case", [("ER", 7), ("G500", 7), ("G500", 8)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_fleet_items_on_reference_plans(case, layout, n):
    """R-MAT block patterns under ``repro.core.plan_bcsr``: every listed
    (member, row) in exactly one item, with its member's table; a shared
    fleet's rows in groups of the rule's size, each item classed by its
    group's bytes; a stacked fleet's members (each its own seed's
    pattern and plan) classed alone."""
    preset, scale = case
    plans = [reference_plan(preset, scale, s) for s in
             range(n if layout == "stacked" else 1)]
    members = [(ia, ac, ia, ac, off, bts, icb)
               for ia, ac, off, bts, _, icb in plans]
    table = max(p[4] for p in plans)
    args = fleet_args(members, n, layout, (8, 8, 8))
    got = check_items(args, n, table, (8, 8, 8), False)
    groups = {g for _, g in got.values()}
    if layout == "shared" and n > 1:
        # most rows take min(n, 4) members an item (ER's every row; 8
        # members go in two items of 4)
        g = -(-n // -(-n // MAX_GROUP))
        assert max(groups) == g and (preset == "G500" or groups == {g})
    else:
        assert groups == {1}


@pytest.mark.parametrize("layout", ("shared", "stacked"))
@pytest.mark.parametrize("large", (False, True), ids=("8x8", "64x64"))
def test_ladder_members_reach_every_class(large, layout):
    """Three members of ``_bcsr_ladder``'s rungs (stacked: each its own
    seed's columns and plan): stacked, each member's rungs land in the
    classes ``_bcsr_ladder`` names; shared, a rung that fits two members
    takes up to three in one item, in a class as large or larger, and
    the rungs that stay alone keep their classes.  Every item's class is
    one the kernel launches for the fleet."""
    block = (64, 64, 64) if large else (8, 8, 8)
    want = LADDER_LARGE_CLASSES if large else LADDER_CLASSES
    n = 3
    plans = [ladder_plan(large, s) for s in range(n)]
    members = [(ia, ac, ib, bc, off, bts, icb)
               for ia, ac, ib, bc, off, bts, _, icb in plans]
    table = max(p[6] for p in plans)
    args = fleet_args(members, n, layout, block)
    got = check_items(args, n, table, block, False)
    bcap_c = max(int(p[7][-1]) for p in plans)
    launched = ref.launch_classes(block, table, bcap_c,
                                  n if layout == "shared" else 1,
                                  (True, False))
    assert {c for c, _ in got.values()} <= set(launched)
    for e in range(n):
        for i, c in enumerate(want):
            if c < 0:
                assert (e, i) not in got
                continue
            gc, g = got[(e, i)]
            if layout == "stacked" or g == 1:
                assert gc == c, (e, i)
            else:
                assert gc >= c and 2 <= g <= n, (e, i)
    if layout == "stacked":
        assert {c for c, _ in got.values()} == {c for c in want if c >= 0}


@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", [("ER", 7), ("G500", 8), ("ladder", 8),
                                  ("ladder", 64)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_one_member_equals_single_product(case, vector):
    """A fleet of one member is the single product: its items are the
    rows ``ref.row_classes_plain`` lists, class by class in the same
    order, each alone, with the same tables and counts."""
    name, size = case
    if name == "ladder":
        ia, ac, ib, bc, off, bts, table, icb = ladder_plan(size == 64, 0)
        block = (size, size, size)
    else:
        ia, ac, off, bts, table, icb = reference_plan(name, size, 0)
        ib, bc, block = ia, ac, (8, 8, 8)
    args = fleet_args([(ia, ac, ib, bc, off, bts, icb)], 1, "shared", block)
    counts, items, unit_tsz = K.batched_row_classes(
        *args, n_members=1, table_size=table, vector=vector)
    s_counts, rows, row_tsz = ref.row_classes_plain(
        t32(off), t32(bts), t32(ia), t32(icb), table_size=table,
        vector=vector, block=block)
    assert torch.equal(counts, s_counts)
    assert torch.equal(unit_tsz[0], row_tsz)
    for it, r in zip(items, rows):
        assert torch.equal(it[:, 2], r.long())
        assert not it[:, 0].any() and bool((it[:, 1] == 1).all())


@pytest.mark.parametrize("batched", [(True, False), (False, True),
                                     (True, True)], ids=("a", "b", "both"))
@pytest.mark.parametrize("n", (2, 3, 8))
@pytest.mark.parametrize("block", [(8, 8, 8), (64, 64, 64), (2, 3, 4)],
                         ids=lambda b: "x".join(map(str, b)))
def test_fleet_launch_classes_hold_every_item(block, n, batched):
    """The classes launched for a fleet that shares its index arrays hold
    the item of every output count and table a row can have, and run
    largest first without a gap."""
    for table, bcap_c in ((8, 100), (256, 5000), (2048, 10 ** 6)):
        launched = ref.launch_classes(block, table, bcap_c, n, batched)
        assert launched == tuple(range(launched[0], launched[-1] - 1, -1))
        for need in range(1, min(table, bcap_c) + 1, 5):
            p = 8
            while p < 2 * need:
                p *= 2
            top = min(table, p)
            tsz = 1
            while tsz < need:
                tsz *= 2
            while tsz <= top:
                g = group_of(n, tsz, need, block, batched)
                assert class_of(item_bytes(tsz, need, block, g,
                                           batched)) in launched
                tsz *= 2


def test_bins_past_the_rows_list_no_row():
    """A member whose bins run past its rows lists none of them (the
    kernels count an error and run none of its rows); the other members
    of a stacked fleet are listed as alone."""
    indptr_c = [0, 3, 12, 32]
    indptr_a = [0, 1, 2, 3]
    good, past = [0, 1, 3], [0, 1, 4]
    off = t32([good, past])
    bts = t32([[8, 32], [8, 32]])
    ipa = t32([indptr_a] * 2)
    ipc = t32([indptr_c] * 2)
    cols = t32([[0, 0, 0]] * 2)
    args = (off, bts, ipa, ipa, ipc, cols, torch.zeros(2, 1, 8, 8), cols,
            torch.zeros(1, 8, 8))
    _, items, _ = K.batched_row_classes(*args, n_members=2, table_size=64,
                                        vector=False)
    listed = {(int(f), int(i)) for it in items for f, _, i in it}
    assert listed == {(0, 0), (0, 1), (0, 2)}
    _, rows, tsz = ref.row_classes_plain(t32(past), t32([8, 32]),
                                         t32(indptr_a), t32(indptr_c),
                                         table_size=64, vector=False,
                                         block=(8, 8, 8))
    assert sum(r.numel() for r in rows) == 0 and not tsz.any()


def test_fleet_classes_on_cpu_count_plain_runs():
    ia, ac, off, bts, table, icb = reference_plan("ER", 7, 0)
    args = fleet_args([(ia, ac, ia, ac, off, bts, icb)], 2, "shared",
                      (8, 8, 8))
    K.CLASS_CALLS.update(dict.fromkeys(K.CLASS_CALLS, 0))
    K.batched_row_classes(*args, n_members=2, table_size=table,
                          vector=False)
    assert K.CLASS_CALLS == dict(dict.fromkeys(K.CLASS_CALLS, 0), plain=1)
