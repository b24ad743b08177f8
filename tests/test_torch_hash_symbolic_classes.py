"""The hash symbolic phase's row classes (plain version,
``ref.batched_row_classes_plain(numeric=False)``; ``kernel.
batched_row_classes`` on the CPU) against the reference's plans, with the
bitmap class.

The symbolic phase sizes each row's table from its product count (flop),
at most its bin's table in the reference plan, and runs rows by table
class, the single product as the fleet of one member.  It always takes
B's width (``n_cols``).  Where B's bitmap fits one block
(``ref.BITMAP_COLS`` columns), every row whose table passes
``ref.bitmap_above(n_cols)`` slots (``ref.BITMAP_ABOVE``, or the bitmap's
words where those are more) goes to one more class, ``bitmap``
(``kernel.BITMAP_CLASS``), which counts the row's columns in a bitmap; a
B wider than that (``WIDE``) leaves those rows on the larger table
classes, clusters and device memory among them.  The schedules and flop
come from ``repro``'s ``plan_spgemm`` on R-MAT inputs at scales 8-10 (and
G500 at 12, whose 4,096 columns give tables past the bitmap's threshold),
from the ``_hash_ladder`` rungs and from the saturation rows.  On a card,
``test_torch_cuda.py`` holds the classifying kernel and the class
launches against these plain versions.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from repro.core import CSR as JCSR, plan_spgemm as jplan  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_hash import ops as jops  # noqa: E402
from repro_torch.core import CSR as TCSR  # noqa: E402
from repro_torch.core.formats import prefix_sum  # noqa: E402
from repro_torch.kernels.spgemm_hash import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_hash import ref  # noqa: E402
from _hash_ladder import (FLEET_LADDER,  # noqa: E402
                          FLEET_LADDER_SYMBOLIC_CLASSES, LADDER_TABLE,
                          N_COLS, ladder, saturated_row)

CASES = [(p, s) for p in ("ER", "G500") for s in (8, 9, 10)] + \
    [("G500", 12)]
#: a B too wide for one block's bitmap: its symbolic rows keep the table
#: classes
WIDE = ref.BITMAP_COLS + 1


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


def to_port(a, n_cols=None):
    """``a`` in the port, on the CPU; ``n_cols`` widens it (the same
    entries, more columns)."""
    shape = a.shape if n_cols is None else (a.shape[0], n_cols)
    return TCSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                           np.asarray(a.data), int(a.nnz), shape,
                           a.sorted_cols, device="cpu")


def bin_caps(offsets, bin_tsize, table_size, m):
    """Each row's table in the plan (0 outside every bin), numpy."""
    off = np.asarray(offsets)
    b = np.searchsorted(off, np.arange(m), side="right") - 1
    inside = (b >= 0) & (b < off.shape[0] - 1)
    cap = np.minimum(np.asarray(bin_tsize, np.int64), table_size)[
        np.where(inside, b, 0)]
    return np.where(inside, cap, 0)


def symbolic_classes(offsets, bin_tsize, a, b, table_size, flop, n=1):
    """Every property of the symbolic (member, row) tables and classes of
    ``n`` members sharing ``a @ b``'s structure, with B's width: returns
    the plain classifier's ``(counts, pairs, row_tsz)`` and member 0's
    class per row (-1: none)."""
    n_cols = b.n_cols
    counts, pairs, row_tsz = K.batched_row_classes(
        t32(offsets), t32(bin_tsize), a.indptr, b.indptr, None, a.indices,
        n_members=n, table_size=table_size, numeric=False, n_cols=n_cols)
    m = a.n_rows
    flop = np.asarray(flop, np.int64)
    above = ref.bitmap_above(n_cols)
    assert len(pairs) == len(counts) == (8 if above else 7)
    assert counts.tolist() == [p.shape[0] for p in pairs]
    tsz = row_tsz.numpy().astype(np.int64)
    assert tsz.shape == (n, m)
    # the table from the row's flop, at most its bin's: the least power of
    # two past 2 * flop and CHUNK, cut at the bin's table
    cap = bin_caps(offsets, bin_tsize, table_size, m)
    full = (flop > 0) & (cap > 0)
    least = 1 << np.ceil(np.log2(np.maximum(2 * flop, K.CHUNK))).astype(
        np.int64)
    want = np.where(full, np.minimum(least, cap), 0)
    assert all(np.array_equal(tsz[e], want) for e in range(n))
    got = np.full((n, m), -1)
    for c, p in enumerate(pairs):
        e, r = p[:, 0].numpy(), p[:, 1].numpy()
        assert np.all(got[e, r] == -1)      # one class a pair
        got[e, r] = c
    assert np.array_equal(got >= 0, np.broadcast_to(full, (n, m)))
    # each table class holds the tables between its bounds; the bitmap
    # class every table past ``above``, and then no table class does
    lo = (0,) + ref.CLASS_SLOTS
    hi = ref.CLASS_SLOTS + (np.iinfo(np.int64).max,)
    for c in range(7):
        rt = tsz[got == c]
        assert np.all((rt > lo[c]) & (rt <= hi[c]))
    if above:
        assert np.array_equal(got == K.BITMAP_CLASS,
                              np.broadcast_to(full & (want > above), (n, m)))
    return counts, pairs, row_tsz, got[0]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_symbolic_classes_on_reference_plan(case):
    """The symbolic tables are the reference flop's, cut at the plan's bin
    tables; the rows past ``ref.bitmap_above`` of B's width are the bitmap
    class's, and with the same entries in a B too wide for the bitmap they
    keep the table classes, every table the same.  G500 s12 puts rows on
    the bitmap class."""
    preset, scale = case
    a = jrmat.rmat_csr(scale, 16, preset, seed=2)
    plan = jplan(a, a, algorithm="hash", cache=False)
    off, bts, table = jops.hash_schedule(a, a, n_bins=plan.n_bins)
    assert np.array_equal(np.asarray(off), np.asarray(plan.offsets))
    ta = to_port(a)
    flop = np.asarray(plan.flop, np.int64)
    with_w = symbolic_classes(plan.offsets, plan.bin_tsize, ta, ta,
                              plan.table_size, flop)
    wide = symbolic_classes(plan.offsets, plan.bin_tsize, ta,
                            to_port(a, WIDE), plan.table_size, flop)
    assert torch.equal(with_w[2], wide[2])
    moved = with_w[3] == K.BITMAP_CLASS
    assert np.array_equal(with_w[3][~moved], wide[3][~moved])
    assert np.all(wide[3][moved] >= 2)
    # every listed row holds its output: the symbolic count never passes
    # the table it was sized for
    nnz = np.asarray(plan.row_nnz_c, np.int64)
    tsz = with_w[2][0].numpy()
    assert np.all(tsz[flop > 0] > nnz[flop > 0])
    assert moved.any() == (case == ("G500", 12))


@pytest.mark.parametrize("n_cols", (None, WIDE), ids=("B", "wide"))
def test_members_share_the_single_products_classes(n_cols):
    """A value fleet of three members on one structure: each member's
    rows get the single product's tables and classes, bitmap included
    (G500 s12 with its own width), and with a B too wide for the
    bitmap."""
    a = jrmat.rmat_csr(12, 16, "G500", seed=4)
    plan = jplan(a, a, algorithm="hash", cache=False)
    args = (plan.offsets, plan.bin_tsize, to_port(a), to_port(a, n_cols),
            plan.table_size, np.asarray(plan.flop, np.int64))
    one = symbolic_classes(*args)
    three = symbolic_classes(*args, n=3)
    assert torch.equal(three[0], 3 * one[0])
    assert all(torch.equal(three[2][e], one[2][0]) for e in range(3))
    assert (int(one[0][-1]) > 0) == (n_cols is None)


def ladder_classes(rungs, n_cols=None, forced=True):
    """Member 0's symbolic class per rung of a ``_hash_ladder`` product,
    under one bin of LADDER_TABLE slots (or the reference's own
    schedule); ``n_cols`` widens B past its ``N_COLS``."""
    (ar, ac, av, ash), (br, bc, bv, bsh) = ladder(True, 0, rungs)
    a, b = JCSR.from_numpy_coo(ar, ac, av, ash), \
        JCSR.from_numpy_coo(br, bc, bv, bsh)
    if forced:
        off, bts, table = [0, len(rungs)], [LADDER_TABLE], LADDER_TABLE
    else:
        off, bts, table = jops.hash_schedule(a, b, n_bins=8)
    flop = np.asarray(jsched.flops_per_row(a, b), np.int64)
    return symbolic_classes(off, bts, to_port(a), to_port(b, n_cols), table,
                            flop)


def test_ladder_reaches_every_symbolic_class():
    """The fleet ladder's rungs under one bin: with B's 131,072 columns (a
    16 KB bitmap) the rows whose table passes 4,096 slots are the bitmap
    class's; with the same entries in a B too wide for the bitmap they
    reach the 16,384-slot class, clusters of 2, 4 and 8 and the
    device-memory table.  The two widths together reach every class."""
    want = list(FLEET_LADDER_SYMBOLIC_CLASSES)
    _, _, _, no_w = ladder_classes(FLEET_LADDER, WIDE)
    assert no_w.tolist() == want
    counts, _, tsz, with_w = ladder_classes(FLEET_LADDER)
    above = ref.bitmap_above(N_COLS)
    assert above == 4096
    moved = [t > above for t in tsz[0].tolist()]
    assert with_w.tolist() == [K.BITMAP_CLASS if mv else c
                               for c, mv in zip(want, moved)]
    assert set(no_w.tolist()) | set(with_w.tolist()) == \
        {-1} | set(range(len(K.SYMBOLIC_CLASS_NAMES)))
    assert int(counts[K.BITMAP_CLASS]) == sum(moved) > 0
    # under the reference's own schedule the ladder's rows past one
    # block's table still find the bitmap
    _, _, _, natural = ladder_classes(FLEET_LADDER, forced=False)
    assert max(natural) == K.BITMAP_CLASS
    assert natural.tolist()[:4] == want[:4]


def test_bitmap_width_limit():
    """The bitmap class exists up to ``ref.BITMAP_COLS`` columns (200 KB
    of bits), not past it, and takes only rows whose table holds at least
    as many slots as the bitmap has words."""
    assert ref.BITMAP_ABOVE == 4096
    assert ref.bitmap_above(0) == ref.bitmap_above(1) == 4096
    # G500 s16's width: 2,048 words
    assert ref.bitmap_above(1 << 16) == 4096
    assert ref.bitmap_above(N_COLS) == 4096
    # 51,200 words: tables past 32,768 slots (65,536 and up)
    assert ref.bitmap_above(ref.BITMAP_COLS) == 32768
    assert ref.bitmap_above(WIDE) == 0
    assert ref.BITMAP_COLS == 200 * 1024 * 8
    with pytest.raises(ValueError):
        ref.bitmap_above(-1)
    for n_cols, bitmap in ((ref.BITMAP_COLS, True), (WIDE, False)):
        _, _, _, got = ladder_classes(FLEET_LADDER, n_cols)
        assert (K.BITMAP_CLASS in got.tolist()) == bitmap


def test_symbolic_phase_needs_b_width():
    """B's width decides the bitmap class, so the symbolic wrappers and
    classifiers refuse to run without it; the numeric classifier takes
    none."""
    a = to_port(jrmat.rmat_csr(8, 8, "G500", seed=1))
    off, bts, table = tops.hash_schedule(a, a, n_bins=4)
    args = (off, bts, a.indptr, a.indptr, a.indices, a.data, a.indices,
            a.data)
    kw = dict(table_size=table, vector=False)
    with pytest.raises(TypeError, match="n_cols"):
        K.symbolic_call(*args, **kw)
    with pytest.raises(TypeError, match="n_cols"):
        K.batched_symbolic_call(*args, n_members=1, **kw)
    cls_args = (off, bts, a.indptr, a.indptr, None, a.indices)
    for fn in (K.batched_row_classes, ref.batched_row_classes_plain):
        with pytest.raises(TypeError, match="n_cols"):
            fn(*cls_args, n_members=1, table_size=table, numeric=False)
    ic = prefix_sum(K.symbolic_call(*args, **kw, n_cols=a.n_cols))
    counts, _, _ = K.batched_row_classes(*cls_args[:4], ic.to(torch.int32),
                                         a.indices, n_members=1,
                                         table_size=table)
    assert counts.shape == (len(K.CLASS_NAMES),)


def test_launch_classes_with_the_bitmap():
    """With a bitmap, the symbolic phase launches the table classes up to
    the bitmap's threshold, then the bitmap class if the largest table
    passes it, and never a cluster or the device-memory table."""
    S, C, B = K.SMEM_SLOTS, K.CLUSTER_SLOTS, K.BITMAP_CLASS
    assert K.launch_classes(0, S) == ()
    assert K.launch_classes(1024, S) == (0,)
    assert K.launch_classes(S, S) == (0, 1, 2)
    assert K.launch_classes(S + 1, S) == (0, 1, 2, B)
    assert K.launch_classes(2 * C, S) == (0, 1, 2, B)
    assert K.launch_classes(2 * C, 4096) == (0, 1, B)
    assert K.launch_classes(4096, 4096) == (0, 1)
    assert K.launch_classes(2 * C) == tuple(range(7))
    assert K.SYMBOLIC_CLASS_NAMES[B] == "bitmap"
    assert K.COUNT_INTS == 2 * len(K.SYMBOLIC_CLASS_NAMES)


@pytest.mark.parametrize("d", (2 * K.SMEM_SLOTS, 2 * K.SMEM_SLOTS + 1),
                         ids=("load-factor-1", "one-past-fill"))
def test_saturated_bitmap_row_keeps_its_table(d):
    """A row of d distinct columns (d products) under a plan table of
    32,768 slots: its symbolic table is the whole 32,768-slot table, a
    bitmap row with B's width and a cluster of two in a B too wide for
    the bitmap.  At d =
    32,768 the count fills it exactly; one more column passes it, which
    the card counts as an error in either class."""
    t = 2 * K.SMEM_SLOTS
    (ar, ac, av, ash), (br, bc, bv, bsh) = saturated_row(d)
    a = TCSR.from_numpy_coo(ar, ac, av, ash, device="cpu")
    for n_cols, cls in ((N_COLS, K.BITMAP_CLASS), (WIDE, 3)):
        b = TCSR.from_numpy_coo(br, bc, bv, (bsh[0], n_cols), device="cpu")
        _, _, row_tsz, got = symbolic_classes([0, 1], [t], a, b, t, [d])
        assert row_tsz.tolist() == [[t]] and got.tolist() == [cls]
    rows = K.symbolic_call(t32([0, 1]), t32([t]), a.indptr, b.indptr,
                           a.indices, a.data, b.indices, b.data,
                           table_size=t, vector=False, n_cols=N_COLS)
    assert rows.tolist() == [d]
    assert (d > t) == (int(rows[0]) > int(row_tsz[0, 0]))


def test_small_saturation_rows_stay_off_the_bitmap():
    """The load-factor-1 and one-past-fill tables of ``test_hash_
    saturation.py``'s pair (CHUNK and 2 * CHUNK slots) never reach the
    bitmap class: tables that small stay in the first one."""
    for d, forced in ((K.CHUNK, True), (K.CHUNK + 1, False)):
        a = JCSR.from_numpy_coo([0, 1, 1], [0, 0, 1],
                                np.array([1.0, 1.0, 0.5], np.float32), (2, 2))
        rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
        cols = np.concatenate([np.arange(d), np.arange(d)])
        b = JCSR.from_numpy_coo(rows, cols, np.ones(2 * d, np.float32),
                                (2, d))
        if forced:
            off, bts, table = [0, 2], [d], d
        else:
            off, bts, table = jops.hash_schedule(a, b, n_bins=1)
        flop = np.asarray(jsched.flops_per_row(a, b), np.int64)
        _, _, row_tsz, got = symbolic_classes(off, bts, to_port(a),
                                              to_port(b), table, flop)
        want = d if forced else 2 * K.CHUNK
        assert row_tsz.tolist() == [[want, want]]
        assert got.tolist() == [0, 0]


def test_symbolic_op_takes_b_width():
    """The custom op carries B's width, an argument without a default, to
    the wrapper; on the CPU it gives the plain version's counts, and the
    front door passes B's width itself."""
    schema = str(torch.ops.repro_torch.spgemm_hash_symbolic.default._schema)
    assert "n_cols) ->" in schema and "n_cols=" not in schema
    a = to_port(jrmat.rmat_csr(8, 8, "G500", seed=1))
    off, bts, table = tops.hash_schedule(a, a, n_bins=4)
    args = (off, bts, a.indptr, a.indptr, a.indices, a.data, a.indices,
            a.data)
    want = ref.symbolic_plain(*args, table_size=table, vector=False)
    with pytest.raises(RuntimeError, match="n_cols"):
        tops.symbolic_op(*args, table, False)
    assert torch.equal(tops.symbolic_op(*args, table, False, a.n_cols), want)
    assert torch.equal(tops.spgemm_hash_symbolic(a, a, n_bins=4), want)
