"""The hash kernels' per-row tables and the numeric kernel's row classes
(plain versions, ``repro_torch/kernels/spgemm_hash/ref.py``) against the
reference's schedule.

Each row probes a table sized from its own output count (numeric) or
product count (symbolic), at most its bin's table in the reference plan;
the single-product numeric kernel runs rows grouped by table class.  The
schedule (``offsets``, ``bin_tsize``, ``table_size``) and ``indptr_c`` /
``flop`` come from ``repro``'s ``plan_spgemm`` and ``hash_schedule`` on
R-MAT inputs at scales 8-10, and from the saturation pairs of
``test_hash_saturation.py``.  On a card, ``test_torch_cuda.py`` holds the
classifying kernel against these plain versions.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from repro.core import CSR as JCSR, plan_spgemm as jplan  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_hash import ops as jops  # noqa: E402
from repro_torch.core import CSR as TCSR  # noqa: E402
from repro_torch.kernels.spgemm_hash import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_hash import ref  # noqa: E402
from _fuzz import VALS  # noqa: E402
from _hash_ladder import (LADDER, LADDER_CLASSES,  # noqa: E402
                          LADDER_TABLE, ladder)

CASES = [(p, s) for p in ("ER", "G500") for s in (8, 9, 10)]


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


def bin_of_rows(offsets, m):
    """Each row's bin in the reference schedule (-1 outside every bin)."""
    off = np.asarray(offsets)
    b = np.searchsorted(off, np.arange(m), side="right") - 1
    b[(b < 0) | (b >= off.shape[0] - 1)] = -1
    return b


def check_classes(offsets, bin_tsize, table_size, indptr_c):
    """Every property of the numeric rows' tables and classes; returns
    ``(counts, rows, row_tsz)``."""
    indptr_c = np.asarray(indptr_c)
    m = indptr_c.shape[0] - 1
    nnz = np.diff(np.asarray(indptr_c, np.int64))
    cap = np.minimum(np.asarray(bin_tsize, np.int64), table_size)[
        bin_of_rows(offsets, m)]
    counts, rows, row_tsz = K.row_classes(
        t32(offsets), t32(bin_tsize), t32(np.zeros(m + 1)),
        t32(np.zeros(1)), t32(indptr_c), t32(np.zeros(0)),
        table_size=table_size)
    tsz = row_tsz.numpy().astype(np.int64)
    assert counts.tolist() == [r.shape[0] for r in rows]
    # every row with output in exactly one class, empty rows in none
    listed = np.concatenate([r.numpy() for r in rows])
    assert np.array_equal(np.sort(listed), np.flatnonzero(nnz > 0))
    assert np.all(tsz[nnz == 0] == 0)
    full = nnz > 0
    # a power of two, at least nnz_i, at most the bin's reference table,
    # and at least CHUNK (the vector probe's chunk) where the bin allows
    t = tsz[full]
    assert np.all(t & (t - 1) == 0)
    assert np.all(t >= nnz[full]) and np.all(t <= cap[full])
    assert np.all(t >= np.minimum(K.CHUNK, cap[full]))
    assert np.all((t == cap[full]) | (t >= 2 * nnz[full]))
    # each class holds the tables between its bounds
    lo = (0,) + ref.CLASS_SLOTS
    hi = ref.CLASS_SLOTS + (np.iinfo(np.int64).max,)
    for c, r in enumerate(rows):
        rt = tsz[r.numpy()]
        assert np.all((rt > lo[c]) & (rt <= hi[c]))
    return counts, rows, row_tsz


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_row_tables_and_classes_on_reference_plan(case):
    preset, scale = case
    a = jrmat.rmat_csr(scale, 16, preset, seed=2)
    plan = jplan(a, a, algorithm="hash", cache=False)
    off, tsz, table = jops.hash_schedule(a, a, n_bins=plan.n_bins)
    assert np.array_equal(np.asarray(off), np.asarray(plan.offsets))
    assert np.array_equal(np.asarray(tsz), np.asarray(plan.bin_tsize))
    assert np.asarray(plan.bin_tsize).min() >= K.CHUNK
    counts, _, _ = check_classes(plan.offsets, plan.bin_tsize,
                                 plan.table_size, plan.indptr_c)
    assert int(counts.sum()) == int(np.count_nonzero(
        np.asarray(plan.row_nnz_c)))
    # symbolic: the table sized from the row's flop holds its output
    flop = torch.from_numpy(np.asarray(plan.flop, np.int64))
    sym = ref.row_table_sizes_plain(t32(plan.offsets), t32(plan.bin_tsize),
                                    flop, table_size=plan.table_size)
    sym = sym.numpy().astype(np.int64)
    nnz = np.asarray(plan.row_nnz_c, np.int64)
    cap = np.minimum(np.asarray(plan.bin_tsize, np.int64), plan.table_size)[
        bin_of_rows(plan.offsets, nnz.shape[0])]
    f = flop.numpy()
    assert np.all(sym[f == 0] == 0)
    assert np.all(sym >= np.minimum(f, cap)) and np.all(sym <= cap)
    assert np.all(sym[f > 0] > nnz[f > 0]) and np.all(sym & (sym - 1) == 0)


def _saturation_pair(d):
    """``test_hash_saturation.py``'s pair: C row 0 has exactly ``d``
    distinct columns, row 1 the same ``d`` with flop ``2d``."""
    a = JCSR.from_numpy_coo([0, 1, 1], [0, 0, 1],
                            np.array([1.0, 1.0, 0.5], np.float32), (2, 2))
    rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
    cols = np.concatenate([np.arange(d), np.arange(d)])
    b = JCSR.from_numpy_coo(rows, cols, VALS[np.arange(2 * d) % len(VALS)],
                            (2, d))
    return a, b


def test_load_factor_one_stays_full():
    """A forced table of d = CHUNK slots for d distinct columns: each row
    keeps the whole table (load factor exactly 1)."""
    d = K.CHUNK
    indptr_c = np.array([0, d, 2 * d])
    _, rows, row_tsz = check_classes([0, 2], [d], d, indptr_c)
    assert row_tsz.tolist() == [d, d]
    assert rows[0].tolist() == [0, 1]


def test_one_past_fill_keeps_the_doubled_table():
    d = K.CHUNK + 1
    a, b = _saturation_pair(d)
    off, tsz, table = jops.hash_schedule(a, b, n_bins=1)
    assert table == 2 * K.CHUNK
    _, _, row_tsz = check_classes(off, tsz, table, [0, d, 2 * d])
    assert row_tsz.tolist() == [2 * K.CHUNK] * 2
    # the reference's own table for these rows, as the port sizes it
    t_off, t_tsz, t_table = tops.hash_schedule(
        TCSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                        np.asarray(a.data), int(a.nnz), a.shape,
                        device="cpu"),
        TCSR.from_numpy(np.asarray(b.indptr), np.asarray(b.indices),
                        np.asarray(b.data), int(b.nnz), b.shape,
                        device="cpu"), n_bins=1)
    assert t_tsz.tolist() == np.asarray(tsz).tolist() and t_table == table


@pytest.mark.parametrize("forced", (True, False), ids=("one-bin", "natural"))
def test_ladder_reaches_every_class(forced):
    """The rows of ``_hash_ladder`` under one bin of LADDER_TABLE slots land
    in every class, one rung each past the first; under the reference's own
    schedule no table passes the largest cluster."""
    (ar, ac, av, ash), (br, bc, bv, bsh) = ladder(dyadic=True)
    a = JCSR.from_numpy_coo(ar, ac, av, ash)
    b = JCSR.from_numpy_coo(br, bc, bv, bsh)
    indptr_c = np.concatenate([[0], np.cumsum(LADDER)])
    if forced:
        off, tsz, table = [0, len(LADDER)], [LADDER_TABLE], LADDER_TABLE
    else:
        off, tsz, table = jops.hash_schedule(a, b, n_bins=8)
    counts, rows, _ = check_classes(off, tsz, table, indptr_c)
    got = [-1] * len(LADDER)
    for c, r in enumerate(rows):
        for i in r.tolist():
            got[i] = c
    if forced:
        assert got == list(LADDER_CLASSES)
    else:
        assert max(got) < len(ref.CLASS_SLOTS)
        assert got[:5] == list(LADDER_CLASSES[:5])


def test_row_classes_on_cpu_count_plain_runs():
    K.CLASS_CALLS.update(dict.fromkeys(K.CLASS_CALLS, 0))
    check_classes([0, 2], [16], 16, np.array([0, 3, 9]))
    assert K.CLASS_CALLS == dict(dict.fromkeys(K.CLASS_CALLS, 0), plain=1)
