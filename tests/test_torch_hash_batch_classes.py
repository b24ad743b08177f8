"""The batched hash kernels' row classes (plain version,
``ref.batched_row_classes_plain``; ``kernel.batched_row_classes`` on the
CPU) against the reference's schedules.

Both phases of a fleet run every member's rows by table class: each
(member, row) pair probes a table sized from its own need -- its output
count (numeric) or product count (symbolic) -- at most its bin's table,
and one launch per class that the fleet's largest table allows runs every
member's rows of that class.  The schedules come from ``repro``'s own
batch plan (``plan_batch``, stacked per class) and ``hash_schedule`` on
R-MAT fleets at scales 8-10, stacked or shared by every member, from
stacked ``_hash_ladder`` members and from the saturation pairs.  On a
card, ``test_torch_cuda.py`` holds the classifying kernel against these
plain versions.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import repro.core as J  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_hash import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.batch as tbatch  # noqa: E402
from repro_torch.kernels.spgemm_hash import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_hash import ref  # noqa: E402
from _fuzz import VALS  # noqa: E402
from _hash_ladder import (FLEET_LADDER, FLEET_LADDER_CLASSES,  # noqa
                          FLEET_LADDER_SYMBOLIC_CLASSES, LADDER_TABLE,
                          ladder)

SCALES = (8, 9, 10)
#: B's width given to the symbolic classes: too wide for one block's
#: bitmap, so that they are the table classes alone
#: (``test_torch_hash_symbolic_classes.py`` holds the bitmap class)
WIDE = ref.BITMAP_COLS + 1


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def rmat_fleet(n_products, scale, seed0=0):
    """``benchmarks.common.rmat_fleet``: mixed G500/ER A's, ER B's."""
    return [(jrmat.rmat_csr(scale, 1 + (i % 3), "G500" if i % 2 else "ER",
                            seed=seed0 + i),
             jrmat.rmat_csr(scale, 1 + ((i + 1) % 4), "ER",
                            seed=seed0 + 100 + i))
            for i in range(n_products)]


def bin_caps(offsets, bin_tsize, table_size, m):
    """Each row's table in the plan (0 outside every bin), numpy."""
    off = np.asarray(offsets)
    b = np.searchsorted(off, np.arange(m), side="right") - 1
    inside = (b >= 0) & (b < off.shape[0] - 1)
    cap = np.minimum(np.asarray(bin_tsize, np.int64), table_size)[
        np.where(inside, b, 0)]
    return np.where(inside, cap, 0)


def member(x, e):
    x = np.asarray(x)
    return x[e] if x.ndim == 2 else x


def check_fleet(offsets, bin_tsize, indptr_a, indptr_b, indptr_c, a_idx,
                n, table_size, needs, numeric):
    """Every property of one phase's (member, row) tables and classes;
    ``needs[e]`` member e's need per row.  Returns ``(counts, pairs,
    row_tsz)`` of the plain classifier."""
    counts, pairs, row_tsz = K.batched_row_classes(
        offsets, bin_tsize, indptr_a, indptr_b,
        indptr_c if numeric else None, a_idx, n_members=n,
        table_size=table_size, numeric=numeric, n_cols=WIDE)
    tsz = row_tsz.numpy().astype(np.int64)
    m = tsz.shape[1]
    assert tsz.shape == (n, m)
    assert counts.tolist() == [p.shape[0] for p in pairs]
    # every pair with a need and a bin listed once, the others in none
    listed = np.concatenate([p.numpy() for p in pairs])
    assert len({tuple(x) for x in listed.tolist()}) == listed.shape[0]
    want = []
    lo = (0,) + ref.CLASS_SLOTS
    hi = ref.CLASS_SLOTS + (np.iinfo(np.int64).max,)
    for e in range(n):
        need = np.asarray(needs[e], np.int64)[:m]
        cap = bin_caps(member(offsets, e), member(bin_tsize, e), table_size,
                       m)
        full = (need > 0) & (cap > 0)
        want += [(e, i) for i in np.flatnonzero(full)]
        t = tsz[e]
        assert np.all(t[~full] == 0)
        t, need, cap = t[full], need[full], cap[full]
        # a power of two, at most the bin's table, and at least twice the
        # need unless the need reaches half the bin's table: the least
        # power of two past both 2 * need and CHUNK, cut at the bin's
        assert np.all(t & (t - 1) == 0) and np.all(t <= cap)
        assert np.all((t == cap) | (t >= 2 * need))
        assert np.all(t[2 * need >= cap] == cap[2 * need >= cap])
        least = 1 << np.ceil(np.log2(np.maximum(2 * need, K.CHUNK))).astype(
            np.int64)
        assert np.array_equal(t, np.minimum(least, cap))
    assert sorted(map(tuple, listed.tolist())) == want
    for c, p in enumerate(pairs):
        rt = tsz[p[:, 0].numpy(), p[:, 1].numpy()]
        assert np.all((rt > lo[c]) & (rt <= hi[c]))
    return counts, pairs, row_tsz


def max_class(pairs):
    return max((c for c, p in enumerate(pairs) if p.shape[0]), default=-1)


@pytest.mark.parametrize("scale", SCALES)
def test_classes_on_reference_batch_plan(scale):
    """Each hash class of the reference's batch plan over ``rmat_fleet``:
    both phases' classes on its stacked schedules, the symbolic need equal
    to the reference's flop per row, and the table classes that the
    port's plan launches (from its host lists) reaching the largest class
    the plain lists reach."""
    pairs = rmat_fleet(6, scale, seed0=10 * scale)
    jp = J.plan_batch(pairs, algorithm="hash", cache=False)
    tpairs = [(to_port(a), to_port(b)) for a, b in pairs]
    tp = T.plan_batch(tpairs, algorithm="hash", cache=False)
    for jc, tc in zip(jp.classes, tp.classes):
        off, bts, ic = (t32(x) for x in jc.hash_sched)
        assert all(torch.equal(x, y) for x, y in zip((off, bts, ic),
                                                     tc.hash_sched))
        M, Kc = tc.shape_a
        a_ops = [tpairs[i][0] for i in tc.members]
        b_ops = [tpairs[i][1] for i in tc.members]
        a_st = tbatch._stack_csr(a_ops, Kc, True,
                                 tbatch._stack_index(a_ops, M, tc.cap_a))
        b_st = tbatch._stack_csr(b_ops, tc.shape_b[1], True,
                                 tbatch._stack_index(b_ops, Kc, tc.cap_b))
        n = tc.n_members
        flops = []
        for e, i in enumerate(tc.members):
            a, b = pairs[i]
            f = np.asarray(jsched.flops_per_row(a, b), np.int64)
            got = ref.row_flop_plain(a_st.indptr[e], b_st.indptr[e],
                                     a_st.indices[e]).numpy()
            assert np.array_equal(got[:a.n_rows], f)
            assert np.all(got[a.n_rows:] == 0)
            flops.append(got)
        nnz = (ic[:, 1:] - ic[:, :-1]).numpy()
        args = (off, bts, a_st.indptr, b_st.indptr, ic, a_st.indices)
        _, num, _ = check_fleet(*args, n, tc.table_size, nnz, True)
        _, sym, _ = check_fleet(*args, n, tc.table_size, flops, False)
        classes = K.launch_classes(tc.hash_largest)
        assert tc.hash_largest == K.fleet_table(*tc.hash_host,
                                                tc.table_size, M, False)
        assert classes == tuple(range(max_class(sym) + 1))
        assert max_class(num) <= max_class(sym)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("preset", ("ER", "G500"))
def test_shared_schedule_lists_every_member(preset, scale):
    """A value fleet on one plan: the schedule, ``indptr_c`` and every
    index array shared (1-D), so each member's rows get the same tables,
    and the lists hold each non-empty row once per member."""
    a = jrmat.rmat_csr(scale, 16, preset, seed=3)
    plan = J.plan_spgemm(a, a, algorithm="hash", cache=False)
    off, bts, table = jops.hash_schedule(a, a, n_bins=plan.n_bins)
    ta = to_port(a)
    n = 3
    ic = t32(plan.indptr_c)
    nnz = np.diff(np.asarray(plan.indptr_c, np.int64))
    flop = np.asarray(plan.flop, np.int64)
    args = (t32(off), t32(bts), ta.indptr, ta.indptr, ic, ta.indices)
    for numeric, need in ((True, nnz), (False, flop)):
        counts, pairs, row_tsz = check_fleet(*args, n, table, [need] * n,
                                             numeric)
        assert all(torch.equal(row_tsz[0], row_tsz[e]) for e in range(n))
        assert int(counts.sum()) == n * int(np.count_nonzero(need))
        one_c, one_p, one_t = K.batched_row_classes(
            *args[:4], ic if numeric else None, ta.indices, n_members=1,
            table_size=table, numeric=numeric, n_cols=WIDE)
        assert torch.equal(one_t[0], row_tsz[0])
        assert torch.equal(counts, n * one_c)
    # the one-member numeric lists are the single product's
    counts, rows, row_tsz = K.row_classes(*args, table_size=table)
    b_counts, b_pairs, b_tsz = K.batched_row_classes(
        *args, n_members=1, table_size=table)
    assert torch.equal(counts, b_counts) and torch.equal(row_tsz, b_tsz[0])
    assert all(torch.equal(r.long(), p[:, 1]) for r, p in zip(rows, b_pairs))


def ladder_members(seeds):
    """Ladder products of ``FLEET_LADDER``'s rungs, one per seed: the
    A's and the B's."""
    parts = [ladder(dyadic=True, seed=s, rungs=FLEET_LADDER) for s in seeds]
    a = [J.CSR.from_numpy_coo(*p[0]) for p in parts]
    b = [J.CSR.from_numpy_coo(*p[1]) for p in parts]
    return a, b


@pytest.mark.parametrize("forced", (True, False), ids=("one-bin", "natural"))
def test_stacked_ladder_members_reach_every_class(forced):
    """Two ``_hash_ladder`` members (``FLEET_LADDER``), stacked: under one
    bin of LADDER_TABLE slots each member's rows reach every class in both
    phases (the symbolic rows, of 1.5x the output in products, in the same
    or the next class); under the reference's own schedule no table
    passes the largest cluster."""
    a, b = ladder_members((0, 1))
    n, m = 2, len(FLEET_LADDER)
    if forced:
        off = t32([[0, m]] * n)
        bts = t32([[LADDER_TABLE]] * n)
        table = LADDER_TABLE
    else:
        scheds = [jops.hash_schedule(x, y, n_bins=8) for x, y in zip(a, b)]
        off = t32([s[0] for s in scheds])
        bts = t32([s[1] for s in scheds])
        table = max(s[2] for s in scheds)
    ta = [to_port(x) for x in a]
    tb = [to_port(y) for y in b]
    indptr_c = np.concatenate([[0], np.cumsum(FLEET_LADDER)])
    ic = t32([indptr_c] * n)
    flops = [np.asarray(jsched.flops_per_row(x, y), np.int64)
             for x, y in zip(a, b)]
    args = (off, bts, torch.stack([x.indptr for x in ta]),
            torch.stack([y.indptr for y in tb]), ic,
            torch.stack([x.indices for x in ta]))
    _, num, num_t = check_fleet(*args, n, table, [np.diff(indptr_c)] * n,
                                True)
    _, sym, sym_t = check_fleet(*args, n, table, flops, False)
    for pairs, want in ((num, FLEET_LADDER_CLASSES),
                        (sym, FLEET_LADDER_SYMBOLIC_CLASSES)):
        for e in range(n):
            got = [-1] * m
            for c, p in enumerate(pairs):
                for ee, i in p.tolist():
                    if ee == e:
                        got[i] = c
            if forced:
                assert got == list(want)
            else:
                assert max(got) < len(ref.CLASS_SLOTS)
                assert got[:4] == list(want[:4])
    assert bool((sym_t >= num_t).all())
    largest = K.fleet_table(off.tolist(), bts.tolist(), table, m, False)
    assert K.launch_classes(largest) == tuple(range(max_class(sym) + 1))
    if forced:
        assert max_class(sym) == len(ref.CLASS_SLOTS)


def saturation_members(d, forced):
    """``test_hash_saturation.py``'s pair (C rows of exactly ``d``
    distinct columns, row 1 with flop ``2d``) as the stacked fleet of two
    members, its schedule forced to ``d`` slots or natural."""
    a = J.CSR.from_numpy_coo([0, 1, 1], [0, 0, 1],
                             np.array([1.0, 1.0, 0.5], np.float32), (2, 2))
    rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
    cols = np.concatenate([np.arange(d), np.arange(d)])
    b = J.CSR.from_numpy_coo(rows, cols, VALS[np.arange(2 * d) % len(VALS)],
                             (2, d))
    if forced:
        off, bts, table = [0, 2], [d], d
    else:
        off, bts, table = jops.hash_schedule(a, b, n_bins=1)
    ta, tb = to_port(a), to_port(b)
    args = (t32([off] * 2), t32([bts] * 2), torch.stack([ta.indptr] * 2),
            torch.stack([tb.indptr] * 2), t32([[0, d, 2 * d]] * 2),
            torch.stack([ta.indices] * 2))
    flop = np.asarray(jsched.flops_per_row(a, b), np.int64)
    return args, table, flop


def test_load_factor_one_keeps_its_table():
    """A forced table of d = CHUNK slots for d distinct columns: in both
    phases every member's rows keep the whole table (load factor 1)."""
    d = K.CHUNK
    args, table, flop = saturation_members(d, True)
    assert table == d
    _, pairs, row_tsz = check_fleet(*args, 2, table, [[d, d]] * 2, True)
    assert row_tsz.tolist() == [[d, d]] * 2
    assert pairs[0].tolist() == [[0, 0], [0, 1], [1, 0], [1, 1]]
    _, _, sym = check_fleet(*args, 2, table, [flop] * 2, False)
    assert sym.tolist() == [[d, d]] * 2


def test_one_past_fill_keeps_the_doubled_table():
    """d = CHUNK + 1 under the natural schedule: the plan's table doubles
    to 2 * CHUNK and each row keeps all of it in both phases."""
    d = K.CHUNK + 1
    args, table, flop = saturation_members(d, False)
    assert table == 2 * K.CHUNK
    _, _, row_tsz = check_fleet(*args, 2, table, [[d, d]] * 2, True)
    assert row_tsz.tolist() == [[2 * K.CHUNK] * 2] * 2
    _, _, sym = check_fleet(*args, 2, table, [flop] * 2, False)
    assert sym.tolist() == [[2 * K.CHUNK] * 2] * 2


def test_launch_classes_and_fleet_table():
    """The classes a fleet launches follow its largest bin table; bins
    that hold no rows and tables past ``table_size`` do not count."""
    S = K.SMEM_SLOTS
    assert K.launch_classes(0) == ()
    assert K.launch_classes(8) == K.launch_classes(1024) == (0,)
    assert K.launch_classes(1025) == (0, 1)
    assert K.launch_classes(S) == (0, 1, 2)
    assert K.launch_classes(K.CLUSTER_SLOTS) == tuple(range(6))
    assert K.launch_classes(2 * K.CLUSTER_SLOTS) == tuple(range(7))
    bounds = [[0, 3, 3, 10], [0, 0, 5, 6]]
    sizes = [[64, 8 * S, 512], [8, 2 * S, 16]]
    assert K.fleet_table(bounds, sizes, 4 * S, 10, False) == 2 * S
    assert K.fleet_table(bounds, sizes, 256, 10, False) == 256
    assert K.fleet_table([[0, 0]], [[64]], 64, 10, False) == 0
    with pytest.raises(ValueError, match="partition"):
        K.fleet_table([[0, 5, 4]], [[8, 8]], 8, 5, False)
    with pytest.raises(ValueError, match="power of two"):
        K.fleet_table([[0, 2]], [[24]], 32, 2, False)
    with pytest.raises(ValueError, match="CHUNK"):
        K.fleet_table([[0, 2]], [[4]], 32, 2, True)


def test_batched_row_classes_on_cpu_count_plain_runs():
    K.CLASS_CALLS.update(dict.fromkeys(K.CLASS_CALLS, 0))
    args, table, flop = saturation_members(K.CHUNK, True)
    check_fleet(*args, 2, table, [flop] * 2, False)
    assert K.CLASS_CALLS == dict(dict.fromkeys(K.CLASS_CALLS, 0), plain=1)
