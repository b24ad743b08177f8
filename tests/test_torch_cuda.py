"""The hand-written CUDA kernels (hash, propagation blocking, BCSR, SpMM,
flash attention, SSD chunk scan) against their plain versions.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one:
the kernels have no CPU mode.  The module imports neither jax nor the
reference package, so it runs on a machine with only PyTorch and CUDA::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py

(``--noconftest`` because the suite's ``conftest.py`` imports jax.)
Row counts and per-row column sets must be bitwise equal; values bitwise
on dyadic inputs and within one ulp per accumulated product otherwise.
Flash attention: float32 within 2e-5 of the plain version (sums in another
order); bfloat16 within one bf16 ulp of the plain output plus that 2e-5
(each rounds its own float32 result, and the two float32 results may
differ by up to 2e-5 before rounding, which matters only near zero).
SSD chunk scan: float32 y and final state within 1e-4 plus 8 float32 ulps
of the chunk's largest |cumsum of log_a|, of the largest |value| (each
cum_i - cum_j carries the rounding of two cumsums taken in another order,
a few ulps of |cum|); bfloat16 y within one bf16 ulp of the plain output
plus that, on either kernel (the tensor-core one feeds its float32
operands as bf16 hi + lo pairs, 2^-16 of each term).
Chains (``core/chain.py``): each stage's kernel launched once an execute,
outputs on dyadic values bitwise the plain composition on the CPU after
a per-row sort, and a ``pb``-ended chain's repeat executes bitwise equal.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get as get_config
from repro_torch.core import CSR
from repro_torch.core.formats import prefix_sum
from repro_torch.data import rmat
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.spgemm_hash import kernel as K
from repro_torch.kernels.spgemm_hash import ops, ref
from repro_torch.kernels.spgemm_pb import kernel as PK
from repro_torch.kernels.spgemm_pb import ops as pb_ops
from repro_torch.kernels.spgemm_pb import ref as pb_ref
from repro_torch.kernels.ssd_chunk import kernel as SSDK
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref
from repro_torch.models import transformer
from repro_torch.parallel.sharding import single_device_ctx
from repro_torch.serve import Engine, Request

sys.path.insert(0, os.path.dirname(__file__))

from _hash_ladder import (LADDER, LADDER_CLASSES,  # noqa: E402
                          LADDER_TABLE, FLEET_LADDER, FLEET_LADDER_CLASSES,
                          FLEET_LADDER_SYMBOLIC_CLASSES, ladder,
                          saturated_row)
import _spmm_ladder  # noqa: E402
import _bcsr_ladder  # noqa: E402

DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
#: B's width given to the hash symbolic phase where a test holds its table
#: classes: too wide for one block's bitmap, so that its largest rows keep
#: the cluster and device-memory classes
WIDE = ref.BITMAP_COLS + 1
CASES = [("ER", 9, 8, True), ("G500", 10, 16, False), ("G500", 12, 16, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def operand(preset, scale, ef, dyadic, device):
    a = rmat.rmat_csr(scale, ef, preset, seed=5, device=device)
    if dyadic:
        rng = np.random.default_rng(6)
        d = np.zeros(a.cap, np.float32)
        d[:int(a.nnz)] = rng.choice(DYADIC, size=int(a.nnz))
        a = CSR(a.indptr, a.indices, torch.from_numpy(d).to(device), a.nnz,
                a.shape)
    return a


def check_numeric(a, indptr_c, cols, vals, pc, pv, dyadic):
    nnz = int(indptr_c[-1])
    s = CSR(indptr_c, cols, vals, indptr_c[-1], a.shape, False).sort_rows()
    assert torch.equal(s.indices, pc)
    assert bool((cols[nnz:] == 0).all())
    if dyadic:
        assert torch.equal(s.data, pv)
        return
    k = ref.products_per_entry(a.indptr, a.indptr, indptr_c, a.indices,
                               a.indices, pc.shape[0])
    ulp = torch.nextafter(pv.abs(), torch.full_like(pv, float("inf"))) \
        - pv.abs()
    assert bool(((s.data - pv).abs() <= k * ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_kernels_match_plain_versions(cuda, case, vector):
    a = operand(*case, cuda)
    off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
    args = (off, tsz, a.indptr, a.indptr, a.indices, a.data, a.indices,
            a.data)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    rows = K.symbolic_call(*args, table_size=table, vector=vector,
                           errors=errors, n_cols=a.n_cols)
    assert torch.equal(rows, ref.symbolic_plain(*args, table_size=table,
                                                vector=vector))
    indptr_c = prefix_sum(rows).to(torch.int32)
    cap = int(indptr_c[-1]) + 5
    nargs = (off, tsz, a.indptr, a.indptr, indptr_c, a.indices, a.data,
             a.indices, a.data)
    cols, vals = K.numeric_call(*nargs, cap_c=cap, table_size=table,
                                vector=vector, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    pc, pv = ref.numeric_plain(*nargs, cap_c=cap, table_size=table,
                               vector=vector)
    check_numeric(a, indptr_c, cols, vals, pc, pv, case[3])


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ("hash", "hash_vector"))
def test_planned_execute_launches_only_the_kernel(cuda, algorithm):
    from repro_torch.core import plan_spgemm
    a = operand("G500", 10, 16, True, cuda)
    plan = plan_spgemm(a, a, algorithm=algorithm, cache=False)
    ops.reset_kernel_calls()
    c = plan.execute(a, a)
    torch.cuda.synchronize()
    key = "numeric_vector" if algorithm == "hash_vector" else "numeric"
    counts = ops.kernel_call_counts()
    assert counts.pop(key) == 1 and set(counts.values()) == {0}
    assert torch.equal(c.indptr, plan.indptr_c)


@pytest.mark.gpu
def test_wrapper_rejects_bad_operands(cuda):
    a = operand("ER", 8, 4, True, cuda)
    off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
    with pytest.raises(ValueError):
        K.symbolic_call(off, tsz, a.indptr, a.indptr, a.indices,
                        a.data.double(), a.indices, a.data,
                        table_size=table, vector=False, n_cols=a.n_cols)
    with pytest.raises(ValueError):              # bins past the last row
        K.symbolic_call(off + 1, tsz, a.indptr, a.indptr, a.indices, a.data,
                        a.indices, a.data, table_size=table, vector=False,
                        n_cols=a.n_cols)
    with pytest.raises(ValueError):              # not a power of two
        K.symbolic_call(off, tsz * 3, a.indptr, a.indptr, a.indices, a.data,
                        a.indices, a.data, table_size=3 * table,
                        vector=False, n_cols=a.n_cols)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_table_too_small_raises(cuda, vector):
    """A table of CHUNK slots for 2 * CHUNK distinct columns: with no
    ``errors`` tensor from the caller, each wrapper and the planned ops
    entry raise instead of returning a partial row."""
    d = 2 * K.CHUNK
    a = CSR.from_numpy_coo([0], [0], np.ones(1, np.float32), (1, 1),
                           device=cuda)
    b = CSR.from_numpy_coo(np.zeros(d, np.int64), np.arange(d),
                           DYADIC[np.arange(d) % 4], (1, d), device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([K.CHUNK], dtype=torch.int32, device=cuda)
    indptr_c = torch.tensor([0, d], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="full-table"):
        K.symbolic_call(off, tsz, a.indptr, b.indptr, a.indices, a.data,
                        b.indices, b.data, table_size=K.CHUNK, vector=vector,
                        n_cols=b.n_cols)
    with pytest.raises(RuntimeError, match="full-table"):
        K.numeric_call(off, tsz, a.indptr, b.indptr, indptr_c, a.indices,
                       a.data, b.indices, b.data, cap_c=d,
                       table_size=K.CHUNK, vector=vector)
    with pytest.raises(RuntimeError, match="full-table"):
        ops.spgemm_hash(a, b, d, vector=vector, table_size=K.CHUNK,
                        schedule=(off, tsz), indptr_c=indptr_c)


def check_product(a, b, indptr_c, cols, vals, pc, pv, dyadic):
    """``check_numeric`` for ``A @ B``: per-row column sets bitwise, the
    tail zero, values bitwise (dyadic) or within one ulp per product."""
    nnz = int(indptr_c[-1])
    s = CSR(indptr_c, cols, vals, indptr_c[-1], (a.n_rows, b.n_cols),
            False).sort_rows()
    assert torch.equal(s.indices[:nnz], pc[:nnz])
    assert bool((cols[nnz:] == 0).all()) and bool((vals[nnz:] == 0).all())
    if dyadic:
        assert torch.equal(s.data[:nnz], pv[:nnz])
        return
    k = ref.products_per_entry(a.indptr, b.indptr, indptr_c, a.indices,
                               b.indices, cols.shape[0])[:nnz]
    ulp = torch.nextafter(pv[:nnz].abs(), torch.full_like(
        pv[:nnz], float("inf"))) - pv[:nnz].abs()
    assert bool(((s.data[:nnz] - pv[:nnz]).abs() <= k * ulp).all())


def reset_class_calls():
    K.CLASS_CALLS.update(dict.fromkeys(K.CLASS_CALLS, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("forced", (True, False), ids=("one-bin", "natural"))
@pytest.mark.parametrize("dyadic", (True, False), ids=("dyadic", "uniform"))
@pytest.mark.parametrize("vector", (False, True))
def test_ladder_reaches_every_table_class(cuda, vector, dyadic, forced):
    """Rows of 0 to 70,000 distinct columns (``_hash_ladder``): under one
    bin of 262,144 slots every class runs -- the three shared-memory
    classes, clusters of 2, 4 and 8 blocks and the device-memory table --
    and under the plan's own bins no table passes the largest cluster.
    The classifying kernel equals its plain version; both phases equal
    theirs, with no kernel error."""
    (ar, ac, av, ash), (br, bc, bv, bsh) = ladder(dyadic)
    a = CSR.from_numpy_coo(ar, ac, av, ash, device=cuda)
    b = CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)
    if forced:
        off = torch.tensor([0, len(LADDER)], dtype=torch.int32, device=cuda)
        tsz = torch.tensor([LADDER_TABLE], dtype=torch.int32, device=cuda)
        table = LADDER_TABLE
    else:
        off, tsz, table = ops.hash_schedule(a, b, n_bins=8)
    args = (off, tsz, a.indptr, b.indptr, a.indices, a.data, b.indices,
            b.data)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    rows = K.symbolic_call(*args, table_size=table, vector=vector,
                           errors=errors, n_cols=WIDE)
    assert torch.equal(rows, ref.symbolic_plain(*args, table_size=table,
                                                vector=vector))
    assert rows.tolist() == list(LADDER)
    indptr_c = prefix_sum(rows).to(torch.int32)
    counts, lists, row_tsz = K.row_classes(
        off, tsz, a.indptr, b.indptr, indptr_c, a.indices, table_size=table,
        errors=errors)
    p_counts, p_lists, p_tsz = ref.row_classes_plain(off, tsz, indptr_c,
                                                     table_size=table)
    assert torch.equal(counts, p_counts) and torch.equal(row_tsz, p_tsz)
    for got, want in zip(lists, p_lists):
        assert torch.equal(torch.sort(got).values, want)
    if forced:
        assert [next((c for c, r in enumerate(p_lists) if i in r.tolist()),
                     -1) for i in range(len(LADDER))] == list(LADDER_CLASSES)
    cap = int(indptr_c[-1]) + 5
    nargs = (off, tsz, a.indptr, b.indptr, indptr_c, a.indices, a.data,
             b.indices, b.data)
    reset_class_calls()
    cols, vals = K.numeric_call(*nargs, cap_c=cap, table_size=table,
                                vector=vector, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    launched = [k for k in K.CLASS_NAMES if K.CLASS_CALLS[k]]
    assert K.CLASS_CALLS["classify"] == 1
    assert all(K.CLASS_CALLS[k] == 1 for k in launched)
    if forced:
        assert launched == list(K.CLASS_NAMES)
    pc, pv = ref.numeric_plain(*nargs, cap_c=cap, table_size=table,
                               vector=vector)
    check_product(a, b, indptr_c, cols, vals, pc, pv, dyadic)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_cluster_table_load_factor_one_and_one_past_fill(cuda, vector):
    """A table of 32,768 slots (a cluster of two blocks) for a row of
    exactly 32,768 distinct columns is full and right; one more column
    raises "full-table" in both phases."""
    t = 2 * K.SMEM_SLOTS
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([t], dtype=torch.int32, device=cuda)
    for d in (t, t + 1):
        (ar, ac, av, ash), (br, bc, bv, bsh) = saturated_row(d)
        a = CSR.from_numpy_coo(ar, ac, av, ash, device=cuda)
        b = CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)
        indptr_c = torch.tensor([0, d], dtype=torch.int32, device=cuda)
        args = (off, tsz, a.indptr, b.indptr, a.indices, a.data, b.indices,
                b.data)
        nargs = args[:4] + (indptr_c,) + args[4:]
        _, lists, row_tsz = K.row_classes(off, tsz, a.indptr, b.indptr,
                                          indptr_c, a.indices, table_size=t)
        assert row_tsz.tolist() == [t]
        assert lists[K.CLASS_NAMES.index("cluster_2")].tolist() == [0]
        if d > t:
            with pytest.raises(RuntimeError, match="full-table"):
                K.symbolic_call(*args, table_size=t, vector=vector,
                                n_cols=WIDE)
            with pytest.raises(RuntimeError, match="full-table"):
                K.numeric_call(*nargs, cap_c=d, table_size=t, vector=vector)
            continue
        assert K.symbolic_call(*args, table_size=t, vector=vector,
                               n_cols=WIDE).tolist() == [d]
        reset_class_calls()
        cols, vals = K.numeric_call(*nargs, cap_c=d, table_size=t,
                                    vector=vector)
        assert K.CLASS_CALLS["cluster_2"] == 1
        pc, pv = ref.numeric_plain(*nargs, cap_c=d, table_size=t,
                                   vector=vector)
        check_product(a, b, indptr_c, cols, vals, pc, pv, True)


def check_symbolic_single(args, table, vector, n_cols, want=None):
    """The single-product symbolic kernel with B's width ``n_cols``:
    launches (one count, one classification, one launch per class the
    schedule's largest table allows, the bitmap class's where B's width
    turns it on), counts bitwise equal to the plain version's, to the
    batched kernel's at one member and to ``want``.  Returns the counts
    and the class launches."""
    m = args[2].shape[0] - 1
    largest = K.fleet_table([args[0].tolist()], [args[1].tolist()], table,
                            m, vector)
    launches = K.launch_classes(largest, ref.bitmap_above(n_cols))
    errors = torch.zeros(1, dtype=torch.int32, device=args[2].device)
    ops.reset_kernel_calls()
    reset_class_calls()
    rows = K.symbolic_call(*args, table_size=table, vector=vector,
                           errors=errors, n_cols=n_cols)
    torch.cuda.synchronize()
    assert int(errors) == 0
    counts = ops.kernel_call_counts()
    assert counts.pop("symbolic_vector" if vector else "symbolic") == 1
    assert set(counts.values()) == {0}
    calls = dict(K.CLASS_CALLS)
    assert calls == dict(dict.fromkeys(K.CLASS_CALLS, 0), classify=1,
                         **{K.SYMBOLIC_CLASS_NAMES[c]: 1 for c in launches})
    assert torch.equal(rows, ref.symbolic_plain(*args, table_size=table,
                                                vector=vector))
    batched = K.batched_symbolic_call(*args, n_members=1, table_size=table,
                                      vector=vector, n_cols=n_cols)
    assert torch.equal(batched[0], rows)
    if want is not None:
        assert torch.equal(rows, want)
    return rows, calls


def check_symbolic_classify(args, table, n_cols):
    """The symbolic classifying kernel at one member with B's width
    ``n_cols`` against its plain version: counts, tables, each class's
    rows as a set.  Returns the plain version's lists."""
    cls_args = args[:4] + (None, args[4])
    kw = dict(n_members=1, table_size=table, numeric=False, n_cols=n_cols)
    errors = torch.zeros(1, dtype=torch.int32, device=args[2].device)
    got = K.batched_row_classes(*cls_args, **kw, errors=errors)
    want = ref.batched_row_classes_plain(
        *(None if x is None else x.cpu() for x in cls_args), **kw)
    assert int(errors) == 0
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert sorted(g.tolist()) == w.tolist()
    return want[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", (True, False), ids=("dyadic", "uniform"))
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", CASES + [("G500", 14, 16, True)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_symbolic_kernel_by_class_matches_esc(cuda, case, vector, dyadic):
    """The single-product symbolic kernel with B's width, on the plan's
    schedule: its counts bitwise equal to ESC's ``row_nnz_c``, the plain
    version's and the batched kernel's at one member; its classification
    the plain version's; one count, one classification and one launch per
    class (G500 s14: rows on the bitmap class, none on a cluster)."""
    from repro_torch.core import plan_spgemm
    a = operand(case[0], case[1], case[2], dyadic, cuda)
    plan = plan_spgemm(a, a, algorithm="hash", cache=False)
    args = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr, a.indices,
            a.data, a.indices, a.data)
    _, calls = check_symbolic_single(args, plan.table_size, vector,
                                     a.n_cols, plan.row_nnz_c)
    lists = check_symbolic_classify(args, plan.table_size, a.n_cols)
    assert all(calls[K.SYMBOLIC_CLASS_NAMES[c]] == 1
               for c, r in enumerate(lists) if r.shape[0])
    if case[1] == 14:
        assert lists[K.BITMAP_CLASS].shape[0] > 0
        assert all(lists[c].shape[0] == 0 for c in range(3, 7))


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", (True, False), ids=("dyadic", "uniform"))
@pytest.mark.parametrize("vector", (False, True))
def test_symbolic_ladder_reaches_every_class(cuda, vector, dyadic):
    """The fleet ladder's rungs under one bin of 262,144 slots: with B's
    width the rows whose table passes 4,096 slots run on the bitmap class;
    with a width too large for the bitmap on the 16,384-slot class,
    clusters of 2, 4 and 8 blocks and the device-memory table.  The two
    runs together launch every symbolic class; counts bitwise equal to the
    plain version's and the rungs."""
    (ar, ac, av, ash), (br, bc, bv, bsh) = ladder(dyadic, 0, FLEET_LADDER)
    a = CSR.from_numpy_coo(ar, ac, av, ash, device=cuda)
    b = CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)
    off = torch.tensor([0, len(FLEET_LADDER)], dtype=torch.int32,
                       device=cuda)
    tsz = torch.tensor([LADDER_TABLE], dtype=torch.int32, device=cuda)
    args = (off, tsz, a.indptr, b.indptr, a.indices, a.data, b.indices,
            b.data)
    want = torch.tensor(FLEET_LADDER, dtype=torch.int32, device=cuda)
    launched = set()
    for n_cols in (b.n_cols, WIDE):
        _, calls = check_symbolic_single(args, LADDER_TABLE, vector, n_cols,
                                         want)
        lists = check_symbolic_classify(args, LADDER_TABLE, n_cols)
        # every class launched holds rows: with the bitmap none is left
        # on a cluster or in device memory
        held = [c for c, r in enumerate(lists) if r.shape[0]]
        assert held == list(K.launch_classes(LADDER_TABLE,
                                             ref.bitmap_above(n_cols)))
        assert (K.BITMAP_CLASS in held) == (n_cols == b.n_cols)
        launched |= {k for k in K.SYMBOLIC_CLASS_NAMES if calls[k]}
    assert launched == set(K.SYMBOLIC_CLASS_NAMES)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("bitmap", (True, False), ids=("bitmap", "cluster"))
def test_symbolic_load_factor_one_and_one_past_fill(cuda, bitmap, vector):
    """A row of exactly 32,768 distinct columns under a table of 32,768
    slots, on the bitmap class (B's width) or a cluster of two blocks (a
    width too large for the bitmap): counted right; one more column adds
    an error, so
    the wrapper raises "full-table", single product and fleet."""
    t = 2 * K.SMEM_SLOTS
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([t], dtype=torch.int32, device=cuda)
    name = "bitmap" if bitmap else "cluster_2"
    for d in (t, t + 1):
        (ar, ac, av, ash), (br, bc, bv, bsh) = saturated_row(d)
        a = CSR.from_numpy_coo(ar, ac, av, ash, device=cuda)
        b = CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)
        n_cols = b.n_cols if bitmap else WIDE
        args = (off, tsz, a.indptr, b.indptr, a.indices, a.data, b.indices,
                b.data)
        lists = check_symbolic_classify(args, t, n_cols)
        assert lists[K.SYMBOLIC_CLASS_NAMES.index(name)].tolist() == [[0, 0]]
        kw = dict(table_size=t, vector=vector, n_cols=n_cols)
        if d > t:
            errors = torch.zeros(1, dtype=torch.int32, device=cuda)
            rows = K.symbolic_call(*args, **kw, errors=errors)
            assert int(errors) >= 1 and rows.tolist() == [t]
            with pytest.raises(RuntimeError, match="full-table"):
                K.symbolic_call(*args, **kw)
            with pytest.raises(RuntimeError, match="full-table"):
                K.batched_symbolic_call(*args, n_members=2, **kw)
            continue
        reset_class_calls()
        assert K.symbolic_call(*args, **kw).tolist() == [d]
        assert K.CLASS_CALLS[name] == 1
        assert K.batched_symbolic_call(*args, n_members=2,
                                       **kw).tolist() == [[d], [d]]


@pytest.mark.gpu
def test_bitmap_class_counts_columns_outside_b_as_errors(cuda):
    """A width smaller than B's real one: the bitmap rows count each
    column past it as an error instead of writing outside the bitmap."""
    t = 2 * K.SMEM_SLOTS
    (ar, ac, av, ash), (br, bc, bv, bsh) = saturated_row(t)
    a = CSR.from_numpy_coo(ar, ac, av, ash, device=cuda)
    b = CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([t], dtype=torch.int32, device=cuda)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    K.symbolic_call(off, tsz, a.indptr, b.indptr, a.indices, a.data,
                    b.indices, b.data, table_size=t, vector=False,
                    errors=errors, n_cols=b.n_cols // 2)
    torch.cuda.synchronize()
    assert int(errors) >= 1


PB_CASES = [("ER", 10, 8), ("G500", 8, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PB_CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_pb_kernels_match_plain_versions(cuda, case):
    """Forced ``algorithm="pb"``: scatter bitwise (one rounding per
    product), merge bitwise on dyadic values; ``plan.execute`` launches
    each kernel once and no plain version."""
    from repro_torch.core import plan_spgemm
    a = operand(*case, True, cuda)
    plan = plan_spgemm(a, a, algorithm="pb", sorted_output=True, cache=False)
    p = plan.pb_plan
    pp = PK.scatter_call(p.bucket_nnz, p.src_a, p.src_b, a.data, a.data)
    assert torch.equal(pp, pb_ref.scatter_plain(p.bucket_nnz, p.src_a,
                                                p.src_b, a.data, a.data))
    data = PK.merge_call(p.bucket_nnz, p.seg, pp, p.cap_c)
    assert torch.equal(data, pb_ref.merge_plain(p.bucket_nnz, p.seg, pp,
                                                p.cap_c))
    pb_ops.reset_kernel_calls()
    c = plan.execute(a, a)
    torch.cuda.synchronize()
    assert pb_ops.kernel_call_counts() == {"inspect": 0, "scatter": 1,
                                           "merge": 1, "plain": 0,
                                           "batched_scatter": 0,
                                           "batched_merge": 0,
                                           "batched_plain": 0}
    assert c.sorted_cols and torch.equal(c.indptr, plan.indptr_c)
    h = plan_spgemm(a, a, algorithm="hash", cache=False).execute(
        a, a, sorted_output=True)
    assert torch.equal(c.indices, h.indices) and torch.equal(c.data, h.data)


@pytest.mark.gpu
def test_pb_kernels_clip_indices_and_zero_pad_lanes(cuda):
    """Out-of-range gather and output slots clip as the TPU kernels' do;
    pad lanes are 0 and never merged; a slot no lane names stays 0."""
    i32 = dict(dtype=torch.int32, device=cuda)
    bucket_nnz = torch.tensor([3, 0, 2], **i32)
    src_a = torch.tensor([[0, 5, -2, 7], [1, 1, 1, 1], [2, 9, 0, 0]], **i32)
    src_b = torch.tensor([[1, -1, 9, 3], [0, 0, 0, 0], [0, 2, 4, 4]], **i32)
    seg = torch.tensor([[0, 1, 1, 9], [0, 0, 0, 0], [3, 7, 9, 9]], **i32)
    a_data = torch.tensor([0.5, 1.5, 2.0], device=cuda)
    b_data = torch.tensor([1.0, 2.0, 4.0], device=cuda)
    pp = PK.scatter_call(bucket_nnz, src_a, src_b, a_data, b_data)
    want = torch.tensor([[1.0, 2.0, 2.0, 0], [0, 0, 0, 0], [2.0, 8.0, 0, 0]],
                        device=cuda)
    assert torch.equal(pp, want)
    data = PK.merge_call(bucket_nnz, seg, pp, 5)
    assert torch.equal(data, torch.tensor([1.0, 4.0, 0.0, 2.0, 8.0],
                                          device=cuda))
    assert torch.equal(data, pb_ref.merge_plain(bucket_nnz, seg, pp, 5))


@pytest.mark.gpu
def test_pb_wrappers_reject_bad_operands(cuda):
    i32 = dict(dtype=torch.int32, device=cuda)
    bucket_nnz = torch.tensor([2], **i32)
    src = torch.zeros((1, 8), **i32)
    vals = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):              # CPU/CUDA mismatch
        PK.scatter_call(bucket_nnz, src, src, vals.cpu(), vals)
    with pytest.raises(ValueError):
        PK.merge_call(bucket_nnz.cpu(), src, torch.zeros((1, 8),
                                                         device=cuda), 4)
    with pytest.raises(ValueError):              # wrong dtype
        PK.scatter_call(bucket_nnz, src, src, vals.double(), vals)
    with pytest.raises(ValueError):
        PK.merge_call(bucket_nnz, src.long(), torch.zeros((1, 8),
                                                          device=cuda), 4)
    with pytest.raises(ValueError):              # shapes disagree
        PK.scatter_call(bucket_nnz, src, torch.zeros((1, 4), **i32), vals,
                        vals)


def pb_fleet(cuda, case, n, seed, dyadic):
    """A PB plan of ``A·A`` on the card and ``n`` members of new values on
    A's pattern, ``(n, cap)`` float32."""
    from repro_torch.core import plan_pb
    a = operand(*case, True, cuda)
    plan = plan_pb(a, a, cache=False)
    rng = np.random.default_rng(seed)
    vals = rng.choice(DYADIC, size=(n, a.cap)) if dyadic else \
        rng.uniform(0.5, 1.5, size=(n, a.cap))
    return a, plan, torch.from_numpy(vals.astype(np.float32)).to(cuda)


def pb_slot_products(plan):
    """Products accumulated into each output slot (the ulp budget)."""
    live = torch.arange(plan.bucket_cap, device=plan.seg.device)[None, :] \
        < plan.bucket_nnz[:, None]
    return torch.bincount(plan.seg[live].long(), minlength=plan.cap_c)


PB_STACKED = ("a", "a_b", "indices", "all")


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", (True, False))
@pytest.mark.parametrize("stacked", PB_STACKED)
def test_pb_batched_kernels_match_plain_versions(cuda, stacked, dyadic):
    """The batched scatter and merge against the batched plain versions:
    A's values stacked, A's and B's, the plan's index arrays stacked (the
    values shared, member stride 0), everything stacked.  Scatter bitwise;
    merge bitwise on dyadic values, else within 1 ulp per product (the
    plain merge adds with atomics); one launch per phase."""
    a, p, stack = pb_fleet(cuda, PB_CASES[0], 3, 40, dyadic)
    av = stack if stacked != "indices" else a.data
    bv = stack.flip(0) if stacked in ("a_b", "all") else a.data
    idx = [p.bucket_nnz, p.src_a, p.src_b, p.seg]
    if stacked in ("indices", "all"):
        idx = [torch.stack([t] * 3) for t in idx]
    bnz, sa, sb, seg = idx
    pb_ops.reset_kernel_calls()
    pp = PK.batched_scatter_call(bnz, sa, sb, av, bv, n_members=3)
    out = PK.batched_merge_call(bnz, seg, pp, p.cap_c, n_members=3)
    torch.cuda.synchronize()
    assert pb_ops.kernel_call_counts() == {
        "inspect": 0, "scatter": 0, "merge": 0, "plain": 0,
        "batched_scatter": 1, "batched_merge": 1, "batched_plain": 0}
    assert torch.equal(pp, pb_ref.batched_scatter_plain(bnz, sa, sb, av, bv,
                                                        3))
    want = pb_ref.batched_merge_plain(bnz, seg, pp, p.cap_c, 3)
    if dyadic:
        assert torch.equal(out, want)
        return
    k = pb_slot_products(p).float()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) \
        - want.abs()
    assert bool(((out - want).abs() <= k * ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", PB_CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_pb_batched_member_equals_single_kernels(cuda, case):
    """On uniform values member e of the batched pair is bitwise what the
    single-product kernels give on member e: the bucket body, its lane
    order and its roundings are the same."""
    a, p, stack = pb_fleet(cuda, case, 4, 41, False)
    pp = PK.batched_scatter_call(p.bucket_nnz, p.src_a, p.src_b, stack,
                                 a.data, n_members=4)
    out = PK.batched_merge_call(p.bucket_nnz, p.seg, pp, p.cap_c,
                                n_members=4)
    for e in range(4):
        one = PK.scatter_call(p.bucket_nnz, p.src_a, p.src_b, stack[e],
                              a.data)
        assert torch.equal(pp[e], one), e
        assert torch.equal(out[e], PK.merge_call(p.bucket_nnz, p.seg, one,
                                                 p.cap_c)), e


@pytest.mark.gpu
def test_pb_batched_kernels_clip_indices_and_zero_pad_lanes(cuda):
    """Per member, out-of-range gathers and slots clip, pad lanes are 0 and
    never merged, a slot no lane names stays 0; ``bucket_nnz`` stacked
    (each member's buckets name disjoint slots, as a plan's do)."""
    i32 = dict(dtype=torch.int32, device=cuda)
    bucket_nnz = torch.tensor([[3, 0, 2], [2, 0, 1]], **i32)
    src_a = torch.tensor([[0, 5, -2, 7], [1, 1, 1, 1], [2, 9, 0, 0]], **i32)
    src_b = torch.tensor([[1, -1, 9, 3], [0, 0, 0, 0], [0, 2, 4, 4]], **i32)
    seg = torch.tensor([[0, 1, 1, 9], [0, 0, 0, 0], [3, 7, 9, 9]], **i32)
    a_data = torch.tensor([[0.5, 1.5, 2.0], [1.0, 2.0, 4.0]], device=cuda)
    b_data = torch.tensor([1.0, 2.0, 4.0], device=cuda)
    pp = PK.batched_scatter_call(bucket_nnz, src_a, src_b, a_data, b_data,
                                 n_members=2)
    out = PK.batched_merge_call(bucket_nnz, seg, pp, 5, n_members=2)
    assert torch.equal(pp[0], torch.tensor(
        [[1.0, 2.0, 2.0, 0], [0, 0, 0, 0], [2.0, 8.0, 0, 0]], device=cuda))
    assert torch.equal(out[0], torch.tensor([1.0, 4.0, 0.0, 2.0, 8.0],
                                            device=cuda))
    for e in range(2):
        one = pb_ref.scatter_plain(bucket_nnz[e], src_a, src_b, a_data[e],
                                   b_data)
        assert torch.equal(pp[e], one)
        assert torch.equal(out[e], pb_ref.merge_plain(bucket_nnz[e], seg,
                                                      one, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("case", PB_CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_pb_single_calls_equal_batched_at_one_member(cuda, case):
    """``scatter_call``/``merge_call`` are the batched kernels at one
    member, every argument shared: bitwise the batched calls on the same
    arguments (uniform values), each wrapper counting under its own
    name."""
    a, p, stack = pb_fleet(cuda, case, 1, 43, False)
    pb_ops.reset_kernel_calls()
    pp = PK.scatter_call(p.bucket_nnz, p.src_a, p.src_b, stack[0], a.data)
    out = PK.merge_call(p.bucket_nnz, p.seg, pp, p.cap_c)
    torch.cuda.synchronize()
    assert pb_ops.kernel_call_counts() == {
        "inspect": 0, "scatter": 1, "merge": 1, "plain": 0,
        "batched_scatter": 0, "batched_merge": 0, "batched_plain": 0}
    assert pp.is_contiguous() and out.is_contiguous()
    for av in (stack[0], stack):
        bpp = PK.batched_scatter_call(p.bucket_nnz, p.src_a, p.src_b, av,
                                      a.data, n_members=1)
        assert torch.equal(bpp[0], pp)
        bout = PK.batched_merge_call(p.bucket_nnz, p.seg, bpp, p.cap_c,
                                     n_members=1)
        assert torch.equal(bout[0], out)


PB_FLEET_SIZES = (1, 2, 4, 8, 9, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("batched", ("a", "b", "both"))
@pytest.mark.parametrize("indices", ("shared", "stacked"))
@pytest.mark.parametrize("n", PB_FLEET_SIZES)
def test_pb_batched_kernels_match_plain_at_fleet_sizes(cuda, n, indices,
                                                       batched):
    """The batched pair against the batched plain versions at ``n``
    members, the plan's index arrays shared (members inside a block,
    slot-major values) or stacked (a block a member), A's, B's or both
    values batched, dyadic: bitwise.  One slot-major copy a batched
    operand where a block takes every member.  The merge returns ``(n,
    cap_c)`` stored slot-major, rows of ``merge_width`` members."""
    a, p, stack = pb_fleet(cuda, PB_CASES[0], n, 44 + n, True)
    av = stack if batched != "b" else a.data
    bv = stack.flip(0) if batched != "a" else a.data
    idx = [p.bucket_nnz, p.src_a, p.src_b, p.seg]
    if indices == "stacked":
        idx = [torch.stack([t] * n) for t in idx]
    bnz, sa, sb, seg = idx
    PK.COPY_CALLS["slot_major"] = 0
    pp = PK.batched_scatter_call(bnz, sa, sb, av, bv, n_members=n)
    out = PK.batched_merge_call(bnz, seg, pp, p.cap_c, n_members=n)
    copies = (batched == "both") + 1 if indices == "shared" and n > 1 else 0
    assert PK.COPY_CALLS["slot_major"] == copies
    assert out.shape == (n, p.cap_c)
    assert out.stride() == (1, PK.merge_width(n, indices == "shared"))
    assert torch.equal(pp, pb_ref.batched_scatter_plain(bnz, sa, sb, av, bv,
                                                        n))
    assert torch.equal(out.contiguous(), pb_ref.batched_merge_plain(
        bnz, seg, pp, p.cap_c, n))


@pytest.mark.gpu
@pytest.mark.parametrize("n", (3, 8, 9))
def test_pb_batched_merge_keeps_unnamed_slots_zero(cuda, n):
    """Shared index arrays (members inside a block): a slot no live lane
    names stays 0 for every member, pad lanes are never merged, and
    out-of-range slots clip."""
    i32 = dict(dtype=torch.int32, device=cuda)
    bucket_nnz = torch.tensor([3, 0, 2], **i32)
    seg = torch.tensor([[0, 1, 1, 9], [0, 0, 0, 0], [3, 7, 9, 9]], **i32)
    pp = torch.arange(n * 12, dtype=torch.float32, device=cuda).view(
        n, 3, 4) + 1
    out = PK.batched_merge_call(bucket_nnz, seg, pp, 6, n_members=n)
    want = pb_ref.batched_merge_plain(bucket_nnz, seg, pp, 6, n)
    assert torch.equal(out.contiguous(), want)
    assert not out[:, 2].any() and not out[:, 4].any()
    assert torch.equal(out[:, 5], pp[:, 2, 1])


@pytest.mark.gpu
def test_pb_slot_major_matches_transpose(cuda):
    """The slot-major copy of a stacked operand is its transpose, at
    member counts around the 32-row tile and a ragged column count."""
    for n in (1, 3, 8, 33):
        x = torch.randn(n, 1000 + n, device=cuda)
        assert torch.equal(PK.slot_major(x), x.t().contiguous()), n


@pytest.mark.gpu
def test_pb_vmap_execute_launches_only_the_batched_kernels(cuda):
    """``torch.func.vmap`` of ``PBPlan.execute`` over A's values on CUDA:
    one batched scatter and one batched merge, no single-product kernel,
    no plain version and no inspection; each member bitwise equal to its
    own execute."""
    import dataclasses
    a, p, stack = pb_fleet(cuda, PB_CASES[1], 4, 42, False)

    def one(v):
        return p.execute(dataclasses.replace(a, data=v), a).data

    pb_ops.reset_kernel_calls()
    data = torch.func.vmap(one)(stack)
    torch.cuda.synchronize()
    assert pb_ops.kernel_call_counts() == {
        "inspect": 0, "scatter": 0, "merge": 0, "plain": 0,
        "batched_scatter": 1, "batched_merge": 1, "batched_plain": 0}
    for e in range(4):
        assert torch.equal(data[e], one(stack[e])), e


def block_operand(gm, gn, bm, bn, density, seed, device, dyadic=True):
    """A block-clustered BCSR: occupied tiles dense, dyadic or uniform
    values."""
    from repro_torch.core import BCSR
    rng = np.random.default_rng(seed)
    occ = rng.random((gm, gn)) < density
    vals = rng.choice(DYADIC, size=(gm * bm, gn * bn)) if dyadic else \
        rng.uniform(0.5, 1.5, size=(gm * bm, gn * bn))
    d = np.kron(occ, np.ones((bm, bn))) * vals
    return BCSR.from_dense(torch.from_numpy(d.astype(np.float32)).to(device),
                           (bm, bn))


def check_bcsr(a, b, plan, bcol, blk, dyadic):
    """The kernel's output against the plain version: block columns per
    row bitwise after a per-row sort, tiles bitwise on dyadic values, else
    within (block pairs x bk) ulp."""
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    args = (plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
            a.indices, a.blocks, b.indices, b.blocks)
    pc, pb = bref.numeric_plain(*args, bcap_c=plan.bcap_c,
                                table_size=plan.table_size, vector=False)
    sc, sb = bref.sort_block_rows(plan.indptr_cb, bcol, blk)
    assert torch.equal(sc, pc)
    if dyadic:
        assert torch.equal(sb, pb)
        return
    k = bref.products_per_block(a.indptr, b.indptr, plan.indptr_cb,
                                a.indices, b.indices, plan.bcap_c)
    ulp = torch.nextafter(pb.abs(), torch.full_like(pb, float("inf"))) \
        - pb.abs()
    bound = (k * a.block[1])[:, None, None] * ulp
    assert bool(((sb - pb).abs() <= bound).all())


BCSR_CASES = [(2, 3, 4, 40, True), (8, 8, 8, 64, True), (8, 8, 8, 64, False),
              (1, 1, 1, 96, True), (4, 2, 16, 24, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", BCSR_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[4]}")
def test_bcsr_kernel_matches_plain_version(cuda, case, vector):
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    bm, bk, bn, g, dyadic = case
    a = block_operand(g, g, bm, bk, 0.15, 1, cuda, dyadic)
    b = block_operand(g, g, bk, bn, 0.15, 2, cuda, dyadic)
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.numeric_call(
        plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
        a.indices, a.blocks, b.indices, b.blocks, bcap_c=plan.bcap_c,
        table_size=plan.table_size, vector=vector, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    check_bcsr(a, b, plan, bcol, blk, dyadic)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_bcsr_global_memory_table(cuda, vector):
    """Two block rows of 900 output blocks each: a 1,024-slot table of 8x8
    tiles (238 KB) past the largest block's shared memory, the direct
    class (keys in device memory, tiles summed in place in the output)."""
    from repro_torch.core import BCSR, plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    n_b = 900
    rng = np.random.default_rng(3)
    a = BCSR.from_dense(torch.from_numpy(rng.choice(DYADIC, (16, 8)).astype(
        np.float32)).to(cuda), (8, 8))
    b = BCSR.from_dense(torch.from_numpy(rng.choice(DYADIC, (8, 8 * n_b))
                                         .astype(np.float32)).to(cuda),
                        (8, 8))
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    counts, rows, _ = BK.row_classes(
        plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
        a.indices, table_size=plan.table_size, vector=vector,
        block=(8, 8, 8))
    assert sorted(rows[-1].tolist()) == [0, 1]
    assert int(counts.sum()) == 2
    bops.reset_kernel_calls()
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    c = plan.execute(a, b)
    torch.cuda.synchronize()
    key = "numeric_vector" if vector else "numeric"
    assert bops.kernel_call_counts() == {"symbolic": 0, "numeric": 0,
                                         "numeric_vector": 0, "plain": 0,
                                         "batched_numeric": 0,
                                         "batched_numeric_vector": 0,
                                         "batched_plain": 0, key: 1}
    assert BK.CLASS_CALLS["direct"] == 1 and BK.CLASS_CALLS["classify"] == 1
    check_bcsr(a, b, plan, c.indices, c.blocks, True)


@pytest.mark.gpu
def test_bcsr_wrong_indptr_raises(cuda):
    """An indptr_cb whose counts disagree with the product, and a table too
    small for a block row, make the wrapper raise."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    a = block_operand(24, 24, 8, 8, 0.3, 4, cuda)
    plan = plan_bcsr(a, a, cache=False)
    wrong = plan.indptr_cb.clone()
    wrong[1:] += 1                       # block row 0 one block too many
    with pytest.raises(RuntimeError, match="flushed count"):
        bops.spgemm_bcsr(a, a, plan.bcap_c + 1, table_size=plan.table_size,
                         schedule=(plan.offsets, plan.bin_tsize),
                         indptr_cb=wrong)
    small = torch.full_like(plan.bin_tsize, 8)
    with pytest.raises(RuntimeError, match="full-table"):
        BK.numeric_call(plan.offsets, small, a.indptr, a.indptr,
                        plan.indptr_cb, a.indices, a.blocks, a.indices,
                        a.blocks, bcap_c=plan.bcap_c, table_size=8,
                        vector=False)
    with pytest.raises(ValueError):              # wrong dtype
        BK.numeric_call(plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                        plan.indptr_cb, a.indices, a.blocks.double(),
                        a.indices, a.blocks, bcap_c=plan.bcap_c,
                        table_size=plan.table_size, vector=False)


@pytest.mark.gpu
def test_bcsr_planned_execute_launches_only_the_kernel(cuda):
    """plan_spgemm(algorithm="bcsr").execute on CUDA: one block-kernel
    launch, no plain version, no inspection; the CSR output equals the
    sorted hash route's."""
    from repro_torch.core import csr_to_bcsr, bcsr_to_csr, plan_spgemm
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    a = bcsr_to_csr(block_operand(32, 32, 8, 8, 0.2, 5, cuda))
    plan = plan_spgemm(a, a, algorithm="bcsr", cache=False)
    bops.reset_kernel_calls()
    ops.reset_kernel_calls()
    c = plan.execute(a, a)
    torch.cuda.synchronize()
    assert bops.kernel_call_counts() == {"symbolic": 0, "numeric": 1,
                                         "numeric_vector": 0, "plain": 0,
                                         "batched_numeric": 0,
                                         "batched_numeric_vector": 0,
                                         "batched_plain": 0}
    assert set(ops.kernel_call_counts().values()) == {0}
    h = plan_spgemm(a, a, algorithm="hash", cache=False).execute(
        a, a, sorted_output=True)
    assert torch.equal(c.indptr, h.indptr) and torch.equal(c.indices,
                                                           h.indices)
    assert torch.equal(c.data, h.data)
    assert csr_to_bcsr(c, (8, 8)).block == (8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("block", ((64, 64, 64, 3), (32, 16, 48, 0)),
                         ids=("64x64x64", "32x16x48"))
@pytest.mark.parametrize("dyadic", (True, False))
def test_bcsr_tiles_past_1024_lanes(cuda, block, dyadic):
    """Tiles of 4,096 and 1,536 output lanes, more than a block's threads:
    each thread walks several (pair, lane) items.  Every block row is
    staged in shared memory, 64x64 tiles in the largest class."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    bm, bk, bn, lowest = block
    a = block_operand(5, 5, bm, bk, 0.5, 11, cuda, dyadic)
    b = block_operand(5, 5, bk, bn, 0.5, 12, cuda, dyadic)
    plan = plan_bcsr(a, b, cache=False)
    assert plan.table_size == 8
    counts, _, _ = BK.row_classes(
        plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
        a.indices, table_size=plan.table_size, vector=False,
        block=(bm, bk, bn))
    per_class = counts.sum(1).tolist()
    assert sum(per_class[:lowest]) == 0 and per_class[-1] == 0
    assert sum(per_class) > 0
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.numeric_call(
        plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
        a.indices, a.blocks, b.indices, b.blocks, bcap_c=plan.bcap_c,
        table_size=plan.table_size, vector=False, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    check_bcsr(a, b, plan, bcol, blk, dyadic)


@pytest.mark.gpu
def test_bcsr_64x64_tile_shared_memory_table(cuda):
    """A 64x64 tile with a 4-slot table: a 4 x 4 block grid has at most 4
    block columns per row, each row's table and stage in one block's
    shared memory; bitwise equal to the plain version after a per-row
    sort (the kernel flushes in order of first appearance)."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    a = block_operand(4, 4, 64, 64, 0.6, 13, cuda)
    plan = plan_bcsr(a, a, cache=False)
    tsz = torch.full_like(plan.bin_tsize, 4)
    args = (plan.offsets, tsz, a.indptr, a.indptr, plan.indptr_cb,
            a.indices, a.blocks, a.indices, a.blocks)
    kw = dict(bcap_c=plan.bcap_c, table_size=4, vector=False)
    counts, _, _ = BK.row_classes(*args[:5], a.indices, table_size=4,
                                  vector=False, block=(64, 64, 64))
    assert int(counts[-1].sum()) == 0 and int(counts.sum()) > 0
    bcol, blk = BK.numeric_call(*args, **kw)
    pc, pb = bref.numeric_plain(*args, **kw)
    sc, sb = bref.sort_block_rows(plan.indptr_cb, bcol, blk)
    assert torch.equal(sc, pc) and torch.equal(sb, pb)


@pytest.mark.gpu
def test_plan_spgemm_bcsr_64x64_matches_plain_version(cuda):
    """plan_spgemm(algorithm="bcsr", block=(64, 64)) on CSR operands: one
    block-kernel launch; the CSR equals the plain version's and the sorted
    hash route's."""
    from repro_torch.core import bcsr_to_csr, plan_spgemm
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    a = bcsr_to_csr(block_operand(4, 4, 64, 64, 0.5, 14, cuda))
    plan = plan_spgemm(a, a, algorithm="bcsr", block=(64, 64), cache=False)
    bops.reset_kernel_calls()
    c = plan.execute(a, a)
    torch.cuda.synchronize()
    assert bops.kernel_call_counts()["numeric"] == 1
    assert bops.kernel_call_counts()["plain"] == 0
    h_a = CSR(a.indptr.cpu(), a.indices.cpu(), a.data.cpu(), a.nnz.cpu(),
              a.shape, a.sorted_cols)
    p = plan_spgemm(h_a, h_a, algorithm="bcsr", block=(64, 64),
                    cache=False).execute(h_a, h_a)
    for f in ("indptr", "indices", "data", "nnz"):
        assert torch.equal(getattr(c, f).cpu(), getattr(p, f)), f
    h = plan_spgemm(a, a, algorithm="hash", cache=False).execute(
        a, a, sorted_output=True)
    assert torch.equal(c.indptr, h.indptr) and torch.equal(c.indices,
                                                           h.indices)


def bcsr_value_fleet(cuda, g, bm, bk, bn, density, n, seed, dyadic):
    """A BCSR A and B on the card, ``plan_bcsr``'s operands, and ``n``
    members of new values on A's tiles (A's pattern kept)."""
    a = block_operand(g, g, bm, bk, density, seed, cuda, dyadic)
    b = block_operand(g, g, bk, bn, density, seed + 1, cuda, dyadic)
    rng = np.random.default_rng(seed + 2)
    shape = (n,) + tuple(a.blocks.shape)
    vals = rng.choice(DYADIC, size=shape) if dyadic else \
        rng.uniform(0.5, 1.5, size=shape)
    stack = torch.from_numpy(vals.astype(np.float32)).to(cuda)
    return a, b, stack * (a.blocks != 0)


def check_bcsr_fleet(a, b, plan, bcol, blk, pc, pb, dyadic):
    """Each member's kernel output against the batched plain version's:
    block columns per row bitwise after a per-row sort, tiles bitwise on
    dyadic values, else within (block pairs x bk) ulp."""
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    k = bref.products_per_block(a.indptr, b.indptr, plan.indptr_cb,
                                a.indices, b.indices, plan.bcap_c)
    for e in range(bcol.shape[0]):
        sc, sb = bref.sort_block_rows(plan.indptr_cb, bcol[e], blk[e])
        assert torch.equal(sc, pc[e]), e
        if dyadic:
            assert torch.equal(sb, pb[e]), e
            continue
        ulp = torch.nextafter(pb[e].abs(), torch.full_like(
            pb[e], float("inf"))) - pb[e].abs()
        bound = (k * a.block[1])[:, None, None] * ulp
        assert bool(((sb - pb[e]).abs() <= bound).all()), e


def fleet_class_launches(plan, block, n, batched):
    """``kernel.CLASS_CALLS`` of one fleet call on a plan's shared index
    arrays: one classification, one launch per class that can hold its
    items (``ref.launch_classes`` of its groups)."""
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    launched = bref.launch_classes(block, plan.table_size, plan.bcap_c, n,
                                   batched)
    return dict(dict.fromkeys(BK.CLASS_CALLS, 0), classify=1,
                **{BK.CLASS_NAMES[c]: 1 for c in launched})


BCSR_FLEET_CASES = [(8, 8, 8, 48, 0.2, True), (8, 8, 8, 48, 0.2, False),
                    (2, 3, 4, 40, 0.2, True), (64, 64, 64, 4, 0.6, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", BCSR_FLEET_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[5]}")
def test_bcsr_batched_kernel_matches_plain_version(cuda, case, vector):
    """The block kernel over a fleet (A's tiles stacked, everything else
    shared: rows of member groups) against ``batched_numeric_plain``; one
    call, one classification and one launch per class that can hold the
    fleet's items."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    bm, bk, bn, g, density, dyadic = case
    a, b, stack = bcsr_value_fleet(cuda, g, bm, bk, bn, density, 3, 30,
                                   dyadic)
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    args = (plan.offsets, plan.bin_tsize, a.indptr, b.indptr,
            plan.indptr_cb, a.indices, stack, b.indices, b.blocks)
    kw = dict(n_members=3, bcap_c=plan.bcap_c, table_size=plan.table_size,
              vector=vector)
    bops.reset_kernel_calls()
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.batched_numeric_call(*args, **kw, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    key = "batched_numeric_vector" if vector else "batched_numeric"
    counts = bops.kernel_call_counts()
    assert counts.pop(key) == 1
    assert set(counts.values()) == {0}
    assert BK.CLASS_CALLS == fleet_class_launches(plan, (bm, bk, bn), 3,
                                                  (True, False))
    pc, pb = bref.batched_numeric_plain(*args, **kw)
    check_bcsr_fleet(a, b, plan, bcol, blk, pc, pb, dyadic)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_bcsr_batched_kernel_global_memory_table(cuda, vector):
    """Members whose block rows need 900 output blocks in a 1,024-slot
    table of 8x8 tiles (past the largest block's shared memory): direct
    items of one member each, keys in the workspace of the block that
    runs them and tiles in each member's output, members not trampling
    each other."""
    from repro_torch.core import BCSR, plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    rng = np.random.default_rng(31)
    a = BCSR.from_dense(torch.from_numpy(rng.choice(DYADIC, (16, 8)).astype(
        np.float32)).to(cuda), (8, 8))
    b = BCSR.from_dense(torch.from_numpy(rng.choice(DYADIC, (8, 8 * 900))
                                         .astype(np.float32)).to(cuda),
                        (8, 8))
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    assert bref.row_bytes(1024, 900, 8, 8, 8) > bref.CLASS_SMEM[-1]
    stack = torch.from_numpy(rng.choice(DYADIC, (4,) + tuple(
        a.blocks.shape)).astype(np.float32)).to(cuda)
    args = (plan.offsets, plan.bin_tsize, a.indptr, b.indptr,
            plan.indptr_cb, a.indices, stack, b.indices, b.blocks)
    kw = dict(n_members=4, bcap_c=plan.bcap_c, table_size=plan.table_size,
              vector=vector)
    counts, items, _ = BK.batched_row_classes(
        *args, n_members=4, table_size=plan.table_size, vector=vector)
    direct = items[len(BK.CLASS_NAMES) - 1].cpu()
    assert int(counts.sum()) == 8 and direct.shape[0] == 8
    assert bool((direct[:, 1] == 1).all())
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    bcol, blk = BK.batched_numeric_call(*args, **kw)
    assert BK.CLASS_CALLS["direct"] == 1
    pc, pb = bref.batched_numeric_plain(*args, **kw)
    check_bcsr_fleet(a, b, plan, bcol, blk, pc, pb, True)


@pytest.mark.gpu
def test_bcsr_batched_shared_operand_equals_stacked_copy(cuda):
    """An operand passed once (member stride 0) and the same operand
    stacked per member give identical bits, raw (unsorted) outputs
    included: the probe order and every sum are the same."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    a, b, stack = bcsr_value_fleet(cuda, 40, 8, 8, 8, 0.2, 3, 32, False)
    plan = plan_bcsr(a, b, cache=False)
    shared = [plan.offsets, plan.bin_tsize, a.indptr, b.indptr,
              plan.indptr_cb, a.indices, stack, b.indices, b.blocks]
    stacked = [t if i == 6 else torch.stack([t] * 3).contiguous()
               for i, t in enumerate(shared)]
    kw = dict(n_members=3, bcap_c=plan.bcap_c, table_size=plan.table_size,
              vector=False)
    c1, b1 = BK.batched_numeric_call(*shared, **kw)
    c2, b2 = BK.batched_numeric_call(*stacked, **kw)
    assert torch.equal(c1, c2) and torch.equal(b1, b2)
    for e in range(3):
        c, blk = BK.numeric_call(*shared[:6], stack[e], *shared[7:],
                                 bcap_c=plan.bcap_c,
                                 table_size=plan.table_size, vector=False)
        assert torch.equal(c1[e], c) and torch.equal(b1[e], blk)


@pytest.mark.gpu
def test_bcsr_vmap_execute_launches_only_the_batched_kernel(cuda):
    """``torch.func.vmap`` of ``BCSRPlan.execute`` over A's tiles on CUDA:
    the rule's one kernel call (one classification, the class launches)
    and nothing else, each member bitwise equal to its own execute (the
    row code is the same)."""
    import dataclasses
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    a, b, stack = bcsr_value_fleet(cuda, 48, 8, 8, 8, 0.2, 4, 33, False)
    plan = plan_bcsr(a, b, cache=False)

    def one(x):
        c = plan.execute(dataclasses.replace(a, blocks=x), b)
        return c.indices, c.blocks

    bops.reset_kernel_calls()
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    bcol, blk = torch.func.vmap(one)(stack)
    torch.cuda.synchronize()
    counts = bops.kernel_call_counts()
    assert counts.pop("batched_numeric") == 1
    assert set(counts.values()) == {0}
    assert BK.CLASS_CALLS == fleet_class_launches(plan, (8, 8, 8), 4,
                                                  (True, False))
    for e in range(4):
        c = plan.execute(dataclasses.replace(a, blocks=stack[e]), b)
        assert torch.equal(bcol[e], c.indices)
        assert torch.equal(blk[e], c.blocks)


@pytest.mark.gpu
def test_bcsr_vmap_table_too_small_raises(cuda):
    """Tables of 8 slots for block rows of more block columns: the op
    raises under vmap, from the batched kernel's error count."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    a, b, stack = bcsr_value_fleet(cuda, 24, 8, 8, 8, 0.3, 2, 34, True)
    plan = plan_bcsr(a, b, cache=False)
    small = torch.full_like(plan.bin_tsize, 8)

    def one(x):
        return bops.numeric_op(plan.offsets, small, a.indptr, b.indptr,
                               plan.indptr_cb, a.indices, x, b.indices,
                               b.blocks, plan.bcap_c, 8, False)

    with pytest.raises(RuntimeError, match="full-table"):
        torch.func.vmap(one)(stack)


def ladder_operands(cuda, rungs, block, dyadic, seed=0):
    """``_bcsr_ladder``'s A and B as BCSRs on the card."""
    from repro_torch.core import BCSR
    (ai, ax, ab, ash), (bi, bx, bb, bsh) = _bcsr_ladder.ladder(
        rungs, block, dyadic, seed)
    a = BCSR.from_numpy(ai, ax, ab, ax.shape[0], ash, block[:2], device=cuda)
    b = BCSR.from_numpy(bi, bx, bb, bx.shape[0], bsh, block[1:],
                        device=cuda)
    return a, b


BCSR_LADDERS = {
    "8x8": (_bcsr_ladder.LADDER, (8, 8, 8), _bcsr_ladder.LADDER_CLASSES),
    "64x64": (_bcsr_ladder.LADDER_LARGE, (64, 64, 64),
              _bcsr_ladder.LADDER_LARGE_CLASSES)}


def check_bcsr_classes(a, b, plan, vector, block, want):
    """The classifying kernels against their plain version: counts per
    (class, A-block bucket), row tables, each class's rows (a set, in
    bucket order), and each rung's class ``want``."""
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    counts, rows, row_tsz = BK.row_classes(
        plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
        a.indices, table_size=plan.table_size, vector=vector, block=block)
    pc, prows, ptsz = bref.row_classes_plain(
        plan.offsets.cpu(), plan.bin_tsize.cpu(), a.indptr.cpu(),
        plan.indptr_cb.cpu(), table_size=plan.table_size, vector=vector,
        block=block)
    assert torch.equal(counts.cpu(), pc) and torch.equal(row_tsz.cpu(), ptsz)
    na = (a.indptr[1:] - a.indptr[:-1]).cpu()
    got = [-1] * (a.indptr.shape[0] - 1)
    for c, (r, pr) in enumerate(zip(rows, prows)):
        r = r.cpu()
        assert sorted(r.tolist()) == sorted(pr.tolist()), c
        assert torch.equal(bref.len_bucket(na[r.long()].clamp(min=1)),
                           bref.len_bucket(na[pr.long()].clamp(min=1))), c
        for i in r.tolist():
            got[i] = c
    assert got == list(want)


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", (True, False))
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("name", sorted(BCSR_LADDERS))
def test_bcsr_ladder_every_class(cuda, name, vector, dyadic):
    """``_bcsr_ladder``'s block rows reach every row class (8x8 tiles: the
    four shared-memory classes and direct, the G500 hub's shape in the
    largest staged class; 64x64: 225 KB and direct): the
    classifying kernels list them as the plain version does, the execute
    launches them once and each class that can hold rows once, and the
    product equals the plain version."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ops as bops
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    rungs, block, want = BCSR_LADDERS[name]
    a, b = ladder_operands(cuda, rungs, block, dyadic)
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    check_bcsr_classes(a, b, plan, vector, block, want)
    bops.reset_kernel_calls()
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    c = plan.execute(a, b)
    torch.cuda.synchronize()
    launched = bref.launch_classes(block, plan.table_size, plan.bcap_c)
    assert set(launched) >= {x for x in want if x >= 0}
    assert BK.CLASS_CALLS == dict(
        dict.fromkeys(BK.CLASS_CALLS, 0), classify=1,
        **{BK.CLASS_NAMES[x]: 1 for x in launched})
    key = "numeric_vector" if vector else "numeric"
    assert bops.kernel_call_counts()[key] == 1
    check_bcsr(a, b, plan, c.indices, c.blocks, dyadic)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_bcsr_hub_shaped_row(cuda, vector):
    """One block row of the G500 pattern's hub shape -- 245 A blocks (its
    B row bounds read in four windows), 666 output blocks, a 2,048-slot
    table -- alone, in the largest staged class, against the plain
    version on uniform values."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    a, b = ladder_operands(cuda, ((666, 245),), (8, 8, 8), False, seed=3)
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    assert int(plan.indptr_cb[-1]) == 666
    check_bcsr_classes(a, b, plan, vector, (8, 8, 8), (3,))
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.numeric_call(
        plan.offsets, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
        a.indices, a.blocks, b.indices, b.blocks, bcap_c=plan.bcap_c,
        table_size=plan.table_size, vector=vector, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    check_bcsr(a, b, plan, bcol, blk, False)


@pytest.mark.gpu
def test_bcsr_two_calls_bitwise(cuda):
    """Two calls, and the two probe modes, give the same bits on the
    8x8 ladder's uniform values, unsorted rows included: tiles are handed
    out in order of first appearance and summed in A-block order."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    a, b = ladder_operands(cuda, _bcsr_ladder.LADDER, (8, 8, 8), False)
    plan = plan_bcsr(a, b, cache=False)
    args = (plan.offsets, plan.bin_tsize, a.indptr, b.indptr,
            plan.indptr_cb, a.indices, a.blocks, b.indices, b.blocks)
    kw = dict(bcap_c=plan.bcap_c, table_size=plan.table_size)
    c1, b1 = BK.numeric_call(*args, **kw, vector=False)
    c2, b2 = BK.numeric_call(*args, **kw, vector=False)
    c3, b3 = BK.numeric_call(*args, **kw, vector=True)
    for c, blk in ((c2, b2), (c3, b3)):
        assert torch.equal(c, c1) and torch.equal(blk, b1)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_bcsr_batched_ladder(cuda, vector):
    """The kernel over 2 members of A's tiles on the 8x8 ladder: small
    rows in groups of both members, the larger ones a member an item, the
    900-block row direct, against the batched plain version."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    a, b = ladder_operands(cuda, _bcsr_ladder.LADDER, (8, 8, 8), True)
    plan = plan_bcsr(a, b, vector=vector, cache=False)
    rng = np.random.default_rng(40)
    stack = torch.from_numpy(rng.choice(DYADIC, (2,) + tuple(
        a.blocks.shape)).astype(np.float32)).to(cuda)
    args = (plan.offsets, plan.bin_tsize, a.indptr, b.indptr,
            plan.indptr_cb, a.indices, stack, b.indices, b.blocks)
    kw = dict(n_members=2, bcap_c=plan.bcap_c, table_size=plan.table_size,
              vector=vector)
    _, items, _ = BK.batched_row_classes(
        *args, n_members=2, table_size=plan.table_size, vector=vector)
    sizes = {int(x) for it in items for x in it[:, 1]}
    assert sizes == {1, 2} and items[-1].shape[0] == 2
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.batched_numeric_call(*args, **kw, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    pc, pb = bref.batched_numeric_plain(*args, **kw)
    check_bcsr_fleet(a, b, plan, bcol, blk, pc, pb, True)


def bcsr_ladder_fleet(cuda, n, layout, name, dyadic, vector):
    """``n`` members of ``_bcsr_ladder``'s rungs on the card, as the
    kernel's fleet arguments: ``stacked``, member e's columns and tiles
    from seed e, each with its own plan, every array stacked; ``shared``,
    member 0's structure and plan with ``n`` members of A's tiles.
    Returns ``(args, table_size, bcap_c)``."""
    from repro_torch.core import plan_bcsr
    rungs, block, _ = BCSR_LADDERS[name]
    pairs, plans = [], []
    for e in range(n if layout == "stacked" else 1):
        a, b = ladder_operands(cuda, rungs, block, dyadic, seed=e)
        pairs.append((a, b))
        plans.append(plan_bcsr(a, b, vector=vector, cache=False))
    table = max(p.table_size for p in plans)
    bcap_c = max(p.bcap_c for p in plans)
    if layout == "shared":
        (a, b), p = pairs[0], plans[0]
        rng = np.random.default_rng(50)
        shape = (n,) + tuple(a.blocks.shape)
        vals = rng.choice(DYADIC, shape) if dyadic else \
            rng.uniform(0.5, 1.5, shape)
        stack = torch.from_numpy(vals.astype(np.float32)).to(cuda)
        args = (p.offsets, p.bin_tsize, a.indptr, b.indptr, p.indptr_cb,
                a.indices, stack * (a.blocks != 0), b.indices, b.blocks)
        return args, table, bcap_c

    def stacked(f):
        return torch.stack([f(a, b, p) for (a, b), p in zip(pairs, plans)])

    args = tuple(stacked(f) for f in (
        lambda a, b, p: p.offsets, lambda a, b, p: p.bin_tsize,
        lambda a, b, p: a.indptr, lambda a, b, p: b.indptr,
        lambda a, b, p: p.indptr_cb, lambda a, b, p: a.indices,
        lambda a, b, p: a.blocks, lambda a, b, p: b.indices,
        lambda a, b, p: b.blocks))
    return args, table, bcap_c


def check_fleet_members(args, n, table, bcap_c, bcol, blk, dyadic):
    """Each member's kernel output against the batched plain version:
    block columns per row bitwise after a per-row sort, tiles bitwise on
    dyadic values, else within (block pairs x bk) ulp of the member's own
    product."""
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    pc, pb = bref.batched_numeric_plain(*args, n_members=n, bcap_c=bcap_c,
                                        table_size=table, vector=False)

    def member(t, e, dim=1):
        return t[e] if t.dim() > dim else t

    for e in range(n):
        off, bts, ia, ib, ic, ac, ablk, bc, bblk = (
            member(t, e, 3 if t.is_floating_point() else 1) for t in args)
        sc, sb = bref.sort_block_rows(ic, bcol[e], blk[e])
        assert torch.equal(sc, pc[e]), e
        if dyadic:
            assert torch.equal(sb, pb[e]), e
            continue
        k = bref.products_per_block(ia, ib, ic, ac, bc, bcap_c)
        ulp = torch.nextafter(pb[e].abs(), torch.full_like(
            pb[e], float("inf"))) - pb[e].abs()
        bound = (k * ablk.shape[-1])[:, None, None] * ulp
        assert bool(((sb - pb[e]).abs() <= bound).all()), e


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("shared", "stacked"))
@pytest.mark.parametrize("vector", (False, True))
def test_bcsr_fleet_classify_kernel_matches_plain(cuda, vector, layout):
    """The classifying kernels over 3 members of the 8x8 ladder's rungs
    against ``ref.batched_row_classes_plain``: counts per (class,
    A-block bucket), every member's row tables, each class's items
    ``(first member, members, row)`` as a set and in bucket order."""
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    args, table, _ = bcsr_ladder_fleet(cuda, 3, layout, "8x8", True,
                                       vector)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    counts, items, tsz = BK.batched_row_classes(
        *args, n_members=3, table_size=table, vector=vector, errors=errors)
    pc, pitems, ptsz = bref.batched_row_classes_plain(
        *(t.cpu() for t in args), n_members=3, table_size=table,
        vector=vector)
    assert int(errors) == 0
    assert torch.equal(counts.cpu(), pc) and torch.equal(tsz.cpu(), ptsz)
    ia = args[2].cpu()
    for c, (it, pit) in enumerate(zip(items, pitems)):
        it = it.cpu()
        assert sorted(map(tuple, it.tolist())) == \
            sorted(map(tuple, pit.tolist())), c
        ipa = [ia[f] if ia.dim() > 1 else ia for f in it[:, 0].tolist()]
        na = torch.tensor([int(x[i + 1] - x[i]) for x, i in
                           zip(ipa, it[:, 2].tolist())], dtype=torch.long)
        buckets = bref.len_bucket(na.clamp(min=1)).tolist()
        assert buckets == sorted(buckets, reverse=True), c


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", (True, False))
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("layout", ("shared", "stacked"))
@pytest.mark.parametrize("name", sorted(BCSR_LADDERS))
def test_bcsr_fleet_ladder_every_class(cuda, name, layout, vector, dyadic):
    """3 members of ``_bcsr_ladder``'s rungs (8x8 tiles: every class,
    the 900-block row direct; 64x64: 225 KB and direct) through the
    kernel, shared or stacked: one call, one classification and one
    launch per class that can hold the fleet's items, against the batched
    plain version; stacked, the items reach every class the ladder
    names."""
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    n = 3
    args, table, bcap_c = bcsr_ladder_fleet(cuda, n, layout, name, dyadic,
                                            vector)
    block = BCSR_LADDERS[name][1]
    want = {c for c in BCSR_LADDERS[name][2] if c >= 0}
    counts, _, _ = BK.batched_row_classes(*args, n_members=n,
                                          table_size=table, vector=vector)
    reached = {c for c in range(len(BK.CLASS_NAMES))
               if int(counts[c].sum())}
    if layout == "stacked":
        assert reached == want
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.batched_numeric_call(
        *args, n_members=n, bcap_c=bcap_c, table_size=table, vector=vector,
        errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    launched = bref.launch_classes(block, table, bcap_c,
                                   n if layout == "shared" else 1,
                                   (True, layout == "stacked"))
    assert reached <= set(launched)
    assert BK.CLASS_CALLS == dict(
        dict.fromkeys(BK.CLASS_CALLS, 0), classify=1,
        **{BK.CLASS_NAMES[c]: 1 for c in launched})
    check_fleet_members(args, n, table, bcap_c, bcol, blk, dyadic)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_bcsr_one_member_fleet_equals_numeric_call(cuda, vector):
    """A fleet of one member is the single product: bitwise equal to
    ``numeric_call``, raw (unsorted) outputs, on the 8x8 ladder's uniform
    values, with the same classification and class launches."""
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    args, table, bcap_c = bcsr_ladder_fleet(cuda, 1, "shared", "8x8",
                                            False, vector)
    kw = dict(bcap_c=bcap_c, table_size=table, vector=vector)
    single_args = args[:6] + (args[6][0],) + args[7:]
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    c1, b1 = BK.numeric_call(*single_args, **kw)
    calls = dict(BK.CLASS_CALLS)
    BK.CLASS_CALLS.update(dict.fromkeys(BK.CLASS_CALLS, 0))
    c2, b2 = BK.batched_numeric_call(*args, n_members=1, **kw)
    assert BK.CLASS_CALLS == calls
    assert torch.equal(c2[0], c1) and torch.equal(b2[0], b1)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ("shared", "stacked"))
def test_bcsr_fleet_table_too_small_raises(cuda, layout):
    """8-slot tables for block rows of more outputs: the fleet call
    raises without an ``errors`` tensor, and with one counts each
    (member, row) the table cannot hold: n times the single product's
    count."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    n = 3
    a, b, stack = bcsr_value_fleet(cuda, 24, 8, 8, 8, 0.3, n, 35, True)
    plan = plan_bcsr(a, b, cache=False)
    small = torch.full_like(plan.bin_tsize, 8)
    args = [plan.offsets, small, a.indptr, b.indptr, plan.indptr_cb,
            a.indices, stack, b.indices, b.blocks]
    if layout == "stacked":
        args = [t if i == 6 else torch.stack([t] * n).contiguous()
                for i, t in enumerate(args)]
    kw = dict(bcap_c=plan.bcap_c, table_size=8, vector=False)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    BK.numeric_call(plan.offsets, small, a.indptr, b.indptr, plan.indptr_cb,
                    a.indices, a.blocks, b.indices, b.blocks, **kw,
                    errors=one)
    every = torch.zeros(1, dtype=torch.int32, device=cuda)
    BK.batched_numeric_call(*args, n_members=n, **kw, errors=every)
    torch.cuda.synchronize()
    assert int(one) > 0 and int(every) == n * int(one)
    with pytest.raises(RuntimeError, match="full-table"):
        BK.batched_numeric_call(*args, n_members=n, **kw)


@pytest.mark.gpu
def test_bcsr_fleet_bins_past_the_rows(cuda):
    """A stacked member whose bins run past its block rows adds one error
    and runs none of its rows (its output stays zero); the other
    member's output is right."""
    from repro_torch.core import plan_bcsr
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    a, b, stack = bcsr_value_fleet(cuda, 24, 8, 8, 8, 0.3, 2, 36, True)
    plan = plan_bcsr(a, b, cache=False)
    off = torch.stack([plan.offsets, plan.offsets])
    off[1, -1] = a.grid[0] + 1
    args = (off, plan.bin_tsize, a.indptr, b.indptr, plan.indptr_cb,
            a.indices, stack, b.indices, b.blocks)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    bcol, blk = BK.batched_numeric_call(
        *args, n_members=2, bcap_c=plan.bcap_c, table_size=plan.table_size,
        vector=False, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 1
    assert not bcol[1].any() and not blk[1].any()
    pc, pb = bref.numeric_plain(plan.offsets, plan.bin_tsize, a.indptr,
                                b.indptr, plan.indptr_cb, a.indices,
                                stack[0], b.indices, b.blocks,
                                bcap_c=plan.bcap_c,
                                table_size=plan.table_size, vector=False)
    sc, sb = bref.sort_block_rows(plan.indptr_cb, bcol[0], blk[0])
    assert torch.equal(sc, pc) and torch.equal(sb, pb)


def spmm_operand(cuda, skewed=False, seed=21):
    """G500 s10 with signed uniform values; ``skewed`` adds one row of
    5,000 nonzeros (with repeated columns)."""
    rng = np.random.default_rng(seed)
    rows, cols = rmat.rmat_edges(10, 8, "G500", seed=seed)
    if skewed:
        rows = np.concatenate([rows, np.full(5000, 7)])
        cols = np.concatenate([cols, rng.integers(0, 1024, 5000)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(1025, np.int64)
    np.cumsum(np.bincount(rows, minlength=1024), out=indptr[1:])
    vals = rng.uniform(-1, 1, rows.shape[0]).astype(np.float32)
    return CSR.from_numpy(indptr, cols, vals, rows.shape[0], (1024, 1024),
                          device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16),
                         ids=("f32", "bf16", "f16"))
@pytest.mark.parametrize("k", (1, 8, 64, 100, 300))
@pytest.mark.parametrize("skewed", (False, True), ids=("rmat", "skewed"))
def test_spmm_kernel_matches_plain_version(cuda, skewed, k, dtype):
    """Bitwise, on signed values: the kernel and the plain version round
    each product and each add alike, in each row's order."""
    from repro_torch.kernels.spmm import kernel as SK
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    a = spmm_operand(cuda, skewed)
    x = torch.from_numpy(np.random.default_rng(k).uniform(
        -1, 1, (1024, k)).astype(np.float32)).to(cuda).to(dtype)
    sops.reset_kernel_calls()
    y = sops.spmm_kernel(a, x)
    torch.cuda.synchronize()
    assert SK.KERNEL_CALLS == {"spmm": 1, "classify": 1, "plain": 0}
    assert y.dtype == dtype and tuple(y.shape) == (1024, k)
    want = sref.spmm_plain(a.indptr, a.indices, a.data, x, a.nnz)
    assert torch.equal(y, want)


@pytest.mark.gpu
def test_spmm_padding_and_front_door(cuda):
    """Slots past nnz count as 0; ``core.spmm`` launches the kernel once
    per call (and the classifying kernel once per CSR); the dense BFS
    launches it once per hop, classifies once, and agrees with the masked
    BFS."""
    from repro_torch.core import spmm
    from repro_torch.data.rmat import symmetrize
    from repro_torch.examples import graph_analytics as ga
    from repro_torch.kernels.spmm import ops as sops
    a = spmm_operand(cuda)
    pad = CSR(a.indptr, torch.cat([a.indices, a.indices[:9]]),
              torch.cat([a.data, torch.full((9,), 5.0, device=cuda)]),
              a.nnz, a.shape)
    x = torch.rand((1024, 16), device=cuda)
    sops.reset_kernel_calls()
    assert torch.equal(spmm(pad, x), spmm(a, x))
    assert sops.kernel_call_counts() == {"spmm": 2, "classify": 2,
                                         "plain": 0}
    g = symmetrize(rmat.rmat_csr(8, 8, "G500", seed=1, device=cuda),
                   device=cuda)
    sops.reset_kernel_calls()
    dense = ga.multi_source_bfs(g, [0, 17, 42, 100], 6)
    assert sops.kernel_call_counts() == {"spmm": 6, "classify": 1,
                                         "plain": 0}
    assert torch.equal(dense, ga.multi_source_bfs_masked(
        g, [0, 17, 42, 100], 6))


def spmm_ladder(cuda, values="signed", seed=0):
    """``_spmm_ladder``'s CSR on the card: a row at every length-class
    edge, to 20,000 nonzeros with repeated columns."""
    indptr, indices, data, shape, _ = _spmm_ladder.ladder(values, seed)
    return CSR.from_numpy(indptr, indices, data, len(indices), shape,
                          sorted_cols=False, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16),
                         ids=("f32", "bf16", "f16"))
@pytest.mark.parametrize("k", (1, 8, 64, 100, 300))
def test_spmm_ladder_every_class_and_copy_path(cuda, k, dtype):
    """The ladder on signed values, bitwise against the plain version:
    the classifying kernel puts rows in every class (its lists equal the
    plain classifier's), one SpMM launch takes them all, and the launch
    brought the long rows' X rows in by bulk copies where X's rows are a
    multiple of 16 bytes, else through registers."""
    from repro_torch.kernels.spmm import kernel as SK
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    a = spmm_ladder(cuda, seed=k)
    x = torch.from_numpy(np.random.default_rng(k).uniform(
        -1, 1, (a.n_cols, k)).astype(np.float32)).to(cuda).to(dtype)
    sops.reset_kernel_calls()
    y = sops.spmm_kernel(a, x)
    torch.cuda.synchronize()
    assert SK.KERNEL_CALLS == {"spmm": 1, "classify": 1, "plain": 0}
    row = k * x.element_size()
    path = "bulk" if row % 16 == 0 else "register"
    assert SK.COPY_PATHS == {"bulk": 0, "register": 0, path: 1}
    assert y.dtype == dtype and tuple(y.shape) == (a.n_rows, k)
    assert torch.equal(y, sref.spmm_plain(a.indptr, a.indices, a.data, x,
                                          a.nnz))
    counts, rows = SK.row_classes(a.indptr, a.nnz, a.cap)
    want_counts, want_rows = sref.row_classes_plain(a.indptr, a.nnz, a.cap)
    assert torch.equal(counts, want_counts)
    assert all(int(c) > 0 for c in counts)
    for r, w in zip(rows, want_rows):
        assert torch.equal(torch.sort(r).values, w)


@pytest.mark.gpu
@pytest.mark.parametrize(("dtype", "offset"), [
    (torch.float32, 4), (torch.bfloat16, 4), (torch.bfloat16, 2)],
    ids=("f32-4", "bf16-4", "bf16-2"))
def test_spmm_unaligned_x_skips_bulk_copies(cuda, dtype, offset):
    """X at a 4- or 2-byte offset (k 64): not 16-byte aligned, so the long
    rows' X rows come through registers, and the short rows load 4 or 2
    bytes a lane; bitwise against the plain version."""
    from repro_torch.kernels.spmm import kernel as SK
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    a = spmm_ladder(cuda, seed=3)
    n, k = a.n_cols, 64
    off = offset // torch.tensor([], dtype=dtype).element_size()
    buf = torch.empty(n * k + off, dtype=dtype, device=cuda)
    x = buf[off:].view(n, k)
    x.copy_(torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (n, k)).astype(np.float32)).to(dtype))
    assert x.data_ptr() % 16 == offset and x.is_contiguous()
    assert not SK.bulk_copies(k, x.element_size(), x.data_ptr())
    assert SK.vector_width(k, x.element_size(), x.data_ptr()) \
        * x.element_size() == offset
    sops.reset_kernel_calls()
    y = sops.spmm_kernel(a, x)
    torch.cuda.synchronize()
    assert SK.COPY_PATHS == {"bulk": 0, "register": 1}
    assert torch.equal(y, sref.spmm_plain(a.indptr, a.indices, a.data, x,
                                          a.nnz))


@pytest.mark.gpu
def test_spmm_row_classes_are_memoized(cuda):
    """A second call on one CSR classifies nothing; a write in place to
    ``indptr`` or ``nnz`` classifies again, and the product follows the
    new structure."""
    from repro_torch.core import spmm
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    a = spmm_ladder(cuda, seed=5)
    x = torch.rand((a.n_cols, 64), device=cuda)
    sops.reset_kernel_calls()
    spmm(a, x)
    y = spmm(a, x)
    assert sops.kernel_call_counts() == {"spmm": 2, "classify": 1,
                                         "plain": 0}
    assert torch.equal(y, sref.spmm_plain(a.indptr, a.indices, a.data, x,
                                          a.nnz))
    # row 0 (empty) takes row 1's slots; row 1 becomes empty
    a.indptr[1] = a.indptr[2]
    y = spmm(a, x)
    assert sops.kernel_call_counts() == {"spmm": 3, "classify": 2,
                                         "plain": 0}
    assert torch.equal(y, sref.spmm_plain(a.indptr, a.indices, a.data, x,
                                          a.nnz))
    # a live length that cuts the 20,000-nonzero row (the last rung, before
    # the last three short rows) to 300
    a.nnz.fill_(int(a.indptr[-5]) + 300)
    y = spmm(a, x)
    assert sops.kernel_call_counts() == {"spmm": 4, "classify": 3,
                                         "plain": 0}
    assert torch.equal(y, sref.spmm_plain(a.indptr, a.indices, a.data, x,
                                          a.nnz))
    counts, _ = sref.row_classes_plain(a.indptr, a.nnz, a.cap)
    assert int(counts[-1]) == 1          # 8,193 left; 20,000 cut to 300
    y = spmm(a, x)
    assert sops.kernel_call_counts()["classify"] == 3


@pytest.mark.gpu
def test_spmm_wrapper_rejects_bad_operands(cuda):
    from repro_torch.kernels.spmm import kernel as SK
    a = spmm_operand(cuda)
    x = torch.rand((1024, 8), device=cuda)
    args = (a.indptr, a.indices, a.data, x, a.nnz)
    with pytest.raises(ValueError):              # float64 X
        SK.spmm_call(*args[:3], x.double(), a.nnz)
    with pytest.raises(ValueError):              # int64 column ids
        SK.spmm_call(a.indptr, a.indices.long(), *args[2:])
    with pytest.raises(ValueError):              # operands on two devices
        SK.spmm_call(a.indptr.cpu(), *args[1:])
    with pytest.raises(ValueError):              # non-contiguous X
        SK.spmm_call(*args[:3], x.t().contiguous().t(), a.nnz)
    with pytest.raises(ValueError):              # nnz not 0-dim
        SK.spmm_call(*args[:4], a.nnz.reshape(1))


# ---------------------------------------------------------------------------
# The batched numeric kernel (a fleet of products, core.batch)
# ---------------------------------------------------------------------------

def wide_operands(cuda, width):
    """A (2, 4) and B (4, width) whose row 0 product has ~0.6 * width
    distinct columns: a table past ``K.SMEM_SLOTS`` for width 40,000."""
    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(4), width // 6)
    cols = np.concatenate([rng.choice(width, width // 6, replace=False)
                           for _ in range(4)])
    b = CSR.from_numpy_coo(rows, cols, rng.choice(DYADIC, rows.shape[0]),
                           (4, width), device=cuda)
    a = CSR.from_numpy_coo([0, 0, 0, 0, 1], [0, 1, 2, 3, 2],
                           rng.choice(DYADIC, 5), (2, 4), device=cuda)
    return a, b


def fleet_args(pairs, shared_b):
    """The batched kernel's arguments for a fleet: each member's own
    schedule (``ops.hash_schedule``) and ``indptr_c``, the operands padded
    and stacked as the batched planner does (B passed once if shared)."""
    from repro_torch.core.batch import _stack_csr, _stack_index
    m = max(a.n_rows for a, _ in pairs)
    k = max(a.n_cols for a, _ in pairs)
    n = max(b.n_cols for _, b in pairs)
    offs, sizes, ics, tables = [], [], [], []
    for a, b in pairs:
        off, tsz, table = ops.hash_schedule(a, b, n_bins=8)
        rows = ref.symbolic_plain(off, tsz, a.indptr, b.indptr, a.indices,
                                  a.data, b.indices, b.data,
                                  table_size=table, vector=False)
        ic = prefix_sum(rows).to(torch.int32)
        ics.append(torch.cat([ic, ic[-1:].expand(m + 1 - ic.shape[0])]))
        offs.append(off)
        sizes.append(tsz)
        tables.append(table)
    a_ops = [a for a, _ in pairs]
    a_st = _stack_csr(a_ops, k, True, _stack_index(
        a_ops, m, max(x.cap for x in a_ops)))
    if shared_b:
        b_st = pairs[0][1]
    else:
        b_ops = [b for _, b in pairs]
        b_st = _stack_csr(b_ops, n, True, _stack_index(
            b_ops, k, max(x.cap for x in b_ops)))
    ic = torch.stack(ics)
    cap_c = int(ic[:, -1].max()) + 3
    args = (torch.stack(offs), torch.stack(sizes), a_st.indptr, b_st.indptr,
            ic, a_st.indices, a_st.data, b_st.indices, b_st.data)
    return args, cap_c, max(tables)


def fleet_classes(offsets, bin_tsize, n, table, n_rows, vector, above=0):
    """The table classes a batched call launches on this schedule (stacked
    or shared): every class up to its largest bin table's (``above``: the
    symbolic phase's ``ref.bitmap_above``)."""
    rows = [offsets.tolist()] * n if offsets.dim() == 1 \
        else offsets.tolist()
    sizes = [bin_tsize.tolist()] * n if bin_tsize.dim() == 1 \
        else bin_tsize.tolist()
    return K.launch_classes(K.fleet_table(rows, sizes, table, n_rows,
                                          vector), above)


def check_batched(pairs, args, cols, vals, pc, pv):
    """Per member: row pointers, sorted column sets and (dyadic) values
    bitwise equal to the plain version; the tail past nnz zero."""
    ic = args[4]
    for e, (a, b) in enumerate(pairs):
        ipc = ic[e, :a.n_rows + 1]
        nnz = int(ipc[-1])
        s = CSR(ipc, cols[e], vals[e], ipc[-1], (a.n_rows, b.n_cols),
                False).sort_rows()
        assert torch.equal(s.indices[:nnz], pc[e, :nnz])
        assert torch.equal(s.data[:nnz], pv[e, :nnz])
        assert bool((cols[e, nnz:] == 0).all())
        assert bool((vals[e, nnz:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shared_b", (False, True), ids=("stacked",
                                                          "shared"))
@pytest.mark.parametrize("vector", (False, True))
def test_batched_kernel_matches_plain_version(cuda, vector, shared_b):
    b_shared = operand("ER", 9, 8, True, cuda)
    pairs = []
    for i, (preset, scale, ef) in enumerate(
            (("ER", 9, 4), ("G500", 9, 8), ("ER", 8, 2), ("G500", 9, 2))):
        a = rmat.rmat_csr(scale, ef, preset, seed=20 + i, device=cuda)
        a = CSR(a.indptr, a.indices, torch.from_numpy(
            np.random.default_rng(i).choice(DYADIC, a.cap)).to(cuda),
            a.nnz, a.shape)
        if scale < 9:       # a narrower A: padded to the fleet's shape
            b = operand("ER", scale, 8, True, cuda)
        else:
            b = b_shared if shared_b else operand("G500", 9, 4 + i, True,
                                                  cuda)
        pairs.append((a, b))
    if shared_b:
        pairs = [(a, b_shared) for a, _ in pairs if a.n_cols == 512]
    args, cap_c, table = fleet_args(pairs, shared_b)
    kw = dict(n_members=len(pairs), cap_c=cap_c, table_size=table,
              vector=vector)
    ops.reset_kernel_calls()
    reset_class_calls()
    cols, vals = K.batched_numeric_call(*args, **kw)
    torch.cuda.synchronize()
    key = "batched_numeric_vector" if vector else "batched_numeric"
    want = len(fleet_classes(args[0], args[1], len(pairs), table,
                             args[4].shape[1] - 1, vector))
    counts = ops.kernel_call_counts()
    assert counts.pop(key) == want and 0 < want <= 8
    assert set(counts.values()) == {0}
    assert K.CLASS_CALLS["classify"] == 1
    pc, pv = ref.batched_numeric_plain(*args, **kw)
    check_batched(pairs, args, cols, vals, pc, pv)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_batched_kernel_member_past_smem(cuda, vector):
    """One member's table past SMEM_SLOTS (a cluster table) in the same
    launches as members whose tables stay in one block's shared
    memory."""
    a_w, b_w = wide_operands(cuda, 40000)
    small = []
    for i in range(3):
        # A's pattern of the wide member, so the bins line up with its
        a = CSR.from_numpy_coo([0, 0, 0, 0, 1], [0, 1, 2, 3, 2],
                               np.resize(DYADIC, 5), (2, 4), device=cuda)
        b = CSR.from_numpy_coo(np.repeat(np.arange(4), 2),
                               np.arange(8) * (i + 7), np.resize(DYADIC, 8),
                               (4, 40000), device=cuda)
        small.append((a, b))
    pairs = [small[0], (a_w, b_w), small[1], small[2]]
    args, cap_c, table = fleet_args(pairs, False)
    assert args[1][1].max() > K.SMEM_SLOTS >= args[1][[0, 2, 3]].max()
    kw = dict(n_members=len(pairs), cap_c=cap_c, table_size=table,
              vector=vector)
    launches = fleet_classes(args[0], args[1], len(pairs), table,
                             args[4].shape[1] - 1, vector)
    check_member_classes(args, len(pairs), table, True)
    ops.reset_kernel_calls()
    cols, vals = K.batched_numeric_call(*args, **kw)
    torch.cuda.synchronize()
    key = "batched_numeric_vector" if vector else "batched_numeric"
    assert ops.kernel_call_counts()[key] == len(launches)
    pc, pv = ref.batched_numeric_plain(*args, **kw)
    check_batched(pairs, args, cols, vals, pc, pv)


def check_classify(args, n, table, numeric, n_cols=WIDE):
    """The batched classifying kernel on a fleet's arguments (as
    :func:`fleet_args` lays them out) equals its plain version: counts,
    each pair's table, each class's pairs (in no order on the card);
    ``n_cols``: B's width for the symbolic phase.  Returns the plain
    version's ``(counts, pairs, row_tsz)``."""
    ic = args[4] if numeric else None
    errors = torch.zeros(1, dtype=torch.int32, device=args[5].device)
    got = K.batched_row_classes(*args[:4], ic, args[5], n_members=n,
                                table_size=table, numeric=numeric,
                                errors=errors, n_cols=n_cols)
    want = ref.batched_row_classes_plain(
        *(x.cpu() for x in args[:4]), None if ic is None else ic.cpu(),
        args[5].cpu(), n_members=n, table_size=table, numeric=numeric,
        n_cols=n_cols)
    assert int(errors) == 0
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    for g, w in zip(got[1], want[1]):
        assert sorted(g.tolist()) == w.tolist()
    return want


def check_member_classes(args, n, table, numeric):
    """The fleet of :func:`test_batched_kernel_member_past_smem`: the
    classifying kernel equals its plain version, member 1's first row on
    a cluster (past SMEM_SLOTS), every other member's rows in one block's
    shared memory."""
    want = check_classify(args, n, table, numeric)
    big = [c for c, p in enumerate(want[1]) if [1, 0] in p.tolist()]
    assert big and 3 <= big[0] < len(K.CLASS_NAMES) - 1
    assert all(e == 1 or c <= 2 for c, p in enumerate(want[1])
               for e, _ in p.tolist())


@pytest.mark.gpu
def test_batched_kernel_table_too_small_raises(cuda):
    pairs = [wide_operands(cuda, 600), wide_operands(cuda, 600)]
    args, cap_c, _ = fleet_args(pairs, True)
    small = torch.full_like(args[1], 8)
    with pytest.raises(RuntimeError, match="full-table"):
        K.batched_numeric_call(args[0], small, *args[2:], n_members=2,
                               cap_c=cap_c, table_size=8, vector=False)
    with pytest.raises(ValueError):              # float64 values
        K.batched_numeric_call(*args[:6], args[6].double(), *args[7:],
                               n_members=2, cap_c=cap_c, table_size=8,
                               vector=False)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ("auto", "hash_vector"))
def test_planned_batch_launches_only_the_batched_kernel(cuda, algorithm):
    """``plan_batch(...).execute`` on the card: per hash class one
    classifying launch and one launch per table class its largest table
    allows, nothing else; each member equal to the per-product planned
    loop (dyadic values: bitwise after a row sort)."""
    from repro_torch.core import plan_batch, plan_spgemm
    pairs = []
    for i in range(12):
        a = operand("G500" if i % 2 else "ER", 8, 1 + i % 3, True, cuda)
        b = operand("ER", 8, 1 + (i + 1) % 4, True, cuda)
        pairs.append((a, b))
    plan = plan_batch(pairs, algorithm=algorithm, cache=False)
    vector = algorithm == "hash_vector"
    key = "batched_numeric_vector" if vector else "batched_numeric"
    want = sum(len(K.launch_classes(c.hash_largest)) for c in plan.classes)
    assert all(c.hash_sched is not None for c in plan.classes)
    assert all(c.hash_largest == K.fleet_table(
        *c.hash_host, c.table_size, c.shape_a[0], vector)
        for c in plan.classes)
    ops.reset_kernel_calls()
    reset_class_calls()
    outs = plan.execute(pairs)
    torch.cuda.synchronize()
    counts = ops.kernel_call_counts()
    assert counts.pop(key) == want <= 8 * plan.n_classes
    assert set(counts.values()) == {0}
    assert K.CLASS_CALLS["classify"] == plan.n_classes
    for i, ((a, b), c) in enumerate(zip(pairs, outs)):
        r = plan_spgemm(a, b, algorithm=plan.algorithms[i],
                        cache=False).execute(a, b)
        assert torch.equal(c.indptr, r.indptr) and int(c.nnz) == int(r.nnz)
        s, t = c.sort_rows(), r.sort_rows()
        nnz = int(c.nnz)
        assert torch.equal(s.indices[:nnz], t.indices[:nnz])
        assert torch.equal(s.data[:nnz], t.data[:nnz])


def symbolic_args(args):
    """:func:`fleet_args`' arguments without ``indptr_c``: the batched
    symbolic kernel's."""
    return args[:4] + args[5:]


def check_batched_symbolic(args, n, table, vector, n_cols=WIDE,
                           launches=None):
    """The batched symbolic kernels on ``args`` (each stacked or shared)
    with B's width ``n_cols`` launch once to classify and once per class
    the schedule's largest table allows, and give bitwise the batched
    plain version's counts; returns them."""
    kw = dict(n_members=n, table_size=table, vector=vector)
    if launches is None:
        launches = fleet_classes(args[0], args[1], n, table,
                                 args[2].shape[-1] - 1, vector,
                                 ref.bitmap_above(n_cols))
    ops.reset_kernel_calls()
    reset_class_calls()
    got = K.batched_symbolic_call(*args, **kw, n_cols=n_cols)
    torch.cuda.synchronize()
    counts = ops.kernel_call_counts()
    key = "batched_symbolic_vector" if vector else "batched_symbolic"
    assert counts.pop(key) == len(launches) > 0
    assert set(counts.values()) == {0}
    assert K.CLASS_CALLS["classify"] == 1
    assert torch.equal(got, ref.batched_symbolic_plain(*args, **kw))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shared_b", (False, True), ids=("stacked",
                                                          "shared"))
@pytest.mark.parametrize("vector", (False, True))
def test_batched_symbolic_kernel_matches_plain_version(cuda, vector,
                                                       shared_b):
    """The batched symbolic kernel over a fleet of different structures
    (stacked schedules and A's, B stacked or shared, shared-memory
    tables): every member's row counts bitwise equal to the batched plain
    version and to the symbolic counts behind its ``indptr_c``."""
    b_shared = operand("ER", 9, 8, True, cuda)
    pairs = [(operand(p, 9, ef, True, cuda),
              b_shared if shared_b else operand("G500", 9, 4 + i, True,
                                                cuda))
             for i, (p, ef) in enumerate((("ER", 4), ("G500", 8),
                                          ("G500", 2)))]
    args, _, table = fleet_args(pairs, shared_b)
    rows = check_batched_symbolic(symbolic_args(args), len(pairs), table,
                                  vector)
    assert torch.equal(rows, args[4][:, 1:] - args[4][:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_batched_symbolic_kernel_member_past_smem(cuda, vector):
    """One member's table past SMEM_SLOTS (a cluster table) in the same
    launches as members whose tables stay in one block's shared
    memory."""
    a_w, b_w = wide_operands(cuda, 40000)
    small = []
    for i in range(3):
        a = CSR.from_numpy_coo([0, 0, 0, 0, 1], [0, 1, 2, 3, 2],
                               np.resize(DYADIC, 5), (2, 4), device=cuda)
        b = CSR.from_numpy_coo(np.repeat(np.arange(4), 2),
                               np.arange(8) * (i + 7), np.resize(DYADIC, 8),
                               (4, 40000), device=cuda)
        small.append((a, b))
    pairs = [small[0], (a_w, b_w), small[1], small[2]]
    args, _, table = fleet_args(pairs, False)
    launches = fleet_classes(args[0], args[1], len(pairs), table,
                             args[4].shape[1] - 1, vector)
    check_member_classes(args, len(pairs), table, False)
    rows = check_batched_symbolic(symbolic_args(args), len(pairs), table,
                                  vector, launches=launches)
    assert torch.equal(rows, args[4][:, 1:] - args[4][:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_batched_symbolic_one_member_equals_single_kernel(cuda, case,
                                                          vector):
    """At one member with every argument shared (stride 0), the batched
    symbolic kernel gives bitwise the single kernel's counts (G500 s12:
    global-memory tables)."""
    a = operand(*case, cuda)
    off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
    args = (off, tsz, a.indptr, a.indptr, a.indices, a.data, a.indices,
            a.data)
    single = K.symbolic_call(*args, table_size=table, vector=vector,
                             n_cols=WIDE)
    rows = check_batched_symbolic(args, 1, table, vector)
    assert rows.shape == (1, a.n_rows)
    assert torch.equal(rows[0], single)


def value_fleet(cuda, n, seed):
    """A hash plan on a G500 s10 square and ``n`` dyadic members of A's
    values, ``(n, cap)``, zero past nnz."""
    from repro_torch.core import plan_spgemm
    a = operand("G500", 10, 16, True, cuda)
    plan = plan_spgemm(a, a, algorithm="hash", cache=False)
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.choice(DYADIC, (n, a.cap))).to(cuda)
    return a, plan, vals * a.valid_mask()


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ("shared", "stacked"))
@pytest.mark.parametrize("vector", (False, True))
def test_batched_kernels_with_plan_schedule(cuda, vector, schedule):
    """A value fleet on one plan: the schedule (and ``indptr_c``) shared,
    stride 0, or stacked per member, A's values stacked, B shared.  The
    symbolic counts equal the plan's; the numeric kernel with a shared
    schedule equals the stacked-schedule call bitwise (rows sorted,
    dyadic values), and the batched plain version."""
    a, plan, vals = value_fleet(cuda, 3, 30)
    n = vals.shape[0]
    sched = [plan.offsets, plan.bin_tsize, plan.indptr_c]
    if schedule == "stacked":
        sched = [torch.stack([t] * n) for t in sched]
    off, tsz, ic = sched
    table = plan.table_size
    rows = check_batched_symbolic((off, tsz, a.indptr, a.indptr, a.indices,
                                   vals, a.indices, a.data), n, table,
                                  vector, a.n_cols)
    assert torch.equal(rows, plan.row_nnz_c.expand(n, -1))
    kw = dict(n_members=n, cap_c=plan.cap_c, table_size=table,
              vector=vector)
    num = (off, tsz, a.indptr, a.indptr, ic, a.indices, vals, a.indices,
           a.data)
    cols, out = K.batched_numeric_call(*num, **kw)
    stacked = [torch.stack([t] * n) for t in (plan.offsets, plan.bin_tsize,
                                              plan.indptr_c)]
    cols_s, out_s = K.batched_numeric_call(stacked[0], stacked[1],
                                           *num[2:4], stacked[2], *num[5:],
                                           **kw)
    pc, pv = ref.batched_numeric_plain(*num, **kw)
    for e in range(n):
        got = CSR(plan.indptr_c, cols[e], out[e], plan.indptr_c[-1], a.shape,
                  False).sort_rows()
        want = CSR(plan.indptr_c, cols_s[e], out_s[e], plan.indptr_c[-1],
                   a.shape, False).sort_rows()
        assert torch.equal(got.indices, want.indices), e
        assert torch.equal(got.data, want.data), e
        assert torch.equal(got.indices, pc[e]), e
        assert torch.equal(got.data, pv[e]), e


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ("hash", "hash_vector"))
def test_hash_vmap_launches_only_the_batched_kernels(cuda, algorithm):
    """``torch.func.vmap`` on CUDA: the plan's execute launches only the
    batched numeric kernels, one classifying launch and one per table
    class its largest table allows; the planless ``spgemm_hash`` with the
    plan's schedule pinned launches the batched symbolic and numeric
    kernels as often each; no single-product kernel, no plain version.
    Each member bitwise equal to its own execute (rows sorted, dyadic
    values)."""
    import dataclasses
    from repro_torch.core import plan_spgemm
    a, _, vals = value_fleet(cuda, 4, 31)
    plan = plan_spgemm(a, a, algorithm=algorithm, cache=False)
    vector = algorithm == "hash_vector"
    n_launches = len(fleet_classes(plan.offsets, plan.bin_tsize, 1,
                                   plan.table_size, a.n_rows, vector))
    sfx = "_vector" if vector else ""

    def planned(v):
        c = plan.execute(dataclasses.replace(a, data=v), a)
        return c.indices, c.data

    def planless(v):
        c = ops.spgemm_hash(dataclasses.replace(a, data=v), a, plan.cap_c,
                            vector=vector, table_size=plan.table_size,
                            schedule=(plan.offsets, plan.bin_tsize))
        return c.indptr, c.indices, c.data

    ops.reset_kernel_calls()
    reset_class_calls()
    cols, data = torch.func.vmap(planned)(vals)
    torch.cuda.synchronize()
    counts = ops.kernel_call_counts()
    assert counts.pop(f"batched_numeric{sfx}") == n_launches > 0
    assert set(counts.values()) == {0}
    assert K.CLASS_CALLS["classify"] == 1
    ops.reset_kernel_calls()
    reset_class_calls()
    ip2, cols2, data2 = torch.func.vmap(planless)(vals)
    torch.cuda.synchronize()
    counts = ops.kernel_call_counts()
    assert counts.pop(f"batched_numeric{sfx}") == n_launches
    assert counts.pop(f"batched_symbolic{sfx}") == n_launches
    assert set(counts.values()) == {0}
    assert K.CLASS_CALLS["classify"] == 2
    assert torch.equal(ip2, plan.indptr_c.expand_as(ip2))
    for e in range(vals.shape[0]):
        one = plan.execute(dataclasses.replace(a, data=vals[e]),
                           a).sort_rows()
        for c, d in ((cols, data), (cols2, data2)):
            got = CSR(plan.indptr_c, c[e], d[e], plan.indptr_c[-1], a.shape,
                      False).sort_rows()
            assert torch.equal(got.indices, one.indices), e
            assert torch.equal(got.data, one.data), e


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_batched_symbolic_table_too_small_raises(cuda, vector):
    """A table of CHUNK slots for 2 * CHUNK distinct columns: the batched
    symbolic kernel's ``errors`` count makes its wrapper raise, and so
    does the planless ``spgemm_hash`` under vmap with that schedule."""
    import dataclasses
    d = 2 * K.CHUNK
    a = CSR.from_numpy_coo([0], [0], np.ones(1, np.float32), (1, 1),
                           device=cuda)
    b = CSR.from_numpy_coo(np.zeros(d, np.int64), np.arange(d),
                           DYADIC[np.arange(d) % 4], (1, d), device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([K.CHUNK], dtype=torch.int32, device=cuda)
    vals = torch.ones(2, 1, device=cuda)
    with pytest.raises(RuntimeError, match="full-table"):
        K.batched_symbolic_call(off, tsz, a.indptr, b.indptr, a.indices,
                                vals, b.indices, b.data, n_members=2,
                                table_size=K.CHUNK, vector=vector,
                                n_cols=b.n_cols)
    with pytest.raises(RuntimeError, match="full-table"):
        torch.func.vmap(lambda v: ops.spgemm_hash(
            dataclasses.replace(a, data=v), b, d, vector=vector,
            table_size=K.CHUNK, schedule=(off, tsz)).data)(vals)



@pytest.mark.gpu
@pytest.mark.parametrize("numeric", (True, False), ids=("numeric",
                                                        "symbolic"))
@pytest.mark.parametrize("layout", ("stacked", "shared"))
def test_batched_classify_matches_plain_version(cuda, layout, numeric):
    """The batched classifying kernel against its plain version: a fleet
    of R-MAT products with their own stacked schedules, and a value fleet
    whose schedule, ``indptr_c`` and index arrays every member shares
    (stride 0), whose G500 s12 rows reach the 16,384-slot class."""
    if layout == "stacked":
        pairs = [(operand(p, s, ef, True, cuda), operand("ER", s, 8, True,
                                                         cuda))
                 for p, s, ef in (("ER", 9, 4), ("G500", 9, 16),
                                  ("G500", 9, 2))]
        args, _, table = fleet_args(pairs, False)
        n = len(pairs)
    else:
        a = operand("G500", 12, 16, True, cuda)
        off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
        rows = K.symbolic_call(off, tsz, a.indptr, a.indptr, a.indices,
                               a.data, a.indices, a.data, table_size=table,
                               vector=False, n_cols=a.n_cols)
        ic = prefix_sum(rows).to(torch.int32)
        args = (off, tsz, a.indptr, a.indptr, ic, a.indices)
        n = 4
    want = check_classify(args, n, table, numeric)
    reached = [c for c, p in enumerate(want[1]) if p.shape[0]]
    if layout == "shared":
        assert max(reached) == 2
        assert int(want[0].sum()) % n == 0


def ladder_fleet(cuda, layout, dyadic):
    """Two ``_hash_ladder`` members (``FLEET_LADDER``'s rungs, every class
    in both phases) under one bin of LADDER_TABLE slots:
    ``stacked``, two structures (seeds 0 and 1) with stacked schedules;
    ``shared``, one structure and schedule shared (stride 0), A's values
    stacked.  Returns the batched arguments (as :func:`fleet_args`), the
    table and the members' ``(a, b)``."""
    seeds = (0, 1) if layout == "stacked" else (0,)
    mats = []
    for seed in seeds:
        (ar, ac, av, ash), (br, bc, bv, bsh) = ladder(dyadic, seed,
                                                      FLEET_LADDER)
        mats.append((CSR.from_numpy_coo(ar, ac, av, ash, device=cuda),
                     CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)))
    m = len(FLEET_LADDER)
    ic = prefix_sum(torch.tensor(FLEET_LADDER, dtype=torch.int32,
                                 device=cuda)).to(torch.int32)
    off = torch.tensor([0, m], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([LADDER_TABLE], dtype=torch.int32, device=cuda)
    if layout == "stacked":
        (a0, b0), (a1, b1) = mats
        st = [torch.stack(x) for x in (
            (off, off), (tsz, tsz), (a0.indptr, a1.indptr),
            (b0.indptr, b1.indptr), (ic, ic), (a0.indices, a1.indices),
            (a0.data, a1.data), (b0.indices, b1.indices),
            (b0.data, b1.data))]
        return tuple(st), LADDER_TABLE, mats
    a, b = mats[0]
    vals = torch.stack([a.data, a.data.flip(0)])
    members = [(a, b), (dataclasses.replace(a, data=vals[1]), b)]
    return ((off, tsz, a.indptr, b.indptr, ic, a.indices, vals, b.indices,
             b.data), LADDER_TABLE, members)


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", (True, False), ids=("dyadic", "uniform"))
@pytest.mark.parametrize("layout", ("stacked", "shared"))
@pytest.mark.parametrize("vector", (False, True))
def test_batched_ladder_reaches_every_class(cuda, vector, layout, dyadic):
    """Two ladder members (rows of 0 to 70,000 distinct columns) under one
    bin of 262,144 slots: in both phases the classifying kernel equals its
    plain version, every class runs -- the three shared-memory classes,
    clusters of 2, 4 and 8 blocks (the symbolic counts summed across the
    cluster) and the device-memory table -- one classifying launch and
    one launch per class a phase, and each member equals the batched plain
    version (counts bitwise, columns bitwise, values bitwise on dyadic
    values, else within 1 ulp per product), with no kernel error."""
    args, table, members = ladder_fleet(cuda, layout, dyadic)
    n = 2
    kw = dict(n_members=n, table_size=table, vector=vector)
    for numeric, classes in ((False, FLEET_LADDER_SYMBOLIC_CLASSES),
                             (True, FLEET_LADDER_CLASSES)):
        want = check_classify(args, n, table, numeric)
        for e in range(n):
            got = [-1] * len(FLEET_LADDER)
            for c, pair in enumerate(want[1]):
                for ee, i in pair.tolist():
                    if ee == e:
                        got[i] = c
            assert got == list(classes)
        assert all(p.shape[0] for p in want[1])
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    sym = symbolic_args(args)
    ops.reset_kernel_calls()
    reset_class_calls()
    rows = K.batched_symbolic_call(*sym, **kw, errors=errors, n_cols=WIDE)
    torch.cuda.synchronize()
    assert int(errors) == 0
    assert torch.equal(rows, ref.batched_symbolic_plain(*sym, **kw))
    assert rows.tolist() == [list(FLEET_LADDER)] * n
    cap = int(args[4][..., -1].max()) + 5
    cols, vals = K.batched_numeric_call(*args, **kw, cap_c=cap,
                                        errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    sfx = "_vector" if vector else ""
    assert ops.kernel_call_counts() == dict(
        dict.fromkeys(ops.kernel_call_counts(), 0),
        **{f"batched_symbolic{sfx}": 7, f"batched_numeric{sfx}": 7})
    assert K.CLASS_CALLS == dict(dict.fromkeys(K.CLASS_NAMES, 2),
                                 bitmap=0, classify=2, plain=0)
    pc, pv = ref.batched_numeric_plain(*args, **kw, cap_c=cap)
    ic = args[4] if args[4].dim() == 1 else args[4][0]
    for e, (a, b) in enumerate(members):
        check_product(a, b, ic, cols[e], vals[e], pc[e], pv[e], dyadic)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_batched_numeric_one_member_equals_single_kernel(cuda, case,
                                                         vector):
    """At one member with every argument shared (stride 0), the batched
    numeric kernels give bitwise the single-product kernel's output after
    a row sort (dyadic values; G500 s12: cluster tables), with the same
    class launches."""
    a = operand(*case, cuda)
    if not case[3]:
        a = operand(case[0], case[1], case[2], True, cuda)
    off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
    rows = K.symbolic_call(off, tsz, a.indptr, a.indptr, a.indices, a.data,
                           a.indices, a.data, table_size=table,
                           vector=vector, n_cols=a.n_cols)
    ic = prefix_sum(rows).to(torch.int32)
    cap = int(ic[-1]) + 3
    args = (off, tsz, a.indptr, a.indptr, ic, a.indices, a.data, a.indices,
            a.data)
    reset_class_calls()
    c1, v1 = K.numeric_call(*args, cap_c=cap, table_size=table,
                            vector=vector)
    single = dict(K.CLASS_CALLS)
    reset_class_calls()
    cn, vn = K.batched_numeric_call(*args, n_members=1, cap_c=cap,
                                    table_size=table, vector=vector)
    torch.cuda.synchronize()
    assert K.CLASS_CALLS == single
    s1 = CSR(ic, c1, v1, ic[-1], a.shape, False).sort_rows()
    sn = CSR(ic, cn[0], vn[0], ic[-1], a.shape, False).sort_rows()
    assert torch.equal(s1.indices, sn.indices)
    assert torch.equal(s1.data, sn.data)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_batched_cluster_table_load_factor_one_and_one_past_fill(cuda,
                                                                  vector):
    """Two members, each a row of exactly 32,768 distinct columns under a
    table of 32,768 slots (a cluster of two blocks), in both batched
    phases: full and right; one more column raises "full-table" in
    each."""
    t = 2 * K.SMEM_SLOTS
    for d in (t, t + 1):
        (ar, ac, av, ash), (br, bc, bv, bsh) = saturated_row(d)
        a = CSR.from_numpy_coo(ar, ac, av, ash, device=cuda)
        b = CSR.from_numpy_coo(br, bc, bv, bsh, device=cuda)
        off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
        tsz = torch.tensor([t], dtype=torch.int32, device=cuda)
        ic = torch.tensor([0, d], dtype=torch.int32, device=cuda)
        vals = torch.stack([b.data, b.data.flip(0)])
        args = (off, tsz, a.indptr, b.indptr, ic, a.indices, a.data,
                b.indices, vals)
        kw = dict(n_members=2, table_size=t, vector=vector)
        want = check_classify(args, 2, t, True)
        assert want[1][K.CLASS_NAMES.index("cluster_2")].tolist() == \
            [[0, 0], [1, 0]]
        if d > t:
            with pytest.raises(RuntimeError, match="full-table"):
                K.batched_symbolic_call(*symbolic_args(args), **kw,
                                        n_cols=WIDE)
            with pytest.raises(RuntimeError, match="full-table"):
                K.batched_numeric_call(*args, **kw, cap_c=d)
            continue
        rows = K.batched_symbolic_call(*symbolic_args(args), **kw,
                                       n_cols=WIDE)
        assert rows.tolist() == [[d], [d]]
        reset_class_calls()
        cols, out = K.batched_numeric_call(*args, **kw, cap_c=d)
        assert K.CLASS_CALLS["cluster_2"] == 1
        pc, pv = ref.batched_numeric_plain(*args, **kw, cap_c=d)
        for e in range(2):
            check_product(a, b, ic, cols[e], out[e], pc[e], pv[e], True)


# ---- flash attention --------------------------------------------------------

def bf16_ulp(x):
    """One bfloat16 ulp at each value of ``x``."""
    _, e = x.float().abs().frexp()
    return (e.float() - 8).exp2()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("b,h,hkv,d,sq,skv", [
    (2, 4, 4, 32, 128, 128), (1, 4, 2, 64, 17, 17), (2, 8, 1, 16, 200, 333),
    (1, 2, 1, 128, 64, 256), (1, 4, 2, 256, 100, 100),
    (2, 2, 2, 128, 1, 64), (1, 16, 8, 128, 300, 300),
    (1, 16, 8, 128, 1000, 1000), (2, 8, 2, 128, 333, 333),
    (1, 8, 2, 64, 200, 500), (1, 16, 1, 256, 300, 300),
    (1, 32, 1, 64, 100, 100)])
def test_flash_kernel_matches_plain_version(cuda, dtype, causal, b, h, hkv,
                                            d, sq, skv):
    gen = torch.Generator(cuda).manual_seed(h * d + sq)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    fa_ops.reset_kernel_calls()
    got = FK.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.kernel_call_counts() == {"flash_fwd": 1, "plain": 0}
    kind = FK.variant(dtype, d)
    assert fa_ops.variant_call_counts() == {
        "wgmma": int(kind == "wgmma"), "fma": int(kind == "fma")}
    want = fa_ref.flash_attention_plain(q, k, v, causal=causal,
                                        scale=d ** -0.5)
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5
    else:
        assert bool((diff <= bf16_ulp(want) + 2e-5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,width", [
    (torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 68)])
def test_flash_kernel_takes_strided_operands(cuda, dtype, width):
    """q, k, v as the model makes them: (B, S, H, D) projections seen as
    (B, H, S, D); bf16 through the tensor maps of the tensor-core kernel.
    ``width`` 68: a head stride of 136 bytes that TMA cannot address, so
    the wrapper copies those operands first."""
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((2, 96, 8, width), generator=gen, device=cuda).to(dtype)
    kv = torch.randn((2, 96, 2, 2, width), generator=gen,
                     device=cuda).to(dtype)
    q, k, v = (t[..., :64].transpose(1, 2)
               for t in (q, kv[:, :, 0], kv[:, :, 1]))
    assert not q.is_contiguous() and not v.is_contiguous()
    fa_ops.reset_kernel_calls()
    got = fa_ops.flash_attention(q, k, v, causal=True, bq=32, bkv=32)
    want = fa_ref.flash_attention_plain(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True,
                                        scale=64 ** -0.5)
    torch.cuda.synchronize()
    assert fa_ops.variant_call_counts()[FK.variant(dtype, 64)] == 1
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5
    else:
        assert bool((diff <= bf16_ulp(want) + 2e-5).all())


@pytest.mark.gpu
def test_flash_variant_by_dtype_and_head_dim(cuda):
    """bf16 at head dims 64, 128 and 256 launches the tensor-core kernel,
    every float32 input and bf16 at 16 and 32 the CUDA-core kernel."""
    for dtype, d, kind in ((torch.bfloat16, 64, "wgmma"),
                           (torch.bfloat16, 128, "wgmma"),
                           (torch.bfloat16, 256, "wgmma"),
                           (torch.float32, 64, "fma"),
                           (torch.float32, 128, "fma"),
                           (torch.float32, 256, "fma"),
                           (torch.bfloat16, 16, "fma"),
                           (torch.bfloat16, 32, "fma")):
        q = torch.ones((1, 2, 40, d), device=cuda, dtype=dtype)
        fa_ops.reset_kernel_calls()
        out = FK.flash_fwd(q, q[:, :1], q[:, :1], scale=d ** -0.5,
                           causal=True)
        torch.cuda.synchronize()
        assert FK.variant(dtype, d) == kind
        assert fa_ops.variant_call_counts() == {
            "wgmma": int(kind == "wgmma"), "fma": int(kind == "fma")}
        # a weighted mean of ones: 1 up to the sums' rounding
        assert float((out.float() - 1).abs().max()) <= 1e-6, (dtype, d)


@pytest.mark.gpu
def test_flash_engine_serves_a_long_ragged_prompt(cuda):
    """qwen3-0.6b's attention widths (16 heads, 8 KV heads, head dim 128;
    2 layers, a 4,096-token vocabulary), random weights, bf16: an engine on
    "flash" serves a 1,000-token prompt and a short one, each admission
    launching the tensor-core kernel once a layer.  The long prompt's
    logits: float32 "flash" within a relative L2 distance of 1e-4 of
    float32 "full"; bf16 "flash" at most 1.5 times as far from them as
    bf16 "full" is (chip_smoke's phase 18 gates)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              vocab_size=4096)
    model = transformer.init_params(torch.Generator(cuda).manual_seed(0),
                                    cfg)
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
          for n in (1000, 7)]
    flash = single_device_ctx(attn_impl="flash")
    full = single_device_ctx(attn_impl="full")
    eng = Engine(cfg, model, flash, max_batch=2, max_len=1024, device=cuda)
    for r, p in enumerate(ps):
        eng.add_request(Request(rid=r, prompt=p, max_new_tokens=4))
    fa_ops.reset_kernel_calls()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    assert sorted(d.rid for d in done) == [0, 1]
    assert all(len(d.out_tokens) == 4 for d in done)
    n = len(ps) * cfg.n_layers
    assert fa_ops.kernel_call_counts() == {"flash_fwd": n, "plain": 0}
    assert fa_ops.variant_call_counts() == {"wgmma": n, "fma": 0}
    tok = torch.from_numpy(ps[0][None]).long().to(cuda)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    r32 = transformer.prefill(model, tok, cfg32, full)[0].float()
    f32 = transformer.prefill(model, tok, cfg32, flash)[0].float()
    lf, lr = (transformer.prefill(model, tok, cfg, c)[0].float()
              for c in (flash, full))
    rel = lambda x: float((x - r32).norm() / r32.norm())  # noqa: E731
    assert bool(torch.isfinite(lf).all())
    assert rel(f32) <= 1e-4
    assert rel(lf) <= 1.5 * rel(lr)


@pytest.mark.gpu
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        FK.flash_fwd(q, q, q, scale=1.0, causal=True)
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FK.flash_fwd(q, q, q, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FK.flash_fwd(q.float(), q.bfloat16(), q.float(), scale=1.0,
                     causal=True)


# ---- SSD chunk scan --------------------------------------------------------

SSD_REL = 1e-4


def ssd_tol(la, chunk, values):
    """The SSD tolerance for ``values``: (SSD_REL + 8 float32 ulps of the
    largest |cumsum of log_a| over a chunk) x max(1, max |values|)."""
    b, s, nh = la.shape
    cum = float(-la.reshape(b, s // chunk, chunk, nh).sum(2).min())
    return (SSD_REL + 8 * torch.finfo(torch.float32).eps * cum) * \
        max(1.0, float(values.float().abs().max()))


def ssd_inputs(gen, b, s, nh, hp, g, n, dtype, decay, device):
    xd = (torch.randn((b, s, nh, hp), generator=gen, device=device) * 0.5)
    la = -torch.rand((b, s, nh), generator=gen, device=device) * decay
    Bm = torch.randn((b, s, g, n), generator=gen, device=device)
    Cm = torch.randn((b, s, g, n), generator=gen, device=device)
    return xd.to(dtype), la, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,s,nh,hp,g,n,chunk,decay", [
    (1, 512, 4, 64, 1, 128, 256, 1.0),    # mamba2-780m's head and state
    (2, 1000, 3, 64, 1, 128, 250, 1.0),   # a ragged chunk of 250
    (1, 512, 2, 64, 1, 128, 256, 16.0),   # cum near -2,000: exp underflows
    (1, 39, 4, 8, 2, 24, 13, 0.5),        # a chunk of 13, n != hp
    (2, 7, 2, 48, 1, 12, 1, 0.5),         # a chunk of 1, a partial hp tile
    (1, 64, 6, 32, 3, 200, 64, 0.2),      # three groups, a large state
])
def test_ssd_kernel_matches_plain_version(cuda, dtype, b, s, nh, hp, g, n,
                                          chunk, decay):
    gen = torch.Generator(cuda).manual_seed(s + n)
    xd, la, Bm, Cm = ssd_inputs(gen, b, s, nh, hp, g, n, dtype, decay, cuda)
    ssd_ops.reset_kernel_calls()
    y, hT = ssd_ops.ssd_chunk(xd, la, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.kernel_call_counts() == {"ssd_chunk": 1, "plain": 0}
    yw, hw = ssd_ref.ssd_chunked(xd, la, Bm, Cm, chunk)
    hw = hw.transpose(-1, -2)
    assert y.dtype == dtype and y.shape == yw.shape
    assert hT.dtype == torch.float32 and hT.shape == (b, nh, n, hp)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    tol = ssd_tol(la, chunk, yw)
    d = (y.float() - yw.float()).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= tol
    else:
        assert bool((d <= bf16_ulp(yw) + tol).all())
    assert float((hT - hw).abs().max()) <= ssd_tol(la, chunk, hw)


@pytest.mark.gpu
def test_ssd_kernel_takes_strided_operands(cuda):
    """B and C as the model slices them out of the convolution's output."""
    gen = torch.Generator(cuda).manual_seed(1)
    b, s, nh, hp, g, n = 2, 96, 4, 64, 1, 128
    xd, la, _, _ = ssd_inputs(gen, b, s, nh, hp, g, n, torch.float32, 1.0,
                              cuda)
    xbc = torch.randn((b, s, 256 + 2 * g * n), generator=gen, device=cuda)
    Bm = xbc[..., 256:256 + g * n].reshape(b, s, g, n)
    Cm = xbc[..., 256 + g * n:].reshape(b, s, g, n)
    assert not Bm.is_contiguous()
    y, hT = ssd_ops.ssd_chunk(xd, la, Bm, Cm, 32)
    yw, hw = ssd_ref.ssd_chunked(xd, la, Bm.contiguous(), Cm.contiguous(),
                                 32)
    torch.cuda.synchronize()
    assert float((y - yw).abs().max()) <= ssd_tol(la, 32, yw)
    assert float((hT - hw.transpose(-1, -2)).abs().max()) <= \
        ssd_tol(la, 32, hw)


@pytest.mark.gpu
def test_ssd_wrapper_raises_rather_than_falls_back(cuda):
    """What the kernel does not take raises on the card, though the plain
    version would compute it."""
    gen = torch.Generator(cuda).manual_seed(2)
    xd, la, Bm, Cm = ssd_inputs(gen, 1, 16, 2, 8, 1, 8, torch.float16, 1.0,
                                cuda)
    ssd_ops.reset_kernel_calls()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_ops.ssd_chunk(xd, la, Bm, Cm, 8)
    with pytest.raises(ValueError, match="log_a must be float32"):
        ssd_ops.ssd_chunk(xd.float(), la.bfloat16(), Bm.float(),
                          Cm.float(), 8)
    big = torch.zeros((1, 16, 1, SSDK.MAX_STATE + 1), device=cuda)
    with pytest.raises(ValueError, match="states up to"):
        ssd_ops.ssd_chunk(xd.float(), la, big, big, 8)
    long = torch.zeros((1, 512, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="chunks up to"):
        SSDK.ssd_fwd(long, torch.zeros((1, 512, 2), device=cuda),
                     torch.zeros((1, 512, 1, 8), device=cuda),
                     torch.zeros((1, 512, 1, 8), device=cuda), 512)
    assert ssd_ops.kernel_call_counts() == {"ssd_chunk": 0, "plain": 0}


# ---- SSD chunk scan: the tensor-core kernel ---------------------------------

def ssd_check(y, hT, xd, la, Bm, Cm, chunk):
    """y within one bf16 ulp of the plain output plus ``ssd_tol``, hT (the
    kernel's (n, hp) order) within ``ssd_tol`` of the plain last state."""
    yw, hw = ssd_ref.ssd_chunked(xd, la, Bm, Cm, chunk)
    hw = hw.transpose(-1, -2)
    assert y.dtype == xd.dtype and y.shape == yw.shape
    assert hT.dtype == torch.float32 and hT.shape == hw.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    d = (y.float() - yw.float()).abs()
    assert bool((d <= bf16_ulp(yw) + ssd_tol(la, chunk, yw)).all()), \
        float(d.max())
    assert float((hT - hw).abs().max()) <= ssd_tol(la, chunk, hw)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hp,g,n,chunk,decay", [
    (1, 512, 8, 64, 1, 128, 256, 1.0),    # mamba2-780m's head and state
    (2, 1000, 4, 64, 1, 128, 250, 1.0),   # ragged chunks of 250
    (1, 300, 4, 64, 1, 128, 150, 16.0),   # 150, cum near -1,200: underflow
    (1, 37, 4, 64, 1, 128, 1, 0.5),       # a prime length: chunks of 1
    (1, 512, 8, 64, 2, 128, 256, 1.0),    # two groups
    (1, 256, 20, 64, 1, 128, 256, 1.0),   # a group of 20: head sets 6, 6, 6, 2
    (1, 256, 4, 128, 1, 64, 64, 1.0),     # two head-dim slices, one k block
    (1, 192, 2, 32, 1, 256, 96, 0.5),     # a partial slice, state 256
])
def test_ssd_tc_kernel_matches_plain_version(cuda, b, s, nh, hp, g, n,
                                             chunk, decay):
    gen = torch.Generator(cuda).manual_seed(s + n + nh)
    xd, la, Bm, Cm = ssd_inputs(gen, b, s, nh, hp, g, n, torch.bfloat16,
                                decay, cuda)
    assert SSDK.variant(xd, Bm, Cm) == "tc"
    ssd_ops.reset_kernel_calls()
    y, hT = ssd_ops.ssd_chunk(xd, la, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.kernel_call_counts() == {"ssd_chunk": 1, "plain": 0}
    assert ssd_ops.variant_call_counts() == {"tc": 1, "fma": 0}
    ssd_check(y, hT, xd, la, Bm, Cm, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", (256, 150))
def test_ssd_tc_passes_match_their_plain_versions(cuda, chunk):
    """Pass by pass: (a)'s cumsum and chunk states, (b)'s entering states
    (the bf16 hi + lo pair) and last state, (c)'s output, each against
    ``ref.py``'s plain pass on the same inputs."""
    b, s, nh, hp, g, n = 2, 3 * chunk, 8, 64, 2, 128
    gen = torch.Generator(cuda).manual_seed(chunk)
    xd, la, Bm, Cm = ssd_inputs(gen, b, s, nh, hp, g, n, torch.bfloat16,
                                1.0, cuda)
    got = SSDK.tc_passes(xd, la, Bm, Cm, chunk, passes=1)
    cum = ssd_ref.chunk_cumsum(la, chunk)
    eps = torch.finfo(torch.float32).eps
    assert float((got["cum"] - cum).abs().max()) <= \
        8 * eps * float(cum.abs().max())
    S = ssd_ref.chunk_states(xd, got["cum"], Bm, chunk)
    assert float((got["states"] - S).abs().max()) <= ssd_tol(la, chunk, S)
    got = SSDK.tc_passes(xd, la, Bm, Cm, chunk, passes=3)
    entering, h = ssd_ref.pass_states(S, got["cum"], chunk)
    assert float((SSDK.states_entering(got["states"]) - entering).abs()
                 .max()) <= ssd_tol(la, chunk, entering)
    assert float((got["hT"] - h.transpose(-1, -2)).abs().max()) <= \
        ssd_tol(la, chunk, h)
    got = SSDK.tc_passes(xd, la, Bm, Cm, chunk)
    yw = ssd_ref.chunk_output(xd, got["cum"], Bm, Cm, entering, chunk)
    d = (got["y"].float() - yw.float()).abs()
    assert bool((d <= bf16_ulp(yw) + ssd_tol(la, chunk, yw)).all())


@pytest.mark.gpu
def test_ssd_tc_takes_the_models_strided_operands(cuda):
    """B and C as ``models/ssm.apply_full`` slices them out of one (b, s,
    d_in + 2 g n) tensor: row stride d_in + 2 g n, 16-byte offsets."""
    gen = torch.Generator(cuda).manual_seed(3)
    b, s, nh, hp, g, n = 2, 512, 4, 64, 2, 128
    d_in = nh * hp
    xd, la, _, _ = ssd_inputs(gen, b, s, nh, hp, g, n, torch.bfloat16, 1.0,
                              cuda)
    xbc = torch.randn((b, s, d_in + 2 * g * n), generator=gen,
                      device=cuda).to(torch.bfloat16)
    _, Bm, Cm = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    Bm, Cm = Bm.reshape(b, s, g, n), Cm.reshape(b, s, g, n)
    assert not Bm.is_contiguous() and SSDK.variant(xd, Bm, Cm) == "tc"
    ssd_ops.reset_kernel_calls()
    y, hT = ssd_ops.ssd_chunk(xd, la, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert ssd_ops.variant_call_counts() == {"tc": 1, "fma": 0}
    ssd_check(y, hT, xd, la, Bm.contiguous(), Cm.contiguous(), 256)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("offset", "row_stride", "head_dim",
                                  "state", "float32"))
def test_ssd_unaligned_or_odd_operands_take_the_fma_kernel(cuda, case):
    """An operand TMA cannot address (a base off 16 bytes, a row stride
    that is no multiple of 16 bytes), a width that is no multiple of 16,
    or float32: the CUDA-core kernel, counted as such, right all the
    same."""
    gen = torch.Generator(cuda).manual_seed(4)
    b, s, nh, g = 1, 256, 4, 1
    hp = 24 if case == "head_dim" else 64
    n = 40 if case == "state" else 128
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    xd, la, Bm, Cm = ssd_inputs(gen, b, s, nh, hp, g, n, dtype, 1.0, cuda)
    if case in ("offset", "row_stride"):
        pad = 3 if case == "offset" else 0
        extra = 0 if case == "offset" else 4
        xbc = torch.randn((b, s, pad + 2 * g * n + extra), generator=gen,
                          device=cuda).to(dtype)
        Bm = xbc[..., pad:pad + g * n].reshape(b, s, g, n)
        Cm = xbc[..., pad + g * n:pad + 2 * g * n].reshape(b, s, g, n)
    assert SSDK.variant(xd, Bm, Cm) == "fma"
    ssd_ops.reset_kernel_calls()
    y, hT = ssd_ops.ssd_chunk(xd, la, Bm, Cm, 128)
    torch.cuda.synchronize()
    assert ssd_ops.kernel_call_counts() == {"ssd_chunk": 1, "plain": 0}
    assert ssd_ops.variant_call_counts() == {"tc": 0, "fma": 1}
    ssd_check(y, hT, xd, la, Bm.contiguous(), Cm.contiguous(), 128)
    with pytest.raises(ValueError, match="tc SSD kernel does not take"):
        SSDK.tc_passes(xd, la, Bm, Cm, 128)


@pytest.mark.gpu
def test_ssd_tc_two_calls_bitwise_equal(cuda):
    gen = torch.Generator(cuda).manual_seed(5)
    xd, la, Bm, Cm = ssd_inputs(gen, 1, 1024, 8, 64, 1, 128,
                                torch.bfloat16, 1.0, cuda)
    y1, h1 = ssd_ops.ssd_chunk(xd, la, Bm, Cm, 256)
    y2, h2 = ssd_ops.ssd_chunk(xd, la, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


# ---------------------------------------------------------------------------
# Chains (core/chain.py): every stage on its kernel, the slot-order rule
# ---------------------------------------------------------------------------

#: the launch counters each chain-stage algorithm bumps once an execute
STAGE_KERNELS = {"hash": ("numeric",), "hash_vector": ("numeric_vector",),
                 "pb": ("pb_scatter", "pb_merge")}


def chain_launches(fn):
    """``fn()`` between a reset and a read of the hash and PB counters."""
    ops.reset_kernel_calls()
    pb_ops.reset_kernel_calls()
    K.CLASS_CALLS.update(dict.fromkeys(K.CLASS_CALLS, 0))
    out = fn()
    torch.cuda.synchronize()
    counts = ops.kernel_call_counts()
    counts.update({f"pb_{k}": v for k, v in pb_ops.kernel_call_counts()
                   .items()})
    return out, counts


def assert_stage_launches(counts, algorithms):
    want: dict = {}
    for algo in algorithms:
        for k in STAGE_KERNELS[algo]:
            want[k] = want.get(k, 0) + 1
    assert counts == {k: want.get(k, 0) for k in counts}, (counts, want)


def on_cpu(c):
    return CSR(c.indptr.cpu(), c.indices.cpu(), c.data.cpu(), c.nnz.cpu(),
               c.shape, c.sorted_cols)


def assert_sorted_equal(c, plain):
    """A card output against the plain composition on the CPU: both rows
    sorted, structure and (dyadic) values bitwise."""
    from repro_torch.core import finalize
    c, plain = on_cpu(finalize(c, True)), finalize(plain, True)
    nnz = int(plain.nnz)
    assert int(c.nnz) == nnz and torch.equal(c.indptr, plain.indptr)
    assert torch.equal(c.indices[:nnz], plain.indices[:nnz])
    assert torch.equal(c.data[:nnz], plain.data[:nnz])


def galerkin_operands(device, scale=12):
    a = operand("ER", scale, 16, True, device)
    r, p = rmat.aggregation_csr(a.n_rows, a.n_rows // 8, seed=0,
                                device=device)
    return r, a, p


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_output", (False, True))
def test_chain_galerkin_stages_launch_their_kernels(cuda, sorted_output):
    from repro_torch.core import plan_galerkin
    r, a, p = galerkin_operands(cuda)
    chain = plan_galerkin(r, a, p, sorted_output=sorted_output, cache=False)
    if sorted_output:
        # a sorted, barely-compressing last stage goes to pb, on a sorted
        # hop
        assert chain.algorithms[-1] == "pb" and chain.sorted_hops == (True,)
    else:
        assert chain.sorted_hops == (False,)
    c, counts = chain_launches(lambda: chain.execute(r, a, p))
    assert_stage_launches(counts, chain.algorithms)
    assert torch.equal(c.indptr, chain.stages[-1].indptr_c.to(c.indptr.dtype))
    cpu = [on_cpu(x) for x in (r, a, p)]
    plain = plan_galerkin(*cpu, sorted_output=sorted_output,
                          cache=False).execute(*cpu)
    assert_sorted_equal(c, plain)


@pytest.mark.gpu
def test_chain_pb_ended_repeat_executes_agree(cuda):
    from repro_torch.core import plan_galerkin
    r, a, p = galerkin_operands(cuda)
    chain = plan_galerkin(r, a, p, sorted_output=True, cache=False)
    assert chain.algorithms[-1] == "pb" and chain.sorted_hops == (True,)
    first = chain.execute(r, a, p)
    for _ in range(10):
        c = chain.execute(r, a, p)
        for f in ("indptr", "indices", "data", "nnz"):
            assert torch.equal(getattr(c, f), getattr(first, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ("auto", "hash", "hash_vector"))
def test_chain_power3_per_algorithm(cuda, algorithm):
    from repro_torch.core import plan_power
    a = operand("ER", 10, 8, True, cuda)
    chain = plan_power(a, 3, algorithm=algorithm, cache=False)
    assert chain.sorted_hops == (False,)
    c, counts = chain_launches(lambda: chain.execute(a, a, a))
    assert_stage_launches(counts, chain.algorithms)
    ac = on_cpu(a)
    plain = plan_power(ac, 3, algorithm=algorithm, cache=False).execute(
        ac, ac, ac)
    assert_sorted_equal(c, plain)


@pytest.mark.gpu
def test_chain_gram_regathers_values_only(cuda):
    from repro_torch.core import (CSR as TCSR, clear_plan_cache, plan_gram,
                                  plan_cache_stats)
    a = operand("G500", 10, 8, True, cuda)
    clear_plan_cache()
    plan = plan_gram(a)
    g, counts = chain_launches(lambda: plan.execute(a))
    assert_stage_launches(counts, (plan.algorithm,))
    ac = on_cpu(a)
    assert_sorted_equal(g, plan_gram(ac).execute(ac))
    a3 = TCSR(a.indptr, a.indices, a.data * 3, a.nnz, a.shape, a.sorted_cols)
    before = plan_cache_stats()["misses"]
    g3, counts = chain_launches(lambda: plan_gram(a3).execute(a3))
    assert plan_cache_stats()["misses"] == before
    assert_stage_launches(counts, (plan.algorithm,))
    assert torch.equal(on_cpu(g3).to_dense(), 9 * on_cpu(g).to_dense())


@pytest.mark.gpu
def test_chain_plans_are_cached_per_device(cuda):
    from repro_torch.core import (clear_plan_cache, plan_batch_power,
                                  plan_cache_stats, plan_galerkin, plan_gram,
                                  plan_spgemm)
    r, a, p = galerkin_operands(cuda, scale=8)
    cpu = [on_cpu(x) for x in (r, a, p)]
    clear_plan_cache()
    plans = (lambda r, a, p: plan_spgemm(a, a),
             lambda r, a, p: plan_galerkin(r, a, p, sorted_output=True),
             lambda r, a, p: plan_gram(a),
             lambda r, a, p: plan_batch_power([a, a], 2))
    for make in plans:
        on_card = make(r, a, p)
        misses = plan_cache_stats()["misses"]
        here = make(*cpu)
        # the same structure on the CPU is another plan, with CPU tensors
        assert here is not on_card
        assert plan_cache_stats()["misses"] > misses
        assert make(r, a, p) is on_card and make(*cpu) is here
    # each CPU plan executes on CPU operands, each card plan on the card
    assert_sorted_equal(plan_gram(a).execute(a),
                        plan_gram(cpu[1]).execute(cpu[1]))
    assert_sorted_equal(plan_galerkin(r, a, p, sorted_output=True)(r, a, p),
                        plan_galerkin(*cpu, sorted_output=True)(*cpu))


@pytest.mark.gpu
def test_chain_batch_power_launches_batched_classes(cuda):
    from repro_torch.core import plan_batch_power, plan_power
    from repro_torch.examples.moe_dispatch_batch import diagonal_blocks
    blocks = [CSR(b.indptr, b.indices, torch.ones_like(b.data), b.nnz,
                  b.shape) for b in diagonal_blocks(cuda)]
    plan = plan_batch_power(blocks, 3, cache=False)
    outs, counts = chain_launches(lambda: plan.execute(blocks))
    classes = [c for st in plan.stages for c in st.classes]
    assert all(c.hash_sched is not None for c in classes)
    want: dict = {}
    for c in classes:
        key = "batched_numeric_vector" if c.algorithm == "hash_vector" \
            else "batched_numeric"
        want[key] = want.get(key, 0) + len(K.launch_classes(c.hash_largest))
    assert counts == {k: want.get(k, 0) for k in counts}, (counts, want)
    assert K.CLASS_CALLS["classify"] == len(classes)
    cpu = [on_cpu(b) for b in blocks]
    for b, c in zip(cpu, outs):
        assert_sorted_equal(c, plan_power(b, 3, cache=False).execute(b, b, b))


@pytest.mark.gpu
def test_chain_bcsr_last_stage_after_hash_hop(cuda):
    """A ``bcsr`` stage re-blocks A's entries by (row, column), so the hash
    hop into it stays unsorted whatever order the card gives its rows."""
    from repro_torch.core import plan_galerkin
    from repro_torch.kernels.spgemm_bcsr import ops as bcsr_ops
    r, a, p = galerkin_operands(cuda, scale=10)
    chain = plan_galerkin(r, a, p, algorithm=("hash", "bcsr"), cache=False)
    assert chain.algorithms == ("hash", "bcsr")
    assert chain.sorted_hops == (False,)
    cpu = [on_cpu(x) for x in (r, a, p)]
    plain = plan_galerkin(*cpu, algorithm=("hash", "bcsr"),
                          cache=False).execute(*cpu)
    for _ in range(3):
        bcsr_ops.reset_kernel_calls()
        c, counts = chain_launches(lambda: chain.execute(r, a, p))
        assert counts["numeric"] == 1 and counts["plain"] == 0
        assert bcsr_ops.kernel_call_counts()["numeric"] == 1
        assert bcsr_ops.kernel_call_counts()["plain"] == 0
        assert_sorted_equal(c, plain)


# ---- the measured recipe (repro_torch.autotune) on the card ---------------

def _autotune_pair(device):
    a = operand("ER", 9, 8, True, device)
    return a, a


@pytest.mark.gpu
def test_autotune_key_names_the_card(cuda):
    from repro_torch.autotune import db_key
    a, b = _autotune_pair(cuda)
    fields = db_key(a, b).split("|")
    assert fields[7] == f"torch-cuda:{torch.cuda.get_device_name()}"
    assert fields[8] == "x32"
    ac = on_cpu(a)
    # the structure fields are the CPU operands'; only the backend differs
    cpu_fields = db_key(ac, ac).split("|")
    assert cpu_fields[7] == "torch-cpu"
    assert fields[:7] + fields[8:] == cpu_fields[:7] + cpu_fields[8:]


@pytest.mark.gpu
def test_autotune_measures_on_the_card_then_hits(cuda, tmp_path):
    from repro_torch.autotune import (PerfDB, measure_call_counts,
                                      measured_recommend,
                                      reset_measure_calls)
    from repro_torch.autotune.measure import _candidates
    from repro_torch.core import plan_spgemm
    a, b = _autotune_pair(cuda)
    db = PerfDB(str(tmp_path / "db.json"))
    reset_measure_calls()
    choice = measured_recommend(a, b, db=db)
    lanes = {label for label, _, _ in _candidates(a, b, "plus_times", None)}
    (entry,) = db.load().values()
    # the winner is a lane that ran, and its time is the fastest
    assert choice.source == "measured" and entry["label"] in lanes
    # every lane ran: on the card a lane that fails raises
    assert set(entry["candidates"]) == lanes
    assert entry["candidates"][entry["label"]] == entry["us"] == choice.us
    assert min(entry["candidates"].values()) == entry["us"] > 0
    assert measure_call_counts()["candidates_timed"] == \
        len(entry["candidates"])
    reset_measure_calls()
    ops.reset_kernel_calls()
    plan = plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    counts = measure_call_counts()
    assert counts["candidates_timed"] == 0 and counts["db_hits"] == 1
    assert plan.provenance == "measured"
    assert plan.algorithm == choice.algorithm
    # a hit launches no numeric kernel: nothing is timed
    assert ops.kernel_call_counts()["numeric"] == 0
    assert ops.kernel_call_counts()["numeric_vector"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("oom", (False, True))
def test_autotune_kernel_failure_on_the_card(cuda, tmp_path, monkeypatch,
                                             oom):
    """A hash kernel that fails to launch makes the race raise: no plain
    lane is measured or served in its place, and nothing is stored.  A
    kernel lane that runs out of memory drops out with a warning."""
    from repro_torch.autotune import AutotuneDBWarning, PerfDB
    from repro_torch.core import plan_spgemm
    a, b = _autotune_pair(cuda)
    db = PerfDB(str(tmp_path / "db.json"))

    def broken(*args, **kwargs):
        if oom:
            raise torch.cuda.OutOfMemoryError("injected")
        raise RuntimeError("spgemm_hash launch failed: injected")

    monkeypatch.setattr(K, "numeric_call", broken)
    if not oom:
        with pytest.raises(RuntimeError, match="injected"):
            plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
        assert db.load() == {}
        return
    with pytest.warns(AutotuneDBWarning, match="OutOfMemoryError"):
        plan = plan_spgemm(a, b, autotune=True, autotune_db=db, cache=False)
    (entry,) = db.load().values()
    assert not {"hash", "hash@t2", "hash_vector",
                "hash_vector@t2"} & set(entry["candidates"])
    assert plan.algorithm == entry["algorithm"] not in ("hash",
                                                        "hash_vector")


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ("hash", "hash_vector"))
@pytest.mark.parametrize("preset,scale,ef", (("ER", 9, 8), ("G500", 11, 16)))
def test_autotune_scale2_plan_matches_plain(cuda, tmp_path, algorithm,
                                            preset, scale, ef):
    """An entry naming a x2 table gives a plan with the clipped doubled
    tables (ER's double; G500's already span every column, p2(n + 1), and
    stay); its kernel output equals the plain version's."""
    from repro_torch.autotune import PerfDB, SCHEMA_VERSION, db_key
    from repro_torch.core.schedule import scale_table_sizes
    from repro_torch.core import plan_spgemm
    from repro_torch.core.recipe import measure_stats
    a = operand(preset, scale, ef, True, cuda)
    db = PerfDB(str(tmp_path / "db.json"))
    s = measure_stats(a, a)
    db.put(db_key(a, a), {
        "schema": SCHEMA_VERSION, "algorithm": algorithm, "table_scale": 2,
        "us": 1.0, "candidates": {}, "backend": "test", "x64": False,
        "stats": {"flop": s.flop, "nnz_a": s.nnz_a, "nnz_c": s.nnz_c_est}})
    base = plan_spgemm(a, a, algorithm=algorithm, cache=False)
    plan = plan_spgemm(a, a, autotune=True, autotune_db=db, cache=False)
    assert plan.algorithm == algorithm and plan.provenance == "measured"
    want_size, want_bins = scale_table_sizes(
        base.table_size, base.bin_tsize, 2, a.n_cols, K.CHUNK)
    assert plan.table_size == want_size
    assert torch.equal(plan.bin_tsize, want_bins)
    if preset == "ER":
        assert plan.table_size == 2 * base.table_size
        assert torch.equal(plan.bin_tsize, 2 * base.bin_tsize)
    else:
        assert plan.table_size == base.table_size == 2 * a.n_cols
        assert torch.equal(plan.bin_tsize, base.bin_tsize)
    ops.reset_kernel_calls()
    c = plan.execute(a, a)
    torch.cuda.synchronize()
    key = "numeric_vector" if algorithm == "hash_vector" else "numeric"
    assert ops.kernel_call_counts()[key] == 1
    ac = on_cpu(a)
    plain = plan_spgemm(ac, ac, algorithm=algorithm, cache=False).execute(
        ac, ac)
    assert_sorted_equal(c, plain)


# ---------------------------------------------------------------------------
# the static contract checker (repro_torch.verify) on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("spgemm", "batch", "bcsr", "pb", "chain",
                                  "gram"))
def test_verify_layer1_on_the_card(cuda, kind):
    """Every layer-1 case of ``kind`` holds its VCs and census budget on
    CUDA tensors, with no plain version run, each kernel op launched its
    kernel, and each case's census equals the same case's on the CPU (the
    kernel boundary makes the census device-free)."""
    from repro_torch.verify import run_layer1
    cases = run_layer1([kind], device=cuda)
    cpu = {c.name: c for c in run_layer1([kind], device="cpu")}
    assert [c.name for c in cases] == list(cpu)
    for case in cases:
        assert case.ok, (case.name, case.budget)
        assert case.budget["got"]["plain"] == 0
        assert case.census == cpu[case.name].census, case.name
        launched = sum(v for k, v in case.budget["launches"].items()
                       if not k.endswith("plain"))
        assert launched >= case.census["pallas_call"], case.budget


@pytest.mark.gpu
@pytest.mark.parametrize("which", ("cap_c", "bin_tsize", "seg"))
def test_verify_rejects_twins_of_card_plans(cuda, which):
    from repro_torch.core import plan_pb, plan_spgemm
    from repro_torch.verify import check_plan_vcs, perturb_plan
    a = operand("ER", 9, 8, True, cuda)
    if which == "seg":
        plan = plan_pb(a, a, n_buckets=4, cache=False)
    else:
        plan = plan_spgemm(a, a, algorithm="hash", cache=False)
    assert all(vc.ok for vc in check_plan_vcs(plan))
    assert any(not vc.ok for vc in check_plan_vcs(perturb_plan(plan, which)))


# ---------------------------------------------------------------------------
# the RG-LRU and MoE layers on the card (plain PyTorch, the reference's jnp)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("stable", (True, False))
@pytest.mark.parametrize("cap", (1, 2, 160, 2048))
def test_moe_dispatch_invariants_on_the_card(cuda, stable, cap):
    """qwen3-moe-30b-a3b's routing (128 experts, top-8) of 2,048 tokens on
    CUDA tensors: each expert keeps exactly min(count, cap) assignments in
    its block's first slots, each kept row is its token's features, the
    rest of the buffer is zero, and the stable sort's slots equal the
    same dispatch's on the CPU bit for bit."""
    from repro_torch.models import moe
    t, e, k, d = 2048, 128, 8, 64
    g = torch.Generator(cuda).manual_seed(cap)
    x2 = torch.randn((t, d), generator=g, device=cuda)
    top_i = torch.rand((t, e), generator=g, device=cuda).topk(k).indices
    buf, slot = moe._dispatch(x2, top_i, e, cap, stable)
    torch.cuda.synchronize()
    counts = torch.bincount(top_i.reshape(-1), minlength=e)
    kept = torch.bincount(top_i[slot >= 0], minlength=e)
    assert torch.equal(kept, counts.clamp(max=cap))
    flat_e, flat_s = top_i.reshape(-1), slot.reshape(-1)
    rank = flat_s - flat_e * cap
    ok = flat_s >= 0
    assert bool(((rank[ok] >= 0) & (rank[ok] < kept[flat_e[ok]])).all())
    assert torch.unique(flat_s[ok]).numel() == int(ok.sum())
    tok = torch.arange(t, device=cuda).repeat_interleave(k)
    assert torch.equal(buf[flat_s[ok]], x2[tok[ok]])
    filled = torch.zeros(e * cap, dtype=torch.bool, device=cuda)
    filled[flat_s[ok]] = True
    assert not bool(buf[~filled].any())
    if stable:
        cb, cs = moe._dispatch(x2.cpu(), top_i.cpu(), e, cap, True)
        assert torch.equal(cs, slot.cpu()) and torch.equal(cb, buf.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("seq", (1, 3, 300, 2048))
def test_rglru_scan_on_the_card_equals_the_recurrence(cuda, seq):
    """``linear_scan`` at recurrentgemma's width (4,096) on CUDA tensors
    against h_t = a_t h_{t-1} + b_t step by step in float64 on the card,
    within 5e-6 of max |h|, with decays as the gates make them (in (0, 1),
    many near 1)."""
    from repro_torch.models import rglru
    g = torch.Generator(cuda).manual_seed(seq)
    a = torch.rand((1, seq, 4096), generator=g, device=cuda) ** 0.05
    b = torch.randn((1, seq, 4096), generator=g, device=cuda)
    got = rglru.linear_scan(a, b)
    h = torch.zeros((1, 4096), dtype=torch.float64, device=cuda)
    want = torch.empty((1, seq, 4096), dtype=torch.float64, device=cuda)
    for i in range(seq):
        h = a[:, i].double() * h + b[:, i].double()
        want[:, i] = h
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.double() - want).abs().max())
    assert err <= 5e-6 * max(1.0, float(want.abs().max()))
