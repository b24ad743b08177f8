"""The port's batched fleet planner (``repro_torch.core.batch``) and its
batched hash kernel's plain version against ``repro``.

The same numpy-built fleets go through ``repro.core.plan_batch`` and
``repro_torch.core.plan_batch`` in one process:

  * plan fields are bitwise equal: ``class_of``, each class's members,
    algorithm, shapes, capacities, ``table_size`` and the stacked
    ``hash_sched`` arrays, ``nnz_cs`` and ``total_flop``;
  * each product's output meets the ROADMAP contract against the
    reference's: ``indptr`` and ``nnz`` bitwise, the same columns in each
    row, values bitwise on dyadic (``_fuzz.VALS``) inputs and otherwise
    within 1 ulp per accumulated product;
  * the port's batched output is bitwise on its live prefix against the
    port's own per-product planned loop (both are plain versions here);
  * a fleet spanning a flop ratio R builds at most ``ceil(log2 R) + 1``
    class executors, and a repeat execute inspects nothing.

``hash_vector`` classes are held against the reference's scalar-probe
kernel: the installed jax has no ``pl.load``, so the reference vector
kernel cannot run here.  The batched CUDA kernel itself is held against
its plain version in ``test_torch_cuda.py`` (on a card only).
"""
import dataclasses
import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import recipe as jrecipe  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_hash import kernel as jK  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.batch as tbatch  # noqa: E402
import repro_torch.core.schedule as tsched  # noqa: E402
from repro_torch.core import recipe as trecipe  # noqa: E402
from repro_torch.data import rmat as trmat  # noqa: E402
from repro_torch.kernels.spgemm_hash import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_hash import ref  # noqa: E402
from _fuzz import VALS, csr_of, rand_dense, scramble_rows  # noqa: E402

CLASS_FIELDS = ("members", "algorithm", "shape_a", "shape_b", "cap_a",
                "cap_b", "cap_c", "flop_cap", "row_cap", "k_width",
                "a_sorted", "b_sorted", "total_flop", "a_shared", "b_shared",
                "table_size")
PLAN_FIELDS = ("class_of", "semiring", "complement_mask", "sorted_output",
               "shapes_a", "shapes_b", "caps_a", "caps_b", "nnzs_a",
               "nnzs_b", "nnz_cs", "total_flop")


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def port_pairs(pairs):
    """The fleet as port CSRs; an object shared in ``pairs`` stays shared."""
    seen = {}

    def conv(x):
        if id(x) not in seen:
            seen[id(x)] = to_port(x)
        return seen[id(x)]

    return [(conv(a), conv(b)) for a, b in pairs]


def rmat_fleet(n_products, scale, seed0=0):
    """``benchmarks.common.rmat_fleet``: mixed G500/ER A's, ER B's."""
    pairs = []
    for i in range(n_products):
        preset = "G500" if i % 2 else "ER"
        a = jrmat.rmat_csr(scale, 1 + (i % 3), preset, seed=seed0 + i)
        b = jrmat.rmat_csr(scale, 1 + ((i + 1) % 4), "ER",
                           seed=seed0 + 100 + i)
        pairs.append((a, b))
    return pairs


def dyadic_fleet(pairs, seed):
    """The fleet's structure with dyadic values (exact f32 arithmetic)."""
    rng = np.random.default_rng(seed)
    memo = {}

    def dy(x):
        if id(x) not in memo:
            d = np.zeros(x.cap, np.float32)
            d[:int(x.nnz)] = rng.choice(VALS, size=int(x.nnz))
            memo[id(x)] = J.CSR(x.indptr, x.indices, jnp.asarray(d), x.nnz,
                                x.shape, x.sorted_cols)
        return memo[id(x)]

    return [(dy(a), dy(b)) for a, b in pairs]


def assert_plans_equal(jp, tp, skip=()):
    for f in PLAN_FIELDS:
        assert getattr(jp, f) == getattr(tp, f), f
    assert jp.n_classes == tp.n_classes
    for jc, tc in zip(jp.classes, tp.classes):
        for f in CLASS_FIELDS:
            if f not in skip:
                assert getattr(jc, f) == getattr(tc, f), f
        assert (jc.hash_sched is None) == (tc.hash_sched is None)
        if jc.hash_sched is not None:
            for x, y in zip(jc.hash_sched, tc.hash_sched):
                x, y = np.asarray(x), y.numpy()
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert tc.hash_host == (tc.hash_sched[0].tolist(),
                                    tc.hash_sched[1].tolist())
        assert (jc.mask_parts is None) == (tc.mask_parts is None)
        if jc.mask_parts is not None:
            for f in ("indptr", "indices", "data", "nnz"):
                assert np.array_equal(np.asarray(getattr(jc.mask_parts, f)),
                                      getattr(tc.mask_parts, f).numpy()), f


def sorted_host(c):
    s = c.sort_rows() if not c.sorted_cols else c
    if isinstance(s, T.CSR):
        return s.indptr.numpy(), s.indices.numpy(), s.data.numpy()
    return np.asarray(s.indptr), np.asarray(s.indices), np.asarray(s.data)


def assert_contract(jc, tc, a, b, exact):
    """The ROADMAP contract: structure bitwise, values bitwise when
    ``exact`` (dyadic values, or sort-based bodies on both sides), else
    within one ulp per accumulated product (``a``, ``b``: port operands)."""
    assert jc.shape == tc.shape and jc.cap == tc.cap
    assert jc.sorted_cols == tc.sorted_cols
    nnz = int(jc.nnz)
    assert nnz == int(tc.nnz)
    ip_j, col_j, val_j = sorted_host(jc)
    ip_t, col_t, val_t = sorted_host(tc)
    assert np.array_equal(ip_j, ip_t)
    assert np.array_equal(col_j[:nnz], col_t[:nnz])
    if exact:
        assert np.array_equal(val_j[:nnz], val_t[:nnz])
        return
    k = ref.products_per_entry(a.indptr, b.indptr, torch.from_numpy(ip_t),
                               a.indices, b.indices, nnz).numpy()
    v = val_t[:nnz].astype(np.float32)
    ulp = np.spacing(np.abs(v))
    assert np.all(np.abs(val_j[:nnz] - v) <= k * ulp)


def assert_bitwise_prefix(c, r):
    """Live prefix bitwise (the reference's ``assert_bitwise_prefix``)."""
    nnz = int(c.nnz)
    assert nnz == int(r.nnz) and c.shape == r.shape
    assert torch.equal(c.indptr, r.indptr)
    assert torch.equal(c.indices[:nnz], r.indices[:nnz])
    assert torch.equal(c.data[:nnz], r.data[:nnz])


def planned_loop(plan, pairs):
    """The port's per-product planned path with each class's algorithm."""
    return [T.plan_spgemm(a, b, algorithm=plan.algorithms[i],
                          sorted_output=plan.sorted_output,
                          semiring=plan.semiring,
                          cache=False).execute(a, b)
            for i, (a, b) in enumerate(pairs)]


def class_bound(pairs):
    flops = [max(int(tsched.flops_per_row(a, b).sum()), 1) for a, b in pairs]
    return math.ceil(math.log2(max(flops) / min(flops))) + 1


def counting(monkeypatch, targets):
    """Wrap ``(module, name)`` callables in call counters."""
    counter = {}
    for mod, name in targets:
        orig = getattr(mod, name)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            counter[_name] = counter.get(_name, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)
    return counter


def compare_fleet(jp, jpairs, tp, tpairs, exact, sorted_output=None):
    """Both executes against each other (contract), and the port's against
    its own per-product planned loop (bitwise live prefix)."""
    jo = jp.execute(jpairs, sorted_output=sorted_output)
    to = tp.execute(tpairs, sorted_output=sorted_output)
    for i, ((a, b), jc, tc) in enumerate(zip(tpairs, jo, to)):
        hash_kernel = tp.classes[tp.class_of[i]].hash_sched is not None
        assert_contract(jc, tc, a, b, exact or not hash_kernel)
    if sorted_output is None:
        for c, r in zip(to, planned_loop(tp, tpairs)):
            assert_bitwise_prefix(c, r)
    return to


# ---------------------------------------------------------------------------
# Acceptance: 32 heterogeneous products
# ---------------------------------------------------------------------------

def test_batch_32_products_bitwise_and_program_bound(monkeypatch):
    pairs = rmat_fleet(32, 4)
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs)
    tp = T.plan_batch(tpairs)
    assert tp.n_products == 32
    assert_plans_equal(jp, tp)
    assert tp.n_classes <= class_bound(tpairs), tp.n_classes

    built = counting(monkeypatch, [(tbatch, "_build_class_program")])
    outs = compare_fleet(jp, pairs, tp, tpairs, exact=False)
    assert built["_build_class_program"] == tp.n_classes

    counter = counting(monkeypatch, [
        (tbatch, "_build_class_program"), (tbatch, "symbolic"),
        (tsched, "flops_per_row"), (tsched, "make_schedule_eager")])
    built.clear()
    outs2 = tp.execute(tpairs)
    assert not counter, f"repeat execute re-inspected: {counter}"
    for c, c2 in zip(outs, outs2):
        assert_bitwise_prefix(c, c2)


def test_batch_32_products_dyadic_bitwise_against_reference():
    pairs = dyadic_fleet(rmat_fleet(32, 4), 7)
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs)
    tp = T.plan_batch(tpairs)
    assert_plans_equal(jp, tp)
    compare_fleet(jp, pairs, tp, tpairs, exact=True)


def test_batch_heterogeneous_shapes():
    """Different (m, k, n) members land in different classes and still
    match the reference and the port's per-product planned path."""
    cases = [(5, 7, 9), (8, 3, 4), (16, 16, 16), (5, 7, 9), (2, 11, 6)]
    pairs = [(csr_of(rand_dense(m, k, 0.4, seed=2 * i)),
              csr_of(rand_dense(k, n, 0.4, seed=2 * i + 1)))
             for i, (m, k, n) in enumerate(cases)]
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs)
    tp = T.plan_batch(tpairs)
    assert_plans_equal(jp, tp)
    outs = compare_fleet(jp, pairs, tp, tpairs, exact=True)
    for (a, b), c in zip(tpairs, outs):
        assert c.shape == (a.n_rows, b.n_cols)
        assert torch.equal(c.to_dense(), a.to_dense() @ b.to_dense())


@pytest.mark.parametrize("algorithm", ("esc", "heap", "hash_jnp"))
def test_batch_pinned_algorithm_bitwise(algorithm):
    pairs = rmat_fleet(6, 3, seed0=40)
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs, algorithm=algorithm)
    tp = T.plan_batch(tpairs, algorithm=algorithm)
    assert set(tp.algorithms) == {algorithm}
    assert_plans_equal(jp, tp)
    compare_fleet(jp, pairs, tp, tpairs, exact=True)


def test_batch_hash_vector_against_scalar_reference():
    """A pinned ``hash_vector`` fleet: the port's plan equals the
    reference's ``hash`` plan but for the algorithm, and its outputs meet
    the contract against the reference's scalar-probe kernel."""
    pairs = dyadic_fleet(rmat_fleet(6, 4, seed0=50), 9)
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs, algorithm="hash")
    tp = T.plan_batch(tpairs, algorithm="hash_vector")
    assert set(tp.algorithms) == {"hash_vector"}
    assert_plans_equal(jp, tp, skip=("algorithm",))
    before = K.KERNEL_CALLS["plain"]
    compare_fleet(jp, pairs, tp, tpairs, exact=True)
    assert K.KERNEL_CALLS["plain"] > before


@pytest.mark.parametrize("semiring", ("boolean", "min_plus", "plus_first"))
def test_batch_semirings_match_single_dispatch(semiring):
    pairs = rmat_fleet(4, 3, seed0=60)
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs, semiring=semiring)
    tp = T.plan_batch(tpairs, semiring=semiring)
    assert_plans_equal(jp, tp)
    outs = T.spgemm_batch(tpairs, semiring=semiring)
    for i, ((a, b), jc, c) in enumerate(zip(tpairs, jp.execute(pairs),
                                            outs)):
        assert_contract(jc, c, a, b, exact=True)
        single = T.spgemm(a, b, max(int(c.nnz), 1) + 4, algorithm="esc",
                          semiring=semiring)
        assert torch.equal(c.to_dense(), single.to_dense())


def test_batch_masked_members():
    """Masked and unmasked members split classes; masked results prune."""
    pairs = rmat_fleet(4, 3, seed0=80)
    masks = [None, None, csr_of(rand_dense(8, 8, 0.5, seed=7)),
             csr_of(rand_dense(8, 8, 0.5, seed=8))]
    tpairs = port_pairs(pairs)
    tmasks = [None if m is None else to_port(m) for m in masks]
    jp = J.plan_batch(pairs, masks=masks)
    tp = T.plan_batch(tpairs, masks=tmasks)
    assert_plans_equal(jp, tp)
    outs = tp.execute(tpairs)
    for i, ((a, b), m, jc, c) in enumerate(zip(tpairs, tmasks,
                                               jp.execute(pairs), outs)):
        assert_contract(jc, c, a, b,
                        exact=tp.classes[tp.class_of[i]].hash_sched is None)
        if m is not None:
            esc = T.spgemm(a, b, 64, algorithm="esc", mask=m)
            assert torch.equal(c.to_dense(), esc.to_dense())
    assert not ({tp.class_of[2], tp.class_of[3]}
                & {tp.class_of[0], tp.class_of[1]})


def test_batch_shared_b_and_sorted_output(monkeypatch):
    """A fleet sharing one B: the executor gets B once, without a member
    axis, and the kernel reads it in place; sorted output as the plan's
    flag and as a per-call override."""
    b = csr_of(rand_dense(8, 8, 0.5, seed=90))
    pairs = [(csr_of(rand_dense(8, 8, 0.2 + 0.2 * (i % 3), seed=91 + i)), b)
             for i in range(5)]
    tpairs = port_pairs(pairs)
    tb = tpairs[0][1]
    jp = J.plan_batch(pairs, sorted_output=True)
    tp = T.plan_batch(tpairs, sorted_output=True)
    assert_plans_equal(jp, tp)
    for c in compare_fleet(jp, pairs, tp, tpairs, exact=True):
        assert c.sorted_cols
        cols, ip = c.indices.numpy(), c.indptr.numpy()
        for i in range(c.n_rows):
            assert np.all(np.diff(cols[ip[i]:ip[i + 1]]) > 0)

    jp_u = J.plan_batch(pairs)
    tp_u = T.plan_batch(tpairs)
    assert_plans_equal(jp_u, tp_u)
    assert all(cls.b_shared and cls.hash_sched is not None
               for cls in tp_u.classes)
    seen = {"shared": [], "kernel_b": []}
    orig_build = tbatch._build_class_program
    orig_call = K.batched_numeric_call

    def build(*args, **kw):
        seen["shared"].append(kw["b_shared"])
        return orig_build(*args, **kw)

    def call(*args, **kw):
        seen["kernel_b"].append((args[3], args[7], args[8]))
        return orig_call(*args, **kw)

    monkeypatch.setattr(tbatch, "_build_class_program", build)
    monkeypatch.setattr(K, "batched_numeric_call", call)
    outs = compare_fleet(jp_u, pairs, tp_u, tpairs, exact=True,
                         sorted_output=True)
    assert seen["shared"] and all(seen["shared"])
    for indptr_b, b_idx, b_val in seen["kernel_b"]:
        assert indptr_b.dim() == b_idx.dim() == b_val.dim() == 1
        assert indptr_b.data_ptr() == tb.indptr.data_ptr()
        assert b_idx.data_ptr() == tb.indices.data_ptr()
        assert b_val.data_ptr() == tb.data.data_ptr()
    assert all(c.sorted_cols for c in outs)


def test_batch_empty_and_mixed_sortedness_members():
    """Fully empty members and unsorted members mixed with sorted ones ride
    the same fleet without special-casing."""
    empty_a = J.CSR.from_numpy_coo(np.zeros(0, np.int64),
                                   np.zeros(0, np.int64),
                                   np.zeros(0, np.float32), (5, 4), cap=2)
    empty_b = J.CSR.from_numpy_coo(np.zeros(0, np.int64),
                                   np.zeros(0, np.int64),
                                   np.zeros(0, np.float32), (4, 6), cap=1)
    b = csr_of(rand_dense(4, 6, 0.5, seed=101))
    a = csr_of(rand_dense(5, 4, 0.5, seed=102))
    pairs = [(empty_a, b), (a, b), (empty_a, empty_b),
             (a.with_unsorted_flag(), b)]
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs)
    tp = T.plan_batch(tpairs)
    assert_plans_equal(jp, tp)
    outs = compare_fleet(jp, pairs, tp, tpairs, exact=True)
    for (ai, bi), c in zip(tpairs, outs):
        assert torch.equal(c.to_dense(), ai.to_dense() @ bi.to_dense())
    assert int(outs[0].nnz) == 0 and int(outs[2].nnz) == 0


@pytest.mark.parametrize("semiring,share_b", [("plus_times", True),
                                              ("min_plus", False)])
def test_batch_fuzz_case_bitwise_equals_planned_loop(semiring, share_b):
    """A case of the reference's property test (``_fuzz.batch_case``'s
    shape): heterogeneous rectangular members, empty rows, row-scrambled
    unsorted members, optionally one shared B."""
    rng = np.random.default_rng(17 if share_b else 23)
    dims = rng.integers(3, 9, size=(4, 3))
    b_one = csr_of(rand_dense(7, 9, 0.4, seed=3))
    pairs = []
    for i, (m, k, n) in enumerate(dims):
        k = 7 if share_b else int(k)
        a = csr_of(rand_dense(int(m), k, 0.15 * (i % 4), seed=30 + i))
        if i % 2:
            a = scramble_rows(a)
        b = b_one if share_b else scramble_rows(
            csr_of(rand_dense(k, int(n), 0.5, seed=40 + i)))
        pairs.append((a, b))
    tpairs = port_pairs(pairs)
    jp = J.plan_batch(pairs, semiring=semiring)
    tp = T.plan_batch(tpairs, semiring=semiring)
    assert_plans_equal(jp, tp)
    outs = compare_fleet(jp, pairs, tp, tpairs, exact=True)
    for (a, b), c in zip(tpairs, outs):
        assert c.shape == (a.n_rows, b.n_cols)


def test_batch_rejects_heap_on_unsorted_and_bcsr():
    a = to_port(csr_of(rand_dense(6, 6, 0.5, seed=5)))
    au = a.with_unsorted_flag()
    with pytest.raises(AssertionError, match="sorted inputs"):
        T.plan_batch([(au, a)], algorithm="heap", cache=False)
    with pytest.raises(NotImplementedError):
        T.plan_batch([(a, a)], algorithm="bcsr", cache=False)
    with pytest.raises(NotImplementedError):
        T.plan_batch([(a, a)], algorithm="dense", cache=False)
    bad = to_port(csr_of(rand_dense(5, 6, 0.5, seed=6)))
    with pytest.raises(AssertionError, match="do not compose"):
        T.plan_batch([(a, a), (a, bad)], cache=False)
    plan_h = T.plan_batch([(a, a)], algorithm="heap", cache=False)
    with pytest.raises(AssertionError, match="unsorted operand"):
        plan_h.execute([(a.with_unsorted_flag(), a)])


def test_batch_cache_kind_and_cold_zero_entries():
    stats = T.plan_cache_stats()
    for kind in ("spgemm", "dist_1d", "summa", "chain", "chain_1d",
                 "gram", "batch", "batch_power"):
        assert stats["kinds"][kind] == 0
    tpairs = port_pairs(rmat_fleet(3, 3, seed0=11))
    plan = T.plan_batch(tpairs)
    before = T.plan_cache_stats()
    assert before["kinds"]["batch"] == 1
    plan2 = T.plan_batch(tpairs)
    after = T.plan_cache_stats()
    assert plan2 is plan and after["hits"] == before["hits"] + 1
    # the values do not enter the key: a re-weighted fleet hits the plan
    rew = port_pairs(dyadic_fleet(rmat_fleet(3, 3, seed0=11), 3))
    assert T.plan_batch(rew) is plan


def test_batch_structure_check_rejects_drift():
    tpairs = port_pairs(rmat_fleet(2, 3, seed0=21))
    plan = T.plan_batch(tpairs)
    other = trmat.rmat_csr(3, 3, "ER", seed=999, device="cpu")
    with pytest.raises(AssertionError, match="nnz differs|capacities"):
        plan.execute([(other, tpairs[0][1]), tpairs[1]])
    with pytest.raises(AssertionError, match="plan is for 2"):
        plan.execute(tpairs[:1])


# ---------------------------------------------------------------------------
# aggregate_stats
# ---------------------------------------------------------------------------

def test_aggregate_stats_field_by_field():
    pairs = rmat_fleet(5, 4, seed0=3)
    tpairs = port_pairs(pairs)
    tstats = [trecipe.measure_stats(a, b) for a, b in tpairs]
    jstats = [jrecipe.measure_stats(a, b) for a, b in pairs]
    # the same inputs: every field bitwise
    same = [jrecipe.SpGEMMStats(**dataclasses.asdict(s)) for s in tstats]
    want = jrecipe.aggregate_stats(same)
    got = trecipe.aggregate_stats(tstats)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    # each package's own statistics: the Eq. 1/2 row sums are float64 in
    # the port and float32 in the reference (test_torch_plan's tolerance)
    want = jrecipe.aggregate_stats(jstats)
    for f in dataclasses.fields(got):
        if f.name in ("eq1_heap_log", "eq2_hash_sort"):
            assert getattr(got, f.name) == pytest.approx(
                getattr(want, f.name), rel=1e-5)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for so in (False, True):
        assert trecipe.choose_algorithm_from_stats(got, so, "batch") == \
            jrecipe.choose_algorithm_from_stats(want, so, "batch")
    with pytest.raises(AssertionError):
        trecipe.aggregate_stats([])


# ---------------------------------------------------------------------------
# The batched kernel's plain version and launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_b", (False, True), ids=("stacked", "shared"))
def test_batched_numeric_plain_matches_reference_kernel(shared_b):
    """``batched_numeric_plain`` against the reference's batched Pallas
    kernel (interpret mode) on one class's stacked operands."""
    jb = jrmat.rmat_csr(4, 3, "ER", seed=77)
    pairs = [(jrmat.rmat_csr(4, 1 + i, "G500" if i % 2 else "ER",
                             seed=70 + i),
              jb if shared_b else jrmat.rmat_csr(4, 2, "ER", seed=80 + i))
             for i in range(3)]
    pairs = dyadic_fleet(pairs, 5)
    tpairs = port_pairs(pairs)
    tp = T.plan_batch(tpairs, algorithm="hash", cache=False)
    assert all(cls.b_shared for cls in tp.classes) == shared_b
    for cls in tp.classes:
        check_class_plain(cls, tpairs)


def check_class_plain(cls, tpairs):
    M, K_ = cls.shape_a
    _, N = cls.shape_b
    a_ops = [tpairs[i][0] for i in cls.members]
    a_st = tbatch._stack_csr(a_ops, K_, True,
                             tbatch._stack_index(a_ops, M, cls.cap_a))
    if cls.b_shared:
        b_st = tpairs[cls.members[0]][1]
    else:
        bs = [tpairs[i][1] for i in cls.members]
        b_st = tbatch._stack_csr(bs, N, True,
                                 tbatch._stack_index(bs, K_, cls.cap_b))
    off, bts, ic = cls.hash_sched
    tops.reset_kernel_calls()
    cols, vals = tops.spgemm_hash_batched(
        a_st, b_st, cls.cap_c, vector=False, table_size=cls.table_size,
        schedule=(off, bts), indptr_c=ic)
    assert tops.kernel_call_counts()["batched_plain"] == 1
    assert tops.kernel_call_counts()["batched_numeric"] == 0
    n = cls.n_members

    def j(t):
        x = jnp.asarray(t.numpy())
        return x if x.ndim == 2 else jnp.broadcast_to(x, (n,) + x.shape)

    jcols, jvals = jK.batched_numeric_call(
        n, off.shape[1] - 1, M, cls.cap_a, b_st.indices.shape[-1],
        cls.cap_c, cls.table_size, False, True)(
        j(off), j(bts), j(a_st.indptr), j(b_st.indptr), j(ic),
        j(a_st.indices), j(a_st.data), j(b_st.indices), j(b_st.data))
    for e, i in enumerate(cls.members):
        ipc = ic[e, :tpairs[i][0].n_rows + 1]
        shape = (tpairs[i][0].n_rows, tpairs[i][1].n_cols)
        jc = J.CSR(jnp.asarray(ipc.numpy()), jcols[e], jvals[e],
                   jnp.int32(int(ipc[-1])), shape, sorted_cols=False)
        tc = T.CSR(ipc, cols[e], vals[e], ipc[-1], shape, sorted_cols=False)
        assert_contract(jc, tc, *tpairs[i], exact=True)


def test_batched_wrapper_runs_plain_on_cpu():
    tpairs = port_pairs(rmat_fleet(3, 3, seed0=5))
    tp = T.plan_batch(tpairs, algorithm="hash", cache=False)
    tops.reset_kernel_calls()
    tp.execute(tpairs)
    counts = tops.kernel_call_counts()
    assert counts["batched_plain"] == sum(c.hash_sched is not None
                                          for c in tp.classes)
    assert counts["batched_numeric"] == counts["batched_numeric_vector"] \
        == counts["numeric"] == 0


# ---------------------------------------------------------------------------
# The MoE dispatch twin (--device cpu)
# ---------------------------------------------------------------------------

def test_moe_dispatch_twin_cpu():
    from repro_torch.examples import moe_dispatch_batch as moe
    res = moe.moe_dispatch_demo("cpu")
    plan, fd, assign = res["plan"], res["fd"], res["assign"]
    assert plan.n_products == moe.N_EXPERTS
    assert set(plan.algorithms) == {"hash"}
    assert all(cls.b_shared for cls in plan.classes)
    for e, c in enumerate(res["outs"]):
        tokens = np.nonzero((assign == e).any(axis=1))[0]
        assert np.array_equal(c.to_dense().numpy(), fd[tokens])
    # the fleet is the reference example's, bit for bit
    spec = importlib.util.spec_from_file_location(
        "reference_moe_dispatch_batch",
        Path(__file__).resolve().parents[1] / "examples"
        / "moe_dispatch_batch.py")
    jmoe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmoe)
    jpairs, jfd, jassign = jmoe.build_dispatch_fleet()
    assert np.array_equal(jfd, fd) and np.array_equal(jassign, assign)
    for (jg, jf), (g, f) in zip(jpairs, res["pairs"]):
        for x, y in ((jg, g), (jf, f)):
            assert x.shape == y.shape
            for name in ("indptr", "indices", "data", "nnz"):
                assert np.array_equal(np.asarray(getattr(x, name)),
                                      getattr(y, name).numpy()), name
