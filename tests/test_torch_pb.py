"""The port's propagation-blocking route against ``repro``.

Same host operands in one process (made with numpy from a seed):
``pb_bucket_layout`` and every ``plan_pb`` array must be bitwise equal to
the reference's; the plain scatter/merge (what the CUDA wrappers run on
CPU tensors) must match the reference's Pallas pair run in interpret mode
-- bitwise on dyadic values, within 1 ulp per accumulated product
otherwise; general semirings run the plain twin and must match the
reference's twin; the recipe must route sorted ER products to ``pb`` in
both packages, and the planner and dispatcher must nest, cache and pad as
the reference does.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_pb import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.kernels.spgemm_pb import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_pb import ref as tref  # noqa: E402
from _fuzz import VALS, csr_of, rand_dense, scramble_rows  # noqa: E402

PB_ARRAYS = ("src_a", "src_b", "seg", "bucket_nnz", "cols_c", "indptr_c",
             "row_nnz_c")
PB_INTS = ("n_buckets", "bucket_w", "bucket_cap", "nnz_c", "cap_c",
           "total_flop", "has_mask", "complement_mask", "semiring")

#: test_pb.py's GRID: (m, k, n, density A, density B, n_buckets)
GRID = [
    (16, 16, 16, 0.2, 0.2, None),
    (16, 16, 16, 0.2, 0.2, 1),
    (16, 16, 16, 0.3, 0.3, 4),
    (24, 8, 40, 0.3, 0.15, 8),
    (40, 24, 8, 0.15, 0.3, 2),
    (5, 7, 3, 0.6, 0.6, None),
    (16, 16, 16, 0.05, 0.05, 4),
]
#: R-MAT A·A fixtures (preset, scale, edge factor); G500 rows collide, so
#: its products hold duplicate (r, c) coordinates
RMAT = [("ER", 5, 8), ("ER", 7, 8), ("G500", 6, 8), ("G500", 8, 8)]


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def dyadic(a, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros(a.cap, np.float32)
    d[:int(a.nnz)] = rng.choice(VALS, size=int(a.nnz))
    return J.CSR(a.indptr, a.indices, jnp.asarray(d), a.nnz, a.shape,
                 a.sorted_cols)


def assert_pb_plans_equal(jp, tp):
    for f in PB_ARRAYS:
        x, y = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f
    for f in PB_INTS:
        assert getattr(jp, f) == getattr(tp, f), f


def assert_csr_equal(jc, tc):
    assert jc.shape == tc.shape and jc.sorted_cols == tc.sorted_cols
    for f in ("indptr", "indices", "data", "nnz"):
        x, y = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert x.shape == y.shape and np.array_equal(x, y), f


def products_per_slot(plan):
    """Products accumulated into each output slot (the ulp budget)."""
    seg = plan.seg.numpy().ravel()
    return np.bincount(seg[seg < plan.cap_c], minlength=plan.cap_c)


def assert_within_ulp_per_product(want, got, counts):
    want, got = np.asarray(want), np.asarray(got)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= np.maximum(counts, 1) * ulp)


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


# ---------------------------------------------------------------------------
# (a) bucket layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_cols", (1, 7, 64, 1000, 262144))
def test_bucket_layout_equal(n_cols):
    assert tsched.PB_BUCKET_BUDGET == jsched.PB_BUCKET_BUDGET
    for n_buckets in (None, 1, 3, 16, 5000):
        for total_flop in (None, 0, 1, 4097, 67_106_183):
            for budget in (100, 2048):
                args = (n_cols, n_buckets)
                kw = {"total_flop": total_flop, "budget": budget}
                assert tsched.pb_bucket_layout(*args, **kw) == \
                    jsched.pb_bucket_layout(*args, **kw), (args, kw)


# ---------------------------------------------------------------------------
# (b) plan arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,da,db,nb", GRID)
def test_plan_arrays_bitwise_on_grid(m, k, n, da, db, nb):
    a = csr_of(rand_dense(m, k, da, seed=m * 31 + n))
    b = csr_of(rand_dense(k, n, db, seed=m * 37 + k))
    jp = J.plan_pb(a, b, n_buckets=nb, cache=False)
    tp = T.plan_pb(to_port(a), to_port(b), n_buckets=nb, cache=False)
    assert_pb_plans_equal(jp, tp)


@pytest.mark.parametrize("fx", RMAT, ids=lambda f: f"{f[0]}{f[1]}")
def test_plan_arrays_bitwise_on_rmat(fx):
    a = jrmat.rmat_csr(fx[1], fx[2], fx[0], seed=0)
    jp = J.plan_pb(a, a, cache=False)
    tp = T.plan_pb(to_port(a), to_port(a), cache=False)
    assert_pb_plans_equal(jp, tp)
    if fx[0] == "G500":
        assert tp.total_flop > tp.nnz_c        # duplicate (r, c) products


@pytest.mark.parametrize("case", ("empty_a", "empty_b", "disjoint_k"))
def test_plan_arrays_bitwise_on_empty_products(case):
    m, k, n = 8, 6, 10
    ad, bd = rand_dense(m, k, 0.4, seed=4), rand_dense(k, n, 0.4, seed=3)
    if case == "empty_a":
        ad = np.zeros_like(ad)
    elif case == "empty_b":
        bd = np.zeros_like(bd)
    else:
        ad[:, 3:] = 0
        bd[:3, :] = 0
    a, b = csr_of(ad), csr_of(bd)
    jp = J.plan_pb(a, b, cache=False)
    tp = T.plan_pb(to_port(a), to_port(b), cache=False)
    assert tp.nnz_c == 0 and tp.total_flop == 0
    assert_pb_plans_equal(jp, tp)
    assert_csr_equal(jp.execute(a, b), tp.execute(to_port(a), to_port(b)))


@pytest.mark.parametrize("which", ("a", "b", "both"))
def test_plan_arrays_bitwise_on_unsorted_inputs(which):
    a = csr_of(rand_dense(12, 10, 0.35, seed=7))
    b = csr_of(rand_dense(10, 14, 0.3, seed=8))
    if which in ("a", "both"):
        a = scramble_rows(a)
    if which in ("b", "both"):
        b = scramble_rows(b)
    jp = J.plan_pb(a, b, cache=False)
    tp = T.plan_pb(to_port(a), to_port(b), cache=False)
    assert_pb_plans_equal(jp, tp)
    assert_csr_equal(jp.execute(a, b), tp.execute(to_port(a), to_port(b)))


@pytest.mark.parametrize("complement", (False, True))
def test_plan_arrays_bitwise_with_mask(complement):
    a = jrmat.rmat_csr(6, 8, "G500", seed=1)
    b = jrmat.rmat_csr(6, 8, "ER", seed=2)
    mask = jrmat.rmat_csr(6, 6, "ER", seed=3)
    jp = J.plan_pb(a, b, mask=mask, complement_mask=complement, cache=False)
    tp = T.plan_pb(to_port(a), to_port(b), mask=to_port(mask),
                   complement_mask=complement, cache=False)
    assert tp.has_mask
    assert_pb_plans_equal(jp, tp)


# ---------------------------------------------------------------------------
# (c) plain scatter/merge against the reference's Pallas pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values", ("dyadic", "rmat"))
@pytest.mark.parametrize("fx", RMAT[1:], ids=lambda f: f"{f[0]}{f[1]}")
def test_plain_pair_matches_interpret_kernels(fx, values):
    a = jrmat.rmat_csr(fx[1], fx[2], fx[0], seed=0)
    if values == "dyadic":
        a = dyadic(a, 11)
    ta = to_port(a)
    jp = J.plan_pb(a, a, cache=False)
    tp = T.plan_pb(ta, ta, cache=False)
    jpp = jops.pb_scatter(a.data, a.data, jp.src_a, jp.src_b, jp.bucket_nnz,
                          interpret=True)
    tops.reset_kernel_calls()
    tpp = tops.pb_scatter(ta.data, ta.data, tp.src_a, tp.src_b,
                          tp.bucket_nnz)
    # one rounding per product on both sides: bitwise always
    assert np.array_equal(np.asarray(jpp), tpp.numpy())
    jdata = jops.pb_merge(jpp, jp.seg, jp.bucket_nnz, jp.cap_c,
                          interpret=True)
    tdata = tops.pb_merge(tpp, tp.seg, tp.bucket_nnz, tp.cap_c)
    assert tops.kernel_call_counts() == {"inspect": 0, "scatter": 0,
                                         "merge": 0, "plain": 2,
                                         "batched_scatter": 0,
                                         "batched_merge": 0,
                                         "batched_plain": 0}
    if values == "dyadic":
        assert np.array_equal(np.asarray(jdata), tdata.numpy())
    else:
        assert_within_ulp_per_product(jdata, tdata.numpy(),
                                      products_per_slot(tp))
    jc = jp.execute(a, a)
    tc = tp.execute(ta, ta)
    assert tc.sorted_cols
    for f in ("indptr", "indices", "nnz"):
        assert np.array_equal(np.asarray(getattr(jc, f)),
                              getattr(tc, f).numpy()), f


def test_plain_pair_clips_indices_and_zeroes_pad_lanes():
    bucket_nnz = torch.tensor([3, 0, 2], dtype=torch.int32)
    src_a = torch.tensor([[0, 5, -2, 7], [1, 1, 1, 1], [2, 9, 0, 0]],
                         dtype=torch.int32)
    src_b = torch.tensor([[1, -1, 9, 3], [0, 0, 0, 0], [0, 2, 4, 4]],
                         dtype=torch.int32)
    a_data = torch.tensor([0.5, 1.5, 2.0])
    b_data = torch.tensor([1.0, 2.0, 4.0])
    pp = tref.scatter_plain(bucket_nnz, src_a, src_b, a_data, b_data)
    want = np.array([[1.0, 2.0, 2.0, 0], [0, 0, 0, 0], [2.0, 8.0, 0, 0]],
                    np.float32)
    assert np.array_equal(pp.numpy(), want)
    seg = torch.tensor([[0, 1, 1, 9], [0, 0, 0, 0], [2, 7, 9, 9]],
                       dtype=torch.int32)
    data = tref.merge_plain(bucket_nnz, seg, pp, 3)
    assert np.array_equal(data.numpy(), np.array([1.0, 4.0, 10.0],
                                                 np.float32))
    jpp = jops.pb_scatter(jnp.asarray(a_data.numpy()),
                          jnp.asarray(b_data.numpy()),
                          jnp.asarray(src_a.numpy()),
                          jnp.asarray(src_b.numpy()),
                          jnp.asarray(bucket_nnz.numpy()), interpret=True)
    assert np.array_equal(np.asarray(jpp), want)
    jdata = jops.pb_merge(jpp, jnp.asarray(seg.numpy()),
                          jnp.asarray(bucket_nnz.numpy()), 3, interpret=True)
    assert np.array_equal(np.asarray(jdata), data.numpy())


# ---------------------------------------------------------------------------
# (d) general semirings through the plain twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("semiring", ("boolean", "min_plus", "plus_first"))
def test_general_semirings_match_reference(semiring):
    a = dyadic(jrmat.rmat_csr(6, 8, "G500", seed=4), 12)
    b = dyadic(jrmat.rmat_csr(6, 8, "ER", seed=5), 13)
    jp = J.plan_pb(a, b, semiring=semiring, cache=False)
    tp = T.plan_pb(to_port(a), to_port(b), semiring=semiring, cache=False)
    assert_pb_plans_equal(jp, tp)
    tops.reset_kernel_calls()
    tc = tp.execute(to_port(a), to_port(b))
    assert tops.kernel_call_counts()["plain"] == 0     # twin, no kernel
    assert_csr_equal(jp.execute(a, b), tc)


# ---------------------------------------------------------------------------
# (e) recipe, nested plan, cache and re-inspection
# ---------------------------------------------------------------------------

def test_sorted_er_plan_chooses_pb_and_never_reinspects():
    a = jrmat.rmat_csr(8, 8, "ER", seed=0)
    ta = to_port(a)
    jp = J.plan_spgemm(a, a, sorted_output=True)
    tops.reset_kernel_calls()
    tp = T.plan_spgemm(ta, ta, sorted_output=True)
    assert jp.algorithm == tp.algorithm == "pb"
    assert_pb_plans_equal(jp.pb_plan, tp.pb_plan)
    assert T.plan_cache_stats()["kinds"]["pb"] == 1
    assert tops.kernel_call_counts()["inspect"] == 1
    c1 = tp.execute(ta, ta)
    c2 = tp.execute(ta, ta)
    assert tops.kernel_call_counts() == {"inspect": 1, "scatter": 0,
                                         "merge": 0, "plain": 4,
                                         "batched_scatter": 0,
                                         "batched_merge": 0,
                                         "batched_plain": 0}
    assert_csr_equal(c1, c2)
    assert T.plan_spgemm(ta, ta, sorted_output=True) is tp
    assert T.plan_pb(ta, ta) is tp.pb_plan               # cache hit
    assert tops.kernel_call_counts()["inspect"] == 1
    jc = jp.execute(a, a)
    for f in ("indptr", "indices", "nnz"):
        assert np.array_equal(np.asarray(getattr(jc, f)),
                              getattr(c1, f).numpy()), f
    assert_within_ulp_per_product(jc.data, c1.data.numpy(),
                                  products_per_slot(tp.pb_plan))


def test_bucket_caps_plan_pads_pb_output():
    a = dyadic(jrmat.rmat_csr(6, 8, "ER", seed=0), 14)
    ta = to_port(a)
    jp = J.plan_spgemm(a, a, algorithm="pb", bucket_caps=True)
    tp = T.plan_spgemm(ta, ta, algorithm="pb", bucket_caps=True)
    assert tp.cap_c > tp.pb_plan.cap_c
    c = tp.execute(ta, ta)
    assert c.cap == tp.cap_c
    assert_csr_equal(jp.execute(a, a), c)


# ---------------------------------------------------------------------------
# (f) dispatcher pads to the caller's capacity; (g) structure == hash's
# ---------------------------------------------------------------------------

def test_dispatcher_pb_pads_to_caller_cap():
    a = csr_of(rand_dense(10, 10, 0.3, seed=16))
    b = csr_of(rand_dense(10, 10, 0.3, seed=17))
    cap = int(J.symbolic(a, b)[1][-1]) + 13
    jc = J.spgemm(a, b, cap_c=cap, algorithm="pb", sorted_output=True,
                  cache=False)
    tc = T.spgemm(to_port(a), to_port(b), cap_c=cap, algorithm="pb",
                  sorted_output=True, cache=False)
    assert tc.indices.shape[0] == cap
    assert_csr_equal(jc, tc)
    with pytest.raises(ValueError):
        T.spgemm(to_port(a), to_port(b), cap_c=cap - 14, algorithm="pb")


@pytest.mark.parametrize("fx", RMAT[1:], ids=lambda f: f"{f[0]}{f[1]}")
def test_pb_structure_equals_sorted_hash_plan(fx):
    ta = to_port(dyadic(jrmat.rmat_csr(fx[1], fx[2], fx[0], seed=0), 15))
    pbp = T.plan_pb(ta, ta, cache=False)
    hp = T.plan_spgemm(ta, ta, algorithm="hash", sorted_output=True,
                       cache=False)
    c_pb = pbp.execute(ta, ta)
    c_h = hp.execute(ta, ta)
    assert pbp.nnz_c == hp.nnz_c
    assert torch.equal(pbp.row_nnz_c, hp.row_nnz_c)
    assert_csr_equal(c_h, c_pb)
