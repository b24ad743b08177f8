"""The port's recipe and planner against ``repro``.

Plan arrays (``flop``, ``offsets``, ``bin_tsize``, ``table_size``,
``row_nnz_c``, ``indptr_c``, ``nnz_c``, ``cap_c``) and the recipe's choice
must be bitwise equal on the same host operands; planned executes must
match the reference's; the plan cache keeps the reference's semantics
(structure-keyed, re-weighted inputs hit, LRU of 256, re-store refreshes
recency).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.plan as jplan  # noqa: E402
from repro.core import recipe as jrecipe  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.plan as tplan  # noqa: E402
from repro_torch.core import recipe as trecipe  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as tops  # noqa: E402
from _fuzz import VALS  # noqa: E402

PLAN_ARRAYS = ("flop", "offsets", "bin_tsize", "row_nnz_c", "indptr_c")
PLAN_INTS = ("table_size", "nnz_c", "cap_c", "total_flop", "flop_cap",
             "row_cap", "k_width", "algorithm", "provenance")


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def reweight(a, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros(a.cap, np.float32)
    d[:int(a.nnz)] = rng.choice(VALS, size=int(a.nnz))
    return J.CSR(a.indptr, a.indices, jnp.asarray(d), a.nnz, a.shape)


def assert_plans_equal(jp, tp):
    for f in PLAN_ARRAYS:
        x, y = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in PLAN_INTS:
        assert getattr(jp, f) == getattr(tp, f), f


def assert_csr_equal(jc, tc):
    assert jc.sorted_cols == tc.sorted_cols
    for f in ("indptr", "indices", "data", "nnz"):
        assert np.array_equal(np.asarray(getattr(jc, f)),
                              getattr(tc, f).numpy()), f


#: (preset, scale, ef): the recipe picks hash, hash_vector, heap or pb
#: across these and the two sortednesses.
FIXTURES = [("ER", 7, 12), ("G500", 7, 12), ("G500", 6, 4), ("ER", 8, 8)]


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


@pytest.mark.parametrize("sorted_output", (False, True))
@pytest.mark.parametrize("fx", FIXTURES, ids=lambda f: f"{f[0]}{f[1]}ef{f[2]}")
def test_auto_plan_arrays_and_choice_bitwise(fx, sorted_output):
    a = jrmat.rmat_csr(fx[1], fx[2], fx[0], seed=0)
    ta = to_port(a)
    want, _ = J.recommend(a, a, sorted_output=sorted_output)
    got, _ = T.recommend(ta, ta, sorted_output=sorted_output)
    assert got == want
    jp = J.plan_spgemm(a, a, sorted_output=sorted_output, cache=False)
    tp = T.plan_spgemm(ta, ta, sorted_output=sorted_output, cache=False)
    assert_plans_equal(jp, tp)
    if jp.algorithm == "bcsr":
        for f in ("flop", "offsets", "bin_tsize", "row_nnzb_c", "indptr_cb"):
            assert np.array_equal(np.asarray(getattr(jp.bcsr_plan, f)),
                                  getattr(tp.bcsr_plan, f).numpy()), f
    if jp.algorithm == "pb":
        for f in ("src_a", "src_b", "seg", "bucket_nnz", "cols_c"):
            assert np.array_equal(np.asarray(getattr(jp.pb_plan, f)),
                                  getattr(tp.pb_plan, f).numpy()), f


@pytest.mark.parametrize("bucket_caps", (False, True))
@pytest.mark.parametrize("algo", ("esc", "heap", "hash_jnp"))
def test_planned_execute_bitwise(algo, bucket_caps):
    a = jrmat.rmat_csr(6, 6, "G500", seed=1)
    b = jrmat.rmat_csr(6, 6, "ER", seed=2)
    jp = J.plan_spgemm(a, b, algorithm=algo, bucket_caps=bucket_caps)
    tp = T.plan_spgemm(to_port(a), to_port(b), algorithm=algo,
                       bucket_caps=bucket_caps)
    assert_plans_equal(jp, tp)
    assert_csr_equal(jp.execute(a, b), tp.execute(to_port(a), to_port(b)))


@pytest.mark.parametrize("sr,kind", [("plus_times", "mask"),
                                     ("boolean", "complement"),
                                     ("min_plus", "none")])
def test_planned_semiring_and_mask_bitwise(sr, kind):
    a = reweight(jrmat.rmat_csr(5, 4, "G500", seed=1), 1)
    b = reweight(jrmat.rmat_csr(5, 4, "ER", seed=2), 2)
    mask = jrmat.rmat_csr(5, 6, "ER", seed=3)
    kw = {} if kind == "none" else {"mask": mask,
                                    "complement_mask": kind == "complement"}
    tkw = {k: (to_port(v) if k == "mask" else v) for k, v in kw.items()}
    jp = J.plan_spgemm(a, b, semiring=sr, **kw)
    tp = T.plan_spgemm(to_port(a), to_port(b), semiring=sr, **tkw)
    assert_plans_equal(jp, tp)
    assert_csr_equal(jp.execute(a, b), tp.execute(to_port(a), to_port(b)))


@pytest.mark.parametrize("algo", ("hash", "hash_vector"))
def test_planned_hash_execute_matches_reference(algo):
    """The port's plan runs the numeric wrapper (plain version on the CPU);
    the reference runs its scalar Pallas kernel in interpret mode.  Dyadic
    values: structure and values bitwise after a per-row sort."""
    a = reweight(jrmat.rmat_csr(6, 6, "G500", seed=4), 5)
    ta = to_port(a)
    jp = J.plan_spgemm(a, a, algorithm="hash")
    tp = T.plan_spgemm(ta, ta, algorithm=algo)
    if algo == "hash":
        assert_plans_equal(jp, tp)
    tops.reset_kernel_calls()
    tc = tp.execute(ta, ta)
    assert tops.kernel_call_counts()["plain"] == 1        # numeric only
    assert not tc.sorted_cols
    assert_csr_equal(jp.execute(a, a, sorted_output=True),
                     tp.execute(ta, ta, sorted_output=True))
    assert np.array_equal(tc.indptr.numpy(), tp.indptr_c.numpy())


def test_structure_key_is_the_references():
    a = jrmat.rmat_csr(5, 4, "G500", seed=0)
    assert T.structure_key(to_port(a)) == J.structure_key(a)


def test_cache_hits_reweighted_input_and_rejects_other_structure():
    a = jrmat.rmat_csr(5, 4, "G500", seed=0)
    ta = to_port(a)
    p1 = T.plan_spgemm(ta, ta)
    p2 = T.plan_spgemm(to_port(reweight(a, 9)), ta)
    assert p2 is p1
    stats = T.plan_cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 1, 1)
    assert stats["kinds"]["spgemm"] == 1 and set(tplan.PLAN_KINDS) <= \
        set(stats["kinds"])
    other = to_port(jrmat.rmat_csr(5, 4, "G500", seed=1))
    assert T.plan_spgemm(other, other) is not p1
    with pytest.raises(ValueError):
        p1.execute(other, ta)
    with pytest.raises(ValueError):
        p1.check_structure(to_port(jrmat.rmat_csr(4, 4, "ER", seed=0)), ta)
    T.clear_plan_cache()
    assert T.plan_cache_stats()["size"] == 0


def test_cache_lru_bound_and_restore_refreshes_recency():
    cap = tplan.PLAN_CACHE_CAPACITY
    assert cap == jplan.PLAN_CACHE_CAPACITY == 256
    cpu = torch.device("cpu")
    for i in range(cap + 10):
        tplan.cache_store(("spgemm", i), cpu, i)
    assert T.plan_cache_stats()["size"] == cap
    assert tplan.cache_lookup(("spgemm", 0), cpu) is None      # evicted first
    oldest = ("spgemm", 10)
    tplan.cache_store(oldest, cpu, "again")             # refresh recency
    tplan.cache_store(("spgemm", "new"), cpu, 0)         # evicts the next
    assert tplan.cache_lookup(oldest, cpu) == "again"
    assert tplan.cache_lookup(("spgemm", 11), cpu) is None
    assert tplan.cache_lookup(("spgemm", 12), cpu) == 12     # a hit is newest
    # the same key on another device is another entry
    assert tplan.cache_lookup(("spgemm", 12), "meta") is None


def test_unported_plan_options_raise(tmp_path):
    """Every plan option is ported now: ``autotune=True`` plans through
    the measured recipe (``tests/test_torch_autotune.py``) and the recipe's
    measured mode answers; nothing raises "not ported yet"."""
    ta = to_port(jrmat.rmat_csr(5, 4, "G500", seed=0))
    db = str(tmp_path / "db.json")
    plan = T.plan_spgemm(ta, ta, cache=False, autotune=True, autotune_db=db)
    assert plan.provenance == "measured"
    algo, _ = trecipe.recommend(ta, ta, mode="measured", db=db)
    assert algo == plan.algorithm
    assert T.plan_spgemm(ta, ta, cache=False,
                         algorithm="bcsr").algorithm == "bcsr"


@pytest.mark.parametrize("probe", (False, True))
@pytest.mark.parametrize("fx", FIXTURES, ids=lambda f: f"{f[0]}{f[1]}ef{f[2]}")
def test_measure_stats_match_reference(fx, probe):
    a = jrmat.rmat_csr(fx[1], fx[2], fx[0], seed=0)
    b = jrmat.rmat_csr(fx[1], fx[2], "ER", seed=1)
    rows = np.asarray(J.symbolic(a, b)[0])
    for row_nnz_c in (None, rows):
        js = jrecipe.measure_stats(a, b, row_nnz_c=row_nnz_c,
                                   probe_blocks=probe)
        ts = trecipe.measure_stats(
            to_port(a), to_port(b), probe_blocks=probe,
            row_nnz_c=None if row_nnz_c is None else torch.tensor(rows))
        for f in ("n_rows", "n_cols", "nnz_a", "flop", "nnz_c_est",
                  "max_row_flop", "mean_row_nnz_a", "row_skew",
                  "compression_ratio", "density_ef", "block_density",
                  "mask_density", "has_mask"):
            assert getattr(js, f) == getattr(ts, f), f
        for f in ("eq1_heap_log", "eq2_hash_sort"):
            assert getattr(ts, f) == pytest.approx(getattr(js, f), rel=1e-5)
        jc = jrecipe.model_costs(js, True)
        tc = trecipe.model_costs(ts, True)
        assert tc == pytest.approx(jc, rel=1e-5)
        for uc in ("AxA", "LxU", "tall_skinny", "masked", "batch", "dist"):
            for so in (False, True):
                assert trecipe.choose_algorithm_from_stats(ts, so, uc) == \
                    jrecipe.choose_algorithm_from_stats(js, so, uc)
