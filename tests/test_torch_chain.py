"""The port's chain planner (``repro_torch.core.chain``: R.A.P, A^k,
A^T.A, batched powers), ``csr_transpose``, ``chained_flop_bound``,
``aggregation_csr`` and the MCL and block-diagonal twins against
``repro``.

The same numpy-built operands go through ``repro.core`` and
``repro_torch.core`` in one process.  Outputs meet the ROADMAP contract:
``indptr`` and ``nnz`` bitwise, the same columns in each row, values
bitwise on dyadic inputs (R and P are all ones, so dyadic A stays exact
through the chain) and within 1e-5 relative otherwise.  Plan arrays that
depend only on row structure are bitwise equal.

The reference runs ``hash_vector`` stages on its scalar-probe kernel: the
installed jax has no ``pl.load``, so the reference vector kernel cannot
run here.  It is planned with the port's per-stage choices, which the
stage-by-stage test holds against the reference's own recipe.

The slot-order test scrambles an intermediate's rows, as the card's hash
kernel may order them on any call, and shows that the unprotected
composition into a ``pb`` stage reads the wrong values while
``ChainPlan.execute`` does not.
"""
import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

sp = pytest.importorskip("scipy.sparse")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import chain as tchain  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.data import rmat as trmat  # noqa: E402
from repro_torch.examples import mcl as tmcl  # noqa: E402
from repro_torch.examples import moe_dispatch_batch as tmoe  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as hash_ops  # noqa: E402
from repro_torch.kernels.spgemm_pb import ops as pb_ops  # noqa: E402
from _fuzz import VALS, scramble_rows  # noqa: E402
from _oracles import semiring_oracle  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEMIRINGS = ("plus_times", "boolean", "min_plus", "plus_first")
#: relative tolerance of non-dyadic values (sums in another order)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


# ---------------------------------------------------------------------------
# Builders and the contract
# ---------------------------------------------------------------------------

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


def rap(seed=3, scale=5, ef=3, values="dyadic"):
    """The reference test's R.A.P: G500 A, aggregation by 4 (J CSRs)."""
    a = jrmat.rmat_csr(scale, ef, "G500", seed=seed)
    if values == "dyadic":
        a = dyadic(a, seed + 100)
    r, p = jrmat.aggregation_csr(a.n_rows, a.n_rows // 4, seed=seed)
    return r, a, p


def rand_mask(shape, density=0.4, seed=11):
    rng = np.random.default_rng(seed)
    dense = (rng.random(shape) < density).astype(np.float32)
    return J.CSR.from_dense(jnp.asarray(dense))


def scalar_algos(plan):
    """The port plan's per-stage algorithms as the reference runs them
    here (scalar probing for ``hash_vector``)."""
    return tuple("hash" if x == "hash_vector" else x for x in plan.algorithms)


def host(c):
    """(indptr, indices, data, nnz) of a port or reference CSR on the
    host, rows sorted by column over the live prefix."""
    ip = np.asarray(c.indptr if not torch.is_tensor(c.indptr)
                    else c.indptr.numpy())
    ind = np.asarray(c.indices if not torch.is_tensor(c.indices)
                     else c.indices.numpy())
    dat = np.asarray(c.data if not torch.is_tensor(c.data)
                     else c.data.numpy())
    nnz = int(c.nnz)
    rows = np.repeat(np.arange(ip.shape[0] - 1), np.diff(ip))[:nnz]
    order = np.lexsort((ind[:nnz], rows))
    return ip, ind[:nnz][order], dat[:nnz][order], nnz


def assert_contract(jc, tc, exact: bool):
    jip, jind, jdat, jnnz = host(jc)
    tip, tind, tdat, tnnz = host(tc)
    assert jnnz == tnnz and np.array_equal(jip, tip)
    assert np.array_equal(jind, tind), "column sets per row differ"
    if exact:
        assert np.array_equal(jdat, tdat), \
            f"values differ by up to {np.abs(jdat - tdat).max()}"
    else:
        assert (np.abs(jdat - tdat) <= RTOL * np.abs(jdat)).all()


def assert_csr_equal(x, y):
    """Two port CSRs bitwise, arrays and flags."""
    assert x.sorted_cols == y.sorted_cols and x.shape == y.shape
    for f in ("indptr", "indices", "data", "nnz"):
        assert torch.equal(getattr(x, f), getattr(y, f)), f


def scramble(c):
    """Port twin of ``_fuzz.scramble_rows``: each row's entries reversed,
    flagged unsorted; the dense view is unchanged."""
    ip = c.indptr.tolist()
    ind, dat = c.indices.clone(), c.data.clone()
    for i in range(c.n_rows):
        lo, hi = ip[i], ip[i + 1]
        ind[lo:hi] = ind[lo:hi].flip(0)
        dat[lo:hi] = dat[lo:hi].flip(0)
    return T.CSR(c.indptr, ind, dat, c.nnz, c.shape, sorted_cols=False)


def oracle_chain(mats, sr_name, mask=None, complement=False):
    cur = np.asarray(mats[0].to_dense())
    for b in mats[1:]:
        cur = semiring_oracle(cur, np.asarray(b.to_dense()), sr_name)
    if mask is not None:
        md = np.asarray(mask.to_dense()) != 0
        cur = np.where(~md if complement else md, cur, 0)
    return cur


def load_reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# R.A.P and A^3 against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sorted_output", (False, True))
@pytest.mark.parametrize("masked", ("none", "mask", "complement"))
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_rap_matches_reference(semiring, masked, sorted_output):
    r, a, p = rap()
    mask = None if masked == "none" else rand_mask((r.n_rows, p.n_cols))
    complement = masked == "complement"
    kw = dict(semiring=semiring, complement_mask=complement,
              sorted_output=sorted_output, cache=False)
    tp = T.plan_galerkin(to_port(r), to_port(a), to_port(p),
                         mask=None if mask is None else to_port(mask), **kw)
    jp = J.plan_galerkin(r, a, p, algorithm=scalar_algos(tp), mask=mask,
                         **kw)
    # no stage here names A's slots, so every hop stays unsorted
    assert tp.sorted_hops == (False,)
    assert tp.nnz_c == jp.nnz_c and tp.total_flop == jp.total_flop
    tc = tp.execute(to_port(r), to_port(a), to_port(p))
    assert tc.sorted_cols or not sorted_output
    assert_contract(jp.execute(r, a, p), tc, exact=True)
    assert np.allclose(tc.to_dense().numpy(),
                       oracle_chain([r, a, p], semiring, mask, complement),
                       atol=1e-3)


@pytest.mark.parametrize("semiring", ("plus_times", "boolean"))
def test_power3_matches_reference(semiring):
    """R-MAT values (not dyadic): within 1e-5 relative under plus_times;
    each stage's plan arrays bitwise the reference's."""
    a = jrmat.rmat_csr(5, 3, "G500", seed=9)
    ta = to_port(a)
    tp = T.plan_power(ta, 3, semiring=semiring, sorted_output=True,
                      cache=False)
    jp = J.plan_power(a, 3, algorithm=scalar_algos(tp), semiring=semiring,
                      sorted_output=True, cache=False)
    for ts, js in zip(tp.stages, jp.stages):
        for f in ("flop", "offsets", "bin_tsize", "row_nnz_c", "indptr_c"):
            assert np.array_equal(getattr(ts, f).numpy(),
                                  np.asarray(getattr(js, f))), f
    tc = tp.execute(ta, ta, ta)
    assert tc.sorted_cols
    assert_contract(jp.execute(a, a, a), tc,
                    exact=semiring != "plus_times")
    assert np.allclose(tc.to_dense().numpy(),
                       oracle_chain([a, a, a], semiring), atol=1e-3)


def test_sorted_final_chain_bitwise_equals_composition():
    r, a, p = rap(seed=4, values="rmat")
    tr, ta, tpp = to_port(r), to_port(a), to_port(p)
    chain = T.plan_galerkin(tr, ta, tpp, algorithm="hash_jnp",
                            sorted_output=True, cache=False)
    c = chain.execute(tr, ta, tpp)
    p1 = T.plan_spgemm(tr, ta, algorithm="hash_jnp", cache=False)
    c1 = p1.execute(tr, ta)
    p2 = T.plan_spgemm(c1, tpp, algorithm="hash_jnp", sorted_output=True,
                       cache=False)
    assert_csr_equal(c, p2.execute(c1, tpp))
    # and bitwise the reference's chain: both sum in sorted order
    jc = J.plan_galerkin(r, a, p, algorithm="hash_jnp", sorted_output=True,
                         cache=False).execute(r, a, p)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(c, f).numpy(),
                              np.asarray(getattr(jc, f))), f


def test_chain_rejects_wrong_structure():
    r, a, p = map(to_port, rap(seed=5))
    plan = T.plan_galerkin(r, a, p, cache=False)
    with pytest.raises(ValueError):
        plan.execute(r, a, a)          # wrong final operand shape
    with pytest.raises(ValueError):
        plan.execute(r, a)             # wrong operand count
    other = to_port(jrmat.rmat_csr(5, 3, "G500", seed=6))
    with pytest.raises(ValueError):
        plan.execute(r, other, p)      # same shape, other nnz
    with pytest.raises(ValueError):
        T.plan_chain([a])
    with pytest.raises(ValueError):
        T.plan_chain([a, r])           # shapes do not compose
    with pytest.raises(ValueError):
        T.plan_chain([r, a, p], algorithm=("hash",))
    with pytest.raises(ValueError):
        T.plan_power(a, 1)
    with pytest.raises(ValueError):
        T.plan_gram(a).execute(other)


def test_chain_sorted_output_override():
    a = to_port(jrmat.rmat_csr(5, 3, "G500", seed=6))
    plan = T.plan_power(a, 3, algorithm="hash_jnp", sorted_output=False,
                        cache=False)
    c_un = plan.execute(a, a, a)
    assert not c_un.sorted_cols
    c_so = plan.execute([a, a, a], sorted_output=True)
    assert c_so.sorted_cols
    assert torch.equal(c_un.to_dense(), c_so.to_dense())


# ---------------------------------------------------------------------------
# The slot-order rule
# ---------------------------------------------------------------------------

class _Scrambling:
    """A stage whose raw output rows come out reversed, as the card's hash
    kernel may emit them on any call, before its sort epilogue."""

    def __init__(self, stage):
        self.stage = stage

    def execute(self, a, b, sorted_output=None):
        raw = scramble(self.stage.execute(a, b, sorted_output=False))
        so = self.stage.sorted_output if sorted_output is None \
            else sorted_output
        return T.finalize(raw, so)


def test_slot_order_rule_sorts_the_hop_into_pb():
    a = trmat.er_csr(12, 16, seed=0, device="cpu")
    r, p = trmat.aggregation_csr(a.n_rows, a.n_rows // 8, seed=0,
                                 device="cpu")
    T.clear_plan_cache()
    pb_ops.reset_kernel_calls()
    chain = T.plan_galerkin(r, a, p, sorted_output=True)
    # the recipe routes the sorted, barely-compressing last stage to pb
    # by itself, and the rule sorts the hop into it
    assert chain.algorithms[1] == "pb"
    assert chain.sorted_hops == (True,)
    # the hop is decided before the stage is planned: one pb inspection,
    # on the sorted intermediate, and no plan of the unsorted one
    assert pb_ops.kernel_call_counts()["inspect"] == 1
    assert T.plan_cache_stats()["kinds"]["pb"] == 1
    assert T.plan_cache_stats()["kinds"]["spgemm"] == 2
    assert "pb" in tchain.A_SLOT_ALGORITHMS
    want = (r.to_dense().double() @ a.to_dense().double()
            @ p.to_dense().double())
    good = chain.execute(r, a, p)
    assert torch.allclose(good.to_dense().double(), want, rtol=1e-5)

    # the unprotected composition: stage 0's output in another row order
    # than the one stage 1's plan froze its slots on gives wrong values
    inter = scramble(chain.stages[0].execute(r, a, sorted_output=False))
    bad = chain.stages[1].execute(inter, p)
    assert torch.equal(bad.indptr, good.indptr)
    assert not torch.allclose(bad.to_dense().double(), want, rtol=1e-5)

    # ChainPlan.execute, with its intermediate scrambled the same way, is
    # right: the hop's sort makes the order canonical
    scrambled = dataclasses.replace(
        chain, stages=(_Scrambling(chain.stages[0]),) + chain.stages[1:])
    pb_ops.reset_kernel_calls()
    c = scrambled.execute(r, a, p)
    assert pb_ops.kernel_call_counts()["inspect"] == 0
    assert_csr_equal(c, good)
    # ten repeat executes agree
    for _ in range(10):
        assert_csr_equal(chain.execute(r, a, p), good)


@pytest.mark.parametrize("last", ("bcsr", "esc", "heap", "dense"))
def test_slot_order_rule_scrambled_hop_into_other_routes(last):
    """The routes the rule leaves out of :data:`A_SLOT_ALGORITHMS` read A's
    entries at execute time, so a hop into them whose slots are scrambled
    gives the composition.  ``heap`` also needs a row-sorted A, so the hop
    into it is sorted (:data:`SORTED_A_ALGORITHMS`); the others stay
    unsorted."""
    r, a, p = map(to_port, rap(seed=11, scale=6, ef=4))
    chain = T.plan_galerkin(r, a, p, algorithm=("hash", last), cache=False)
    assert chain.algorithms == ("hash", last)
    assert chain.sorted_hops == ((last in tchain.SORTED_A_ALGORITHMS),)
    assert last not in tchain.A_SLOT_ALGORITHMS
    want = (r.to_dense().double() @ a.to_dense().double()
            @ p.to_dense().double())
    good = chain.execute(r, a, p)
    assert torch.equal(good.to_dense().double(), want)     # dyadic: exact
    scrambled = dataclasses.replace(
        chain, stages=(_Scrambling(chain.stages[0]),) + chain.stages[1:])
    c = scrambled.execute(r, a, p)
    assert torch.equal(c.to_dense().double(), want)
    assert_csr_equal(T.finalize(c, True), T.finalize(good, True))
    if not chain.sorted_hops[0]:
        # the stage itself is order-free: handed the scrambled raw
        # intermediate directly, it computes the same product
        inter = scramble(chain.stages[0].execute(r, a, sorted_output=False))
        raw = chain.stages[1].execute(inter, p)
        assert torch.equal(raw.to_dense().double(), want)


def test_slot_order_rule_pinned_pb_and_controls():
    a = trmat.er_csr(10, 8, seed=1, device="cpu")
    r, p = trmat.aggregation_csr(a.n_rows, a.n_rows // 8, seed=1,
                                 device="cpu")
    pinned = T.plan_galerkin(r, a, p, algorithm=("hash", "pb"),
                             sorted_output=True, cache=False)
    assert pinned.algorithms == ("hash", "pb")
    assert pinned.sorted_hops == (True,)
    unsorted = T.plan_galerkin(r, a, p, algorithm="hash", cache=False)
    assert unsorted.sorted_hops == (False,)
    control = T.plan_galerkin(r, a, p, algorithm="hash",
                              sort_intermediates=True, cache=False)
    assert control.sorted_hops == (True,)
    want = unsorted.execute(r, a, p).to_dense()
    for plan in (pinned, control):
        assert torch.allclose(plan.execute(r, a, p).to_dense(), want,
                              rtol=1e-5)
    # a pinned pb stage is planned once, on the sorted hop
    T.clear_plan_cache()
    T.plan_galerkin(r, a, p, algorithm=("hash", "pb"), sorted_output=True)
    assert T.plan_cache_stats()["kinds"]["pb"] == 1


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

def test_repeat_galerkin_hits_chain_cache():
    r, a, p = map(to_port, rap(seed=7))
    c1 = T.galerkin(r, a, p, sorted_output=True)
    stats1 = T.plan_cache_stats()
    assert stats1["kinds"]["chain"] == 1
    c2 = T.galerkin(r, a, p, sorted_output=True)
    stats2 = T.plan_cache_stats()
    assert stats2["misses"] == stats1["misses"]
    assert stats2["hits"] > stats1["hits"]
    assert torch.equal(c1.to_dense(), c2.to_dense())
    # a re-weighted A (same adjacency) reuses the frozen chain
    a2 = T.CSR(a.indptr, a.indices, a.data * 3.0, a.nnz, a.shape,
               a.sorted_cols)
    before = T.plan_cache_stats()
    c3 = T.galerkin(r, a2, p, sorted_output=True)
    assert T.plan_cache_stats()["misses"] == before["misses"]
    assert torch.equal(c3.to_dense(), 3.0 * c1.to_dense())
    # the key is the reference's
    jr, ja, jp = rap(seed=7)
    jkey = J.plan_galerkin(jr, ja, jp, algorithm=scalar_algos(
        T.plan_galerkin(r, a, p, sorted_output=True)),
        sorted_output=True).key
    tkey = T.plan_galerkin(r, a, p, algorithm=scalar_algos(
        T.plan_galerkin(r, a, p, sorted_output=True)),
        sorted_output=True).key
    assert tkey == jkey


# ---------------------------------------------------------------------------
# Transpose and Gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ("sorted", "scrambled"))
def test_csr_transpose_and_perm_bitwise_reference(order):
    a = jrmat.rmat_csr(5, 3, "G500", seed=8)
    if order == "scrambled":
        a = scramble_rows(a)
    jt, jperm = J.csr_transpose(a, return_perm=True)
    tt, tperm = T.csr_transpose(to_port(a), return_perm=True)
    assert tt.shape == jt.shape and tt.sorted_cols and jt.sorted_cols
    for f in ("indptr", "indices", "data", "nnz"):
        x, y = getattr(tt, f).numpy(), np.asarray(getattr(jt, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert tperm.dtype == torch.int32
    assert np.array_equal(tperm.numpy(), np.asarray(jperm))
    ta = to_port(a)
    nnz = int(a.nnz)
    assert torch.equal(ta.data[tperm.long()][:nnz], tt.data[:nnz])
    assert torch.equal(tt.to_dense(), ta.to_dense().T)
    tc = T.csr_transpose(ta, cap=2 * a.cap)
    assert tc.cap == 2 * a.cap and torch.equal(tc.to_dense(), tt.to_dense())
    with pytest.raises(ValueError):
        T.csr_transpose(ta, cap=nnz - 1)


def test_gram_matches_scipy_and_regathers_values_only():
    a = jrmat.rmat_csr(5, 3, "G500", seed=10)
    ta = to_port(a)
    ad = np.asarray(a.to_dense())
    oracle = np.asarray((sp.csr_matrix(ad).T @ sp.csr_matrix(ad)).todense(),
                        np.float32)
    g = T.gram(ta, sorted_output=True)
    assert g.sorted_cols
    assert np.allclose(g.to_dense().numpy(), oracle, rtol=RTOL, atol=1e-6)
    plan = T.plan_gram(ta, sorted_output=True)
    jplan = J.plan_gram(a, sorted_output=True)
    assert plan.algorithm == jplan.algorithm and plan.nnz_c == jplan.nnz_c
    assert np.array_equal(plan.t_perm.numpy(), np.asarray(jplan.t_perm))
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(plan.t_struct, f).numpy(),
                              np.asarray(getattr(jplan.t_struct, f))), f
    # re-weighted operand: the same plan, values re-gathered only
    a2 = T.CSR(ta.indptr, ta.indices, ta.data * 2.0, ta.nnz, ta.shape,
               ta.sorted_cols)
    before = T.plan_cache_stats()
    hash_ops.reset_kernel_calls()
    g2 = T.plan_gram(a2, sorted_output=True).execute(a2)
    assert T.plan_cache_stats()["misses"] == before["misses"]
    assert np.allclose(g2.to_dense().numpy(), 4.0 * oracle, rtol=RTOL,
                       atol=1e-5)
    jg = jplan.execute(a) if jplan.algorithm != "hash_vector" else \
        J.plan_gram(a, algorithm="hash", sorted_output=True).execute(a)
    assert_contract(jg, g, exact=False)


# ---------------------------------------------------------------------------
# Mid-chain recipe hook, capacity bound math, the sort site
# ---------------------------------------------------------------------------

def test_chain_stage_recipes_match_reference_stage_by_stage():
    """An auto chain's stage 1 consumes stage 0's recorded row_nnz_c: its
    choice and plan arrays equal the reference's recipe on the reference's
    own intermediate with the same hook."""
    r, a, p = rap(seed=16, values="rmat")
    tr, ta, tpp = to_port(r), to_port(a), to_port(p)
    chain = T.plan_galerkin(tr, ta, tpp, cache=False)
    j0 = J.plan_spgemm(r, a, cache=False)
    inter = J.plan_spgemm(r, a, algorithm=scalar_algos(chain)[0],
                          cache=False).execute(r, a)
    j1 = J.plan_spgemm(inter, p, a_row_nnz=j0.row_nnz_c, cache=False)
    for ts, js in zip(chain.stages, (j0, j1)):
        assert ts.algorithm == js.algorithm
        assert ts.provenance == js.provenance == "heuristic"
        for f in ("flop", "offsets", "bin_tsize", "row_nnz_c", "indptr_c"):
            assert np.array_equal(getattr(ts, f).numpy(),
                                  np.asarray(getattr(js, f))), f
    # the hook reaches the stage's cache key
    t1 = T.plan_spgemm(chain.stages[0].execute(tr, ta), tpp, cache=False)
    assert t1.key != chain.stages[1].key


def test_chained_flop_bound_dominates_real_flops():
    a = jrmat.rmat_csr(5, 3, "G500", seed=17)
    b = jrmat.rmat_csr(5, 3, "ER", seed=18)
    ta, tb = to_port(a), to_port(b)
    plan = T.plan_spgemm(ta, tb, cache=False)
    inter = plan.execute(ta, tb)
    bound = T.chained_flop_bound(plan.row_nnz_c, ta)
    jbound = J.chained_flop_bound(jnp.asarray(plan.row_nnz_c.numpy()), a)
    assert bound.dtype == torch.int32
    assert np.array_equal(bound.numpy(), np.asarray(jbound))
    assert bool((bound >= tsched.flops_per_row(inter, ta)).all())


def test_finalize_is_the_single_sort_site():
    a = to_port(jrmat.rmat_csr(5, 3, "G500", seed=19))
    cd = a.to_dense() @ a.to_dense()
    u = T.spgemm(a, a, int((cd != 0).sum()), algorithm="hash_jnp")
    assert not u.sorted_cols
    s = T.finalize(u, True)
    assert s.sorted_cols and T.finalize(s, True) is s
    assert T.finalize(u, False) is u
    assert torch.allclose(s.to_dense(), cd, rtol=RTOL)


# ---------------------------------------------------------------------------
# Batched powers
# ---------------------------------------------------------------------------

def test_plan_batch_power_matches_per_product_chains():
    mats = [dyadic(jrmat.rmat_csr(3, 2, "G500", seed=50 + i), i)
            for i in range(4)]
    tmats = [to_port(m) for m in mats]
    # the same algorithm on both port sides: bitwise on the live prefix
    plan = T.plan_batch_power(tmats, 3, algorithm="hash")
    outs = plan.execute(tmats)
    jplan = J.plan_batch_power(mats, 3, algorithm="hash_jnp")
    jouts = jplan.execute(mats)
    for m, c, jc in zip(tmats, outs, jouts):
        ref = T.plan_power(m, 3, algorithm="hash").execute([m, m, m])
        nnz = int(ref.nnz)
        assert torch.equal(c.indptr, ref.indptr) and int(c.nnz) == nnz
        assert torch.equal(c.indices[:nnz], ref.indices[:nnz])
        assert torch.equal(c.data[:nnz], ref.data[:nnz])
        assert_contract(jc, c, exact=True)
    assert plan.n_classes < plan.n_products * plan.n_stages
    # a repeat plan is one cache hit, and the key is the reference's
    before = T.plan_cache_stats()
    assert T.plan_batch_power(tmats, 3, algorithm="hash") is plan
    after = T.plan_cache_stats()
    assert after["misses"] == before["misses"]
    assert after["kinds"]["batch_power"] == 1
    assert T.plan_batch_power(tmats, 3, algorithm="hash_jnp").key == \
        jplan.key
    with pytest.raises(ValueError):
        plan.execute(tmats[:3])
    with pytest.raises(ValueError):
        T.plan_batch_power(tmats, 1)


def test_block_diagonal_twin_cpu():
    res = tmoe.block_diagonal_demo("cpu")
    plan = res["plan"]
    assert plan.n_products == 12 and plan.n_stages == 1
    jblocks = [jrmat.rmat_csr(4, 1 + (i % 3), "G500" if i % 2 else "ER",
                              seed=40 + i) for i in range(12)]
    jplan = J.plan_batch_power(jblocks, 2)
    assert plan.nnz_cs == jplan.nnz_cs
    assert plan.n_classes == jplan.n_classes
    for b, jb in zip(res["blocks"], jblocks):
        assert np.array_equal(b.indices.numpy(), np.asarray(jb.indices))


# ---------------------------------------------------------------------------
# Data and the MCL twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,coarse,seed", [(64, 16, 0), (1000, 125, 3)])
def test_aggregation_csr_bitwise_reference(n, coarse, seed):
    jr, jp = jrmat.aggregation_csr(n, coarse, seed=seed)
    tr, tp = trmat.aggregation_csr(n, coarse, seed=seed, device="cpu")
    for j, t in ((jr, tr), (jp, tp)):
        assert t.shape == j.shape and t.sorted_cols == j.sorted_cols
        for f in ("indptr", "indices", "data", "nnz"):
            x, y = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_mcl_twin_recovers_planted_clusters_cpu(capsys):
    tmcl.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "recovered all 3 planted clusters" in out and "mcl: OK" in out


def test_mcl_twin_steps_match_reference():
    jmcl = load_reference_example("mcl")
    jg = jmcl.clustered_graph(3, 12, seed=0)
    tg = tmcl.clustered_graph(3, 12, seed=0, device="cpu")
    for f in ("indptr", "indices", "data", "nnz"):
        assert np.array_equal(getattr(tg, f).numpy(),
                              np.asarray(getattr(jg, f))), f
    # one expansion of the normalized flow matrix, then each step
    jm = jmcl.row_normalize(jmcl._with_self_loops(jg))
    tm = tmcl.row_normalize(tmcl._with_self_loops(tg))
    assert np.allclose(tm.data.numpy(), np.asarray(jm.data), rtol=1e-6)
    jx = J.plan_spgemm(jm, jm, algorithm="hash_jnp").execute(jm, jm)
    tx = T.plan_spgemm(tm, tm, algorithm="hash").execute(tm, tm)
    assert_contract(jx, tx, exact=False)
    jx = J.finalize(jx, True)
    tx = T.finalize(tx, True)
    for jstep, tstep in ((lambda c: jmcl.inflate(c, jnp.float32(1.5)),
                          lambda c: tmcl.inflate(c, 1.5)),
                         (lambda c: jmcl.prune(c, jnp.float32(0.02), 512),
                          lambda c: tmcl.prune(c, 0.02, 512))):
        jy, ty = jstep(jx), tstep(tx)
        assert int(jy.nnz) == int(ty.nnz)
        assert np.array_equal(np.asarray(jy.indptr), ty.indptr.numpy())
        assert np.array_equal(np.asarray(jy.indices), ty.indices.numpy())
        assert np.allclose(ty.data.numpy(), np.asarray(jy.data), rtol=1e-5,
                           atol=1e-7)
