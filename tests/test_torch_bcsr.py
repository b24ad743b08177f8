"""The port's BCSR route against ``repro`` (and scipy BSR).

Same host operands in one process (made with numpy from a seed): the
conversions (``csr_to_bcsr``, ``BCSR.from_dense``, ``to_dense``,
``bcsr_to_csr`` with and without ``prune``) and the numpy bridge must be
bitwise equal to the reference's; ``bcsr_inspect``'s six outputs and every
``BCSRPlan`` array bitwise equal; ``plan.execute`` (the plain version of
the CUDA kernel on CPU tensors) must give the reference's block row
pointer bitwise, the same block-column set per block row, and blocks
bitwise on dyadic values (within 1 ulp per accumulated product
otherwise), held against the reference's Pallas kernel run in interpret
mode and against scipy's BSR product.  The planner, the dispatcher and
the recipe's automatic route must choose and return what the reference
does.  The reference's vector kernel cannot run on the installed jax (no
``pl.load``), so ``vector=True`` is held against the port's scalar
variant and scipy.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.kernels.spgemm_bcsr import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import ref as tref  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as thash_ops  # noqa: E402
from _fuzz import (VALS, block_clustered_dense, csr_of,  # noqa: E402
                   rand_dense, scramble_rows)

sp = pytest.importorskip("scipy.sparse")

BCSR_FIELDS = ("indptr", "indices", "blocks", "nnzb")
PLAN_ARRAYS = ("flop", "offsets", "bin_tsize", "row_nnzb_c", "indptr_cb")
PLAN_INTS = ("block_a", "block_b", "shape_a", "shape_b", "bcap_a", "bcap_b",
             "nnzb_a", "nnzb_b", "n_bins", "vector", "total_flop",
             "table_size", "nnzb_c", "bcap_c", "provenance", "block_c")

#: test_bcsr.py's BLOCK_GRID: (bm, bk, bn, gm, gk, gn), square and
#: rectangular tiles, 1x1 included
BLOCK_GRID = [
    (1, 1, 1, 5, 4, 6),
    (2, 2, 2, 4, 3, 5),
    (4, 4, 4, 3, 4, 2),
    (8, 8, 8, 2, 2, 2),
    (2, 4, 8, 3, 2, 2),
    (4, 2, 1, 2, 3, 4),
    (2, 3, 4, 4, 3, 5),
]
#: ragged logical shapes with their tiles: (shape, block)
RAGGED = [((19, 23), (4, 4)), ((19, 23), (8, 8)), ((7, 5), (2, 4)),
          ((9, 16), (4, 4)), ((16, 9), (8, 2))]


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def to_port_bcsr(a):
    return T.BCSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                             np.asarray(a.blocks), int(a.nnzb), a.shape,
                             a.block, device="cpu")


def to_ref_bcsr(a):
    indptr, indices, blocks, nnzb, shape, block = a.to_numpy()
    return J.BCSR(jnp.asarray(indptr), jnp.asarray(indices),
                  jnp.asarray(blocks), jnp.asarray(nnzb, jnp.int32), shape,
                  block)


def assert_bcsr_equal(jb, tb):
    assert jb.shape == tb.shape and tuple(jb.block) == tb.block
    for f in BCSR_FIELDS:
        x, y = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def assert_csr_equal(jc, tc):
    assert jc.shape == tc.shape and jc.sorted_cols == tc.sorted_cols
    for f in ("indptr", "indices", "data", "nnz"):
        x, y = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def assert_plans_equal(jp, tp):
    for f in PLAN_ARRAYS:
        x, y = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in PLAN_INTS:
        assert getattr(jp, f) == getattr(tp, f), f


def sorted_rows(indptr, bcol, blk):
    """Block rows in sorted block-column order (host arrays)."""
    c, b = tref.sort_block_rows(torch.as_tensor(np.array(indptr)),
                                torch.as_tensor(np.array(bcol)),
                                torch.as_tensor(np.array(blk)))
    return c.numpy(), b.numpy()


def assert_product_equal(jc, tc, counts=None):
    """Block row pointer bitwise, per-row block-column sets equal, blocks
    bitwise (``counts is None``) or within ``counts`` ulp per cell."""
    nnzb = int(jc.nnzb)
    assert int(tc.nnzb) == nnzb and tc.shape == jc.shape
    assert np.array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    jcol, jblk = sorted_rows(jc.indptr, jc.indices, jc.blocks)
    tcol, tblk = sorted_rows(tc.indptr, tc.indices, tc.blocks)
    assert np.array_equal(jcol[:nnzb], tcol[:nnzb])
    assert not tcol[nnzb:].any() and not tblk[nnzb:].any()
    if counts is None:
        assert np.array_equal(jblk[:nnzb], tblk[:nnzb])
        return
    ulp = np.spacing(np.abs(jblk[:nnzb]).astype(np.float32))
    assert np.all(np.abs(tblk[:nnzb] - jblk[:nnzb])
                  <= counts[:nnzb, None, None] * ulp)


def assert_matches_scipy(tc, ad, bd, a_block, b_block):
    """The product against scipy's BSR product: block row pointer and
    per-row block-column sets, dense values bitwise."""
    oracle = (sp.bsr_matrix(ad, blocksize=a_block)
              @ sp.bsr_matrix(bd, blocksize=b_block)).astype(np.float32)
    nnzb = int(tc.nnzb)
    assert nnzb == oracle.indices.shape[0]
    ip = tc.indptr.numpy()
    assert np.array_equal(ip, oracle.indptr)
    bcol = tc.indices.numpy()
    for i in range(len(ip) - 1):
        assert set(bcol[ip[i]:ip[i + 1]].tolist()) == \
            set(oracle.indices[ip[i]:ip[i + 1]].tolist()), i
    assert np.array_equal(tc.to_dense().numpy(),
                          np.asarray(oracle.todense(), np.float32))


def operands(bm, bk, bn, gm, gk, gn, seed=7):
    ad = block_clustered_dense(gm, gk, bm, bk, 0.5, seed=seed * bm + bk)
    bd = block_clustered_dense(gk, gn, bk, bn, 0.5, seed=seed * bn + gk + 1)
    return ad, bd


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


# ---------------------------------------------------------------------------
# formats: conversions and the numpy bridge
# ---------------------------------------------------------------------------

def _conversion_cases():
    for bm, bk, _, gm, gk, _ in BLOCK_GRID:
        for density in (0.3, 0.7):
            ad = block_clustered_dense(gm, gk, bm, bk, density,
                                       seed=bm * 100 + gk)
            yield f"grid{bm}x{bk}-{density}", ad, (bm, bk)
    for shape, block in RAGGED:
        yield f"ragged{shape}{block}", rand_dense(
            shape[0], shape[1], 0.35, seed=shape[0] + block[0]), block
    partial = block_clustered_dense(4, 4, 4, 4, 0.6, seed=13)
    partial[np.random.default_rng(3).random(partial.shape) < 0.5] = 0.0
    yield "partial-tiles", partial, (4, 4)
    empty_rows = block_clustered_dense(4, 3, 2, 2, 0.6, seed=17)
    empty_rows[2:4, :] = 0.0
    yield "empty-rows", empty_rows, (2, 2)
    yield "empty", np.zeros((8, 6), np.float32), (2, 2)


CONVERSIONS = list(_conversion_cases())


@pytest.mark.parametrize("unsorted", (False, True))
@pytest.mark.parametrize("case", CONVERSIONS, ids=lambda c: c[0])
def test_conversions_bitwise(case, unsorted):
    """csr_to_bcsr (default and pinned capacity), from_dense, to_dense and
    bcsr_to_csr (with and without prune) equal the reference's; the
    bridge round-trips losslessly."""
    _, ad, block = case
    a = csr_of(ad)
    if unsorted:
        a = scramble_rows(a)
    jb = jfmt.csr_to_bcsr(a, block)
    tb = T.csr_to_bcsr(to_port(a), block)
    assert_bcsr_equal(jb, tb)
    pinned = int(jb.nnzb) + 3
    assert_bcsr_equal(jfmt.csr_to_bcsr(a, block, bcap=pinned),
                      T.csr_to_bcsr(to_port(a), block, bcap=pinned))
    assert_bcsr_equal(jfmt.BCSR.from_dense(jnp.asarray(ad), block),
                      T.BCSR.from_dense(torch.from_numpy(ad), block))
    assert np.array_equal(np.asarray(jb.to_dense()), tb.to_dense().numpy())
    assert np.array_equal(tb.to_dense().numpy(), ad)
    for prune in (True, False):
        assert_csr_equal(jfmt.bcsr_to_csr(jb, prune=prune),
                         T.bcsr_to_csr(tb, prune=prune))
    assert_bcsr_equal(jb, to_port_bcsr(jb))
    assert_bcsr_equal(to_ref_bcsr(tb), tb)
    for x, y in zip(tb.to_numpy(), to_port_bcsr(to_ref_bcsr(tb)).to_numpy()):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert np.array_equal(np.asarray(jb.brow_ids()), tb.brow_ids().numpy())
    assert np.array_equal(np.asarray(jb.valid_mask()),
                          tb.valid_mask().numpy())
    assert tb.grid == jb.grid and tb.bcap == jb.bcap


@pytest.mark.parametrize("case", CONVERSIONS, ids=lambda c: c[0])
def test_flatten_unsorted_block_columns_bitwise(case):
    """bcsr_to_csr of a BCSR whose block columns are shuffled within each
    block row (as a product's come out) equals the reference's, with and
    without prune and at a pinned capacity; a capacity below nnz raises."""
    _, ad, block = case
    jb = jfmt.csr_to_bcsr(csr_of(ad), block)
    indptr, indices, blocks, nnzb, shape, _ = to_port_bcsr(jb).to_numpy()
    rng = np.random.default_rng(nnzb)
    perm = np.arange(indices.shape[0])
    for i in range(len(indptr) - 1):
        perm[indptr[i]:indptr[i + 1]] = rng.permutation(
            perm[indptr[i]:indptr[i + 1]])
    args = (indptr, indices[perm], blocks[perm], nnzb, shape, block)
    tb = T.BCSR.from_numpy(*args, device="cpu")
    jb = to_ref_bcsr(tb)
    for prune in (True, False):
        assert_csr_equal(jfmt.bcsr_to_csr(jb, prune=prune),
                         T.bcsr_to_csr(tb, prune=prune))
    nnz = int(np.count_nonzero(ad))
    assert_csr_equal(jfmt.bcsr_to_csr(jb, cap=nnz + 2),
                     T.bcsr_to_csr(tb, cap=nnz + 2))
    if nnz:
        with pytest.raises(ValueError, match="exceeds capacity"):
            T.bcsr_to_csr(tb, cap=nnz - 1)


def test_conversion_capacity_and_device_rules(monkeypatch):
    """A pinned capacity below the block count raises; the bridge goes to
    CUDA unless a device is named, and raises without one."""
    ad = block_clustered_dense(3, 3, 2, 2, 0.8, seed=3)
    a = to_port(csr_of(ad))
    nnzb = int(T.csr_to_bcsr(a, (2, 2)).nnzb)
    with pytest.raises(ValueError, match="exceeds capacity"):
        T.csr_to_bcsr(a, (2, 2), bcap=nnzb - 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = T.csr_to_bcsr(a, (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.BCSR.from_numpy(*tb.to_numpy())
    assert T.BCSR.from_numpy(*tb.to_numpy(), device="cpu").device.type == \
        "cpu"


# ---------------------------------------------------------------------------
# inspection and plans
# ---------------------------------------------------------------------------

INSPECT = [BLOCK_GRID[1], BLOCK_GRID[3], BLOCK_GRID[6]]


@pytest.mark.parametrize("n_bins", (1, 8))
@pytest.mark.parametrize("case", INSPECT, ids=lambda c: "x".join(
    map(str, c[:3])))
def test_bcsr_inspect_bitwise(case, n_bins):
    """The six outputs of bcsr_inspect (the port's on the hash symbolic
    kernel's plain version, the reference's Pallas symbolic kernel in
    interpret mode) are bitwise equal."""
    bm, bk, bn = case[:3]
    ad, bd = operands(*case)
    ja = jfmt.csr_to_bcsr(csr_of(ad), (bm, bk))
    jb = jfmt.csr_to_bcsr(csr_of(bd), (bk, bn))
    want = jops.bcsr_inspect(ja, jb, n_bins=n_bins, eager=True)
    got = tops.bcsr_inspect(to_port_bcsr(ja), to_port_bcsr(jb),
                            n_bins=n_bins)
    assert want[3] == got[3]                          # table_size
    for i in (0, 1, 2, 4, 5):
        x, y = np.asarray(want[i]), got[i].numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), i


@pytest.mark.parametrize("case", BLOCK_GRID, ids=lambda c: "x".join(
    map(str, c[:3])))
def test_planned_product_matches_reference_and_scipy(case):
    """Every BCSRPlan array bitwise; the planned product equals the
    reference's Pallas kernel (block row pointer bitwise, block-column
    sets, blocks bitwise on dyadic values) and scipy's BSR product."""
    bm, bk, bn = case[:3]
    ad, bd = operands(*case)
    ja = jfmt.csr_to_bcsr(csr_of(ad), (bm, bk))
    jb = jfmt.csr_to_bcsr(csr_of(bd), (bk, bn))
    ta, tb = to_port_bcsr(ja), to_port_bcsr(jb)
    jp = J.plan_bcsr(ja, jb, cache=False)
    tp = T.plan_bcsr(ta, tb, cache=False)
    assert_plans_equal(jp, tp)
    assert T.bcsr_structure_key(ta) == J.bcsr_structure_key(ja)
    tc = tp.execute(ta, tb)
    assert tc.block == (bm, bn) and tc.shape == (ad.shape[0], bd.shape[1])
    assert_product_equal(jp.execute(ja, jb), tc)
    assert_matches_scipy(tc, ad, bd, (bm, bk), (bk, bn))


@pytest.mark.parametrize("case", [BLOCK_GRID[2], BLOCK_GRID[6]],
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_uniform_values_within_one_ulp_per_product(case):
    """Non-dyadic values: each cell within (block pairs x bk) ulp of the
    reference's, whose kernel may fuse multiply-adds."""
    bm, bk, bn = case[:3]
    ad, bd = operands(*case, seed=11)
    rng = np.random.default_rng(5)
    ad = np.where(ad != 0, rng.uniform(0.5, 1.5, ad.shape), 0).astype(
        np.float32)
    bd = np.where(bd != 0, rng.uniform(0.5, 1.5, bd.shape), 0).astype(
        np.float32)
    ja = jfmt.csr_to_bcsr(csr_of(ad), (bm, bk))
    jb = jfmt.csr_to_bcsr(csr_of(bd), (bk, bn))
    ta, tb = to_port_bcsr(ja), to_port_bcsr(jb)
    tp = T.plan_bcsr(ta, tb, cache=False)
    tc = tp.execute(ta, tb)
    pairs = tref.products_per_block(ta.indptr, tb.indptr, tp.indptr_cb,
                                    ta.indices, tb.indices,
                                    tp.bcap_c).numpy()
    assert_product_equal(J.plan_bcsr(ja, jb, cache=False).execute(ja, jb),
                         tc, counts=pairs * bk)
    want = ad.astype(np.float64) @ bd.astype(np.float64)
    assert np.allclose(tc.to_dense().numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("case", [BLOCK_GRID[1], BLOCK_GRID[4]],
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_vector_variant_matches_scalar_and_scipy(case):
    """``vector=True`` plans the same arrays as the scalar variant (it is a
    separate cache entry) and its product equals the scalar one and
    scipy's."""
    bm, bk, bn = case[:3]
    ad, bd = operands(*case, seed=37)
    ta = T.csr_to_bcsr(to_port(csr_of(ad)), (bm, bk))
    tb = T.csr_to_bcsr(to_port(csr_of(bd)), (bk, bn))
    scalar = T.plan_bcsr(ta, tb)
    vector = T.plan_bcsr(ta, tb, vector=True)
    assert vector is not scalar and vector.vector
    for f in PLAN_ARRAYS:
        assert torch.equal(getattr(vector, f), getattr(scalar, f)), f
    tops.reset_kernel_calls()
    cv = vector.execute(ta, tb)
    assert tops.kernel_call_counts() == {"symbolic": 0, "numeric": 0,
                                         "numeric_vector": 0, "plain": 1,
                                         "batched_numeric": 0,
                                         "batched_numeric_vector": 0,
                                         "batched_plain": 0}
    cs = scalar.execute(ta, tb)
    for f in BCSR_FIELDS:
        assert torch.equal(getattr(cv, f), getattr(cs, f)), f
    assert_matches_scipy(cv, ad, bd, (bm, bk), (bk, bn))


def test_empty_rows_and_empty_operands():
    """Empty block rows, an all-zero A and an all-zero product plan and
    execute to the reference's (empty) results."""
    ad = block_clustered_dense(4, 3, 2, 2, 0.6, seed=17)
    ad[2:4, :] = 0.0
    bd = block_clustered_dense(3, 4, 2, 2, 0.6, seed=18)
    ta = T.csr_to_bcsr(to_port(csr_of(ad)), (2, 2))
    tb = T.csr_to_bcsr(to_port(csr_of(bd)), (2, 2))
    assert_matches_scipy(T.plan_bcsr(ta, tb).execute(ta, tb), ad, bd,
                         (2, 2), (2, 2))
    jz = jfmt.BCSR.from_dense(jnp.zeros((8, 6), jnp.float32), (2, 2))
    tz = T.BCSR.from_dense(torch.zeros((8, 6)), (2, 2))
    jb = jfmt.csr_to_bcsr(csr_of(bd), (2, 2))
    jp = J.plan_bcsr(jz, jb, cache=False)
    tp = T.plan_bcsr(tz, tb, cache=False)
    assert_plans_equal(jp, tp)
    assert tp.nnzb_c == 0
    out = tp.execute(tz, tb)
    assert_product_equal(jp.execute(jz, jb), out)
    assert out.to_dense().shape == (8, 8) and not out.to_dense().any()


def test_repeat_execute_zero_reinspection_and_cache_kind():
    """plan_bcsr lands in the shared LRU under "bcsr"; a repeat plan is a
    hit that inspects nothing, and repeat executes run the numeric kernel
    wrapper only -- no inspection, no hash symbolic phase."""
    ad, bd = operands(4, 3, 4, 4, 3, 4, seed=29)
    ta = T.csr_to_bcsr(to_port(csr_of(ad)), (4, 3))
    tb = T.csr_to_bcsr(to_port(csr_of(bd)), (3, 4))
    tops.reset_kernel_calls()
    thash_ops.reset_kernel_calls()
    p1 = T.plan_bcsr(ta, tb)
    assert tops.kernel_call_counts()["symbolic"] == 1
    assert thash_ops.kernel_call_counts()["plain"] == 1   # hash symbolic
    stats = T.plan_cache_stats()
    assert stats["kinds"]["bcsr"] == 1 and stats["misses"] == 1
    reweighted = T.BCSR(ta.indptr, ta.indices, ta.blocks * 2, ta.nnzb,
                        ta.shape, ta.block)
    assert T.plan_bcsr(reweighted, tb) is p1
    assert T.plan_cache_stats()["hits"] == 1
    tops.reset_kernel_calls()
    thash_ops.reset_kernel_calls()
    for _ in range(3):
        p1.execute(ta, tb)
    assert tops.kernel_call_counts() == {"symbolic": 0, "numeric": 0,
                                         "numeric_vector": 0, "plain": 3,
                                         "batched_numeric": 0,
                                         "batched_numeric_vector": 0,
                                         "batched_plain": 0}
    assert set(thash_ops.kernel_call_counts().values()) == {0}
    fewer = T.BCSR(ta.indptr, ta.indices, ta.blocks, ta.nnzb - 1,
                   ta.shape, ta.block)
    with pytest.raises(ValueError, match="block nnz"):
        p1.execute(fewer, tb)
    with pytest.raises(ValueError, match="block-inner"):
        T.plan_bcsr(ta, ta)


# ---------------------------------------------------------------------------
# planner, dispatcher and recipe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_block", [((24, 24), (8, 8)),
                                         ((19, 23, 17), (4, 4)),
                                         ((24, 16, 20), (2, 4))],
                         ids=("8x8", "ragged4x4", "2x4"))
def test_plan_spgemm_bcsr_matches_reference(shape_block):
    """plan_spgemm(algorithm="bcsr"): the scalar plan arrays, the nested
    block plan and the CSR output bitwise equal to the reference's; the
    output equals the hash plan's product."""
    shape, block = shape_block
    m, k, n = shape if len(shape) == 3 else (shape[0], shape[1], shape[1])
    if shape == (24, 24):
        ad = block_clustered_dense(3, 3, 8, 8, 0.8, seed=33)
        bd = block_clustered_dense(3, 3, 8, 8, 0.8, seed=34)
    else:
        ad = rand_dense(m, k, 0.4, seed=23)
        bd = rand_dense(k, n, 0.4, seed=24)
    a, b = csr_of(ad), csr_of(bd)
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_spgemm(a, b, algorithm="bcsr", block=block, cache=False)
    tp = T.plan_spgemm(ta, tb, algorithm="bcsr", block=block, cache=False)
    assert tp.algorithm == "bcsr" and tp.block == jp.block == block
    for f in ("flop", "offsets", "bin_tsize", "row_nnz_c", "indptr_c"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()), f
    assert (tp.nnz_c, tp.cap_c) == (jp.nnz_c, jp.cap_c)
    assert_plans_equal(jp.bcsr_plan, tp.bcsr_plan)
    tops.reset_kernel_calls()
    tc = tp.execute(ta, tb)
    assert tops.kernel_call_counts()["symbolic"] == 0
    assert_csr_equal(jp.execute(a, b), tc)
    assert np.array_equal(tc.to_dense().numpy(), ad @ bd)
    h = T.plan_spgemm(ta, tb, algorithm="hash", cache=False).execute(
        ta, tb, sorted_output=True)
    assert torch.equal(tc.indptr, h.indptr) and torch.equal(tc.indices,
                                                            h.indices)


def test_plan_spgemm_bcsr_caches_both_levels():
    """A repeat plan_spgemm hits the "spgemm" entry; the nested block plan
    sits under "bcsr"; the block shape is part of the key."""
    ad = block_clustered_dense(3, 3, 4, 4, 0.8, seed=5)
    ta = to_port(csr_of(ad))
    p1 = T.plan_spgemm(ta, ta, algorithm="bcsr", block=(4, 4))
    kinds = T.plan_cache_stats()["kinds"]
    assert kinds["bcsr"] == 1 and kinds["spgemm"] == 1
    assert T.plan_spgemm(ta, ta, algorithm="bcsr", block=(4, 4)) is p1
    p2 = T.plan_spgemm(ta, ta, algorithm="bcsr", block=(2, 2))
    assert p2 is not p1 and p2.bcsr_plan.block_a == (2, 2)
    assert T.plan_cache_stats()["kinds"]["bcsr"] == 2


def test_dispatcher_bcsr_matches_reference():
    """spgemm(algorithm="bcsr") with its defaults (8x8 tiles, the whole
    block grid as capacity) and with explicit options."""
    ad = block_clustered_dense(3, 3, 8, 8, 0.6, seed=41)
    bd = block_clustered_dense(3, 3, 8, 8, 0.6, seed=42)
    a, b = csr_of(ad), csr_of(bd)
    cap = int(np.count_nonzero(ad @ bd)) + 8
    assert_csr_equal(J.spgemm(a, b, cap, algorithm="bcsr"),
                     T.spgemm(to_port(a), to_port(b), cap,
                              algorithm="bcsr"))
    kw = dict(block=(4, 4), n_bins=2, bcap_c=40)
    assert_csr_equal(J.spgemm(a, b, cap, algorithm="bcsr", **kw),
                     T.spgemm(to_port(a), to_port(b), cap, algorithm="bcsr",
                              **kw))


#: (name, dense): block-dense inputs the recipe routes to bcsr, and a
#: scattered one it does not
AUTO = [("clustered6", block_clustered_dense(6, 6, 8, 8, 0.4, seed=1)),
        ("clustered3", block_clustered_dense(3, 3, 8, 8, 0.9, seed=35)),
        ("scattered", rand_dense(48, 48, 0.05, seed=2))]


@pytest.mark.parametrize("case", AUTO, ids=lambda c: c[0])
def test_auto_route_matches_reference(case):
    """With no algorithm the recipe's probe_blocks="auto" route chooses as
    the reference does; plan_spgemm and spgemm then return its output."""
    _, ad = case
    a = csr_of(ad)
    ta = to_port(a)
    want = J.choose_algorithm(a, a)
    assert T.choose_algorithm(ta, ta) == want
    assert (want == "bcsr") == case[0].startswith("clustered")
    jp = J.plan_spgemm(a, a, cache=False)
    tp = T.plan_spgemm(ta, ta, cache=False)
    assert tp.algorithm == jp.algorithm and tp.provenance == "heuristic"
    if want != "bcsr":
        return
    assert_plans_equal(jp.bcsr_plan, tp.bcsr_plan)
    tops.reset_kernel_calls()
    assert_csr_equal(jp.execute(a, a), tp.execute(ta, ta))
    assert tops.kernel_call_counts()["plain"] == 1
    cap = jp.cap_c
    assert_csr_equal(J.spgemm(a, a, cap), T.spgemm(ta, ta, cap))


@pytest.mark.parametrize("request_kind", ("boolean", "min_plus", "masked"))
def test_general_requests_raise_in_both(request_kind):
    """The block path is (+, x)-only and unmasked: an explicit bcsr
    request with another semiring or a mask raises in both packages, and
    the recipe never routes one there."""
    ad = block_clustered_dense(3, 3, 8, 8, 0.9, seed=35)
    a = csr_of(ad)
    ta = to_port(a)
    if request_kind == "masked":
        kw = {"mask": a}
        tkw = {"mask": ta}
    else:
        kw = tkw = {"semiring": request_kind}
    with pytest.raises(NotImplementedError):
        J.plan_spgemm(a, a, algorithm="bcsr", cache=False, **kw)
    with pytest.raises(NotImplementedError, match="plus_times"):
        T.plan_spgemm(ta, ta, algorithm="bcsr", cache=False, **tkw)
    with pytest.raises(NotImplementedError):
        J.spgemm(a, a, 64 * 9, algorithm="bcsr", **kw)
    with pytest.raises(NotImplementedError, match="unmasked"):
        T.spgemm(ta, ta, 64 * 9, algorithm="bcsr", **tkw)
    assert T.plan_spgemm(ta, ta, cache=False, **tkw).algorithm != "bcsr"


def test_explicit_zero_tile_is_kept():
    """A stored tile that holds only explicit zeros: the port re-blocks the
    CSR sparsely and keeps the tile, so the planned execute returns the
    product; the reference's execute re-blocks through a dense matrix,
    drops the tile and fails its structure check (ROADMAP, Queue 3)."""
    ad = block_clustered_dense(3, 3, 4, 4, 0.5, seed=9)
    ad[:4, 8:12] = 0.0                  # tile (0, 2) empty ...
    r, c = np.nonzero(ad)
    rows = np.concatenate([r, [1]])
    cols = np.concatenate([c, [9]])     # ... but for one stored zero
    vals = np.concatenate([ad[r, c], [0.0]]).astype(np.float32)
    a = J.CSR.from_numpy_coo(rows, cols, vals, ad.shape)
    ta = to_port(a)
    assert int(T.csr_to_bcsr(ta, (4, 4)).nnzb) == \
        int(jfmt.csr_to_bcsr(a, (4, 4)).nnzb)
    tp = T.plan_spgemm(ta, ta, algorithm="bcsr", block=(4, 4), cache=False)
    assert np.array_equal(tp.execute(ta, ta).to_dense().numpy(), ad @ ad)
    jp = J.plan_spgemm(a, a, algorithm="bcsr", block=(4, 4), cache=False)
    with pytest.raises(AssertionError):
        jp.execute(a, a)


def block_rmat(scale, edge_factor, preset, block, seed):
    """A block R-MAT input: the R-MAT pattern over the block grid,
    duplicates collapsed, each occupied tile dense with dyadic values (the
    structure chip_smoke.py drives at full size)."""
    from repro_torch.data.rmat import rmat_edges
    br, bc = rmat_edges(scale, edge_factor, preset, seed)
    key = np.unique(br * (1 << scale) + bc)
    br, bc = key >> scale, key & ((1 << scale) - 1)
    bm, bn = block
    ii, jj = np.meshgrid(np.arange(bm), np.arange(bn), indexing="ij")
    rows = (br[:, None, None] * bm + ii).ravel()
    cols = (bc[:, None, None] * bn + jj).ravel()
    vals = np.random.default_rng(seed).choice(VALS, size=rows.shape[0])
    n = (1 << scale) * bm
    return J.CSR.from_numpy_coo(rows, cols, vals.astype(np.float32), (n, n))


@pytest.mark.parametrize("preset", ("ER", "G500"))
def test_block_rmat_product_matches_reference(preset):
    """The full-size input's structure at scale 4: the recipe routes it to
    bcsr in both packages and the planned products agree bitwise."""
    a = block_rmat(4, 4, preset, (8, 8), seed=0)
    ta = to_port(a)
    jp = J.plan_spgemm(a, a, cache=False)
    tp = T.plan_spgemm(ta, ta, cache=False)
    assert jp.algorithm == tp.algorithm == "bcsr"
    assert_plans_equal(jp.bcsr_plan, tp.bcsr_plan)
    assert_csr_equal(jp.execute(a, a), tp.execute(ta, ta))


def test_signed_cancellation_prunes_cells_in_both():
    """Signed dyadic values whose products cancel exactly: row 3 of A
    holds 1 at columns 0 and 1, and row 1 of B is minus row 0, so every
    cell of C's row 3 computes to 0.  Both packages' bcsr execute prune
    those cells (``bcsr_to_csr``): the same nnz and row pointer, below the
    plan's ``nnz_c``, which counts the structure (plan_spgemm's docstring)."""
    ad = block_clustered_dense(2, 2, 8, 8, 1.0, seed=51)
    bd = block_clustered_dense(2, 2, 8, 8, 1.0, seed=52)
    ad[3, :] = 0.0
    ad[3, :2] = 1.0
    bd[1, :] = -bd[0, :]
    cd = ad @ bd
    assert not cd[3].any()
    a, b = csr_of(ad), csr_of(bd)
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_spgemm(a, b, algorithm="bcsr", cache=False)
    tp = T.plan_spgemm(ta, tb, algorithm="bcsr", cache=False)
    assert tp.nnz_c == jp.nnz_c == 16 * 16
    jc, tc = jp.execute(a, b), tp.execute(ta, tb)
    nnz = int(np.count_nonzero(cd))
    assert int(jc.nnz) == int(tc.nnz) == nnz < tp.nnz_c
    assert np.array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    assert not np.array_equal(tc.indptr.numpy(), tp.indptr_c.numpy())
    assert_csr_equal(jc, tc)
    assert np.array_equal(tc.to_dense().numpy(), cd)
