"""The port's graph workloads against the reference's (paper sections
5.5-5.6): the preprocessing of ``data/rmat.py``, the triangle count and
both multi-source BFS variants of ``examples/graph_analytics.py``, the
square x tall-skinny product, and the two example twins.

Same host operands in one process, made with numpy from a seed.  The
port's ``symmetrize`` and ``triangular_split`` work on the live entries
where the reference goes through a dense matrix; their CSR arrays
(``indptr``, ``indices``, ``data``, ``nnz``, ``cap``) must be bitwise the
reference's.  Triangle counts must be equal, and BFS distances equal per
hop.  The reference example is loaded by file path: the suite runs with
``PYTHONPATH=src`` only.
"""
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.data import rmat as trmat  # noqa: E402
from repro_torch.examples import graph_analytics as tga  # noqa: E402
from repro_torch.examples import quickstart as tqs  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as hash_ops  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SOURCES = [0, 17, 42, 100]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_graph_analytics", ROOT / "examples" / "graph_analytics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jga = _reference_example()


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def assert_csr_equal(jc, tc):
    assert jc.shape == tc.shape and jc.sorted_cols == tc.sorted_cols
    assert jc.cap == tc.cap
    for f in ("indptr", "indices", "data", "nnz"):
        x, y = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


GRAPHS = [(p, s) for p in ("ER", "G500") for s in (6, 8)]


@pytest.mark.parametrize("case", GRAPHS, ids=lambda c: f"{c[0]}{c[1]}")
def test_preprocessing_bitwise(case):
    """symmetrize (default and explicit capacity), triangular_split (with
    and without the adjacency, on the directed and the symmetric graph)
    and tall_skinny_from give the reference's CSR arrays bitwise."""
    preset, scale = case
    a = jrmat.rmat_csr(scale, 8, preset, seed=1)
    ta = to_port(a)
    s = jrmat.symmetrize(a)
    ts = trmat.symmetrize(ta, device="cpu")
    assert_csr_equal(s, ts)
    assert_csr_equal(jrmat.symmetrize(a, cap=2 * a.cap),
                     trmat.symmetrize(ta, cap=2 * a.cap, device="cpu"))
    for src, tsrc in ((a, ta), (s, ts)):
        for jx, tx in zip(jrmat.triangular_split(src, return_adjacency=True),
                          trmat.triangular_split(tsrc, return_adjacency=True,
                                                 device="cpu")):
            assert_csr_equal(jx, tx)
    for jx, tx in zip(jrmat.triangular_split(s),
                      trmat.triangular_split(ts, device="cpu")):
        assert_csr_equal(jx, tx)
    rows, cols = jrmat.rmat_edges(scale, 8, preset, seed=2)
    assert_csr_equal(
        jrmat.tall_skinny_from(rows, cols, 1 << scale, 3, seed=3),
        trmat.tall_skinny_from(rows, cols, 1 << scale, 3, seed=3,
                               device="cpu"))


def test_preprocessing_with_duplicates_and_cancellation():
    """A CSR with duplicate entries (summed before the degree is taken),
    a pair of duplicates that cancel to 0, a stored zero, signed values
    (A + A^T must be positive to make an edge), and a capacity too small
    for the output (entries cut, nnz and indptr still counting them)."""
    rows = np.array([0, 0, 1, 2, 2, 3, 3, 4, 4, 5, 5, 1, 6, 6, 7, 2, 0])
    cols = np.array([1, 1, 2, 3, 3, 4, 0, 5, 1, 6, 2, 0, 7, 7, 0, 5, 0])
    vals = np.array([0.5, 0.5, 1.0, 2.0, -2.0, 1.5, -1.0, 1.0, 0.0, 2.0,
                     -0.5, 0.5, 1.0, 1.0, 1.5, 1.0, 2.0], np.float32)
    a = J.CSR.from_numpy_coo(rows, cols, vals, (8, 8), sum_duplicates=False)
    ta = to_port(a)
    assert_csr_equal(jrmat.symmetrize(a), trmat.symmetrize(ta, device="cpu"))
    assert_csr_equal(jrmat.symmetrize(a, cap=5),
                     trmat.symmetrize(ta, cap=5, device="cpu"))
    for jx, tx in zip(jrmat.triangular_split(a, return_adjacency=True),
                      trmat.triangular_split(ta, return_adjacency=True,
                                             device="cpu")):
        assert_csr_equal(jx, tx)
    small = J.CSR(a.indptr, a.indices[:6], a.data[:6], a.nnz, a.shape,
                  sorted_cols=False)
    for jx, tx in zip(jrmat.triangular_split(small),
                      trmat.triangular_split(to_port(small), device="cpu")):
        assert_csr_equal(jx, tx)


def test_preprocessing_rejects_rectangular_input():
    a = to_port(J.CSR.from_numpy_coo([0], [3], np.ones(1, np.float32),
                                     (2, 4)))
    with pytest.raises(ValueError, match="square"):
        trmat.symmetrize(a, device="cpu")
    with pytest.raises(ValueError, match="square"):
        trmat.triangular_split(a, device="cpu")


def example_graph(scale=8, preset="G500"):
    """The example's input: an R-MAT pattern, edge factor 8, seed 1,
    symmetrized; in both packages."""
    a = jrmat.symmetrize(jrmat.rmat_csr(scale, 8, preset, seed=1))
    return a, to_port(a)


def brute_triangles(a) -> int:
    ad = np.asarray(a.to_dense()).astype(np.int64)
    return int(np.trace(np.linalg.matrix_power(ad, 3)) // 6)


@pytest.mark.parametrize("case", [("G500", 8), ("ER", 7)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_triangle_count_matches_reference_and_brute_force(case):
    a, ta = example_graph(case[1], case[0])
    tri = tga.triangle_count(ta)
    assert tri == jga.triangle_count(a) == brute_triangles(a)
    assert tri > 0


@pytest.mark.parametrize("case", [("G500", 8), ("ER", 7)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_bfs_distances_match_reference_per_hop(case):
    """Dense (SpMM) and masked (planned boolean products) BFS: the port's
    distances equal the reference's after 1, 3 and 6 hops."""
    a, ta = example_graph(case[1], case[0])
    for hops in (1, 3, 6):
        want = np.asarray(jga.multi_source_bfs(a, SOURCES, hops))
        spmm_ops.reset_kernel_calls()
        dense = tga.multi_source_bfs(ta, SOURCES, hops)
        assert spmm_ops.kernel_call_counts() == {"spmm": 0, "classify": 0,
                                                 "plain": hops}
        assert dense.dtype == torch.int32
        assert np.array_equal(dense.numpy(), want)
        masked = tga.multi_source_bfs_masked(ta, SOURCES, hops)
        assert np.array_equal(masked.numpy(), want)
        assert np.array_equal(
            np.asarray(jga.multi_source_bfs_masked(a, SOURCES, hops)), want)


def test_repeat_masked_bfs_plans_nothing():
    """The serving shape: a repeat BFS hits the plan cache on every hop,
    and its hash products run no planning kernel."""
    _, ta = example_graph()
    first = tga.multi_source_bfs_masked(ta, SOURCES, 6)
    before = T.plan_cache_stats()
    hash_ops.reset_kernel_calls()
    again = tga.multi_source_bfs_masked(ta, SOURCES, 6)
    after = T.plan_cache_stats()
    assert torch.equal(first, again)
    assert after["misses"] == before["misses"]
    assert after["hits"] - before["hits"] == before["misses"] > 0
    assert hash_ops.kernel_call_counts()["symbolic"] == 0


def test_tall_skinny_product_matches_reference():
    """Section 5.5's square x tall-skinny product through the planner:
    plan arrays and the CSR (row pointer, per-row column sets, values on
    these unit-valued frontiers) equal the reference's."""
    rows, cols = jrmat.rmat_edges(7, 8, "G500", seed=2)
    a = jrmat.rmat_csr(7, 8, "G500", seed=2)
    b = jrmat.tall_skinny_from(rows, cols, 1 << 7, 4, seed=3)
    ta = to_port(a)
    tb = trmat.tall_skinny_from(rows, cols, 1 << 7, 4, seed=3, device="cpu")
    jp = J.plan_spgemm(a, b, use_case="tall_skinny", cache=False)
    tp = T.plan_spgemm(ta, tb, use_case="tall_skinny", cache=False)
    assert tp.algorithm == jp.algorithm == "hash"
    for f in ("flop", "offsets", "bin_tsize", "indptr_c"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()), f
    jc = J.finalize(jp.execute(a, b), True)
    tc = tp.execute(ta, tb, sorted_output=True)
    nnz = int(jc.nnz)
    assert int(tc.nnz) == nnz
    assert np.array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    assert np.array_equal(np.asarray(jc.indices)[:nnz],
                          tc.indices.numpy()[:nnz])
    ulp = np.spacing(np.asarray(jc.data)[:nnz])
    assert np.all(np.abs(tc.data.numpy()[:nnz] - np.asarray(jc.data)[:nnz])
                  <= 8 * ulp)


@pytest.mark.parametrize("example", (tga, tqs),
                         ids=("graph_analytics", "quickstart"))
def test_example_twins_run_on_cpu(example, capsys):
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\n") >= 4
    if example is tga:
        a, _ = example_graph()
        assert f"brute force -> {brute_triangles(a)}" in out


def test_wedge_sum_is_exact_past_float32():
    """Three wedge counts of 2^23 + 1 sum to an odd number past 2^24: the
    reference's float32 sum rounds it, the port's sum is exact."""
    counts = np.full(3, 2.0 ** 23 + 1, np.float32)
    c = T.CSR.from_numpy(np.array([0, 3], np.int32), np.arange(4),
                         np.concatenate([counts, [5.0]]).astype(np.float32),
                         3, (1, 4), device="cpu")
    exact = 3 * (2 ** 23 + 1)
    assert tga.wedge_sum(c) == exact
    assert float(jnp.asarray(counts).sum()) != exact
