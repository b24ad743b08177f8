"""The hash SpGEMM kernels' plain versions and ops against ``repro``.

On the CPU the port's kernel wrappers run the plain versions of
``repro_torch/kernels/spgemm_hash/ref.py``.  They are held against the
reference Pallas kernel run in interpret mode (scalar probing): row
counts and per-row column sets bitwise, values bitwise on dyadic inputs
and within 1 ulp per accumulated product otherwise.  The ``hash_vector``
mode is held against the scalar reference and ``spgemm_hash_jnp``: the
installed jax has no ``pl.load``, so the reference vector kernel cannot
run here.  The saturation pins of ``test_hash_saturation.py`` (load factor
exactly 1.0, and one past fill) run through the port's ops.  The CUDA
kernels themselves are held against the plain versions in
``test_torch_cuda.py`` (on a card only).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

from repro.core import CSR as JCSR, spgemm_hash_jnp  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_hash import ops as jops  # noqa: E402
from repro_torch.core import CSR as TCSR  # noqa: E402
from repro_torch.core.formats import prefix_sum  # noqa: E402
from repro_torch.kernels.spgemm_hash import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_hash import ref  # noqa: E402
from _fuzz import VALS  # noqa: E402


def to_port(a, device="cpu"):
    return TCSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                           np.asarray(a.data), int(a.nnz), a.shape,
                           a.sorted_cols, device=device)


def dyadic(a, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros(a.cap, np.float32)
    d[:int(a.nnz)] = rng.choice(VALS, size=int(a.nnz))
    return JCSR(a.indptr, a.indices, jnp.asarray(d), a.nnz, a.shape)


def operands(case):
    preset, scale, ef, values = case
    a = jrmat.rmat_csr(scale, ef, preset, seed=2)
    b = jrmat.rmat_csr(scale, ef, "ER", seed=12)
    if values == "dyadic":
        a, b = dyadic(a, 3), dyadic(b, 4)
    return a, b


def sorted_host(c):
    """``(indptr, cols, vals)`` of a CSR with rows sorted, on the host."""
    s = c.sort_rows()
    if isinstance(s, TCSR):
        return s.indptr.numpy(), s.indices.numpy(), s.data.numpy()
    return np.asarray(s.indptr), np.asarray(s.indices), np.asarray(s.data)


def assert_matches(ref_c, port_c, a, b, dyadic_values):
    """Structure bitwise; values bitwise (dyadic) or within one ulp per
    accumulated product of the port's plain values."""
    ip_r, col_r, val_r = sorted_host(ref_c)
    ip_p, col_p, val_p = sorted_host(port_c)
    nnz = int(ip_r[-1])
    assert np.array_equal(ip_r, ip_p)
    assert np.array_equal(col_r[:nnz], col_p[:nnz])
    if dyadic_values:
        assert np.array_equal(val_r[:nnz], val_p[:nnz])
        return
    ta, tb = to_port(a), to_port(b)
    k = ref.products_per_entry(ta.indptr, tb.indptr,
                               torch.from_numpy(ip_p), ta.indices,
                               tb.indices, len(col_p)).numpy()[:nnz]
    ulp = np.spacing(np.abs(val_p[:nnz]))
    assert np.all(np.abs(val_r[:nnz] - val_p[:nnz]) <= k * ulp)


CASES = [("ER", 5, 8, "dyadic"), ("G500", 6, 6, "uniform")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}-{c[3]}")
def test_plain_versions_match_reference_pallas_kernel(case):
    a, b = operands(case)
    ta, tb = to_port(a), to_port(b)
    j_off, j_tsz, j_table = jops.hash_schedule(a, b, n_bins=8)
    t_off, t_tsz, t_table = tops.hash_schedule(ta, tb, n_bins=8)
    assert np.array_equal(np.asarray(j_off), t_off.numpy())
    assert np.array_equal(np.asarray(j_tsz), t_tsz.numpy())
    assert j_table == t_table
    j_rows = jops.spgemm_hash_symbolic(a, b, n_bins=8)   # interpret mode
    args = (t_off, t_tsz, ta.indptr, tb.indptr, ta.indices, ta.data,
            tb.indices, tb.data)
    t_rows = K.symbolic_call(*args, table_size=t_table, vector=False)
    assert np.array_equal(np.asarray(j_rows), t_rows.numpy())
    cap = int(np.asarray(j_rows).sum())
    jc = jops.spgemm_hash(a, b, cap, n_bins=8)
    assert not jc.sorted_cols
    indptr_c = prefix_sum(t_rows).to(torch.int32)
    cols, vals = K.numeric_call(t_off, t_tsz, ta.indptr, tb.indptr,
                                indptr_c, ta.indices, ta.data, tb.indices,
                                tb.data, cap_c=cap, table_size=t_table,
                                vector=False)
    tc = TCSR(indptr_c, cols, vals, indptr_c[-1], jc.shape, False)
    assert_matches(jc, tc, a, b, case[3] == "dyadic")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}-{c[3]}")
def test_vector_mode_matches_scalar_reference_and_fallback(case):
    a, b = operands(case)
    cap = int(np.asarray(jops.spgemm_hash_symbolic(a, b)).sum())
    tc = tops.spgemm_hash(to_port(a), to_port(b), cap, vector=True)
    assert not tc.sorted_cols
    assert np.array_equal(
        tops.spgemm_hash_symbolic(to_port(a), to_port(b), vector=True)
        .numpy(), np.asarray(jops.spgemm_hash_symbolic(a, b)))
    assert_matches(jops.spgemm_hash(a, b, cap), tc, a, b,
                   case[3] == "dyadic")
    assert_matches(spgemm_hash_jnp(a, b, cap), tc, a, b, case[3] == "dyadic")


def _pair_with_row_flop(d):
    """The saturation structure of ``test_hash_saturation.py``: C row 0 has
    exactly ``d`` distinct columns, row 1 the same ``d`` with flop ``2d``."""
    a = JCSR.from_numpy_coo([0, 1, 1], [0, 0, 1],
                            np.array([1.0, 1.0, 0.5], np.float32), (2, 2))
    rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
    cols = np.concatenate([np.arange(d), np.arange(d)])
    vals = VALS[np.arange(2 * d) % len(VALS)]
    b = JCSR.from_numpy_coo(rows, cols, vals, (2, d))
    oracle = np.asarray(a.to_dense(), np.float64) @ \
        np.asarray(b.to_dense(), np.float64)
    return a, b, oracle


@pytest.mark.parametrize("vector", (False, True))
def test_load_factor_one(vector):
    d = K.CHUNK
    a, b, oracle = _pair_with_row_flop(d)
    schedule = (torch.tensor([0, 2], dtype=torch.int32),
                torch.tensor([d], dtype=torch.int32))
    c = tops.spgemm_hash(to_port(a), to_port(b), cap_c=2 * d, vector=vector,
                         table_size=d, schedule=schedule)
    assert c.indptr.tolist() == [0, d, 2 * d]       # table fully flushed
    assert np.array_equal(c.to_dense().numpy().astype(np.float64), oracle)


@pytest.mark.parametrize("vector", (False, True))
def test_one_past_fill_doubles_table(vector):
    d = K.CHUNK + 1
    a, b, oracle = _pair_with_row_flop(d)
    ta, tb = to_port(a), to_port(b)
    offsets, bin_tsize, table_size = tops.hash_schedule(ta, tb, n_bins=1)
    j_off, j_tsz, j_table = jops.hash_schedule(a, b, n_bins=1)
    assert table_size == j_table == 2 * K.CHUNK
    assert bin_tsize.tolist() == np.asarray(j_tsz).tolist() == [2 * K.CHUNK]
    c = tops.spgemm_hash(ta, tb, cap_c=2 * d, vector=vector,
                         table_size=table_size, schedule=(offsets, bin_tsize))
    assert np.array_equal(c.sort_rows().to_dense().numpy()
                          .astype(np.float64), oracle)


def test_launch_counters_on_cpu_count_plain_runs():
    a, b = operands(CASES[0])
    ta, tb = to_port(a), to_port(b)
    cap = 4 * int(a.nnz)
    tops.reset_kernel_calls()
    tops.spgemm_hash(ta, tb, cap)                       # symbolic + numeric
    assert tops.kernel_call_counts() == {
        "symbolic": 0, "numeric": 0, "symbolic_vector": 0,
        "numeric_vector": 0, "plain": 2}
    tops.reset_kernel_calls()
    assert set(tops.kernel_call_counts().values()) == {0}


def test_semiring_or_mask_takes_the_fallback():
    a, b = operands(CASES[0])
    cap = int(np.asarray(jops.spgemm_hash_symbolic(a, b)).sum())
    tops.reset_kernel_calls()
    c = tops.spgemm_hash(to_port(a), to_port(b), cap, semiring="boolean")
    assert tops.kernel_call_counts()["plain"] == 0
    jc = spgemm_hash_jnp(a, b, cap, semiring="boolean")
    assert np.array_equal(np.asarray(jc.indices), c.indices.numpy())
