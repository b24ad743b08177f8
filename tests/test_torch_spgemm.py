"""The port's ``core.spgemm`` against ``repro.core.spgemm``, bitwise.

Same host operands in one process: ESC, heap, dense and the sort-based
hash fallback (``spgemm_hash_jnp``, including its hash-order row layout)
must give bitwise equal ``indptr``/``indices``/``data``/``nnz`` across
semirings and structural masks; ``symbolic`` must give bitwise equal row
counts; the dispatcher must route as the reference does.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
import repro_torch.core as T  # noqa: E402
from _fuzz import VALS  # noqa: E402

MASKS = ("none", "mask", "complement")


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def dyadic(a, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros(a.cap, np.float32)
    d[:int(a.nnz)] = rng.choice(VALS, size=int(a.nnz))
    return J.CSR(a.indptr, a.indices, jnp.asarray(d), a.nnz, a.shape)


def assert_csr_equal(jc, tc, what):
    assert jc.shape == tc.shape and jc.sorted_cols == tc.sorted_cols, what
    for f in ("indptr", "indices", "data", "nnz"):
        x, y = np.asarray(getattr(jc, f)), getattr(tc, f).numpy()
        assert x.shape == y.shape and np.array_equal(x, y), (what, f)


def operands(values="dyadic", scale=5, ef=3):
    a = jrmat.rmat_csr(scale, ef, "G500", seed=3)
    b = jrmat.rmat_csr(scale, ef, "ER", seed=103)
    if values == "dyadic":
        a, b = dyadic(a, 1), dyadic(b, 2)
    mask = jrmat.rmat_csr(scale, 4, "ER", seed=7)
    return a, b, mask


def mask_args(kind, mask):
    if kind == "none":
        return {}
    return {"mask": mask, "complement_mask": kind == "complement"}


def port_kw(kw):
    return {k: (to_port(v) if k == "mask" else v) for k, v in kw.items()}


@pytest.mark.parametrize("values,kind", [("dyadic", k) for k in MASKS]
                         + [("uniform", "none")])
def test_symbolic_bitwise(values, kind):
    a, b, mask = operands(values)
    kw = mask_args(kind, mask)
    jr = J.symbolic(a, b, **kw)
    tr = T.symbolic(to_port(a), to_port(b), **port_kw(kw))
    for x, y, name in zip(jr[:3], tr[:3], ("row_nnz", "indptr", "flop")):
        assert np.array_equal(np.asarray(x), y.numpy()), name
        assert np.asarray(x).dtype == y.numpy().dtype, name
    assert int(jr[3]) == int(tr[3])
    # a short flop_cap drops the same products as the reference
    cap = int(jr[3]) // 2
    js = J.symbolic(a, b, flop_cap=cap, **kw)
    ts = T.symbolic(to_port(a), to_port(b), flop_cap=cap, **port_kw(kw))
    assert np.array_equal(np.asarray(js[0]), ts[0].numpy())


#: every semiring and every mask kind, each at least once
GRID = [("plus_times", "none"), ("plus_times", "mask"),
        ("plus_times", "complement"), ("boolean", "mask"),
        ("min_plus", "complement"), ("plus_first", "none")]


@pytest.mark.parametrize("sr,kind", GRID)
def test_accumulators_bitwise_across_semirings_and_masks(sr, kind):
    a, b, mask = operands()
    kw = mask_args(kind, mask)
    cap = int(J.symbolic(a, b, **kw)[1][-1]) + 3     # slack: zero tail
    ta, tb, tkw = to_port(a), to_port(b), port_kw(kw)
    assert_csr_equal(J.spgemm_esc(a, b, cap, semiring=sr, **kw),
                     T.spgemm_esc(ta, tb, cap, semiring=sr, **tkw), "esc")
    assert_csr_equal(J.spgemm_hash_jnp(a, b, cap, semiring=sr, **kw),
                     T.spgemm_hash_jnp(ta, tb, cap, semiring=sr, **tkw),
                     "hash_jnp")
    k_width = int(np.asarray(a.row_nnz()).max())
    assert_csr_equal(
        J.spgemm_heap(a, b, row_cap=b.n_cols, k_width=k_width, cap_c=cap,
                      semiring=sr, **kw),
        T.spgemm_heap(ta, tb, row_cap=b.n_cols, k_width=k_width, cap_c=cap,
                      semiring=sr, **tkw), "heap")
    assert_csr_equal(J.spgemm_dense(a, b, cap, semiring=sr, **kw),
                     T.spgemm_dense(ta, tb, cap, semiring=sr, **tkw),
                     "dense")


@pytest.mark.parametrize("algo", ("esc", "hash_jnp", "heap"))
def test_uniform_values_bitwise(algo):
    """Off the dyadic grid the sort-based accumulators still add in the
    reference's order, so even rounded sums agree bitwise."""
    a, b, _ = operands("uniform", scale=6, ef=6)
    cap = int(J.symbolic(a, b)[1][-1])
    kw = {"row_cap": b.n_cols, "k_width": a.cap} if algo == "heap" else {}
    assert_csr_equal(J.spgemm(a, b, cap, algorithm=algo, **kw),
                     T.spgemm(to_port(a), to_port(b), cap, algorithm=algo,
                              **kw), algo)


@pytest.mark.parametrize("row_cap", (1, 3))
def test_heap_overflow_drops_like_reference(row_cap):
    a, b, _ = operands()
    cap = a.n_rows * row_cap
    k_width = int(np.asarray(a.row_nnz()).max())
    assert_csr_equal(
        J.spgemm_heap(a, b, row_cap=row_cap, k_width=k_width, cap_c=cap),
        T.spgemm_heap(to_port(a), to_port(b), row_cap=row_cap,
                      k_width=k_width, cap_c=cap), "heap overflow")


def test_esc_capacity_overflow_like_reference():
    a, b, _ = operands()
    cap = int(J.symbolic(a, b)[1][-1]) // 2
    assert_csr_equal(J.spgemm_esc(a, b, cap),
                     T.spgemm_esc(to_port(a), to_port(b), cap), "esc short")


@pytest.mark.parametrize("use_case", ("AxA", "LxU", "tall_skinny"))
def test_dispatcher_auto_routes_like_reference(use_case):
    for scale, ef, preset in ((5, 3, "G500"), (6, 12, "ER"), (6, 12, "G500")):
        a = jrmat.rmat_csr(scale, ef, preset, seed=1)
        ta = to_port(a)
        for so in (False, True):
            want = J.choose_algorithm(a, a, sorted_output=so,
                                      use_case=use_case)
            got = T.choose_algorithm(ta, ta, sorted_output=so,
                                     use_case=use_case)
            assert got == want, (scale, ef, preset, so)


@pytest.mark.parametrize("sr", ("plus_times", "boolean"))
def test_dispatcher_hash_family_and_finalize(sr):
    """``hash`` on a CPU tensor runs the kernels' plain versions; a general
    semiring routes to the fallback.  Either way the unsorted result sorts
    to the reference's ESC output."""
    a, b, mask = operands()
    cap = int(J.symbolic(a, b)[1][-1])
    ta, tb = to_port(a), to_port(b)
    ref = J.spgemm_esc(a, b, cap, semiring=sr)
    for algo in ("hash", "hash_vector", "hash_jnp"):
        c = T.spgemm(ta, tb, cap, algorithm=algo, semiring=sr)
        assert not c.sorted_cols
        assert_csr_equal(ref, T.finalize(c, True), algo)
        assert T.finalize(c, False) is c
    c = T.spgemm(ta, tb, cap, algorithm="hash", sorted_output=True,
                 mask=to_port(mask))
    assert_csr_equal(J.spgemm_esc(a, b, cap, mask=mask),
                     T.finalize(c, True), "masked hash")


@pytest.mark.parametrize("algo", ("bcsr", "pb"))
def test_unported_paths_raise(algo):
    a, b, _ = operands()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.spgemm(to_port(a), to_port(b), 64, algorithm=algo)
    with pytest.raises(ValueError):
        T.spgemm(to_port(a), to_port(b), 64, algorithm="no_such_algorithm")
