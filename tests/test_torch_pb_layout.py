"""The PB fleet at the member counts and layouts the batched kernels
choose between, against loops of single products and ``repro``.

The batched scatter and merge take every member of a bucket in one block
where the plan's index arrays are shared, eight members at a time, and a
block a member where any index array is stacked; a stacked value operand
goes slot-major (``kernel.slot_major``), and the merge returns its
``(n, cap_c)`` output stored slot-major (rows of ``kernel.merge_width``
members).  Here, on the CPU, the wrappers
run the plain versions: member counts below, at and past one chunk of
eight (1, 2, 3, 4, 8, 9, 16), both index layouts and A's, B's or both
values batched must give each member what the single-product plain
versions give it, bitwise; ``torch.func.vmap`` of ``PBPlan.execute``
must give what ``jax.vmap`` of the reference's planned execute gives
(its Pallas kernels in interpret mode), bitwise on dyadic values.

Same host operands in one process (numpy, seeded).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.kernels.spgemm_pb import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels.spgemm_pb import kernel as TK  # noqa: E402
from repro_torch.kernels.spgemm_pb import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_pb import ref as tref  # noqa: E402
from _fuzz import VALS, csr_of, rand_dense  # noqa: E402

#: below, at and past one chunk of eight members
SIZES = (1, 2, 3, 4, 8, 9, 16)


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


def with_data(c, v):
    """``c``'s structure with the values ``v`` (either package)."""
    return type(c)(c.indptr, c.indices, v, c.nnz, c.shape, c.sorted_cols)


def dyadic_fleet(c, n, seed):
    """``(n, cap)`` dyadic member values on ``c``'s pattern, zero past
    nnz."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, c.cap), np.float32)
    out[:, :int(c.nnz)] = rng.choice(VALS, size=(n, int(c.nnz)))
    return out


def member(t, dim, e):
    return t[e] if t.dim() > dim else t


@pytest.mark.parametrize("batched", ("a", "b", "both"))
@pytest.mark.parametrize("indices", ("shared", "stacked"))
@pytest.mark.parametrize("n", SIZES)
def test_batched_plain_members_equal_single_plain(n, indices, batched):
    """The batched wrappers (plain versions here) at ``n`` members: each
    member's ``pp`` and merged values bitwise what the single-product
    plain versions give on its arguments (uniform values), whichever
    operands are batched and whether the index arrays are shared or
    stacked; the merge's output stored slot-major, rows of
    ``merge_width`` members."""
    a = to_port(csr_of(rand_dense(11, 9, 0.4, seed=60)))
    b = to_port(csr_of(rand_dense(9, 13, 0.35, seed=61)))
    p = T.plan_pb(a, b, n_buckets=3, cache=False)
    rng = np.random.default_rng(62 + n)
    av = torch.from_numpy(rng.uniform(0.5, 1.5, (n, a.cap))
                          .astype(np.float32))
    bv = torch.from_numpy(rng.uniform(0.5, 1.5, (n, b.cap))
                          .astype(np.float32))
    if batched == "b":
        av = a.data
    if batched == "a":
        bv = b.data
    idx = [p.bucket_nnz, p.src_a, p.src_b, p.seg]
    if indices == "stacked":
        idx = [torch.stack([t] * n) for t in idx]
    bnz, sa, sb, seg = idx
    tops.reset_kernel_calls()
    pp = TK.batched_scatter_call(bnz, sa, sb, av, bv, n_members=n)
    out = TK.batched_merge_call(bnz, seg, pp, p.cap_c, n_members=n)
    assert tops.kernel_call_counts()["batched_plain"] == 2
    assert pp.shape == (n, p.n_buckets, p.bucket_cap)
    assert out.shape == (n, p.cap_c)
    assert out.stride() == (1, TK.merge_width(n, indices == "shared"))
    for e in range(n):
        one = tref.scatter_plain(p.bucket_nnz, p.src_a, p.src_b,
                                 member(av, 1, e), member(bv, 1, e))
        assert torch.equal(pp[e], one), e
        assert torch.equal(out[e], tref.merge_plain(
            p.bucket_nnz, p.seg, one, p.cap_c)), e


@pytest.mark.parametrize("n", SIZES)
def test_vmapped_execute_matches_reference_at_fleet_sizes(n):
    """``torch.func.vmap`` of ``PBPlan.execute`` over ``n`` members of
    A's values (B's shared) equals ``jax.vmap`` of the reference's planned
    execute bitwise on dyadic values, structure and values; one batched
    plain run per phase; each member bitwise its own execute."""
    a = csr_of(rand_dense(12, 10, 0.35, seed=63))
    b = csr_of(rand_dense(10, 14, 0.3, seed=64))
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_pb(a, b, n_buckets=4, cache=False)
    tp = T.plan_pb(ta, tb, n_buckets=4, cache=False)
    vals = dyadic_fleet(a, n, 65 + n)

    def jrun(v):
        c = jp.execute(with_data(a, v), b)
        return c.indices, c.data

    def trun(v):
        c = tp.execute(with_data(ta, v), tb)
        return c.indices, c.data

    jops.reset_kernel_calls()
    jcol, jdata = jax.vmap(jrun)(jnp.asarray(vals))
    assert jops.kernel_call_counts()["batched_merge"] == 1
    tops.reset_kernel_calls()
    tcol, tdata = torch.func.vmap(trun)(torch.from_numpy(vals))
    assert tops.kernel_call_counts() == {
        "inspect": 0, "scatter": 0, "merge": 0, "plain": 0,
        "batched_scatter": 0, "batched_merge": 0, "batched_plain": 2}
    assert tdata.shape == (n, tp.cap_c)
    assert np.array_equal(np.asarray(jcol), tcol.numpy())
    assert np.array_equal(np.asarray(jdata), tdata.numpy())
    for e in range(n):
        one = tp.execute(with_data(ta, torch.from_numpy(vals[e])), tb)
        assert torch.equal(tdata[e], one.data), e


def test_merge_width_rounds_to_whole_sectors():
    """The merge's output rows: ``n`` members, or ``n`` rounded up to a
    multiple of 8 (one 32-byte sector of float32) where the index arrays
    are shared and ``4 <= n``, ``n % 8 != 0``."""
    want = {1: 1, 2: 2, 3: 3, 4: 8, 7: 8, 8: 8, 9: 16, 16: 16, 17: 24}
    assert {n: TK.merge_width(n, True) for n in want} == want
    assert all(TK.merge_width(n, False) == n for n in want)


@pytest.mark.parametrize("n", (1, 3, 8))
def test_slot_major_is_the_transpose(n):
    """``slot_major`` (its plain version on the CPU) lays a ``(n, cap)``
    stack out as ``(cap, n)``, members innermost, contiguous."""
    x = torch.from_numpy(np.random.default_rng(66).uniform(
        -1, 1, (n, 37)).astype(np.float32))
    got = TK.slot_major(x)
    assert got.is_contiguous() and torch.equal(got, x.t().contiguous())
    assert torch.equal(tref.slot_major_plain(x), got)
    with pytest.raises(ValueError, match="slot_major"):
        TK.slot_major(x[0])
