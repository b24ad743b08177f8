"""The port's PB value-fleet path against ``repro``.

A frozen ``PBPlan`` executed under ``torch.func.vmap`` over members'
values (new values on one structure: A's, B's or both) must reach the
batched scatter and merge through the custom ops' vmap rules, once per
phase per call, and give what ``jax.vmap`` of the reference's planned
execute gives (its Pallas kernels in interpret mode, through their
``custom_vmap`` rules): bitwise on dyadic values, within 1 ulp per
accumulated product on uniform ones, structure bitwise.  On CPU tensors
the rules run the batched plain versions, so ``batched_plain`` counts the
rules' runs.  General semirings run the plain twin under vmap, as in the
reference.

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
from repro.data import rmat as jrmat  # noqa: E402
from repro.kernels.spgemm_pb import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels.spgemm_pb import kernel as TK  # noqa: E402
from repro_torch.kernels.spgemm_pb import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_pb import ref as tref  # noqa: E402
from _fuzz import csr_of, member_value_fleet, rand_dense  # noqa: E402

QUIET = {"inspect": 0, "scatter": 0, "merge": 0, "plain": 0,
         "batched_scatter": 0, "batched_merge": 0, "batched_plain": 0}
#: one batched plain run per phase (scatter, merge) per vmapped call
ONE_CALL = {**QUIET, "batched_plain": 2}


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


def fleet(c, n, seed, values):
    """``(n, cap)`` member values on ``c``'s (sorted) pattern, zero past
    nnz: ``member_value_fleet``'s dyadic stack (member 0 is ``c``'s own
    values), or uniform in [0.5, 1.5)."""
    nnz = int(c.nnz)
    out = np.zeros((n, c.cap), np.float32)
    if values == "dyadic":
        out[:, :nnz] = member_value_fleet(np.asarray(c.to_dense()), n, seed)
    else:
        rng = np.random.default_rng(seed)
        out[:, :nnz] = rng.uniform(0.5, 1.5, (n, nnz))
    return out


def products_per_slot(plan):
    """Products accumulated into each output slot (the ulp budget)."""
    seg = plan.seg.numpy().ravel()
    return np.bincount(seg[seg < plan.cap_c], minlength=plan.cap_c)


def assert_values(want, got, counts, values):
    want, got = np.asarray(want), np.asarray(got)
    if values == "dyadic":
        assert np.array_equal(want, got)
        return
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= np.maximum(counts, 1) * ulp)


def vmapped_pair(jrun, trun, dims, xa, xb):
    """``jax.vmap(jrun)`` and ``torch.func.vmap(trun)`` over the same host
    stacks (``dims``: 0 or None per operand); the port's launch counts."""
    jops.reset_kernel_calls()
    want = jax.vmap(jrun, in_axes=dims)(jnp.asarray(xa), jnp.asarray(xb))
    jcounts = jops.kernel_call_counts()
    assert jcounts["batched_scatter"] == jcounts["batched_merge"] == 1
    assert jcounts["inspect"] == 0
    tops.reset_kernel_calls()
    got = torch.func.vmap(trun, in_dims=dims)(torch.from_numpy(xa),
                                              torch.from_numpy(xb))
    return want, got, tops.kernel_call_counts()


# ---------------------------------------------------------------------------
# the value fleet under vmap, against the reference
# ---------------------------------------------------------------------------

def test_value_fleet_matches_reference_vmap_bitwise():
    """The counterpart of ``test_pb.py``'s vmap case: ``torch.func.vmap``
    of the planned execute over A's values equals ``jax.vmap`` of the
    reference bitwise per member; one batched plain run per phase, no
    inspection, no single-product run."""
    ad = rand_dense(10, 10, 0.3, seed=24)
    bd = rand_dense(10, 10, 0.3, seed=25)
    a, b = csr_of(ad), csr_of(bd)
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_pb(a, b, cache=False)
    tp = T.plan_pb(ta, tb, cache=False)
    vals = member_value_fleet(ad, 3, seed=26)

    def jrun(v, _):
        return jp.execute(with_data(a, v), b).data

    def trun(v, _):
        return tp.execute(with_data(ta, v), tb).data

    want, got, counts = vmapped_pair(jrun, trun, (0, None), vals,
                                     np.zeros(1, np.float32))
    assert counts == ONE_CALL
    assert got.shape == (3, tp.cap_c)
    assert np.array_equal(np.asarray(want), got.numpy())
    for e in range(3):
        one = tp.execute(with_data(ta, torch.from_numpy(vals[e])), tb)
        assert torch.equal(got[e], one.data), e


@pytest.mark.parametrize("values", ("dyadic", "uniform"))
@pytest.mark.parametrize("batched", ("a", "b", "both"))
def test_batched_operands_match_reference(batched, values):
    """A's values, B's or both batched on a rectangular product: values
    bitwise on the dyadic fleet and within 1 ulp per product on the
    uniform one against ``jax.vmap`` of the reference; structure bitwise
    (the plan's); each member bitwise equal to the port's own execute."""
    a = csr_of(rand_dense(12, 10, 0.35, seed=40))
    b = csr_of(rand_dense(10, 14, 0.3, seed=41))
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_pb(a, b, n_buckets=4, cache=False)
    tp = T.plan_pb(ta, tb, n_buckets=4, cache=False)
    n = 3
    xa = fleet(a, n, 42, values) if batched != "b" else np.array(a.data)
    xb = fleet(b, n, 43, values) if batched != "a" else np.array(b.data)
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)

    def jrun(x, y):
        c = jp.execute(with_data(a, x), with_data(b, y))
        return c.indices, c.data

    def trun(x, y):
        c = tp.execute(with_data(ta, x), with_data(tb, y))
        return c.indices, c.data

    (jcol, jdata), (tcol, tdata), counts = vmapped_pair(jrun, trun, dims,
                                                        xa, xb)
    assert counts == ONE_CALL
    assert tcol.shape == tdata.shape == (n, tp.cap_c)
    k = products_per_slot(tp)
    for e in range(n):
        assert np.array_equal(np.asarray(jcol[e]), tcol[e].numpy())
        assert torch.equal(tcol[e], tp.cols_c)
        assert_values(jdata[e], tdata[e].numpy(), k, values)
        x = torch.from_numpy(xa[e] if xa.ndim == 2 else xa)
        y = torch.from_numpy(xb[e] if xb.ndim == 2 else xb)
        one = tp.execute(with_data(ta, x), with_data(tb, y))
        assert torch.equal(tdata[e], one.data), e


@pytest.mark.parametrize("route", ("pb", "auto", "bucket_caps"))
def test_planned_pb_route_under_vmap(route):
    """``SpGEMMPlan.execute`` under ``torch.func.vmap`` with the PB route:
    ``algorithm="pb"``, the recipe's own choice for a sorted ER product,
    and ``bucket_caps=True`` (the execute pads C to the plan's capacity).
    Structure and dyadic values bitwise against ``jax.vmap`` of the
    reference's planned execute."""
    a = jrmat.rmat_csr(8, 8, "ER", seed=0)
    ta = to_port(a)
    kw = {"sorted_output": True}
    if route != "auto":
        kw["algorithm"] = "pb"
    if route == "bucket_caps":
        kw["bucket_caps"] = True
    jp = J.plan_spgemm(a, a, **kw)
    tp = T.plan_spgemm(ta, ta, **kw)
    assert jp.algorithm == tp.algorithm == "pb"
    assert jp.cap_c == tp.cap_c
    if route == "bucket_caps":
        assert tp.cap_c > tp.pb_plan.cap_c
    vals = fleet(a, 3, 44, "dyadic")

    def jrun(v, _):
        c = jp.execute(with_data(a, v), a)
        return c.indptr, c.indices, c.data

    def trun(v, _):
        c = tp.execute(with_data(ta, v), ta)
        assert c.sorted_cols
        return c.indptr, c.indices, c.data

    want, got, counts = vmapped_pair(jrun, trun, (0, None), vals,
                                     np.zeros(1, np.float32))
    assert counts == ONE_CALL
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert got[2].shape == (3, tp.cap_c)


@pytest.mark.parametrize("semiring", ("min_plus", "plus_first", "boolean"))
def test_general_semirings_under_vmap_match_reference(semiring):
    """General semirings run the plain twin (``pb_numeric_ref``) on every
    device, under vmap too: its segment reduction is out of place, so the
    vmapped plan computes, bitwise equal to ``jax.vmap`` of the
    reference's plan and to the port's per-member execute."""
    ad = rand_dense(10, 10, 0.3, seed=24)
    bd = rand_dense(10, 10, 0.3, seed=25)
    a, b = csr_of(ad), csr_of(bd)
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_pb(a, b, semiring=semiring, cache=False)
    tp = T.plan_pb(ta, tb, semiring=semiring, cache=False)
    vals = member_value_fleet(ad, 3, seed=26)

    def jrun(v):
        return jp.execute(with_data(a, v), b).data

    def trun(v):
        return tp.execute(with_data(ta, v), tb).data

    want = jax.vmap(jrun)(jnp.asarray(vals))
    tops.reset_kernel_calls()
    got = torch.func.vmap(trun)(torch.from_numpy(vals))
    assert tops.kernel_call_counts() == QUIET          # twin, no kernel
    assert got.shape == (3, tp.cap_c)
    assert np.array_equal(np.asarray(want), got.numpy())
    for e in range(3):
        one = tp.execute(with_data(ta, torch.from_numpy(vals[e])), tb)
        assert torch.equal(got[e], one.data), e


def test_counters_one_batched_run_per_phase():
    """Two vmapped calls: two batched plain runs each, nothing else; a
    call outside vmap runs the single-product path once per phase."""
    a = csr_of(rand_dense(9, 9, 0.4, seed=45))
    ta = to_port(a)
    tp = T.plan_pb(ta, ta, cache=False)
    vals = torch.from_numpy(fleet(a, 4, 46, "uniform"))

    def trun(v):
        return tp.execute(with_data(ta, v), ta).data

    tops.reset_kernel_calls()
    first = torch.func.vmap(trun)(vals)
    second = torch.func.vmap(trun)(vals)
    assert tops.kernel_call_counts() == {**QUIET, "batched_plain": 4}
    assert torch.equal(first, second)
    tops.reset_kernel_calls()
    one = trun(vals[1])
    assert tops.kernel_call_counts() == {**QUIET, "plain": 2}
    assert torch.equal(one, first[1])


# ---------------------------------------------------------------------------
# the batched plain versions and the ops
# ---------------------------------------------------------------------------

def pb_arrays(seed=47):
    """A plan's arrays and two members' worth of operand values."""
    a = csr_of(rand_dense(11, 9, 0.4, seed=seed))
    b = csr_of(rand_dense(9, 13, 0.35, seed=seed + 1))
    ta, tb = to_port(a), to_port(b)
    p = T.plan_pb(ta, tb, n_buckets=3, cache=False)
    return ta, tb, p


@pytest.mark.parametrize("stacked", ("none", "values", "indices", "all"))
def test_batched_plain_equals_loop_of_single_plain(stacked):
    """The batched plain versions equal a loop of the single-product plain
    versions bitwise (uniform values), whichever arguments are stacked and
    whichever are shared (stride 0); a shared argument and the same
    argument stacked per member give the same bits."""
    ta, tb, p = pb_arrays()
    n = 3
    rng = np.random.default_rng(48)
    av = torch.from_numpy(rng.uniform(0.5, 1.5, (n, ta.cap))
                          .astype(np.float32))
    bv = torch.from_numpy(rng.uniform(0.5, 1.5, (n, tb.cap))
                          .astype(np.float32))
    if stacked in ("none", "indices"):
        av, bv = av[0], bv[0]
    idx = [p.bucket_nnz, p.src_a, p.src_b, p.seg]
    if stacked in ("indices", "all"):
        idx = [torch.stack([t] * n) for t in idx]
    bnz, sa, sb, seg = idx

    def member(t, dim, e):
        return t[e] if t.dim() > dim else t

    pp = tref.batched_scatter_plain(bnz, sa, sb, av, bv, n)
    out = tref.batched_merge_plain(bnz, seg, pp, p.cap_c, n)
    assert pp.shape == (n, p.n_buckets, p.bucket_cap)
    assert out.shape == (n, p.cap_c)
    for e in range(n):
        one = tref.scatter_plain(p.bucket_nnz, p.src_a, p.src_b,
                                 member(av, 1, e), member(bv, 1, e))
        assert torch.equal(pp[e], one), e
        assert torch.equal(out[e], tref.merge_plain(p.bucket_nnz, p.seg,
                                                    one, p.cap_c)), e
    stack = [torch.stack([t] * n) if t.dim() == d else t
             for t, d in ((bnz, 1), (sa, 2), (sb, 2), (av, 1), (bv, 1))]
    assert torch.equal(tref.batched_scatter_plain(*stack, n), pp)
    shared_pp = tref.batched_merge_plain(p.bucket_nnz, p.seg, pp[1], p.cap_c,
                                         n)
    assert all(torch.equal(shared_pp[e], out[1]) for e in range(n))


def test_batched_plain_clips_indices_and_zeroes_pad_lanes():
    """Per member: out-of-range gathers and slots clip, pad lanes are 0
    and never merged, as in the single-product plain versions."""
    i32 = dict(dtype=torch.int32)
    bucket_nnz = torch.tensor([[3, 0, 2], [2, 0, 1]], **i32)
    src_a = torch.tensor([[0, 5, -2, 7], [1, 1, 1, 1], [2, 9, 0, 0]], **i32)
    src_b = torch.tensor([[1, -1, 9, 3], [0, 0, 0, 0], [0, 2, 4, 4]], **i32)
    seg = torch.tensor([[0, 1, 1, 9], [0, 0, 0, 0], [2, 7, 9, 9]], **i32)
    a_data = torch.tensor([[0.5, 1.5, 2.0], [1.0, 2.0, 4.0]])
    b_data = torch.tensor([1.0, 2.0, 4.0])
    pp = TK.batched_scatter_call(bucket_nnz, src_a, src_b, a_data, b_data,
                                 n_members=2)
    out = TK.batched_merge_call(bucket_nnz, seg, pp, 3, n_members=2)
    for e in range(2):
        one = tref.scatter_plain(bucket_nnz[e], src_a, src_b, a_data[e],
                                 b_data)
        assert torch.equal(pp[e], one)
        assert torch.equal(out[e], tref.merge_plain(bucket_nnz[e], seg, one,
                                                    3))
    assert np.array_equal(pp[0].numpy(), np.array(
        [[1.0, 2.0, 2.0, 0], [0, 0, 0, 0], [2.0, 8.0, 0, 0]], np.float32))
    assert np.array_equal(out[0].numpy(), np.array([1.0, 4.0, 10.0],
                                                   np.float32))


def test_batched_wrappers_reject_bad_member_axis():
    """An argument that is neither shared nor stacked ``n_members`` deep is
    refused before any plain version or kernel runs."""
    _, _, p = pb_arrays()
    vals = torch.ones(2, 40)
    tops.reset_kernel_calls()
    with pytest.raises(ValueError, match="a_data"):
        TK.batched_scatter_call(p.bucket_nnz, p.src_a, p.src_b, vals,
                                vals[0], n_members=3)
    with pytest.raises(ValueError, match="seg"):
        TK.batched_merge_call(p.bucket_nnz, torch.stack([p.seg] * 2),
                              torch.zeros(3, *p.seg.shape), p.cap_c,
                              n_members=3)
    with pytest.raises(ValueError, match="n_members"):
        TK.batched_merge_call(p.bucket_nnz, p.seg, torch.zeros(p.seg.shape),
                              p.cap_c, n_members=0)
    assert tops.kernel_call_counts() == QUIET


def test_op_with_batched_integer_operands():
    """The custom ops called directly under ``torch.func.vmap`` with every
    array batched: three members of different structures (each with its
    own plan at 3 buckets, padded to common capacities), ``seg``,
    ``src_*`` and ``bucket_nnz`` stacked, the values stacked along dim 1.
    Each member equals its own plan's execute bitwise (dyadic values)."""
    b = to_port(csr_of(rand_dense(9, 12, 0.4, seed=50)))
    members, plans = [], []
    for e in range(3):
        a = to_port(csr_of(rand_dense(8, 9, 0.2 + 0.15 * e, seed=51 + e)))
        members.append(a)
        plans.append(T.plan_pb(a, b, n_buckets=3, cache=False))
    lanes = max(p.bucket_cap for p in plans)
    cap_c = max(p.cap_c for p in plans)
    cap_a = max(a.cap for a in members)

    def pad(t, n, value=0):
        return torch.nn.functional.pad(t, (0, n - t.shape[-1]), value=value)

    bnz = torch.stack([p.bucket_nnz for p in plans])
    src_a = torch.stack([pad(p.src_a, lanes) for p in plans])
    src_b = torch.stack([pad(p.src_b, lanes) for p in plans])
    seg = torch.stack([pad(p.seg, lanes, cap_c) for p in plans])
    # members on dim 1: the rules move the axis to the front
    a_vals = torch.stack([pad(a.data, cap_a) for a in members], 1)

    def f(bn, sa, sb, sg, av):
        pp = tops.scatter_op(bn, sa, sb, av, b.data)
        return tops.merge_op(bn, sg, pp, cap_c)

    tops.reset_kernel_calls()
    out = torch.func.vmap(f, in_dims=(0, 0, 0, 0, 1))(bnz, src_a, src_b, seg,
                                                      a_vals)
    assert tops.kernel_call_counts() == ONE_CALL
    assert out.shape == (3, cap_c)
    for e, (a, p) in enumerate(zip(members, plans)):
        one = p.execute(a, b)
        assert torch.equal(out[e, :p.nnz_c], one.data[:p.nnz_c]), e
        assert not out[e, p.nnz_c:].any()
