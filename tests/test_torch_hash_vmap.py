"""The port's hash value-fleet path against ``repro``.

A frozen hash plan (``algorithm="hash"`` or ``"hash_vector"``) executed
under ``torch.func.vmap`` over members' values (A's, B's or both) must
reach the batched numeric kernel through the custom op
``repro_torch::spgemm_hash_numeric``'s vmap rule, once per call; the
planless ``spgemm_hash`` with a pinned schedule (or over stacked
per-member structures with stacked schedules) must also reach the batched
symbolic kernel through ``repro_torch::spgemm_hash_symbolic``'s rule.
Results equal ``jax.vmap`` of the reference (its Pallas kernels in
interpret mode, through their ``custom_vmap`` rules): structure bitwise,
values bitwise on dyadic inputs and within 1 ulp per accumulated product
on uniform ones.  On CPU tensors the rules run the batched plain
versions, so ``batched_plain`` counts the rules' runs and no
single-product counter fires.  General semirings and masks run the
sort-based fallback under vmap, as in the reference.

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
import scipy.sparse as sp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.kernels.spgemm_hash import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.formats import prefix_sum  # noqa: E402
from repro_torch.kernels.spgemm_hash import kernel as TK  # noqa: E402
from repro_torch.kernels.spgemm_hash import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_hash import ref as tref  # noqa: E402
from _fuzz import VALS, csr_of, member_value_fleet, rand_dense  # noqa: E402

QUIET = {"symbolic": 0, "numeric": 0, "symbolic_vector": 0,
         "numeric_vector": 0, "batched_symbolic": 0,
         "batched_symbolic_vector": 0, "batched_numeric": 0,
         "batched_numeric_vector": 0, "plain": 0, "batched_plain": 0}
#: a vmapped planned execute: one batched plain run (the numeric rule)
PLANNED = {**QUIET, "batched_plain": 1}
#: a vmapped planless product: the symbolic rule, then the numeric rule
PLANLESS = {**QUIET, "batched_plain": 2}


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
    """``(n, cap)`` member values on ``c``'s pattern, zero past nnz:
    ``member_value_fleet``'s dyadic stack (member 0 is ``c``'s own
    values), or uniform in [0.5, 1.5)."""
    nnz = int(c.nnz)
    out = np.zeros((n, c.cap), np.float32)
    if values == "dyadic":
        out[:, :nnz] = member_value_fleet(np.asarray(c.to_dense()), n, seed)
    else:
        rng = np.random.default_rng(seed)
        out[:, :nnz] = rng.uniform(0.5, 1.5, (n, nnz))
    return out


def member(x, e):
    return x[e] if x.ndim == 2 else x


def scipy_dense(a, b, x, y):
    """float64 ``A @ B`` with A's values ``x`` and B's ``y`` (scipy)."""
    def csr(c, v):
        nnz = int(c.nnz)
        return sp.csr_matrix((np.asarray(v)[:nnz].astype(np.float64),
                              np.asarray(c.indices)[:nnz],
                              np.asarray(c.indptr)), shape=c.shape)
    return np.asarray((csr(a, x) @ csr(b, y)).todense())


def sorted_member(indptr, cols, vals, shape):
    """One member's output as a port CSR with rows sorted."""
    ip, cols, vals = (torch.from_numpy(np.array(x))
                      for x in (indptr, cols, vals))
    c = T.CSR(ip, cols, vals, ip[-1], shape, False)
    return c.sort_rows()


def assert_member(want, got, k, values):
    """Two sorted-row members: structure bitwise; values bitwise on the
    dyadic fleet, else within ``k`` ulp per slot (``k``: products per
    slot, :func:`ref.products_per_entry`)."""
    assert torch.equal(want.indptr, got.indptr)
    nnz = int(want.indptr[-1])
    assert torch.equal(want.indices[:nnz], got.indices[:nnz])
    w, g = want.data[:nnz].numpy(), got.data[:nnz].numpy()
    if values == "dyadic":
        assert np.array_equal(w, g)
        return
    ulp = np.spacing(np.abs(w).astype(np.float32))
    assert np.all(np.abs(g - w) <= np.maximum(k[:nnz].numpy(), 1) * ulp)


def vmapped_pair(jrun, trun, dims, xa, xb):
    """``jax.vmap(jrun)`` and ``torch.func.vmap(trun)`` over the same host
    stacks (``dims``: 0 or None per operand); the port's launch counts."""
    jops.reset_kernel_calls()
    want = jax.vmap(jrun, in_axes=dims)(jnp.asarray(xa), jnp.asarray(xb))
    assert jops.kernel_call_counts()["batched_numeric"] > 0
    tops.reset_kernel_calls()
    got = torch.func.vmap(trun, in_dims=dims)(torch.from_numpy(xa),
                                              torch.from_numpy(xb))
    return want, got, tops.kernel_call_counts()


def rect_case():
    a = csr_of(rand_dense(12, 10, 0.35, seed=40))
    b = csr_of(rand_dense(10, 14, 0.3, seed=41))
    return a, b


# ---------------------------------------------------------------------------
# a value fleet on one frozen hash plan, against the reference
# ---------------------------------------------------------------------------

def test_planned_hash_eager_vmap_bitwise():
    """The counterpart of ``test_trace_contexts.py``'s
    ``test_planned_hash_eager_jit_vmap_bitwise`` (scalar probe): one frozen
    plan executed eagerly per member and under ``torch.func.vmap`` over 3
    members of A's values; bitwise equal to each other, to ``jax.vmap`` of
    the reference's plan and to scipy on dyadic values; one batched plain
    run, no single-product run."""
    ad, bd = rand_dense(8, 6, 0.4, 20), rand_dense(6, 9, 0.4, 21)
    a, b = csr_of(ad), csr_of(bd)
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_spgemm(a, b, algorithm="hash")
    tp = T.plan_spgemm(ta, tb, algorithm="hash")
    vals = fleet(a, 3, 22, "dyadic")

    def jrun(v, _):
        return jp.execute(with_data(a, v), b).to_dense()

    def trun(v, _):
        return tp.execute(with_data(ta, v), tb).to_dense()

    want, got, counts = vmapped_pair(jrun, trun, (0, None), vals,
                                     np.zeros(1, np.float32))
    assert counts == PLANNED
    tops.reset_kernel_calls()
    eager = [trun(torch.from_numpy(vals[e]), None) for e in range(3)]
    assert tops.kernel_call_counts() == {**QUIET, "plain": 3}
    for e in range(3):
        oracle = scipy_dense(a, b, vals[e], b.data)
        assert np.array_equal(eager[e].numpy(), oracle), e
        assert torch.equal(got[e], eager[e]), e
        assert np.array_equal(np.asarray(want[e]), got[e].numpy()), e


@pytest.mark.parametrize("values", ("dyadic", "uniform"))
@pytest.mark.parametrize("batched", ("a", "b", "both"))
def test_batched_operands_match_reference(batched, values):
    """A's values, B's or both batched on a rectangular product: row
    pointers and column sets bitwise (the plan's), values bitwise on the
    dyadic fleet and within 1 ulp per product on the uniform one against
    ``jax.vmap`` of the reference; each member bitwise equal to the
    port's own execute."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_spgemm(a, b, algorithm="hash", n_bins=4)
    tp = T.plan_spgemm(ta, tb, algorithm="hash", n_bins=4)
    n = 3
    xa = fleet(a, n, 42, values) if batched != "b" else np.array(a.data)
    xb = fleet(b, n, 43, values) if batched != "a" else np.array(b.data)
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)

    def jrun(x, y):
        c = jp.execute(with_data(a, x), with_data(b, y))
        return c.indptr, c.indices, c.data

    def trun(x, y):
        c = tp.execute(with_data(ta, x), with_data(tb, y))
        return c.indptr, c.indices, c.data

    want, got, counts = vmapped_pair(jrun, trun, dims, xa, xb)
    assert counts == PLANNED
    assert got[1].shape == got[2].shape == (n, tp.cap_c)
    k = tref.products_per_entry(ta.indptr, tb.indptr, tp.indptr_c,
                                ta.indices, tb.indices, tp.cap_c)
    shape = (a.n_rows, b.n_cols)
    for e in range(n):
        assert torch.equal(got[0][e], tp.indptr_c)
        w = sorted_member(want[0][e], want[1][e], want[2][e], shape)
        g = sorted_member(got[0][e], got[1][e], got[2][e], shape)
        assert_member(w, g, k, values)
        x, y = torch.from_numpy(member(xa, e)), torch.from_numpy(
            member(xb, e))
        one = tp.execute(with_data(ta, x), with_data(tb, y))
        assert torch.equal(got[1][e], one.indices), e
        assert torch.equal(got[2][e], one.data), e


@pytest.mark.parametrize("route", ("hash_vector", "auto"))
def test_vector_plan_under_vmap(route):
    """The ``hash_vector`` plan (explicit, and the recipe's own choice for
    an unsorted ER square) under ``torch.func.vmap`` over A's values.  The
    reference's vector probe cannot run here (jax 0.9.0 has no
    ``pl.load``), so the result is held against ``jax.vmap`` of the
    reference's scalar ``hash`` plan and against its ``hash_jnp`` plan per
    member, bitwise on dyadic values."""
    from repro.data import rmat as jrmat
    a = jrmat.rmat_csr(6, 4, "ER", seed=3)
    dyadic = np.zeros(a.cap, np.float32)
    dyadic[:int(a.nnz)] = np.random.default_rng(43).choice(VALS, int(a.nnz))
    a = with_data(a, jnp.asarray(dyadic))
    ta = to_port(a)
    kw = {} if route == "auto" else {"algorithm": "hash_vector"}
    tp = T.plan_spgemm(ta, ta, **kw)
    assert tp.algorithm == "hash_vector"
    jp = J.plan_spgemm(a, a, algorithm="hash")
    twin = J.plan_spgemm(a, a, algorithm="hash_jnp", cache=False)
    vals = fleet(a, 3, 44, "dyadic")

    def jrun(v, _):
        return jp.execute(with_data(a, v), a).to_dense()

    def trun(v, _):
        return tp.execute(with_data(ta, v), ta).to_dense()

    want, got, counts = vmapped_pair(jrun, trun, (0, None), vals,
                                     np.zeros(1, np.float32))
    assert counts == PLANNED
    for e in range(3):
        ref = twin.execute(with_data(a, jnp.asarray(vals[e])), a).to_dense()
        assert np.array_equal(np.asarray(want[e]), got[e].numpy()), e
        assert np.array_equal(np.asarray(ref), got[e].numpy()), e


def test_sorted_output_plan_under_vmap():
    """``execute(sorted_output=True)`` on a hash plan under vmap: the sort
    epilogue runs on the batched output; indices and dyadic values bitwise
    equal to ``jax.vmap`` of the reference's sorted execute."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    jp = J.plan_spgemm(a, b, algorithm="hash")
    tp = T.plan_spgemm(ta, tb, algorithm="hash")
    vals = fleet(a, 3, 45, "dyadic")

    def jrun(v, _):
        c = jp.execute(with_data(a, v), b, sorted_output=True)
        return c.indices, c.data

    def trun(v, _):
        c = tp.execute(with_data(ta, v), tb, sorted_output=True)
        assert c.sorted_cols
        return c.indices, c.data

    want, got, counts = vmapped_pair(jrun, trun, (0, None), vals,
                                     np.zeros(1, np.float32))
    assert counts == PLANNED
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("semiring", ("min_plus", "plus_first", "boolean",
                                      "mask"))
def test_general_semirings_and_masks_under_vmap(semiring):
    """General semirings and masks on a hash plan run the sort-based
    fallback under vmap, as in the reference: no kernel and no plain
    version, bitwise equal to ``jax.vmap`` of the reference's plan and to
    the port's per-member execute."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    if semiring == "mask":
        m = csr_of(rand_dense(12, 14, 0.4, seed=46))
        jkw, tkw = {"mask": m}, {"mask": to_port(m)}
    else:
        jkw = tkw = {"semiring": semiring}
    jp = J.plan_spgemm(a, b, algorithm="hash", cache=False, **jkw)
    tp = T.plan_spgemm(ta, tb, algorithm="hash", cache=False, **tkw)
    vals = fleet(a, 3, 47, "dyadic")

    def jrun(v):
        return jp.execute(with_data(a, v), b).to_dense()

    def trun(v):
        return tp.execute(with_data(ta, v), tb).to_dense()

    want = jax.vmap(jrun)(jnp.asarray(vals))
    tops.reset_kernel_calls()
    got = torch.func.vmap(trun)(torch.from_numpy(vals))
    assert tops.kernel_call_counts() == QUIET
    assert np.array_equal(np.asarray(want), got.numpy())
    for e in range(3):
        assert torch.equal(got[e], trun(torch.from_numpy(vals[e]))), e


# ---------------------------------------------------------------------------
# the planless product under vmap: both rules
# ---------------------------------------------------------------------------

def pair_with_row_flop(d):
    """``test_hash_saturation.py``'s ``_pair_with_row_flop``: C row 0 has
    exactly ``d`` distinct columns, row 1 the same with flop ``2d``."""
    a = J.CSR.from_numpy_coo([0, 1, 1], [0, 0, 1], [1.0, 1.0, 0.5], (2, 2))
    rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
    cols = np.concatenate([np.arange(d), np.arange(d)])
    b = J.CSR.from_numpy_coo(rows, cols, VALS[np.arange(2 * d) % len(VALS)],
                             (2, d))
    return a, b


def saturation_fleet(d, vector, table_size, schedule):
    """Two members (A's values, twice A's) on the saturating structure
    through the planless ``spgemm_hash`` under vmap, the schedule closed
    over, in both packages: per-member ``(indptr, dense)`` stacks and the
    port's launch counts."""
    a, b = pair_with_row_flop(d)
    ta, tb = to_port(a), to_port(b)
    vals = np.stack([np.asarray(a.data), 2 * np.asarray(a.data)])

    def jrun(v):
        c = jops.spgemm_hash(with_data(a, v), b, cap_c=2 * d,
                             table_size=table_size,
                             schedule=tuple(map(jnp.asarray, schedule)))
        return c.indptr, c.to_dense()

    def trun(v):
        c = tops.spgemm_hash(with_data(ta, v), tb, cap_c=2 * d,
                             vector=vector, table_size=table_size,
                             schedule=tuple(map(torch.as_tensor, schedule)))
        return c.indptr, c.to_dense()

    jops.reset_kernel_calls()
    want = jax.vmap(jrun)(jnp.asarray(vals))
    jcounts = jops.kernel_call_counts()
    assert jcounts["batched_symbolic"] > 0 and jcounts["batched_numeric"] > 0
    tops.reset_kernel_calls()
    got = torch.func.vmap(trun)(torch.from_numpy(vals))
    assert tops.kernel_call_counts() == PLANLESS
    for e in range(2):
        ip = got[0][e].numpy()
        assert ip[1] - ip[0] == d and ip[2] - ip[1] == d, e
        assert np.array_equal(np.asarray(want[0][e]), ip), e
        assert np.array_equal(np.asarray(want[1][e]), got[1][e].numpy()), e
        oracle = scipy_dense(a, b, vals[e], b.data)
        assert np.array_equal(got[1][e].numpy().astype(np.float64),
                              oracle), e


@pytest.mark.parametrize("vector", (False, True))
def test_batched_grid_load_factor_one_under_vmap(vector):
    """The counterpart of ``test_hash_saturation.py``'s
    ``test_batched_grid_load_factor_one_under_vmap`` (the reference on its
    scalar probe): a forced table of exactly ``d = CHUNK`` slots for ``d``
    distinct columns, every member flushing exactly ``d`` slots with exact
    values, through the batched symbolic and numeric rules."""
    d = TK.CHUNK
    saturation_fleet(d, vector, d, (np.array([0, 2], np.int32),
                                    np.array([d], np.int32)))


@pytest.mark.parametrize("vector", (False, True))
def test_batched_grid_one_past_fill_doubles_table_under_vmap(vector):
    """One past exact fill under vmap: the natural sizing's doubled table
    (2 * CHUNK, the same in both packages) rides into the batched rules as
    data and every member stays exact."""
    d = TK.CHUNK + 1
    a, b = pair_with_row_flop(d)
    off, tsz, table = tops.hash_schedule(to_port(a), to_port(b), n_bins=1)
    j_off, j_tsz, j_table = jops.hash_schedule(a, b, n_bins=1)
    assert table == j_table == 2 * TK.CHUNK
    assert off.tolist() == np.asarray(j_off).tolist()
    assert tsz.tolist() == np.asarray(j_tsz).tolist()
    saturation_fleet(d, vector, table, (off.numpy(), tsz.numpy()))


@pytest.mark.parametrize("front_door", (False, True))
def test_planless_values_fleet_matches_reference(front_door):
    """The planless product with only values batched: the inspection runs
    once on the shared structure, then both rules; ``spgemm_hash`` and
    ``core.spgemm(..., algorithm="hash")`` against ``jax.vmap`` of the
    reference's, bitwise on dyadic values (row pointers and dense)."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    cap_c = 120
    vals = fleet(a, 3, 48, "dyadic")

    def jrun(v):
        x = with_data(a, v)
        c = J.spgemm(x, b, cap_c, algorithm="hash") if front_door else \
            jops.spgemm_hash(x, b, cap_c)
        return c.indptr, c.to_dense()

    def trun(v):
        x = with_data(ta, v)
        c = T.spgemm(x, tb, cap_c, algorithm="hash") if front_door else \
            tops.spgemm_hash(x, tb, cap_c)
        return c.indptr, c.to_dense()

    want = jax.vmap(jrun)(jnp.asarray(vals))
    tops.reset_kernel_calls()
    got = torch.func.vmap(trun)(torch.from_numpy(vals))
    assert tops.kernel_call_counts() == PLANLESS
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def stacked_members(n=3, seed=50):
    """``n`` different A's of one shape on a shared B, padded to one
    capacity, with their schedules at one static table size: the stacked
    CSR arrays, the stacked schedule, the members and ``(table, cap_c)``."""
    tb = to_port(csr_of(rand_dense(9, 12, 0.4, seed=seed)))
    members = [to_port(csr_of(rand_dense(8, 9, 0.2 + 0.15 * e, seed + 1 + e)))
               for e in range(n)]
    table = max(tops.hash_schedule(x, tb, n_bins=4)[2] for x in members)
    scheds = [tops.hash_schedule(x, tb, n_bins=4, table_size=table)[:2]
              for x in members]
    cap = max(x.cap for x in members)
    cap_c = 8 * 12

    def pad(t):
        return torch.nn.functional.pad(t, (0, cap - t.shape[0]))

    stacks = (torch.stack([x.indptr for x in members]),
              torch.stack([pad(x.indices) for x in members]),
              torch.stack([pad(x.data) for x in members]),
              torch.stack([x.nnz for x in members]))
    schedule = tuple(torch.stack(s) for s in zip(*scheds))
    return stacks, schedule, members, tb, table, cap_c


def test_planless_stacked_structures_and_schedules():
    """``torch.func.vmap`` of the planless ``spgemm_hash`` over stacked
    per-member structures with a stacked ``schedule=`` (each member's own
    bins at one static table size): both rules once, each member bitwise
    equal to its own unbatched product (row pointers, columns, values) and
    to scipy."""
    stacks, schedule, members, tb, table, cap_c = stacked_members()

    def run(ip, ix, dv, nnz, off, tsz):
        x = T.CSR(ip, ix, dv, nnz, members[0].shape)
        c = tops.spgemm_hash(x, tb, cap_c, table_size=table,
                             schedule=(off, tsz))
        return c.indptr, c.indices, c.data, c.to_dense()

    tops.reset_kernel_calls()
    got = torch.func.vmap(run)(*stacks, *schedule)
    assert tops.kernel_call_counts() == PLANLESS
    for e, x in enumerate(members):
        one = tops.spgemm_hash(x, tb, cap_c, table_size=table,
                               schedule=(schedule[0][e], schedule[1][e]))
        assert torch.equal(got[0][e], one.indptr), e
        assert torch.equal(got[1][e], one.indices), e
        assert torch.equal(got[2][e], one.data), e
        oracle = scipy_dense(x, tb, x.data, tb.data)
        assert np.array_equal(got[3][e].numpy().astype(np.float64), oracle)


def test_ops_with_members_on_another_dim():
    """The two ops called directly under ``torch.func.vmap`` with the
    structure stacked on dim 0 and A's values on dim 1: the rules move
    each member axis to the front; each member equals its own product."""
    stacks, schedule, members, tb, table, cap_c = stacked_members(seed=60)
    ip, ix, dv, _ = stacks
    f32 = torch.float32

    def run(off, tsz, ip_a, a_idx, a_val):
        rows = tops.symbolic_op(off, tsz, ip_a, tb.indptr, a_idx, a_val,
                                tb.indices, tb.data.to(f32), table, False,
                                tb.n_cols)
        ic = prefix_sum(rows).to(torch.int32)
        return ic, tops.numeric_op(off, tsz, ip_a, tb.indptr, ic, a_idx,
                                   a_val, tb.indices, tb.data.to(f32), cap_c,
                                   table, False)

    tops.reset_kernel_calls()
    ic, (cols, vals) = torch.func.vmap(run, in_dims=(0, 0, 0, 0, 1))(
        *schedule, ip, ix, dv.T.contiguous())
    assert tops.kernel_call_counts() == PLANLESS
    for e, x in enumerate(members):
        one = tops.spgemm_hash(x, tb, cap_c, table_size=table,
                               schedule=(schedule[0][e], schedule[1][e]))
        assert torch.equal(ic[e], one.indptr), e
        assert torch.equal(cols[e], one.indices), e
        assert torch.equal(vals[e], one.data), e


def test_batched_structure_without_schedule_raises():
    """Under vmap over stacked structures the inspection cannot run: a
    planless call with no ``schedule=`` raises ``ValueError`` saying to
    pass it and ``table_size=``, before any kernel or plain version runs,
    as the reference refuses a traced inspection; a schedule without its
    ``table_size`` raises too."""
    stacks, schedule, members, tb, table, cap_c = stacked_members()

    def run(ip, ix, dv, nnz):
        x = T.CSR(ip, ix, dv, nnz, members[0].shape)
        return tops.spgemm_hash(x, tb, cap_c).data

    def run_sched(ip, ix, dv, nnz, off, tsz):
        x = T.CSR(ip, ix, dv, nnz, members[0].shape)
        return tops.spgemm_hash(x, tb, cap_c, schedule=(off, tsz)).data

    tops.reset_kernel_calls()
    with pytest.raises(ValueError, match="schedule=.*table_size="):
        torch.func.vmap(run)(*stacks)
    with pytest.raises(ValueError, match="table_size"):
        torch.func.vmap(run_sched)(*stacks, *schedule)
    assert tops.kernel_call_counts() == QUIET


# ---------------------------------------------------------------------------
# CSR.to_dense, the batched plain versions and the counters
# ---------------------------------------------------------------------------

def test_to_dense_under_vmap():
    """``CSR.to_dense`` builds out of place, so it runs under vmap with the
    values batched (the zeros are not), and with whole stacked
    structures; each member equals its own dense view."""
    stacks, _, members, _, _, _ = stacked_members()
    ip, ix, dv, nnz = stacks
    shape = members[0].shape
    x = members[1]
    got = torch.func.vmap(lambda v: with_data(x, v).to_dense())(dv[:, :x.cap])
    for e in range(3):
        assert torch.equal(got[e], with_data(x, dv[e, :x.cap]).to_dense())
    got = torch.func.vmap(lambda *t: T.CSR(*t, shape).to_dense())(ip, ix, dv,
                                                                 nnz)
    for e, x in enumerate(members):
        assert torch.equal(got[e], x.to_dense()), e


@pytest.mark.parametrize("shared", ("stride0", "stacked"))
def test_batched_plain_equals_loop(shared):
    """The batched plain versions (and the batched wrappers on CPU) equal
    a loop of the single-product plain versions bitwise (uniform values),
    with the plan's schedule and ``indptr_c`` shared (1-D, stride 0) or
    stacked per member, A's values stacked and B shared."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    tp = T.plan_spgemm(ta, tb, algorithm="hash", n_bins=4)
    n = 3
    av = torch.from_numpy(fleet(a, n, 49, "uniform"))
    sched = [tp.offsets, tp.bin_tsize, tp.indptr_c]
    if shared == "stacked":
        sched = [torch.stack([t] * n) for t in sched]
    off, tsz, ic = sched
    kw = dict(table_size=tp.table_size, vector=False)
    sym = (off, tsz, ta.indptr, tb.indptr, ta.indices, av, tb.indices,
           tb.data)
    num = (off, tsz, ta.indptr, tb.indptr, ic, ta.indices, av, tb.indices,
           tb.data)
    rows = tref.batched_symbolic_plain(*sym, n_members=n, **kw)
    cols, vals = tref.batched_numeric_plain(*num, n_members=n,
                                            cap_c=tp.cap_c, **kw)
    assert rows.shape == (n, ta.n_rows) and rows.dtype == torch.int32
    assert cols.shape == vals.shape == (n, tp.cap_c)
    for e in range(n):
        assert torch.equal(rows[e], tref.symbolic_plain(
            tp.offsets, tp.bin_tsize, ta.indptr, tb.indptr, ta.indices,
            av[e], tb.indices, tb.data, **kw)), e
        assert torch.equal(rows[e], tp.row_nnz_c), e
        c1, v1 = tref.numeric_plain(
            tp.offsets, tp.bin_tsize, ta.indptr, tb.indptr, tp.indptr_c,
            ta.indices, av[e], tb.indices, tb.data, cap_c=tp.cap_c, **kw)
        assert torch.equal(cols[e], c1) and torch.equal(vals[e], v1), e
    tops.reset_kernel_calls()
    assert torch.equal(TK.batched_symbolic_call(*sym, n_members=n, **kw,
                                                n_cols=tb.n_cols), rows)
    kc, kv = TK.batched_numeric_call(*num, n_members=n, cap_c=tp.cap_c, **kw)
    assert torch.equal(kc, cols) and torch.equal(kv, vals)
    assert tops.kernel_call_counts() == {**QUIET, "batched_plain": 2}


def test_batched_wrappers_reject_bad_member_axis():
    """An argument that is neither shared nor stacked ``n_members`` deep is
    refused before any plain version or kernel runs."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    tp = T.plan_spgemm(ta, tb, algorithm="hash")
    kw = dict(table_size=tp.table_size, vector=False)
    vals = torch.ones(2, ta.cap)
    tops.reset_kernel_calls()
    with pytest.raises(ValueError, match="a_val"):
        TK.batched_symbolic_call(tp.offsets, tp.bin_tsize, ta.indptr,
                                 tb.indptr, ta.indices, vals, tb.indices,
                                 tb.data, n_members=3, **kw,
                                 n_cols=tb.n_cols)
    with pytest.raises(ValueError, match="indptr_c"):
        TK.batched_numeric_call(tp.offsets, tp.bin_tsize, ta.indptr,
                                tb.indptr, torch.stack([tp.indptr_c] * 2),
                                ta.indices, ta.data, tb.indices, tb.data,
                                n_members=3, cap_c=tp.cap_c, **kw)
    with pytest.raises(ValueError, match="n_members"):
        TK.batched_numeric_call(tp.offsets, tp.bin_tsize, ta.indptr,
                                tb.indptr, tp.indptr_c, ta.indices, ta.data,
                                tb.indices, tb.data, n_members=0,
                                cap_c=tp.cap_c, **kw)
    assert tops.kernel_call_counts() == QUIET


def test_counters_one_batched_run_per_rule():
    """Two vmapped executes: one batched plain run each, nothing else; a
    call outside vmap runs the single-product path once; a vmapped
    planless call runs both rules once."""
    a, b = rect_case()
    ta, tb = to_port(a), to_port(b)
    tp = T.plan_spgemm(ta, tb, algorithm="hash")
    vals = torch.from_numpy(fleet(a, 4, 51, "uniform"))

    def trun(v):
        return tp.execute(with_data(ta, v), tb).data

    tops.reset_kernel_calls()
    first = torch.func.vmap(trun)(vals)
    second = torch.func.vmap(trun)(vals)
    assert tops.kernel_call_counts() == {**QUIET, "batched_plain": 2}
    assert torch.equal(first, second)
    tops.reset_kernel_calls()
    one = trun(vals[1])
    assert tops.kernel_call_counts() == {**QUIET, "plain": 1}
    assert torch.equal(one, first[1])
    tops.reset_kernel_calls()
    planless = torch.func.vmap(lambda v: tops.spgemm_hash(
        with_data(ta, v), tb, tp.cap_c, table_size=tp.table_size,
        schedule=(tp.offsets, tp.bin_tsize)).data)(vals)
    assert tops.kernel_call_counts() == PLANLESS
    assert torch.equal(planless, first)
