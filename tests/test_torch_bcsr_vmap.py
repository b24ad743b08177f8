"""The port's BCSR value-fleet path against ``repro``, and the structure
memos under writes in place.

A frozen ``BCSRPlan`` executed under ``torch.func.vmap`` over members'
tiles (new values on one block structure: DBCSR's repeated products) must
reach the batched grid through the custom op's vmap rule, once per call,
and give what ``jax.vmap`` of the reference's planned execute gives (its
Pallas kernel in interpret mode, through its ``custom_vmap`` rule): bitwise
on dyadic values, within 1 ulp per accumulated product (block pairs x bk,
``ref.products_per_block``) on uniform ones.  On CPU tensors the rule runs
the batched plain version, so ``batched_plain`` counts the rule's runs.

Same host operands in one process (numpy, seeded).  The last tests pin the
port's version-keyed memos: a write in place to a CSR's or a BCSR's
structure is seen, and planning again follows from it.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.kernels.spgemm_bcsr import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import batch as tbatch  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import kernel as TK  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import ops as tops  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import ref as tref  # noqa: E402
from _fuzz import VALS, block_clustered_dense, csr_of  # noqa: E402

sp = pytest.importorskip("scipy.sparse")

QUIET = {"symbolic": 0, "numeric": 0, "numeric_vector": 0, "plain": 0,
         "batched_numeric": 0, "batched_numeric_vector": 0,
         "batched_plain": 0}


@pytest.fixture(autouse=True)
def _fresh_caches():
    J.clear_plan_cache()
    T.clear_plan_cache()
    yield
    J.clear_plan_cache()
    T.clear_plan_cache()


def to_port_bcsr(a):
    return T.BCSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                             np.asarray(a.blocks), int(a.nnzb), a.shape,
                             a.block, device="cpu")


def trace_case():
    """``test_trace_contexts.py``'s planned BCSR case: both packages'
    operands and plans, and the seed-52 dyadic fleet on A's frozen
    pattern (member 0 is A's own tiles)."""
    ad = block_clustered_dense(4, 3, 4, 4, 0.6, seed=50)
    bd = block_clustered_dense(3, 4, 4, 4, 0.6, seed=51)
    ja = jfmt.csr_to_bcsr(csr_of(ad), (4, 4))
    jb = jfmt.csr_to_bcsr(csr_of(bd), (4, 4))
    rng = np.random.default_rng(52)
    vstack = rng.choice(np.array([0.5, 1.0, 1.5, 2.0], np.float32),
                        size=(3,) + ja.blocks.shape)
    vstack *= (np.asarray(ja.blocks) != 0)
    vstack[0] = np.asarray(ja.blocks)
    return ad, bd, ja, jb, vstack


def uniform_fleet(blocks, n, seed):
    """``n`` members of uniform values in [0.5, 1.5) on ``blocks``'
    pattern, ``(n,) + blocks.shape`` float32."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.5, 1.5, (n,) + blocks.shape).astype(np.float32)
    return vals * (np.asarray(blocks) != 0)


def sorted_rows(indptr, bcol, blk):
    c, b = tref.sort_block_rows(torch.as_tensor(np.array(indptr)),
                                torch.as_tensor(np.array(bcol)),
                                torch.as_tensor(np.array(blk)))
    return c.numpy(), b.numpy()


def assert_member_equal(jc, indptr, bcol, blk, counts=None):
    """One member against the reference's: block row pointer bitwise,
    block columns per row equal, tiles bitwise (``counts`` None) or within
    ``counts`` ulp per cell."""
    nnzb = int(jc.nnzb)
    assert np.array_equal(np.asarray(jc.indptr), indptr.numpy())
    jcol, jblk = sorted_rows(jc.indptr, jc.indices, jc.blocks)
    tcol, tblk = sorted_rows(indptr, bcol, blk)
    assert np.array_equal(jcol[:nnzb], tcol[:nnzb])
    assert not tcol[nnzb:].any() and not tblk[nnzb:].any()
    if counts is None:
        assert np.array_equal(jblk[:nnzb], tblk[:nnzb])
        return
    ulp = np.spacing(np.abs(jblk[:nnzb]).astype(np.float32))
    assert np.all(np.abs(tblk[:nnzb] - jblk[:nnzb])
                  <= counts[:nnzb, None, None] * ulp)


# ---------------------------------------------------------------------------
# the value fleet under vmap, against the reference
# ---------------------------------------------------------------------------

def test_value_fleet_matches_reference_vmap_bitwise():
    """The counterpart of ``test_trace_contexts.py``'s planned BCSR vmap
    case: ``torch.func.vmap(one)`` equals ``jax.vmap(one)`` of the
    reference bitwise per member; the rule fires once, and neither the
    per-member path nor the inspection runs."""
    ad, bd, ja, jb, vstack = trace_case()
    jp = J.plan_bcsr(ja, jb, cache=False)
    ta, tb = to_port_bcsr(ja), to_port_bcsr(jb)
    tp = T.plan_bcsr(ta, tb, cache=False)

    def jone(blk):
        return jp.execute(dataclasses.replace(ja, blocks=blk), jb).to_dense()

    def tone(blk):
        return tp.execute(dataclasses.replace(ta, blocks=blk), tb).to_dense()

    jops.reset_kernel_calls()
    want = np.asarray(jax.vmap(jone)(jnp.asarray(vstack)))
    jcounts = jops.kernel_call_counts()
    assert jcounts["batched_numeric"] == 1 and jcounts["symbolic"] == 0
    tops.reset_kernel_calls()
    got = torch.func.vmap(tone)(torch.from_numpy(vstack))
    assert tops.kernel_call_counts() == {**QUIET, "batched_plain": 1}
    assert got.shape == (3,) + ad.shape[:1] + bd.shape[1:]
    for e in range(len(vstack)):
        assert np.array_equal(got[e].numpy(), want[e]), e
    oracle = np.asarray((sp.csr_matrix(ad) @ sp.csr_matrix(bd)).todense())
    assert np.array_equal(got[0].numpy(), oracle)


@pytest.mark.parametrize("vector", (False, True), ids=("scalar", "vector"))
@pytest.mark.parametrize("batched", ("a", "b", "both"))
def test_batched_operands_match_reference(batched, vector):
    """Uniform values on A's tiles, B's or both, under ``torch.func.vmap``
    of the planned execute: each member within 1 ulp per accumulated
    product of ``jax.vmap`` of the reference's scalar plan (its vector
    kernel cannot run on the installed jax; the two plans' arrays are
    equal), and bitwise equal to the port's own per-member execute."""
    _, _, ja, jb, _ = trace_case()
    n = 3
    avals = uniform_fleet(np.asarray(ja.blocks), n, 60)
    bvals = uniform_fleet(np.asarray(jb.blocks), n, 61)
    if batched == "a":
        bvals = np.array(jb.blocks)
    elif batched == "b":
        avals = np.array(ja.blocks)
    jp = J.plan_bcsr(ja, jb, cache=False)
    ta, tb = to_port_bcsr(ja), to_port_bcsr(jb)
    tp = T.plan_bcsr(ta, tb, vector=vector, cache=False)
    for f in ("offsets", "bin_tsize", "indptr_cb"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()), f
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)

    def jone(x, y):
        c = jp.execute(dataclasses.replace(ja, blocks=x),
                       dataclasses.replace(jb, blocks=y))
        return c.indices, c.blocks

    def tone(x, y):
        c = tp.execute(dataclasses.replace(ta, blocks=x),
                       dataclasses.replace(tb, blocks=y))
        return c.indices, c.blocks

    jcol, jblk = jax.vmap(jone, in_axes=dims)(jnp.asarray(avals),
                                              jnp.asarray(bvals))
    tops.reset_kernel_calls()
    tcol, tblk = torch.func.vmap(tone, in_dims=dims)(torch.from_numpy(avals),
                                                     torch.from_numpy(bvals))
    assert tops.kernel_call_counts() == {**QUIET, "batched_plain": 1}
    assert tcol.shape == (n, tp.bcap_c) and \
        tblk.shape == (n, tp.bcap_c, 4, 4)
    pairs = tref.products_per_block(ta.indptr, tb.indptr, tp.indptr_cb,
                                    ta.indices, tb.indices,
                                    tp.bcap_c).numpy()
    for e in range(n):
        jc = J.BCSR(jp.indptr_cb, jcol[e], jblk[e], jnp.int32(jp.nnzb_c),
                    (ja.shape[0], jb.shape[1]), (4, 4))
        assert_member_equal(jc, tp.indptr_cb, tcol[e], tblk[e],
                            counts=pairs * 4)
        x = torch.from_numpy(avals[e] if avals.ndim == 4 else avals)
        y = torch.from_numpy(bvals[e] if bvals.ndim == 4 else bvals)
        one = tp.execute(dataclasses.replace(ta, blocks=x),
                         dataclasses.replace(tb, blocks=y))
        assert torch.equal(one.indices, tcol[e])
        assert torch.equal(one.blocks, tblk[e])


def test_op_with_batched_integer_operands():
    """The custom op called directly under ``torch.func.vmap`` with every
    array batched but B's: three members of different block patterns
    (each with its own plan, padded to common capacities), one shared B,
    A's tiles stacked along dim 1.  Each member equals its own plan's
    execute bitwise (dyadic values)."""
    g, blk = 6, (2, 2)
    bd = block_clustered_dense(g, g, *blk, 0.5, seed=70)
    b = T.BCSR.from_dense(torch.from_numpy(bd), blk)
    members, plans = [], []
    for e in range(3):
        ad = block_clustered_dense(g, g, *blk, 0.3 + 0.2 * e, seed=71 + e)
        members.append(T.BCSR.from_dense(torch.from_numpy(ad), blk))
        plans.append(T.plan_bcsr(members[-1], b, cache=False))
    bcap_a = max(a.bcap for a in members)
    bcap_c = max(p.bcap_c for p in plans)
    table = max(p.table_size for p in plans)

    def pad(t, n):
        return torch.cat([t, t.new_zeros((n - t.shape[0],) + t.shape[1:])])

    stack = {
        "offsets": torch.stack([p.offsets for p in plans]),
        "bin_tsize": torch.stack([p.bin_tsize for p in plans]),
        "indptr_a": torch.stack([a.indptr for a in members]),
        "indptr_c": torch.stack([p.indptr_cb for p in plans]),
        "a_bcol": torch.stack([pad(a.indices, bcap_a) for a in members]),
        # members on dim 1: the rule moves the axis to the front
        "a_blk": torch.stack([pad(a.blocks, bcap_a) for a in members], 1),
    }

    def f(off, bts, ipa, ipc, abc, ablk):
        return tops.numeric_op(off, bts, ipa, b.indptr, ipc, abc, ablk,
                               b.indices, b.blocks, bcap_c, table, False)

    tops.reset_kernel_calls()
    bcol, blocks = torch.func.vmap(f, in_dims=(0, 0, 0, 0, 0, 1))(
        *stack.values())
    assert tops.kernel_call_counts() == {**QUIET, "batched_plain": 1}
    for e, (a, p) in enumerate(zip(members, plans)):
        one = p.execute(a, b)
        nnzb = p.nnzb_c
        assert torch.equal(bcol[e, :nnzb], one.indices[:nnzb])
        assert torch.equal(blocks[e, :nnzb], one.blocks[:nnzb])
        assert not bcol[e, nnzb:].any() and not blocks[e, nnzb:].any()


def test_to_dense_under_vmap():
    """``BCSR.to_dense`` computes out of place, so it runs under vmap with
    batched tiles (and batched block columns) on an unbatched structure."""
    _, _, ja, _, vstack = trace_case()
    ta = to_port_bcsr(ja)
    got = torch.func.vmap(
        lambda blk: dataclasses.replace(ta, blocks=blk).to_dense())(
            torch.from_numpy(vstack))
    cols = torch.stack([ta.indices, (ta.indices + 1) % ta.grid[1]])
    shifted = torch.func.vmap(
        lambda c: dataclasses.replace(ta, indices=c).to_dense())(cols)
    for e in range(len(vstack)):
        member = dataclasses.replace(ta, blocks=torch.from_numpy(vstack[e]))
        assert torch.equal(got[e], member.to_dense())
    for e in range(2):
        assert torch.equal(
            shifted[e], dataclasses.replace(ta, indices=cols[e]).to_dense())


@pytest.mark.parametrize("shared", ("stride0", "stacked"))
def test_batched_plain_equals_loop(shared):
    """``ref.batched_numeric_plain`` (and ``batched_numeric_call`` on CPU
    tensors, which runs it) equals a loop of ``numeric_plain``: with every
    array but A's tiles shared (member stride 0) and with every array
    stacked; the wrapper refuses an argument with the wrong member
    count."""
    _, _, ja, jb, vstack = trace_case()
    ta, tb = to_port_bcsr(ja), to_port_bcsr(jb)
    p = T.plan_bcsr(ta, tb, cache=False)
    n = len(vstack)
    a_blk = torch.from_numpy(vstack)
    args = [p.offsets, p.bin_tsize, ta.indptr, tb.indptr, p.indptr_cb,
            ta.indices, a_blk, tb.indices, tb.blocks]
    if shared == "stacked":
        args = [t if i == 6 else torch.stack([t] * n)
                for i, t in enumerate(args)]
    kw = dict(bcap_c=p.bcap_c, table_size=p.table_size, vector=False)
    bcol, blocks = tref.batched_numeric_plain(*args, n_members=n, **kw)
    TK.KERNEL_CALLS.update(QUIET)
    kcol, kblk = TK.batched_numeric_call(*args, n_members=n, **kw)
    assert TK.KERNEL_CALLS == {**QUIET, "batched_plain": 1}
    for e in range(n):
        pc, pb = tref.numeric_plain(p.offsets, p.bin_tsize, ta.indptr,
                                    tb.indptr, p.indptr_cb, ta.indices,
                                    a_blk[e], tb.indices, tb.blocks, **kw)
        assert torch.equal(bcol[e], pc) and torch.equal(blocks[e], pb)
        assert torch.equal(kcol[e], pc) and torch.equal(kblk[e], pb)
    with pytest.raises(ValueError, match="a_bcol"):
        TK.batched_numeric_call(*args[:5], torch.stack([ta.indices] * 2),
                                *args[6:], n_members=n, **kw)


# ---------------------------------------------------------------------------
# structure memos follow writes in place
# ---------------------------------------------------------------------------

def test_csr_in_place_edit_replans():
    """A CSR whose ``indices`` are rewritten in place gets a new structure
    key, ``plan_spgemm`` plans again, and the product equals scipy's."""
    rng = np.random.default_rng(80)
    d = np.where(rng.random((64, 64)) < 0.08,
                 rng.choice(VALS, (64, 64)), 0).astype(np.float32)
    r, c = np.nonzero(d)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=64))])
    a = T.CSR.from_numpy(indptr, c, d[r, c], len(r), (64, 64), False,
                         device="cpu")
    key = T.structure_key(a)
    plan = T.plan_spgemm(a, a, algorithm="hash")
    a.indices.copy_((a.indices + 1) % 64)
    assert T.structure_key(a) != key
    again = T.plan_spgemm(a, a, algorithm="hash")
    assert again is not plan
    ad = a.to_dense().numpy()
    oracle = sp.csr_matrix(ad) @ sp.csr_matrix(ad)
    got = again.execute(a, a)
    assert int(got.nnz) == oracle.nnz
    assert np.array_equal(got.to_dense().numpy(),
                          np.asarray(oracle.todense(), np.float32))


def test_host_nnz_follows_in_place_edit():
    """``batch._host_nnz`` reads ``nnz`` again after a write in place, so
    a batched plan's structure check sees the change."""
    rng = np.random.default_rng(81)
    pairs = []
    for i in range(2):
        d = np.where(rng.random((16, 16)) < 0.2, 1.0, 0).astype(np.float32)
        x = T.CSR.from_dense(torch.from_numpy(d))
        pairs.append((x, x))
    a = pairs[0][0]
    k = tbatch._host_nnz(a)
    plan = T.plan_batch(pairs)
    a.nnz.fill_(k - 1)
    assert tbatch._host_nnz(a) == k - 1
    with pytest.raises(AssertionError, match="nnz differs"):
        plan.execute(pairs)


def test_bcsr_in_place_edit_replans():
    """A BCSR whose block columns are rewritten in place gets a new
    structure key, ``plan_bcsr`` plans again, and the product equals the
    dense one."""
    ad = block_clustered_dense(6, 6, 2, 2, 0.4, seed=82)
    a = T.BCSR.from_dense(torch.from_numpy(ad), (2, 2))
    key = T.bcsr_structure_key(a)
    plan = T.plan_bcsr(a, a)
    a.indices.copy_((a.indices + 1) % a.grid[1])
    assert T.bcsr_structure_key(a) != key
    again = T.plan_bcsr(a, a)
    assert again is not plan
    dense = a.to_dense().numpy().astype(np.float64)
    assert np.array_equal(again.execute(a, a).to_dense().numpy(),
                          (dense @ dense).astype(np.float32))


def test_inference_tensors_are_memoized_once():
    """Inference tensors have no version counter: their digest and host
    nnz are computed once per instance, as for a tensor never written,
    and the digest equals the normal one."""
    d = block_clustered_dense(4, 4, 2, 2, 0.5, seed=83)
    with torch.inference_mode():
        a = T.BCSR.from_dense(torch.from_numpy(d), (2, 2))
        c = T.CSR.from_dense(torch.from_numpy(d))
        first = T.bcsr_structure_key(a)
        calls = []
        for x, name, fn in ((a, "_structure_digest", T.bcsr_structure_key),
                            (c, "_structure_digest", T.structure_key),
                            (c, "_host_nnz", tbatch._host_nnz)):
            value = fn(x)
            stamp, memo = x.__dict__[name]
            assert memo == value
            object.__setattr__(x, name, (stamp, "memo"))
            calls.append(fn(x))
        assert calls == ["memo"] * 3
    b = T.BCSR.from_dense(torch.from_numpy(d), (2, 2))
    assert T.bcsr_structure_key(b) == first
