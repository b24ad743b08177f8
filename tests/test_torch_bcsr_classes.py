"""The BCSR block kernel's per-row tables and row classes (the plain
version of its classifying kernels, ``repro_torch/kernels/spgemm_bcsr/
ref.py``) against the reference's plan.

Each block row probes a table sized from its own output count, at most
its bin's table in the reference plan, and keeps its table, its tiles and
its stage buffers in one block's shared memory of 30 / 54 / 111 / 225 KB,
or runs direct; within a class, rows run longest A-block count first.  The
schedule (``offsets``, ``bin_tsize``, ``table_size``) and ``indptr_cb``
come from ``repro``'s ``bcsr_inspect`` on R-MAT block patterns and on the
ladder of ``_bcsr_ladder.py``, whose rows sit across every class border;
each row's need, table, bytes, class and A-block bucket are counted here
again with numpy.  The ladder's product goes through the reference's
Pallas kernel in interpret mode and the port's plain version.  On a card,
``test_torch_cuda.py`` holds the classifying kernels against this plain
version.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.kernels.spgemm_bcsr import ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import kernel as K  # noqa: E402
from repro_torch.kernels.spgemm_bcsr import ref  # noqa: E402
from _bcsr_ladder import (LADDER, LADDER_CLASSES, LADDER_LARGE,  # noqa: E402
                          LADDER_LARGE_CLASSES, ladder)

#: the classes' shared memory (bytes) and the stage's sizing, restated
SMEM = (30 * 1024, 54 * 1024, 111 * 1024, 225 * 1024)
STAGE_MIN, STAGE_FLOATS, BUFFERS = 8, 2048, 4


def r16(x):
    return (np.asarray(x, np.int64) + 15) // 16 * 16


def expected(offsets, bin_tsize, table_size, indptr_a, indptr_c, block,
             vector):
    """``(need, tsz, bytes, class, bucket)`` per block row, numpy; class
    -1 for rows that join none."""
    bm, bk, bn = block
    off = np.asarray(offsets, np.int64)
    ic = np.asarray(indptr_c, np.int64)
    ia = np.asarray(indptr_a, np.int64)
    m = ic.shape[0] - 1
    need, na = np.diff(ic), np.diff(ia)
    b = np.searchsorted(off, np.arange(m), side="right") - 1
    inside = (b >= 0) & (b < off.shape[0] - 1)
    cap = np.where(inside, np.minimum(
        np.asarray(bin_tsize, np.int64)[np.clip(b, 0, len(bin_tsize) - 1)],
        table_size), 0)
    tsz = np.zeros(m, np.int64)
    for i in range(m):
        if need[i] > 0 and cap[i] > 0:
            p = 8
            while p < 2 * need[i]:
                p *= 2
            tsz[i] = min(cap[i], p)
    stage = np.minimum(need, min(STAGE_MIN, max(1, STAGE_FLOATS // (bk * bn))))
    half = r16(4 * bm * bk) + r16(4 * stage) + 16 + r16(4 * bk * bn * stage)
    nbuf = 3 if bm * bk + bk * bn > STAGE_FLOATS else BUFFERS
    nbytes = r16(8 * tsz + 4 * bm * bn * need) + nbuf * half
    cls = np.searchsorted(np.asarray(SMEM), nbytes, side="left")
    ok = (need > 0) & (cap >= 1) & ((cap & (cap - 1)) == 0) & \
        (need <= cap) & (na >= 1)
    if vector:
        ok &= cap >= 8
    bucket = np.minimum(np.floor(np.log2(np.maximum(na, 1))).astype(np.int64),
                        ref.LEN_BUCKETS - 1)
    return need, tsz, nbytes, np.where(ok, cls, -1), bucket


def check_classes(offsets, bin_tsize, table_size, indptr_a, indptr_c,
                  block, vector=False):
    """``K.row_classes`` (its plain version on the CPU) against
    :func:`expected`; returns each row's class."""
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32)  # noqa
    m = len(indptr_c) - 1
    counts, rows, row_tsz = K.row_classes(
        t(offsets), t(bin_tsize), t(indptr_a), t(np.zeros(2)), t(indptr_c),
        t(np.zeros(0)), table_size=table_size, vector=vector, block=block)
    need, tsz, _, cls, bucket = expected(offsets, bin_tsize, table_size,
                                         indptr_a, indptr_c, block, vector)
    assert np.array_equal(row_tsz.numpy(), np.where(cls >= 0, tsz, 0))
    got = np.full(m, -1)
    for c, r in enumerate(rows):
        r = r.numpy()
        got[r] = c
        # longest A-block bucket first, ascending ids within a bucket
        key = -bucket[r] * (m + 1) + r
        assert np.all(np.diff(key) > 0), c
    assert np.array_equal(got, cls)
    want = np.zeros((len(ref.CLASS_NAMES), ref.LEN_BUCKETS), np.int64)
    for c, bk_ in zip(cls[cls >= 0], bucket[cls >= 0]):
        want[c, bk_] += 1
    assert np.array_equal(counts.numpy(), want)
    # a table is a power of two, holds the output, at most the row's cap
    sel = cls >= 0
    assert np.all(tsz[sel] & (tsz[sel] - 1) == 0)
    assert np.all(tsz[sel] >= need[sel])
    return got


def ref_bcsr(parts, block):
    indptr, indices, blocks, shape = parts
    return J.BCSR(jnp.asarray(indptr), jnp.asarray(indices),
                  jnp.asarray(blocks), jnp.asarray(indices.shape[0],
                                                   jnp.int32),
                  shape, block)


def port_bcsr(parts, block):
    indptr, indices, blocks, shape = parts
    return T.BCSR.from_numpy(indptr, indices, blocks, indices.shape[0],
                             shape, block, device="cpu")


def block_pattern(preset, scale, ef, seed=0):
    """An R-MAT pattern over the block grid of dense 8x8 dyadic tiles, as
    ``(indptr, indices, blocks, shape)``."""
    from repro_torch.data.rmat import rmat_edges
    g = 1 << scale
    br, bc = rmat_edges(scale, ef, preset, seed)
    key = np.unique(br.astype(np.int64) * g + bc)
    br, bc = key // g, key % g
    indptr = np.zeros(g + 1, np.int32)
    np.cumsum(np.bincount(br, minlength=g), out=indptr[1:])
    blocks = np.random.default_rng(seed + 1).choice(
        np.array([0.5, 1.0, 1.5, 2.0], np.float32), (key.shape[0], 8, 8))
    return indptr, bc.astype(np.int32), blocks.astype(np.float32), \
        (g * 8, g * 8)


@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", [("ER", 7), ("G500", 7), ("G500", 8)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_row_classes_on_reference_plan(case, vector):
    """R-MAT block patterns (8x8 tiles) under the reference's inspection:
    every row with output in exactly one class, by its bytes and A-block
    count, with the table the reference plan's bin allows.  (The
    reference's chunked probe cannot run on the installed jax; its plan
    arrays are the scalar plan's, so both modes classify that plan.)"""
    preset, scale = case
    parts = block_pattern(preset, scale, 8)
    ja = ref_bcsr(parts, (8, 8))
    _, off, bts, table, _, icb = jops.bcsr_inspect(ja, ja, eager=True)
    got = check_classes(off, bts, table, parts[0], icb, (8, 8, 8), vector)
    need = np.diff(np.asarray(icb))
    assert np.array_equal(got >= 0, need > 0)
    assert set(got[got >= 0]) <= set(ref.launch_classes(
        (8, 8, 8), table, int(np.asarray(icb)[-1])))


@pytest.mark.parametrize("large", (False, True), ids=("8x8", "64x64"))
def test_ladder_reaches_every_class(large):
    """The ladder's rows under the reference's plan land in the classes
    ``_bcsr_ladder`` names: with 8x8 tiles every staged class and direct
    (the G500 hub's shape, 666 outputs over 245 A blocks, in the largest
    staged class), with 64x64 tiles the 225 KB class and direct; each is
    a class the single-product kernel launches."""
    rungs, want = (LADDER_LARGE, LADDER_LARGE_CLASSES) if large else \
        (LADDER, LADDER_CLASSES)
    block = (64, 64, 64) if large else (8, 8, 8)
    a, b = ladder(rungs, block, dyadic=True)
    ja, jb = ref_bcsr(a, block[:2]), ref_bcsr(b, block[1:])
    _, off, bts, table, _, icb = jops.bcsr_inspect(ja, jb, eager=True)
    got = check_classes(off, bts, table, a[0], icb, block)
    assert got.tolist() == list(want)
    launched = ref.launch_classes(block, table, int(np.asarray(icb)[-1]))
    assert set(got[got >= 0]) <= set(launched)
    assert list(launched) == sorted(launched, reverse=True)
    if not large:
        hub = LADDER.index((666, 245))
        assert ref.len_bucket(245) == 7 and got[hub] == 3


def test_ladder_product_matches_reference():
    """The 64x64 ladder's product (staged and direct rows) through the
    port's plain version equals the reference's Pallas kernel in interpret
    mode: block row pointer bitwise, block columns and tiles bitwise after
    a per-row sort (dyadic values)."""
    block = (64, 64, 64)
    a, b = ladder(LADDER_LARGE, block, dyadic=True, seed=4)
    ja, jb = ref_bcsr(a, block[:2]), ref_bcsr(b, block[1:])
    _, off, bts, table, _, icb = jops.bcsr_inspect(ja, jb, eager=True)
    bcap_c = int(np.asarray(icb)[-1])
    jc = jops.spgemm_bcsr(ja, jb, bcap_c)
    ta, tb = port_bcsr(a, block[:2]), port_bcsr(b, block[1:])
    tc = T.plan_bcsr(ta, tb, cache=False).execute(ta, tb)
    assert np.array_equal(np.asarray(jc.indptr), tc.indptr.numpy())
    jcol, jblk = ref.sort_block_rows(
        torch.as_tensor(np.array(jc.indptr)),
        torch.as_tensor(np.array(jc.indices)),
        torch.as_tensor(np.array(jc.blocks)))
    tcol, tblk = ref.sort_block_rows(tc.indptr, tc.indices, tc.blocks)
    assert torch.equal(jcol[:bcap_c], tcol[:bcap_c])
    assert torch.equal(jblk[:bcap_c], tblk[:bcap_c])


def test_rows_the_table_cannot_hold_join_no_class():
    """Rows past their table (8-slot bins for 9 and 20 outputs), a table
    that is not a power of two, rows outside every bin, a row of output
    with no A block, and (vector) a 4-slot table: no class."""
    indptr_c = [0, 3, 12, 32, 35, 38, 39]
    indptr_a = [0, 1, 2, 3, 4, 5, 5]
    off, bts = [0, 3, 4, 6], [8, 6, 4]
    got = check_classes(off, bts, 64, indptr_a, indptr_c, (8, 8, 8))
    assert got.tolist() == [0, -1, -1, -1, 0, -1]
    got = check_classes(off, bts, 64, indptr_a, indptr_c, (8, 8, 8),
                        vector=True)
    assert got.tolist() == [0, -1, -1, -1, -1, -1]
    got = check_classes([0, 2], [64], 64, indptr_a[:4], indptr_c[:4],
                        (8, 8, 8))
    assert got.tolist() == [0, 0, -1]


@pytest.mark.parametrize("block", [(8, 8, 8), (64, 64, 64), (32, 16, 48),
                                   (1, 1, 1), (2, 3, 4)],
                         ids=lambda b: "x".join(map(str, b)))
def test_launch_classes_span_every_possible_row(block):
    """The launched classes run from the smallest row's class (one output,
    an 8-slot table) to the largest's (``min(table_size, bcap_c)``
    outputs), largest first, and hold every row the classifier can list."""
    rng = np.random.default_rng(sum(block))
    for table in (8, 64, 256, 2048):
        bcap_c = int(rng.integers(1, 4096))
        launched = ref.launch_classes(block, table, bcap_c)
        assert launched == tuple(range(launched[0], launched[-1] - 1, -1))
        for need in range(1, min(table, bcap_c) + 1, 7):
            p = 8
            while p < 2 * need:
                p *= 2
            tsz = min(table, p)
            c = int(ref.class_of_bytes(ref.row_bytes(tsz, need, *block)))
            assert c in launched, (table, need)
    assert ref.launch_classes((8, 8, 8), 256, 10 ** 6) == (2, 1, 0)
    assert ref.launch_classes((8, 8, 8), 2048, 10 ** 6) == (4, 3, 2, 1, 0)


def test_row_classes_on_cpu_count_plain_runs():
    K.CLASS_CALLS.update(dict.fromkeys(K.CLASS_CALLS, 0))
    check_classes([0, 2], [16], 16, [0, 1, 3], [0, 3, 9], (8, 8, 8))
    assert K.CLASS_CALLS == dict(dict.fromkeys(K.CLASS_CALLS, 0), plain=1)
