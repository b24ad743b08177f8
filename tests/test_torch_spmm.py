"""The port's SpMM (``core.spmm`` and the plain version behind the CUDA
kernel) against ``repro.core.spgemm.spmm`` and scipy.

Same host operands in one process, made with numpy from a seed: R-MAT ER
and G500 at scales 5 and 8, k in {1, 8, 32, 100}, float32 and bfloat16 X,
padded and truncated CSRs, empty rows, and the ladder of
``_spmm_ladder.py`` (a row at every length-class edge of the card's
kernel, to 20,000 nonzeros).  The classifying kernel's plain version
(``ref.row_classes_plain``) is held against a numpy count.  Values are
bitwise equal on dyadic inputs (every product and sum exact) and within
one ulp per accumulated product otherwise.  The reference's Pallas kernel cannot run on the
installed jax (no ``pl.load``), so the port is held against its jnp
``spmm``, scipy and an in-order numpy loop.  On CPU tensors the CUDA kernel
is never launched.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.data import rmat as trmat  # noqa: E402
from repro_torch.kernels.spmm import kernel as K  # noqa: E402
from repro_torch.kernels.spmm import ops  # noqa: E402
from repro_torch.kernels.spmm import ref  # noqa: E402
from _fuzz import VALS  # noqa: E402
from _spmm_ladder import LADDER_CLASSES, ladder  # noqa: E402

sp = pytest.importorskip("scipy.sparse")

KS = (1, 8, 32, 100)
INPUTS = [(p, s) for p in ("ER", "G500") for s in (5, 8)]


def to_port(a):
    return T.CSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                            np.asarray(a.data), int(a.nnz), a.shape,
                            a.sorted_cols, device="cpu")


def operand(preset, scale, values, seed=11):
    """R-MAT ``A`` (edge factor 8) with dyadic or uniform [0.5, 1.5)
    values, and a matching X sampler."""
    a = jrmat.rmat_csr(scale, 8, preset, seed=seed)
    nnz = int(a.nnz)
    rng = np.random.default_rng(seed + 1)
    d = np.zeros(a.cap, np.float32)
    d[:nnz] = rng.choice(VALS, nnz) if values == "dyadic" else \
        rng.uniform(0.5, 1.5, nnz)
    return J.CSR(a.indptr, a.indices, jnp.asarray(d), a.nnz, a.shape)


def x_of(n, k, values, seed=13):
    rng = np.random.default_rng(seed)
    x = rng.choice(VALS, (n, k)) if values == "dyadic" else \
        rng.uniform(0.5, 1.5, (n, k))
    return x.astype(np.float32)


def scipy_of(a):
    ip, idx, dat = (np.asarray(a.indptr), np.asarray(a.indices),
                    np.asarray(a.data))
    nnz = int(a.nnz)
    return sp.csr_matrix((dat[:nnz].astype(np.float64), idx[:nnz], ip),
                         shape=a.shape)


def within_ulps(y, want, counts):
    """``|y - want| <= counts * ulp(want)`` row-wise, float32."""
    ulp = np.spacing(np.abs(want).astype(np.float32))
    return np.all(np.abs(y.astype(np.float64) - want)
                  <= counts[:, None] * ulp)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("values", ("dyadic", "uniform"))
@pytest.mark.parametrize("case", INPUTS, ids=lambda c: f"{c[0]}{c[1]}")
def test_spmm_matches_reference_and_scipy(case, values, k):
    a = operand(*case, values)
    x = x_of(a.shape[1], k, values)
    yj = np.asarray(J.spmm(a, jnp.asarray(x)))
    ops.reset_kernel_calls()
    yt = T.spmm(to_port(a), torch.from_numpy(x))
    assert ops.kernel_call_counts() == {"spmm": 0, "classify": 0,
                                        "plain": 1}
    assert yt.dtype == torch.float32 and tuple(yt.shape) == yj.shape
    yt = yt.numpy()
    y64 = scipy_of(a) @ x.astype(np.float64)
    if values == "dyadic":
        assert np.array_equal(yt, yj)
        assert np.array_equal(yt, y64.astype(np.float32))
        return
    counts = np.diff(np.asarray(a.indptr))
    assert within_ulps(yt, yj.astype(np.float64), counts)
    assert within_ulps(yt, y64, counts)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", INPUTS, ids=lambda c: f"{c[0]}{c[1]}")
def test_bf16_x_is_stored_in_its_dtype(case, k):
    """bfloat16 X: float32 accumulation, one rounding at the store.  The
    reference promotes to float32; on dyadic values its sum is exact, so
    rounding it to bfloat16 gives the port's values bitwise."""
    a = operand(*case, "dyadic")
    x = torch.from_numpy(x_of(a.shape[1], k, "dyadic")).to(torch.bfloat16)
    yt = T.spmm(to_port(a), x)
    assert yt.dtype == torch.bfloat16
    yj = np.asarray(J.spmm(a, jnp.asarray(x.float().numpy(), jnp.bfloat16)))
    assert yj.dtype == np.float32
    assert torch.equal(yt, torch.from_numpy(np.array(yj)).to(torch.bfloat16))
    y64 = scipy_of(a) @ x.double().numpy()
    assert torch.equal(yt, torch.from_numpy(y64.astype(np.float32))
                       .to(torch.bfloat16))


def in_order(indptr, indices, data, x, live):
    """The rounding contract spelled out: per row, from 0, ``acc = acc +
    a * x`` in float32 over the row's live slots in order."""
    m = len(indptr) - 1
    y = np.zeros((m, x.shape[1]), np.float32)
    for i in range(m):
        acc = np.zeros(x.shape[1], np.float32)
        for j in range(indptr[i], min(indptr[i + 1], live)):
            acc = acc + np.float32(data[j]) * x[indices[j]]
        y[i] = acc
    return y


@pytest.mark.parametrize("k", (1, 33, 100))
def test_plain_version_rounds_in_row_order(k):
    """Signed values, so the order of the adds matters: the plain version
    the card holds the kernel against adds each row in slot order, as the
    TPU kernel does."""
    a = jrmat.rmat_csr(6, 8, "G500", seed=4)
    nnz = int(a.nnz)
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, a.cap).astype(np.float32)
    x = rng.uniform(-1, 1, (a.shape[1], k)).astype(np.float32)
    ip, idx = np.array(a.indptr), np.array(a.indices)
    y = ref.spmm_plain(torch.from_numpy(ip), torch.from_numpy(idx),
                       torch.from_numpy(data), torch.from_numpy(x),
                       torch.tensor(nnz, dtype=torch.int32))
    assert np.array_equal(y.numpy(), in_order(ip, idx, data, x, nnz))


def test_padded_csr_and_empty_rows():
    """Slots past nnz hold garbage (columns and values): they count as 0,
    as the reference's valid mask makes them.  Empty rows give 0 rows."""
    d = np.zeros((12, 9), np.float32)
    rng = np.random.default_rng(8)
    d[[0, 3, 4, 10]] = rng.choice(VALS, (4, 9)) * (rng.random((4, 9)) < 0.6)
    r, c = np.nonzero(d)
    a = J.CSR.from_numpy_coo(r, c, d[r, c], d.shape, cap=len(r) + 7)
    nnz = int(a.nnz)
    idx = np.asarray(a.indices).copy()
    dat = np.asarray(a.data).copy()
    idx[nnz:] = rng.integers(0, 9, 7)
    dat[nnz:] = 3.0
    a = J.CSR(a.indptr, jnp.asarray(idx), jnp.asarray(dat), a.nnz, a.shape)
    x = x_of(9, 8, "dyadic")
    yt = T.spmm(to_port(a), torch.from_numpy(x)).numpy()
    assert np.array_equal(yt, np.asarray(J.spmm(a, jnp.asarray(x))))
    assert np.array_equal(yt, d @ x)
    assert not yt[[1, 2, 5, 6, 7, 8, 9, 11]].any()
    empty = J.CSR.from_numpy_coo([], [], np.zeros(0, np.float32), (5, 9),
                                 cap=4)
    ye = T.spmm(to_port(empty), torch.from_numpy(x))
    assert tuple(ye.shape) == (5, 8) and not ye.any()


def test_truncated_csr_uses_every_slot():
    """A CSR whose row pointer counts more entries than its capacity (the
    reference's ``from_dense`` with a small ``cap``): every stored slot is
    live and the rows past the capacity are cut, in both packages."""
    d = np.random.default_rng(9).choice(VALS, (6, 7)).astype(np.float32)
    a = J.CSR.from_dense(jnp.asarray(d), cap=20)
    assert int(a.nnz) == 42 and a.cap == 20
    x = x_of(7, 4, "dyadic")
    yt = T.spmm(to_port(a), torch.from_numpy(x)).numpy()
    assert np.array_equal(yt, np.asarray(J.spmm(a, jnp.asarray(x))))


def test_cpu_never_launches_and_rejects_bad_operands():
    a = to_port(operand("ER", 5, "dyadic"))
    x = torch.from_numpy(x_of(a.shape[1], 8, "dyadic"))
    ops.reset_kernel_calls()
    ops.spmm_kernel(a, x)
    T.spmm(a, x.to(torch.float16))
    assert K.KERNEL_CALLS == {"spmm": 0, "classify": 0, "plain": 2}
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        T.spmm(a, x.double())
    with pytest.raises(ValueError):              # wrong number of rows
        T.spmm(a, x[1:])
    with pytest.raises(ValueError):              # not 2-D
        T.spmm(a, x[:, 0])
    assert K.KERNEL_CALLS["spmm"] == 0


# ---- row classes (the card's classifying kernel) and the class ladder ----


def numpy_classes(indptr, nnz, cap):
    """Each row's live length and class, counted with numpy: class 0 up to
    32 live nonzeros, then one class a doubling, the last past 8,192."""
    ip = np.asarray(indptr, np.int64)
    live = min(int(nnz), cap)
    length = np.maximum(np.minimum(ip[1:], live) - ip[:-1], 0)
    cls = np.zeros(length.shape[0], np.int64)
    for c, lo in enumerate((32, 64, 128, 256, 512, 1024, 2048, 4096, 8192),
                           start=1):
        cls[length > lo] = c
    return length, cls


def assert_classes(counts, rows, cls):
    want = np.bincount(cls, minlength=ref.N_CLASSES)
    assert counts.dtype == torch.int32
    assert counts.tolist() == want.tolist()
    for c in range(ref.N_CLASSES):
        assert rows[c].dtype == torch.int32
        assert rows[c].tolist() == np.flatnonzero(cls == c).tolist()


@pytest.mark.parametrize("preset", ("ER", "G500"))
@pytest.mark.parametrize("symmetric", (False, True), ids=("a", "sym"))
def test_row_classes_plain_matches_numpy(preset, symmetric):
    """R-MAT at scale 8 (and its symmetrized graph): the plain classifier
    against a numpy count; every row lands in exactly one class."""
    a = trmat.rmat_csr(8, 16, preset, seed=3, device="cpu")
    if symmetric:
        a = trmat.symmetrize(a, cap=2 * a.cap, device="cpu")
    counts, rows = K.row_classes(a.indptr, a.nnz, a.cap)
    _, cls = numpy_classes(a.indptr.numpy(), int(a.nnz), a.cap)
    assert_classes(counts, rows, cls)
    assert int(counts.sum()) == a.n_rows
    rooms = ref.class_rooms(a.n_rows, a.cap)
    assert all(int(n) <= r for n, r in zip(counts, rooms))


def test_row_classes_plain_ladder():
    """A row at every class edge (0, 1, 32, 33, ..., 255, 256, 257, ...,
    8,193, 20,000 nonzeros), short rows between them: each rung in its
    class."""
    indptr, indices, data, shape, rung_rows = ladder("dyadic")
    ip = torch.from_numpy(indptr.astype(np.int32))
    counts, rows = ref.row_classes_plain(ip, torch.tensor(len(indices)),
                                         len(indices))
    _, cls = numpy_classes(indptr, len(indices), len(indices))
    assert cls[rung_rows].tolist() == list(LADDER_CLASSES)
    assert_classes(counts, rows, cls)
    assert all(int(counts[c]) > 0 for c in range(ref.N_CLASSES))
    rooms = ref.class_rooms(shape[0], len(indices))
    assert all(int(n) <= r for n, r in zip(counts, rooms))


def test_padded_csr_classifies_by_live_length():
    """A row pointer that counts 5,000 slots in row 1 but a live length
    that cuts it to 100: row 1 is a warp's row, row 2 (all past nnz) is
    empty, row 0 (300) a block's; the garbage past nnz counts as 0 in the
    product too."""
    rng = np.random.default_rng(12)
    indptr = np.array([0, 300, 5300, 5400], np.int32)
    nnz, cap = 400, 5400
    idx = rng.integers(0, 50, cap).astype(np.int32)
    dat = rng.choice(VALS, cap).astype(np.float32)
    counts, rows = ref.row_classes_plain(torch.from_numpy(indptr),
                                         torch.tensor(nnz), cap)
    length, cls = numpy_classes(indptr, nnz, cap)
    assert length.tolist() == [300, 100, 0]
    assert_classes(counts, rows, cls)
    assert counts.tolist() == [1, 0, 1, 0, 1, 0, 0, 0, 0, 0]
    a = J.CSR(jnp.asarray(indptr), jnp.asarray(idx), jnp.asarray(dat),
              jnp.asarray(nnz, jnp.int32), (3, 50), False)
    x = x_of(50, 8, "dyadic")
    ops.reset_kernel_calls()
    yt = T.spmm(to_port(a), torch.from_numpy(x)).numpy()
    assert ops.kernel_call_counts() == {"spmm": 0, "classify": 0,
                                        "plain": 1}
    assert np.array_equal(yt, np.asarray(J.spmm(a, jnp.asarray(x))))
    live = np.zeros((3, 50), np.float64)
    for i in range(3):
        for j in range(indptr[i], min(indptr[i + 1], nnz)):
            live[i, idx[j]] += dat[j]
    assert np.array_equal(yt, (live @ x).astype(np.float32))


@pytest.mark.parametrize("k", (1, 64, 100))
@pytest.mark.parametrize("values", ("dyadic", "uniform"))
def test_ladder_spmm_matches_reference_and_scipy(values, k):
    """The class ladder (rows to 20,000 nonzeros, repeated columns) on CPU
    tensors: the plain version runs, nothing launches, and the values
    match the reference's ``spmm`` and scipy (bitwise on dyadic values,
    within one ulp per accumulated product otherwise)."""
    indptr, indices, data, shape, _ = ladder(values, seed=k)
    a = J.CSR(jnp.asarray(indptr.astype(np.int32)), jnp.asarray(indices),
              jnp.asarray(data), jnp.asarray(len(indices), jnp.int32),
              shape, False)
    x = x_of(shape[1], k, values, seed=k)
    ops.reset_kernel_calls()
    yt = T.spmm(to_port(a), torch.from_numpy(x))
    assert ops.kernel_call_counts() == {"spmm": 0, "classify": 0,
                                        "plain": 1}
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (shape[0], k)
    yt = yt.numpy()
    yj = np.asarray(J.spmm(a, jnp.asarray(x)))
    y64 = scipy_of(a) @ x.astype(np.float64)
    if values == "dyadic":
        assert np.array_equal(yt, yj)
        assert np.array_equal(yt, y64.astype(np.float32))
        return
    counts = np.diff(indptr)
    assert within_ulps(yt, yj.astype(np.float64), counts)
    assert within_ulps(yt, y64, counts)


@pytest.mark.parametrize(("k", "itemsize", "ptr", "vw", "bulk"), [
    (64, 4, 0, 2, True),      # float32 k 64: 8-byte lanes, bulk copies
    (64, 4, 4, 1, False),     # X at a 4-byte offset: 4-byte lanes, registers
    (100, 4, 0, 4, True),     # 400-byte rows: 16-byte lanes, bulk
    (100, 2, 0, 4, False),    # bf16 k 100: 200-byte rows, registers
    (300, 2, 0, 4, False),    # bf16 k 300: 600-byte rows, registers
    (300, 4, 0, 4, True),
    (8, 4, 0, 1, True),
    (1, 4, 0, 1, False),      # k 1: registers, any dtype
    (1, 2, 0, 1, False),
    (64, 2, 2, 1, False),     # bf16 X at a 2-byte offset
])
def test_launch_choices(k, itemsize, ptr, vw, bulk):
    """The wrapper's choices from the shape before a launch: the short
    rows' load width and the long rows' copy path (bulk copies or
    registers)."""
    assert K.vector_width(k, itemsize, ptr) == vw
    assert K.bulk_copies(k, itemsize, ptr) is bulk
