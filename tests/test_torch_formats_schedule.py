"""The port's CSR, semirings, schedule and R-MAT data against ``repro``.

Both packages get the same host (numpy) operands in one process; every
array the port computes must be bitwise equal to the reference's
(``tests/_fuzz.py`` dyadic values and the generators' uniform values).
Also pinned here: the device rule (no device and no CUDA raises) and the
import boundary (no ``jax`` and no ``repro`` under ``src/repro_torch`` or
in ``chip_smoke.py``).
"""
import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402

import repro.core.schedule as jsched  # noqa: E402
from repro.core import CSR as JCSR  # noqa: E402
from repro.data import rmat as jrmat  # noqa: E402
import repro_torch.core.schedule as tsched  # noqa: E402
from repro_torch.core import CSR as TCSR  # noqa: E402
from repro_torch.core import semiring as tsr  # noqa: E402
from repro_torch.core.formats import resolve_device  # noqa: E402
from repro_torch.data import rmat as trmat  # noqa: E402
from _fuzz import VALS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def to_port(a: JCSR) -> TCSR:
    return TCSR.from_numpy(np.asarray(a.indptr), np.asarray(a.indices),
                           np.asarray(a.data), int(a.nnz), a.shape,
                           a.sorted_cols, device="cpu")


def same(x, y):
    """Bitwise equality of a reference array and a port tensor."""
    x = np.asarray(x)
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return x.shape == y.shape and np.array_equal(x, y)


def fixture(preset, scale, ef, dyadic, seed=0):
    a = jrmat.rmat_csr(scale, ef, preset, seed=seed)
    if dyadic:
        rng = np.random.default_rng(seed + 7)
        d = np.zeros(a.cap, np.float32)
        d[:int(a.nnz)] = rng.choice(VALS, size=int(a.nnz))
        a = JCSR(a.indptr, a.indices, jnp.asarray(d), a.nnz, a.shape)
    return a


CASES = [("ER", 4, 4), ("G500", 5, 8), ("G500", 7, 16)]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,scale,ef", CASES)
def test_rmat_port_matches_reference(preset, scale, ef):
    re, ce = jrmat.rmat_edges(scale, ef, preset, seed=3)
    rt, ct = trmat.rmat_edges(scale, ef, preset, seed=3)
    assert np.array_equal(re, rt) and np.array_equal(ce, ct)
    a = jrmat.rmat_csr(scale, ef, preset, seed=3)
    t = trmat.rmat_csr(scale, ef, preset, seed=3, device="cpu")
    for f in ("indptr", "indices", "data", "nnz"):
        assert same(getattr(a, f), getattr(t, f)), f
    assert t.shape == a.shape and t.sorted_cols
    er = trmat.er_csr(scale, ef, seed=3, device="cpu")
    g5 = trmat.g500_csr(scale, ef, seed=3, device="cpu")
    assert same(jrmat.er_csr(scale, ef, seed=3).indices, er.indices)
    assert same(jrmat.g500_csr(scale, ef, seed=3).indices, g5.indices)


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap_extra", (0, 5))
def test_from_numpy_coo_sums_duplicates_like_reference(cap_extra):
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 9, size=60)
    cols = rng.integers(0, 7, size=60)
    vals = rng.uniform(0.5, 1.5, size=60).astype(np.float32)
    cap = 70 + cap_extra
    a = JCSR.from_numpy_coo(rows, cols, vals, (9, 7), cap=cap)
    t = TCSR.from_numpy_coo(rows, cols, vals, (9, 7), cap=cap, device="cpu")
    for f in ("indptr", "indices", "data", "nnz"):
        assert same(getattr(a, f), getattr(t, f)), f
    back = t.to_numpy()
    assert np.array_equal(back[0], np.asarray(a.indptr))
    assert back[3] == int(a.nnz) and back[4] == (9, 7) and back[5]


@pytest.mark.parametrize("preset,scale,ef", CASES)
def test_csr_views_match_reference(preset, scale, ef):
    a = fixture(preset, scale, ef, dyadic=True)
    t = to_port(a)
    assert same(a.valid_mask(), t.valid_mask())
    assert same(a.row_ids(), t.row_ids())
    assert same(a.row_nnz(), t.row_nnz())
    assert same(a.to_dense(), t.to_dense())
    rng = np.random.default_rng(2)
    r = rng.integers(0, a.n_rows, size=50).astype(np.int32)
    c = rng.integers(0, a.n_cols, size=50).astype(np.int32)
    assert same(a.contains(jnp.asarray(r), jnp.asarray(c)),
                t.contains(torch.from_numpy(r), torch.from_numpy(c)))


def test_from_dense_matches_reference():
    rng = np.random.default_rng(4)
    d = np.where(rng.random((11, 13)) < 0.3, rng.choice(VALS, (11, 13)),
                 0).astype(np.float32)
    for cap in (None, 100):
        a = JCSR.from_dense(jnp.asarray(d), cap=cap)
        t = TCSR.from_dense(torch.from_numpy(d), cap=cap)
        for f in ("indptr", "indices", "data", "nnz"):
            assert same(getattr(a, f), getattr(t, f)), (cap, f)


@pytest.mark.parametrize("seed", (0, 1))
def test_sort_rows_matches_reference(seed):
    a = fixture("G500", 6, 8, dyadic=False, seed=seed)
    nnz = int(a.nnz)
    rng = np.random.default_rng(seed)
    ip = np.asarray(a.indptr)
    perm = np.arange(a.cap)
    for i in range(a.n_rows):        # scramble columns within every row
        perm[ip[i]:ip[i + 1]] = rng.permutation(np.arange(ip[i], ip[i + 1]))
    idx = np.asarray(a.indices)[perm]
    dat = np.asarray(a.data)[perm]
    js = JCSR(a.indptr, jnp.asarray(idx), jnp.asarray(dat), a.nnz, a.shape,
              sorted_cols=False).sort_rows()
    ts = TCSR.from_numpy(ip, idx, dat, nnz, a.shape, False,
                         device="cpu").sort_rows()
    assert ts.sorted_cols
    for f in ("indices", "data"):
        assert same(getattr(js, f), getattr(ts, f)), f


# ---------------------------------------------------------------------------
# semirings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("plus_times", "boolean", "any_pair",
                                  "min_plus", "plus_first"))
def test_semiring_ops_match_reference(name):
    from repro.core.semiring import resolve_semiring as jres
    js, ts = jres(name), tsr.resolve_semiring(name)
    x = np.array([0.5, -1.0, 2.0, 3.5], np.float32)
    y = np.array([1.5, 2.0, -0.5, 0.0], np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert ts.name == js.name and ts.zero == js.zero
    assert same(js.add(jnp.asarray(x), jnp.asarray(y)), ts.add(tx, ty))
    assert same(js.mul(jnp.asarray(x), jnp.asarray(y)), ts.mul(tx, ty))
    seg = np.array([0, 2, 0, 2], np.int32)
    ref = js.segment_reduce(jnp.asarray(x), jnp.asarray(seg),
                            num_segments=3)
    got = tsr.segment_reduce(ts, tx, torch.from_numpy(seg), 3)
    live = np.array([True, False, True])     # empty segments are masked
    assert np.array_equal(np.asarray(ref)[live], got.numpy()[live])
    with pytest.raises(ValueError):
        tsr.resolve_semiring("no_such_semiring")


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bins", (1, 8))
@pytest.mark.parametrize("preset,scale,ef", CASES)
def test_schedule_arrays_bitwise(preset, scale, ef, n_bins):
    a = fixture(preset, scale, ef, dyadic=False)
    b = fixture("ER", scale, ef, dyadic=False, seed=5)
    ta, tb = to_port(a), to_port(b)
    jf, jo, jt = jsched.make_schedule_eager(a, b, n_bins)
    tf, to, tt = tsched.make_schedule_eager(ta, tb, n_bins)
    assert same(jf, tf) and same(jo, to) and same(jt, tt)
    assert same(jsched.flops_per_row(a, b), tsched.flops_per_row(ta, tb))
    assert same(jsched.rows_to_bins(jf, n_bins), tsched.rows_to_bins(tf, n_bins))
    assert same(jsched.bin_row_assignment(jo, a.n_rows),
                tsched.bin_row_assignment(to, a.n_rows))
    assert np.array_equal(np.asarray(jsched.bin_flop(jf, jo)),
                          tsched.bin_flop(tf, to).numpy())
    assert same(jsched.max_flop_per_bin_row(jf, jo),
                tsched.max_flop_per_bin_row(tf, to))
    table_size = max(jsched.lowest_p2(min(int(jf.max()), b.n_cols) + 1), 8)
    assert same(jsched.bin_table_sizes(jt, b.n_cols, table_size, floor=8),
                tsched.bin_table_sizes(tt, b.n_cols, table_size, floor=8))
    mask = fixture("ER", scale, ef, dyadic=True, seed=9)
    for comp in (False, True):
        assert same(jsched.masked_row_bound(jf, mask, comp),
                    tsched.masked_row_bound(tf, to_port(mask), comp))


def test_lowest_p2_and_lowbnd_match_reference():
    xs = np.array([-3, 0, 1, 2, 3, 4, 5, 7, 8, 9, 1000, 1 << 20, (1 << 20) + 1,
                   (1 << 24) - 1], np.int32)
    assert same(jsched.lowest_p2_arr(jnp.asarray(xs)),
                tsched.lowest_p2_arr(torch.from_numpy(xs)))
    for x in (0, 1, 2, 3, 1023, 1024, 1025):
        assert tsched.lowest_p2(x) == jsched.lowest_p2(x)
    vec = np.array([0, 2, 2, 5, 9], np.int32)
    val = np.array([0, 1, 2, 3, 9, 10], np.int32)
    assert same(jsched.lowbnd(jnp.asarray(vec), jnp.asarray(val)),
                tsched.lowbnd(torch.from_numpy(vec), torch.from_numpy(val)))


def test_int64_prefix_sums_and_expansion_guard():
    """Flop prefix sums are int64: a total far past 2^31 still bins (the
    reference's int32 guard would raise without x64), while the int32
    expansion positions of ``symbolic`` are guarded."""
    flop = torch.full((8,), 2**30, dtype=torch.int32)
    off = tsched.rows_to_bins(flop, 8)
    assert off.tolist() == list(range(9))
    assert int(tsched.bin_flop(flop, off).sum()) == 8 * 2**30
    with pytest.raises(OverflowError):
        tsched.guard_i32_flop(flop)
    tsched.guard_i32_flop(flop[:1])


# ---------------------------------------------------------------------------
# device rule and import boundary
# ---------------------------------------------------------------------------

def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        trmat.rmat_csr(4, 4, "ER")
    with pytest.raises(RuntimeError):
        TCSR.from_numpy_coo([0], [0], np.ones(1, np.float32), (2, 2))
    assert resolve_device("cpu") == torch.device("cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
