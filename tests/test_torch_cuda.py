"""The hand-written CUDA hash kernels against their plain versions.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one:
the kernels have no CPU mode.  The module imports neither jax nor the
reference package, so it runs on a machine with only PyTorch and CUDA::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py

(``--noconftest`` because the suite's ``conftest.py`` imports jax.)
Row counts and per-row column sets must be bitwise equal; values bitwise
on dyadic inputs and within one ulp per accumulated product otherwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CSR
from repro_torch.core.formats import prefix_sum
from repro_torch.data import rmat
from repro_torch.kernels.spgemm_hash import kernel as K
from repro_torch.kernels.spgemm_hash import ops, ref

DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
CASES = [("ER", 9, 8, True), ("G500", 10, 16, False), ("G500", 12, 16, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def operand(preset, scale, ef, dyadic, device):
    a = rmat.rmat_csr(scale, ef, preset, seed=5, device=device)
    if dyadic:
        rng = np.random.default_rng(6)
        d = np.zeros(a.cap, np.float32)
        d[:int(a.nnz)] = rng.choice(DYADIC, size=int(a.nnz))
        a = CSR(a.indptr, a.indices, torch.from_numpy(d).to(device), a.nnz,
                a.shape)
    return a


def check_numeric(a, indptr_c, cols, vals, pc, pv, dyadic):
    nnz = int(indptr_c[-1])
    s = CSR(indptr_c, cols, vals, indptr_c[-1], a.shape, False).sort_rows()
    assert torch.equal(s.indices, pc)
    assert bool((cols[nnz:] == 0).all())
    if dyadic:
        assert torch.equal(s.data, pv)
        return
    k = ref.products_per_entry(a.indptr, a.indptr, indptr_c, a.indices,
                               a.indices, pc.shape[0])
    ulp = torch.nextafter(pv.abs(), torch.full_like(pv, float("inf"))) \
        - pv.abs()
    assert bool(((s.data - pv).abs() <= k * ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_kernels_match_plain_versions(cuda, case, vector):
    a = operand(*case, cuda)
    off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
    args = (off, tsz, a.indptr, a.indptr, a.indices, a.data, a.indices,
            a.data)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    rows = K.symbolic_call(*args, table_size=table, vector=vector,
                           errors=errors)
    assert torch.equal(rows, ref.symbolic_plain(*args, table_size=table,
                                                vector=vector))
    indptr_c = prefix_sum(rows).to(torch.int32)
    cap = int(indptr_c[-1]) + 5
    nargs = (off, tsz, a.indptr, a.indptr, indptr_c, a.indices, a.data,
             a.indices, a.data)
    cols, vals = K.numeric_call(*nargs, cap_c=cap, table_size=table,
                                vector=vector, errors=errors)
    torch.cuda.synchronize()
    assert int(errors) == 0
    pc, pv = ref.numeric_plain(*nargs, cap_c=cap, table_size=table,
                               vector=vector)
    check_numeric(a, indptr_c, cols, vals, pc, pv, case[3])


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ("hash", "hash_vector"))
def test_planned_execute_launches_only_the_kernel(cuda, algorithm):
    from repro_torch.core import plan_spgemm
    a = operand("G500", 10, 16, True, cuda)
    plan = plan_spgemm(a, a, algorithm=algorithm, cache=False)
    ops.reset_kernel_calls()
    c = plan.execute(a, a)
    torch.cuda.synchronize()
    key = "numeric_vector" if algorithm == "hash_vector" else "numeric"
    counts = ops.kernel_call_counts()
    assert counts.pop(key) == 1 and set(counts.values()) == {0}
    assert torch.equal(c.indptr, plan.indptr_c)


@pytest.mark.gpu
def test_wrapper_rejects_bad_operands(cuda):
    a = operand("ER", 8, 4, True, cuda)
    off, tsz, table = ops.hash_schedule(a, a, n_bins=8)
    with pytest.raises(ValueError):
        K.symbolic_call(off, tsz, a.indptr, a.indptr, a.indices,
                        a.data.double(), a.indices, a.data,
                        table_size=table, vector=False)
    with pytest.raises(ValueError):              # bins past the last row
        K.symbolic_call(off + 1, tsz, a.indptr, a.indptr, a.indices, a.data,
                        a.indices, a.data, table_size=table, vector=False)
    with pytest.raises(ValueError):              # not a power of two
        K.symbolic_call(off, tsz * 3, a.indptr, a.indptr, a.indices, a.data,
                        a.indices, a.data, table_size=3 * table,
                        vector=False)


@pytest.mark.gpu
@pytest.mark.parametrize("vector", (False, True))
def test_table_too_small_raises(cuda, vector):
    """A table of CHUNK slots for 2 * CHUNK distinct columns: with no
    ``errors`` tensor from the caller, each wrapper and the planned ops
    entry raise instead of returning a partial row."""
    d = 2 * K.CHUNK
    a = CSR.from_numpy_coo([0], [0], np.ones(1, np.float32), (1, 1),
                           device=cuda)
    b = CSR.from_numpy_coo(np.zeros(d, np.int64), np.arange(d),
                           DYADIC[np.arange(d) % 4], (1, d), device=cuda)
    off = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    tsz = torch.tensor([K.CHUNK], dtype=torch.int32, device=cuda)
    indptr_c = torch.tensor([0, d], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="full-table"):
        K.symbolic_call(off, tsz, a.indptr, b.indptr, a.indices, a.data,
                        b.indices, b.data, table_size=K.CHUNK, vector=vector)
    with pytest.raises(RuntimeError, match="full-table"):
        K.numeric_call(off, tsz, a.indptr, b.indptr, indptr_c, a.indices,
                       a.data, b.indices, b.data, cap_c=d,
                       table_size=K.CHUNK, vector=vector)
    with pytest.raises(RuntimeError, match="full-table"):
        ops.spgemm_hash(a, b, d, vector=vector, table_size=K.CHUNK,
                        schedule=(off, tsz), indptr_c=indptr_c)
