"""R-MAT recursive matrix generator (Chakrabarti et al.; paper section 5.1).

Port of ``repro.data.rmat`` (its own copy: this package imports nothing of
the JAX one).  Two presets, as the paper:
  * ER   -- a=b=c=d=0.25 (Erdos-Renyi uniform)
  * G500 -- a=0.57, b=c=0.19, d=0.05 (Graph500 power-law / skewed)

"A scale n matrix represents 2^n-by-2^n"; ``edge_factor`` = nnz / n.
Generation is host numpy from ``default_rng(seed)``, so the same seed gives
the reference's matrix bit for bit; the CSR goes to ``device=``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import CSR, csr_transpose

PRESETS = {
    "ER":   (0.25, 0.25, 0.25, 0.25),
    "G500": (0.57, 0.19, 0.19, 0.05),
}


def rmat_edges(scale: int, edge_factor: int, preset: str = "G500",
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Generate ``2^scale * edge_factor`` directed edges (duplicates kept)."""
    a, b, c, d = PRESETS[preset]
    n_edges = (1 << scale) * edge_factor
    rng = np.random.default_rng(seed)
    rows = np.zeros(n_edges, np.int64)
    cols = np.zeros(n_edges, np.int64)
    # vectorized bit-by-bit recursive descent
    for _ in range(scale):
        r = rng.random(n_edges)
        row_bit = (r >= a + b).astype(np.int64)
        # conditional col-bit probability given the row bit
        p_col1 = np.where(row_bit == 0, b / (a + b), d / (c + d))
        col_bit = (rng.random(n_edges) < p_col1).astype(np.int64)
        rows = (rows << 1) | row_bit
        cols = (cols << 1) | col_bit
    return rows, cols


def rmat_csr(scale: int, edge_factor: int, preset: str = "G500",
             seed: int = 0, cap: int | None = None, dtype=np.float32,
             device=None) -> CSR:
    """Paper-style input: R-MAT pattern, values uniform in [0.5, 1.5),
    duplicates summed."""
    rows, cols = rmat_edges(scale, edge_factor, preset, seed)
    n = 1 << scale
    rng = np.random.default_rng(seed + 1)
    vals = rng.uniform(0.5, 1.5, size=rows.shape[0]).astype(dtype)
    return CSR.from_numpy_coo(rows, cols, vals, (n, n), cap=cap,
                              device=device)


def er_csr(scale: int, edge_factor: int, seed: int = 0,
           cap: int | None = None, device=None) -> CSR:
    return rmat_csr(scale, edge_factor, "ER", seed, cap, device=device)


def g500_csr(scale: int, edge_factor: int, seed: int = 0,
             cap: int | None = None, device=None) -> CSR:
    return rmat_csr(scale, edge_factor, "G500", seed, cap, device=device)


def tall_skinny_from(a_rows: np.ndarray, a_cols: np.ndarray, n: int,
                     k_scale: int, seed: int = 0, cap: int | None = None,
                     device=None) -> CSR:
    """Paper section 5.5: the tall-skinny B is built by randomly selecting
    2^k_scale columns of the graph itself (multi-source BFS frontiers)."""
    rng = np.random.default_rng(seed)
    k = 1 << k_scale
    chosen = rng.choice(n, size=k, replace=False)
    col_map = np.full(n, -1, np.int64)
    col_map[chosen] = np.arange(k)
    keep = col_map[a_cols] >= 0
    rows, cols = a_rows[keep], col_map[a_cols[keep]]
    vals = np.ones(rows.shape[0], np.float32)
    return CSR.from_numpy_coo(rows, cols, vals, (n, k), cap=cap,
                              device=device)



def aggregation_csr(n: int, coarse: int, seed: int = 0, device=None):
    """AMG-style aggregation pair for Galerkin triple products R.A.P.

    ``P`` is ``(n, coarse)`` with one unit entry per row (each fine vertex
    assigned to a random aggregate, the reference's draw) and ``R = P^T``;
    returns ``(r, p)`` on ``device``, bitwise the reference's.
    """
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, coarse, size=n)
    p = CSR.from_numpy_coo(np.arange(n), cols, np.ones(n, np.float32),
                           (n, coarse), device=device)
    return csr_transpose(p), p

# ----------------------------------------------------------------------------
# Graph preprocessing (sections 5.5-5.6).  The reference builds both through
# a dense matrix (``to_dense()``: 17 GB at n = 65,536); here they work on the
# live entries and give the same CSR arrays bit for bit.
# ----------------------------------------------------------------------------

def _dense_entries(a: CSR):
    """The nonzero pattern of the reference's ``a.to_dense()``, sparse:
    distinct row-major keys ``row * n_cols + col`` (sorted) and their
    values, duplicates summed in slot order in ``a``'s dtype."""
    indptr, indices, data, nnz, (m, n), _ = a.to_numpy()
    slot = np.arange(min(nnz, indices.shape[0]))
    rows = np.clip(np.searchsorted(indptr, slot, side="right") - 1, 0,
                   max(m - 1, 0))
    key = rows.astype(np.int64) * n + indices[slot]
    uniq, inv = np.unique(key, return_inverse=True)
    vals = np.zeros(uniq.shape[0], data.dtype)
    np.add.at(vals, inv, data[slot])
    return uniq, vals


def _from_sorted_keys(key: np.ndarray, vals: np.ndarray, shape, cap,
                      device) -> CSR:
    """The reference's ``CSR.from_dense(d, cap)`` for the dense ``d`` that
    holds the nonzero ``vals`` at the sorted row-major ``key``: the arrays
    hold ``min(cap, m * n)`` slots, the entries past ``cap`` are cut, and
    ``nnz`` and the row pointer still count them."""
    m, n = shape
    cap = m * n if cap is None else min(cap, m * n)
    live = min(key.shape[0], cap)
    indices = np.zeros(cap, np.int32)
    data = np.zeros(cap, vals.dtype)
    indices[:live] = key[:live] % n
    data[:live] = vals[:live]
    indptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(key // n, minlength=m), out=indptr[1:])
    return CSR.from_numpy(indptr, indices, data, key.shape[0], shape, True,
                          device=device)


def symmetrize(a: CSR, cap: int | None = None, device=None) -> CSR:
    """Undirected simple graph from a directed pattern: A|A^T, no diagonal.

    The entries where ``A + A^T`` (duplicates summed) is positive, off the
    diagonal, as float32 ones; ``cap`` defaults to ``n * n`` as in the
    reference (pass a bound such as ``2 * a.cap`` at scale).
    """
    m, n = a.shape
    if m != n:
        raise ValueError(f"symmetrize needs a square matrix, got {a.shape}")
    key, vals = _dense_entries(a)
    tkey = (key % n) * n + key // n
    both = np.unique(np.concatenate([key, tkey]))
    s = np.zeros(both.shape[0], vals.dtype)
    s[np.searchsorted(both, key)] += vals
    s[np.searchsorted(both, tkey)] += vals
    keep = (s > 0) & (both // n != both % n)
    both = both[keep]
    return _from_sorted_keys(both, np.ones(both.shape[0], np.float32),
                             (n, n), cap, device)


def triangular_split(a: CSR, return_adjacency: bool = False, device=None):
    """Paper section 5.6 preprocessing: reorder rows by increasing degree,
    split A = L + U; returns (L, U) ready for the L @ U wedge count.

    Degree is the count of nonzero values per row (duplicates summed),
    ordered by a stable argsort.  With ``return_adjacency=True`` also
    returns the degree-permuted adjacency -- the structural mask of the
    masked triangle count ``plan_spgemm(L, U, mask=adj)``.  Every output
    has ``a``'s capacity.
    """
    m, n = a.shape
    if m != n:
        raise ValueError(f"triangular_split needs a square matrix, got "
                         f"{a.shape}")
    key, vals = _dense_entries(a)
    nz = vals != 0
    key, vals = key[nz], vals[nz]
    order = np.argsort(np.bincount(key // n, minlength=n), kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    pr, pc = inv[key // n], inv[key % n]
    perm = np.argsort(pr * n + pc, kind="stable")
    pr, pc, vals = pr[perm], pc[perm], vals[perm]
    pkey = pr * n + pc

    def part(sel):
        return _from_sorted_keys(pkey[sel], vals[sel], (n, n), a.cap, device)

    L, U = part(pr > pc), part(pr < pc)
    if return_adjacency:
        return L, U, part(np.ones(pkey.shape[0], bool))
    return L, U
