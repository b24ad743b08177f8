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

from repro_torch.core.formats import CSR

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
