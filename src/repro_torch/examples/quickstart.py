"""Quickstart: SpGEMM with the hash kernel + the recipe (paper sections 4-5).

Twin of the repository's ``examples/quickstart.py`` on the port::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the hash route runs the hand-written CUDA kernels; with
``--device cpu`` their plain versions.
"""
import argparse

import torch

from repro_torch.core import (spgemm, spgemm_esc, measure_stats, model_costs,
                              choose_algorithm, symbolic)
from repro_torch.data.rmat import rmat_csr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the operands (default: cuda)")
    device = ap.parse_args(argv).device

    # A Graph500-style power-law matrix (scale 8 = 256 vertices, ef 8)
    a = rmat_csr(8, 8, "G500", seed=0, device=device)
    print(f"A: {a.shape}, nnz={int(a.nnz)}, device={a.device}")

    # Two-phase: symbolic gives exact output size (Fig. 7 phase 1)
    row_nnz, indptr_c, flop, total_flop = symbolic(a, a)
    nnz_c = int(row_nnz.sum())
    print(f"symbolic: flop={int(total_flop)}, nnz(A^2)={nnz_c}, "
          f"compression ratio={int(total_flop) / nnz_c:.2f}")

    # The recipe picks an algorithm from the stats (Table 4)
    stats = measure_stats(a, a)
    print("cost model:", {k: f"{v:.2e}" for k, v in
                          model_costs(stats, sorted_output=False).items()})
    algo = choose_algorithm(a, a, sorted_output=False)
    print(f"recipe picks: {algo}")

    c = spgemm(a, a, cap_c=nnz_c + 16, algorithm=algo, n_bins=8)
    print(f"C = A@A: nnz={int(c.nnz)}, sorted={c.sorted_cols}")

    # C8: ask for sorted output only when you need it -- it costs a pass
    c_sorted = spgemm(a, a, cap_c=nnz_c + 16, algorithm=algo,
                      sorted_output=True, n_bins=8)
    ref = spgemm_esc(a, a, cap_c=nnz_c + 16)
    err = float(torch.abs(c_sorted.to_dense() - ref.to_dense()).max())
    print(f"hash vs ESC max err: {err:.2e}")
    assert err < 1e-3


if __name__ == "__main__":
    main()
