"""A CSR whose rows sit at every length-class edge of the SpMM kernel
(``repro_torch.kernels.spmm``), built with numpy only so the card's tests
can use it without jax.

Rung r is a row of ``LADDER[r]`` nonzeros with columns drawn with
repetition from ``N_COLS`` (so the long rows repeat columns), followed by
``SHORT`` short rows of 0-40 nonzeros; ``LADDER_CLASSES[r]`` is the class
the rung's row lands in: a warp's row in classes 0-3 (at most 32, 64,
128, 256 nonzeros), a block's in classes 4-9 ((256, 512], ...,
(4,096, 8,192] and past 8,192).
"""
import numpy as np

LADDER = (0, 1, 32, 33, 64, 65, 128, 129, 255, 256, 257, 512, 513, 1024,
          1025, 2048, 2049, 4096, 8192, 8193, 20000)
LADDER_CLASSES = (0, 0, 0, 1, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8,
                  9, 9)
N_COLS = 3000
SHORT = 3
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


def ladder(values, seed=0):
    """``(indptr, indices, data, shape, rung_rows)``: the host CSR (int64
    row pointer, int32 columns, float32 values, every slot live) and the
    row id of each rung.  ``values``: "dyadic" (0.5, 1, 1.5, 2: every sum
    exact), "uniform" in [0.5, 1.5) (no cancellation, so a sum is within
    one ulp per product of the exact one) or "signed" in [-1, 1) (the
    order of the adds shows)."""
    rng = np.random.default_rng(seed)
    lengths, rung_rows = [], []
    for d in LADDER:
        rung_rows.append(len(lengths))
        lengths += [d] + rng.integers(0, 41, SHORT).tolist()
    lengths = np.asarray(lengths)
    indptr = np.zeros(lengths.shape[0] + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, N_COLS, nnz).astype(np.int32)
    data = {"dyadic": lambda: rng.choice(DYADIC, nnz),
            "uniform": lambda: rng.uniform(0.5, 1.5, nnz),
            "signed": lambda: rng.uniform(-1, 1, nnz)}[values]()
    return (indptr, indices, data.astype(np.float32),
            (lengths.shape[0], N_COLS), np.asarray(rung_rows))
