"""A product whose rows reach every table class of the hash numeric
kernel (``repro_torch.kernels.spgemm_hash``), built with numpy only so the
card's tests can use it without jax.

Row r of ``A @ B`` has ``LADDER[r]`` distinct columns, drawn from a seeded
permutation of ``N_COLS``: A's row r holds columns 2r and 2r + 1, B's row
2r the row's columns and B's row 2r + 1 every other one of them, so half
the entries sum two products.  Under one bin whose table holds
``LADDER_TABLE`` slots the rows' own tables are 0 (none), 16 and 1,024
(one block, 1,024 slots), 4,096, 8,192, then 32,768, 65,536 and 131,072
(clusters of 2, 4 and 8 blocks) and 262,144 (device memory).

``FLEET_LADDER``'s rows reach every class in both phases: a row of d
columns has 1.5 d products (the symbolic phase's need), so its symbolic
table may be a class above its numeric one.
"""
import numpy as np

LADDER = (0, 5, 300, 1500, 3000, 12000, 20000, 40000, 70000)
#: the class each rung lands in under the one-bin schedule (-1: none)
LADDER_CLASSES = (-1, 0, 0, 1, 2, 3, 4, 5, 6)
#: rungs that reach every class by output count (numeric) and by product
#: count (symbolic), and the class of each under the one-bin schedule
FLEET_LADDER = (0, 5, 300, 1000, 1500, 3000, 8000, 12000, 16000, 20000,
                40000, 70000)
FLEET_LADDER_CLASSES = (-1, 0, 0, 1, 1, 2, 2, 3, 3, 4, 5, 6)
FLEET_LADDER_SYMBOLIC_CLASSES = (-1, 0, 0, 1, 2, 2, 3, 4, 4, 4, 5, 6)
LADDER_TABLE = 1 << 18
N_COLS = 1 << 17
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


def saturated_row(d, seed=0):
    """COO parts of a one-row A (one entry) and a one-row B of ``d``
    distinct columns of ``N_COLS``: C's row has exactly ``d`` entries."""
    rng = np.random.default_rng(seed)
    a = (np.zeros(1, np.int64), np.zeros(1, np.int64),
         np.ones(1, np.float32), (1, 1))
    cols = rng.permutation(N_COLS)[:d]
    b = (np.zeros(d, np.int64), cols, DYADIC[np.arange(d) % 4], (1, N_COLS))
    return a, b


def ladder(dyadic, seed=0, rungs=LADDER):
    """COO parts ``(rows, cols, vals, shape)`` of A and of B, C's row r of
    ``rungs[r]`` distinct columns."""
    rng = np.random.default_rng(seed)
    n = len(rungs)
    a_rows = np.repeat(np.arange(n), 2)
    a_cols = np.arange(2 * n)
    b_rows, b_cols = [], []
    for r, d in enumerate(rungs):
        cols = rng.permutation(N_COLS)[:d]
        b_rows += [np.full(d, 2 * r), np.full(len(cols[::2]), 2 * r + 1)]
        b_cols += [cols, cols[::2]]
    b_rows, b_cols = np.concatenate(b_rows), np.concatenate(b_cols)
    if dyadic:
        a_vals = rng.choice(DYADIC, a_rows.shape[0])
        b_vals = rng.choice(DYADIC, b_rows.shape[0])
    else:
        a_vals = rng.uniform(-1, 1, a_rows.shape[0]).astype(np.float32)
        b_vals = rng.uniform(-1, 1, b_rows.shape[0]).astype(np.float32)
    return ((a_rows, a_cols, a_vals, (n, 2 * n)),
            (b_rows, b_cols, b_vals, (2 * n, N_COLS)))
