"""Block rows of a BCSR product that reach every row class of the block
kernel (``repro_torch.kernels.spgemm_bcsr``), built with numpy only so the
card's tests can use it without jax.

A rung ``(need, na)`` is one block row of ``A @ B`` with ``need`` distinct
output block columns (a seeded draw from ``GN``) and ``na`` A blocks, each
on a B block row of its own: B row k of the rung holds a window of
``min(need, 2 * ceil(need / na))`` of the row's columns starting at ``k *
ceil(need / na)`` (wrapping), so the windows cover every column and most
output blocks sum two tile products.  With 8x8 tiles the rungs of
:data:`LADDER` land in the classes of :data:`LADDER_CLASSES` under the
plan's own tables: a block's 30 / 54 / 111 / 225 KB of shared memory, then
direct -- the row with the G500 pattern's hub shape (666 outputs, 245 A
blocks, its B row bounds read in four windows) in the largest staged
class, a row of 900 outputs direct.
"""
import numpy as np

#: (outputs, A blocks) of each block row, 8x8 tiles
LADDER = ((0, 0), (1, 1), (5, 3), (3, 100), (60, 20), (100, 7), (180, 40),
          (400, 70), (666, 245), (900, 9))
#: the class of each rung at 8x8 tiles under the plan's tables (-1: none)
LADDER_CLASSES = (-1, 0, 0, 0, 0, 1, 2, 3, 3, 4)
#: rungs for 64x64 tiles: up to 8 outputs in 225 KB (three stage buffers
#: of one 16 KB tile each), 12 direct
LADDER_LARGE = ((1, 1), (2, 3), (3, 2), (6, 4), (12, 5))
LADDER_LARGE_CLASSES = (3, 3, 3, 3, 4)
#: block columns of B and C
GN = 1024
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


def ladder(rungs, block, dyadic, seed=0, gn=GN):
    """``(A, B)``, each ``(indptr, indices, blocks, shape)`` of a BCSR
    with ``block`` ``(bm, bk, bn)`` tiles: A's block row r is rung r."""
    bm, bk, bn = block
    rng = np.random.default_rng(seed)
    a_indptr, a_idx, b_rows = [0], [], []
    for need, na in rungs:
        cols = rng.permutation(gn)[:need]
        step = -(-need // na) if na else 0
        width = min(need, 2 * step)
        for k in range(na):
            a_idx.append(len(b_rows))
            at = (k * step + np.arange(width)) % need
            b_rows.append(np.sort(cols[at]))
        a_indptr.append(len(a_idx))
    b_indptr = np.concatenate([[0], np.cumsum([r.shape[0] for r in b_rows])])
    b_idx = np.concatenate(b_rows) if b_rows else np.zeros(0, np.int64)

    def tiles(n, r, c):
        if dyadic:
            return rng.choice(DYADIC, (n, r, c)).astype(np.float32)
        return rng.uniform(0.5, 1.5, (n, r, c)).astype(np.float32)

    gm, gk = len(rungs), len(b_rows)
    a = (np.asarray(a_indptr, np.int32), np.asarray(a_idx, np.int32),
         tiles(len(a_idx), bm, bk), (gm * bm, max(gk, 1) * bk))
    b = (b_indptr.astype(np.int32), b_idx.astype(np.int32),
         tiles(b_idx.shape[0], bk, bn), (max(gk, 1) * bk, gn * bn))
    return a, b
