#!/usr/bin/env python3
"""Repeat the SpMM kernel on one card and report the calls that come out
wrong.

Runs ``kernel.spmm_call`` ``--calls`` times per case on ``chip_smoke.py``'s
graph (R-MAT G500 s16 ef16, seed 1, symmetrized: 65,536 rows, a
9,629-nonzero row, 949 rows past 256 nonzeros, a block's each), the row
lists made once by the classifying kernel as the front door memoizes
them, and compares
each call bitwise with the plain version (computed once a case).  Cases:
``f32_k64`` (X float32, k 64: long rows' X rows by bulk copies) and
``bf16_k100`` (X bfloat16, k 100: 200-byte rows, through registers).  A wrong
call prints the rows that differ, with their length class and live
length.  A race that a single ``chip_smoke.py`` call can miss (a late
lane a barrier behind, a ring slot read before it filled) shows here as a
share of wrong calls::

    python3 tools/spmm_stress.py --calls 300

``--src`` names the tree's ``src`` directory, as for
``tools/spmm_cost.py``.  One summary line per case, with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

import _timing

ROOT = Path(__file__).resolve().parents[1]
CASES = {"f32_k64": ("float32", 64), "bf16_k100": ("bfloat16", 100)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spmm_stress: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.data import rmat
    from repro_torch.kernels.spmm import kernel as SK
    from repro_torch.kernels.spmm import ref as sref
    card = _timing.card()
    dev = torch.device("cuda")
    g = rmat.rmat_csr(16, 16, "G500", seed=1, device=dev)
    a = rmat.symmetrize(g, cap=2 * g.cap, device=dev)
    cls = SK.classify(a.indptr, a.nnz, a.cap)
    length = sref.live_lengths(a.indptr, a.nnz, a.cap)
    row_cls = torch.searchsorted(torch.tensor(sref.CLASS_BOUNDS, device=dev),
                                 length)
    data = a.data.float()
    failed = 0
    for case in args.cases.split(","):
        dtype, k = CASES[case]
        x = torch.from_numpy(np.random.default_rng(k).uniform(
            -1, 1, (a.n_cols, k)).astype(np.float32)).to(dev).to(
                getattr(torch, dtype))
        kargs = (a.indptr, a.indices, data, x, a.nnz)
        want = sref.spmm_plain(*kargs)
        SK.COPY_PATHS.update(dict.fromkeys(SK.COPY_PATHS, 0))
        bad_calls = 0
        for it in range(args.calls):
            y = SK.spmm_call(*kargs, classes=cls)
            torch.cuda.synchronize()
            if torch.equal(y, want):
                continue
            bad_calls += 1
            rows = (y != want).any(dim=1).nonzero().flatten().tolist()
            print(json.dumps({
                "case": case, "call": it, "bad_rows": len(rows),
                "rows": [{"row": r, "class": SK.CLASS_NAMES[int(row_cls[r])],
                          "length": int(length[r])} for r in rows[:8]]}),
                  flush=True)
        failed += bad_calls
        print(json.dumps({"case": case, "card": card, "calls": args.calls,
                          "wrong_calls": bad_calls,
                          "copy_paths": dict(SK.COPY_PATHS)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
