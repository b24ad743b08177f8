#!/usr/bin/env python3
"""Repeat the hash numeric kernel on one card and report the calls that
come out wrong.

Runs ``kernel.numeric_call`` ``--calls`` times per probe mode on
``chip_smoke.py``'s G500 s16 ef16 input (R-MAT, seed 0, squared, the
recipe's plan), each call with its own ``errors`` counter.  A call whose
counter is not zero is compared with the plain version row by row; the
line it prints names the rows that differ with their table class, output
count, A row length and table size, and for rows with one A entry how
many of the B row's columns went missing per warp of the block (threads
take products ``tid, tid + blockDim, ...``).  A race that a single
``chip_smoke.py`` call can miss shows here as a share of failing calls::

    python3 tools/hash_stress.py --calls 300 --modes vector

``--src`` names the tree's ``src`` directory, as for
``tools/hash_op_cost.py``.  One summary line per mode, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import _timing

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--modes", default="scalar,vector",
                    help="comma-separated: scalar, vector")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hash_stress: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core as core
    from repro_torch.core.formats import CSR
    from repro_torch.data import rmat
    from repro_torch.kernels.spgemm_hash import kernel as K
    from repro_torch.kernels.spgemm_hash import ref
    card = _timing.card()
    dev = torch.device("cuda")
    a = rmat.rmat_csr(16, 16, "G500", seed=0, device=dev)
    plan = core.plan_spgemm(a, a, algorithm="hash")
    kargs = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr, plan.indptr_c,
             a.indices, a.data.float(), a.indices, a.data.float())
    kw = dict(cap_c=plan.cap_c, table_size=plan.table_size)
    pc, _ = ref.numeric_plain(*kargs, vector=False, **kw)
    _, rows, row_tsz = K.row_classes(*kargs[:5], a.indices,
                                     table_size=plan.table_size)
    cls = torch.full((a.n_rows,), -1, dtype=torch.long, device=dev)
    for c, r in enumerate(rows):
        cls[r.long()] = c
    threads = [K.class_shape(c, False)["threads"]
               for c in range(len(K.CLASS_NAMES))]
    a_len = (a.indptr[1:] - a.indptr[:-1]).long()
    ic = plan.indptr_c.long()
    row_of = torch.repeat_interleave(torch.arange(a.n_rows, device=dev),
                                     ic[1:] - ic[:-1])
    for mode in args.modes.split(","):
        vector = mode == "vector"
        bad_calls = 0
        for it in range(args.calls):
            err = torch.zeros(1, dtype=torch.int32, device=dev)
            cols, vals = K.numeric_call(*kargs, vector=vector, errors=err,
                                        **kw)
            torch.cuda.synchronize()
            if not int(err):
                continue
            bad_calls += 1
            s = CSR(plan.indptr_c, cols, vals, plan.indptr_c[-1], a.shape,
                    False).sort_rows()
            nnz = plan.nnz_c
            diff = (s.indices[:nnz] != pc[:nnz]).nonzero().flatten()
            bad = torch.unique(row_of[diff]).tolist()
            rows_info = []
            for r in bad[:8]:
                c = int(cls[r])
                info = {"row": r, "class": K.CLASS_NAMES[c] if c >= 0
                        else None, "want": int(ic[r + 1] - ic[r]),
                        "a_len": int(a_len[r]), "tsz": int(row_tsz[r])}
                if info["a_len"] == 1 and c >= 0:
                    k = int(a.indices[int(a.indptr[r])])
                    b_cols = a.indices[int(a.indptr[k]):int(a.indptr[k + 1])]
                    got = set(cols[ic[r]:ic[r + 1]].tolist())
                    per_warp = {}
                    for i, col in enumerate(b_cols.tolist()):
                        if col not in got:
                            w = (i % threads[c]) // 32
                            per_warp[w] = per_warp.get(w, 0) + 1
                    info["missing_per_warp"] = dict(sorted(per_warp.items()))
                rows_info.append(info)
            print(json.dumps({"mode": mode, "call": it, "errors": int(err),
                              "bad_rows": len(bad), "rows": rows_info}),
                  flush=True)
        print(json.dumps({"mode": mode, "card": card, "calls": args.calls,
                          "calls_with_errors": bad_calls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
