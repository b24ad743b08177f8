#!/usr/bin/env python3
"""Time the BCSR block kernel of one source tree on one card.

On ``chip_smoke.py``'s block inputs (phase 7: R-MAT ER s13 ef8 and G500
s10 ef8 patterns, seed 0, over the block grid, every occupied 8x8 tile
dense with dyadic values from seed 1), planned with ``core.plan_bcsr``,
prints for each probe mode the median single-call CUDA-event times
(``--reps`` runs after 2 warm-ups) and the back-to-back times (20 calls
inside one CUDA event pair, divided by 20: the card's time a call, beside
the host's time to issue one, ``_timing.stream_ms``) of:

* ``kernel``: ``kernel.numeric_call`` with an ``errors`` tensor of the
  caller's (no read-back);
* ``execute``: ``BCSRPlan.execute`` (the custom op, the errors read-back,
  the tail mask);
* ``torch_sparse_mm``: ``torch.sparse.mm`` of the flattened CSR by itself
  (a yardstick, never on the path), once per input;

and, with ``--fleets``, the batched kernel (``kernel.batched_numeric_call``)
on phase 13's value fleets: 8 members of A's tiles on the ER pattern, 4 on
the G500 pattern (single calls).  Each kernel's output is checked against
the tree's plain version once (block columns and tiles bitwise after a
per-row sort).

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/bcsr_cost.py --src build/parent/src --label parent
    python3 tools/bcsr_cost.py --src src --label change

One JSON line per input, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

import _timing

ROOT = Path(__file__).resolve().parents[1]
INPUTS = {"ER": ("ER", 13, 8), "G500": ("G500", 10, 8)}
BLOCK = 8
FLEET = {"ER": 8, "G500": 4}
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


def block_pattern(torch, BCSR, preset, scale, ef, dev):
    """The R-MAT pattern over the block grid as a BCSR of dense dyadic
    tiles (duplicates collapsed)."""
    from repro_torch.data import rmat
    g = 1 << scale
    br, bc = rmat.rmat_edges(scale, ef, preset, seed=0)
    key = np.unique(br.astype(np.int64) * g + bc)
    br, bc = key // g, key % g
    indptr = np.zeros(g + 1, np.int64)
    np.cumsum(np.bincount(br, minlength=g), out=indptr[1:])
    blocks = np.random.default_rng(1).choice(
        DYADIC, (key.shape[0], BLOCK, BLOCK)).astype(np.float32)
    return BCSR.from_numpy(indptr, bc, blocks, key.shape[0],
                           (g * BLOCK, g * BLOCK), (BLOCK, BLOCK), device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--inputs", default="ER,G500")
    ap.add_argument("--fleets", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bcsr_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core as core
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    card = _timing.card()
    dev = torch.device("cuda")

    def median(fn):
        t = _timing.event_times(torch, fn, args.reps)
        return t[len(t) // 2]

    for name in args.inputs.split(","):
        a = block_pattern(torch, core.BCSR, *INPUTS[name], dev)
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
        ms, stream, host = {}, {}, {}
        plan = None
        for vector in (False, True):
            mode = "vector" if vector else "scalar"
            plan = core.plan_bcsr(a, a, vector=vector, cache=False)
            kargs = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                     plan.indptr_cb, a.indices, a.blocks, a.indices,
                     a.blocks)
            kw = dict(bcap_c=plan.bcap_c, table_size=plan.table_size,
                      vector=vector)
            pc, pb = bref.numeric_plain(*kargs, **kw)
            kc, kb = BK.numeric_call(*kargs, **kw, errors=errors)
            sc, sb = bref.sort_block_rows(plan.indptr_cb, kc, kb)
            torch.cuda.synchronize()
            if int(errors) or not (torch.equal(sc, pc) and
                                   torch.equal(sb, pb)):
                print(f"bcsr_cost: {args.label} {name} {mode}: the kernel "
                      f"differs from its plain version", file=sys.stderr)
                return 1

            def kernel():
                BK.numeric_call(*kargs, **kw, errors=errors)

            ms[f"kernel_{mode}"] = median(kernel)
            ms[f"execute_{mode}"] = median(lambda: plan.execute(a, a))
            stream[f"kernel_{mode}"], host[f"kernel_{mode}"] = \
                _timing.stream_ms(torch, kernel)
            stream[f"execute_{mode}"], host[f"execute_{mode}"] = \
                _timing.stream_ms(torch, lambda: plan.execute(a, a))
        c = core.bcsr_to_csr(a)
        nnz = int(c.nnz)
        sp = torch.sparse_csr_tensor(c.indptr.long(), c.indices[:nnz].long(),
                                     c.data[:nnz], size=c.shape)
        ms["torch_sparse_mm"] = median(lambda: torch.sparse.mm(sp, sp))
        stream["torch_sparse_mm"], host["torch_sparse_mm"] = \
            _timing.stream_ms(torch, lambda: torch.sparse.mm(sp, sp))
        if args.fleets:
            n = FLEET[name]
            vals = torch.from_numpy(np.random.default_rng(2).choice(
                DYADIC, (n,) + tuple(a.blocks.shape)).astype(
                    np.float32)).to(dev)
            plan = core.plan_bcsr(a, a, cache=False)
            fargs = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                     plan.indptr_cb, a.indices, vals, a.indices, a.blocks)
            fkw = dict(n_members=n, bcap_c=plan.bcap_c,
                       table_size=plan.table_size, vector=False)
            pc, pb = bref.batched_numeric_plain(*fargs, **fkw)
            kc, kb = BK.batched_numeric_call(*fargs, **fkw, errors=errors)
            torch.cuda.synchronize()
            for e in range(n):
                sc, sb = bref.sort_block_rows(plan.indptr_cb, kc[e], kb[e])
                if int(errors) or not (torch.equal(sc, pc[e]) and
                                       torch.equal(sb, pb[e])):
                    print(f"bcsr_cost: {args.label} {name} fleet member "
                          f"{e}: the batched kernel differs from its plain "
                          f"version", file=sys.stderr)
                    return 1
            ms[f"batched_x{n}"] = median(lambda: BK.batched_numeric_call(
                *fargs, **fkw, errors=errors))
        print(json.dumps({
            "label": args.label, "input": f"{name}-pattern", "card": card,
            "nnzb_a": int(a.nnzb), "nnzb_c": plan.nnzb_c,
            "block_flop": plan.total_flop, "table_size": plan.table_size,
            "reps": args.reps, "ms": ms, "stream_ms": stream,
            "host_ms": host}), flush=True)
        del a, plan, sp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
