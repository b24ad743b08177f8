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
on phase 13's value fleets -- 8 members of A's tiles on the ER pattern, 4
with A's and B's, 4 of A's on the G500 pattern and 4 on a 6 x 6 grid of
64x64 tiles (half of it occupied, seed 9) -- single calls and back to
back, and ``torch.func.vmap`` of ``BCSRPlan.execute`` over the ER
pattern's 8 members.  Each kernel's output is checked against the tree's
plain version once (block columns and tiles bitwise after a per-row
sort).

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/bcsr_cost.py --src build/parent/src --label parent
    python3 tools/bcsr_cost.py --src src --label change

(``--fleets ER8 --inputs ""``: the ER pattern's 8-member fleet alone.)
``--classes`` adds, per input (scalar probes), the card's time of the
classifying kernels and of each class launch alone, back to back (each
launch after its pop counter is zeroed), through whichever steps the
tree's wrapper has.

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
#: phase 13's fleets by name: (input, members, B's tiles batched too)
FLEETS = {"ER8": ("ER", 8, False), "ER4AB": ("ER", 4, True),
          "G5004": ("G500", 4, False), "64x64-4": ("64x64", 4, False)}
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


def block_bcsr(BCSR, br, bc, g, tile, dev):
    """A BCSR of dense dyadic ``tile`` x ``tile`` tiles (seed 1) on the
    block pattern ``(br, bc)`` of a ``g`` x ``g`` grid (duplicates
    collapsed)."""
    key = np.unique(br.astype(np.int64) * g + bc)
    br, bc = key // g, key % g
    indptr = np.zeros(g + 1, np.int64)
    np.cumsum(np.bincount(br, minlength=g), out=indptr[1:])
    blocks = np.random.default_rng(1).choice(
        DYADIC, (key.shape[0], tile, tile)).astype(np.float32)
    return BCSR.from_numpy(indptr, bc, blocks, key.shape[0],
                           (g * tile, g * tile), (tile, tile), device=dev)


def block_pattern(torch, BCSR, preset, scale, ef, dev):
    """The R-MAT pattern over the block grid as a BCSR of dense dyadic
    8x8 tiles; ``"64x64"``: a 6 x 6 grid, half occupied (seed 9), of
    64x64 tiles."""
    if preset == "64x64":
        occ = np.nonzero(np.random.default_rng(9).random((6, 6)) < 0.5)
        return block_bcsr(BCSR, occ[0], occ[1], 6, 64, dev)
    from repro_torch.data import rmat
    g = 1 << scale
    br, bc = rmat.rmat_edges(scale, ef, preset, seed=0)
    return block_bcsr(BCSR, br, bc, g, BLOCK, dev)


def class_times(torch, BK, bref, plan, a, errors) -> dict:
    """Back-to-back ms of the single product's classifying kernels (with
    the memset of their counts) and of each class launch alone, scalar
    probes: this tree's call steps (``prepare``, ``classify``,
    ``launch_class``), or an older tree's ``classify_rows`` and
    ``launch_class``."""
    args = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
            plan.indptr_cb, a.indices, a.blocks, a.indices, a.blocks)
    n_keys = len(BK.CLASS_NAMES) * bref.LEN_BUCKETS
    block = (a.block[0], a.block[1], a.block[1])
    if hasattr(BK, "prepare"):
        call = BK.prepare(*args, n_members=1, bcap_c=plan.bcap_c,
                          table_size=plan.table_size, vector=False,
                          errors=errors)

        def classify():
            call.counts.zero_()
            BK.classify(call)

        classify()
        counts, classes = call.counts, call.classes

        def launch(c):
            counts[n_keys + c].zero_()
            BK.launch_class(call, c)
    else:
        def classify():
            return BK.classify_rows(False, plan.offsets, plan.bin_tsize,
                                    plan.table_size, a.indptr, a.indptr,
                                    plan.indptr_cb, a.indices, block, errors)

        counts, work = classify()
        out_c = torch.zeros(plan.bcap_c, dtype=torch.int32,
                            device=a.blocks.device)
        out_b = torch.zeros((plan.bcap_c, block[0], block[2]),
                            device=a.blocks.device)
        classes = bref.launch_classes(block, plan.table_size, plan.bcap_c)

        def launch(c):
            counts[n_keys + c].zero_()
            BK.launch_class(c, counts, work, pdl=False,
                            table_size=plan.table_size, vector=False,
                            indptr_a=a.indptr, indptr_b=a.indptr,
                            indptr_c=plan.indptr_cb, a_bcol=a.indices,
                            a_blk=a.blocks, b_bcol=a.indices, b_blk=a.blocks,
                            out_bcol=out_c, out_blk=out_b, errors=errors)
    out = {"classify": _timing.stream_ms(torch, classify)[0]}
    for c in classes:
        out[BK.CLASS_NAMES[c]] = _timing.stream_ms(
            torch, lambda c=c: launch(c))[0]
    return out


def fleet_times(torch, core, BK, bref, a, n, b_too, label, median, errors):
    """The batched kernel on ``n`` members of new dyadic tiles on ``a``'s
    pattern (A's; with ``b_too`` B's as well, the products A·A), checked
    once against the batched plain version: ``(single-call ms, b2b ms,
    host ms)``, and the same of ``torch.func.vmap`` of
    ``BCSRPlan.execute`` on 8 members of A's; None on a mismatch."""
    import dataclasses
    dev = a.blocks.device
    rng = np.random.default_rng(2)
    shape = (n,) + tuple(a.blocks.shape)
    xa = torch.from_numpy(rng.choice(DYADIC, shape).astype(np.float32)).to(
        dev)
    xb = torch.from_numpy(rng.choice(DYADIC, shape).astype(np.float32)).to(
        dev) if b_too else a.blocks
    plan = core.plan_bcsr(a, a, cache=False)
    fargs = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
             plan.indptr_cb, a.indices, xa, a.indices, xb)
    fkw = dict(n_members=n, bcap_c=plan.bcap_c, table_size=plan.table_size,
               vector=False)
    pc, pb = bref.batched_numeric_plain(*fargs, **fkw)
    kc, kb = BK.batched_numeric_call(*fargs, **fkw, errors=errors)
    torch.cuda.synchronize()
    for e in range(n):
        sc, sb = bref.sort_block_rows(plan.indptr_cb, kc[e], kb[e])
        if int(errors) or not (torch.equal(sc, pc[e]) and
                               torch.equal(sb, pb[e])):
            print(f"bcsr_cost: {label} fleet member {e}: the batched "
                  f"kernel differs from its plain version", file=sys.stderr)
            return None

    def kernel():
        BK.batched_numeric_call(*fargs, **fkw, errors=errors)

    out = {"kernel": (median(kernel),) + _timing.stream_ms(torch, kernel)}
    if n == 8 and not b_too:
        def one(x):
            c = plan.execute(dataclasses.replace(a, blocks=x), a)
            return c.indices, c.blocks

        def vmapped():
            return torch.func.vmap(one)(xa)
        out["vmap_execute"] = (median(vmapped),) + \
            _timing.stream_ms(torch, vmapped)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--inputs", default="ER,G500",
                    help="single-product inputs (empty: none)")
    ap.add_argument("--classes", action="store_true")
    ap.add_argument("--fleets", nargs="?", const=",".join(FLEETS),
                    default="", help=f"fleets of {sorted(FLEETS)} "
                    f"(without a value: all)")
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

    for name in filter(None, args.inputs.split(",")):
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
        classes = class_times(torch, BK, bref, plan, a, errors) \
            if args.classes else None
        print(json.dumps({
            "label": args.label, "input": f"{name}-pattern", "card": card,
            "nnzb_a": int(a.nnzb), "nnzb_c": plan.nnzb_c,
            "block_flop": plan.total_flop, "table_size": plan.table_size,
            "reps": args.reps, "ms": ms, "stream_ms": stream,
            "host_ms": host, "class_b2b_ms": classes}), flush=True)
        del a, plan, sp
        torch.cuda.empty_cache()
    for name, n, b_too in (FLEETS[k] for k in
                           filter(None, args.fleets.split(","))):
        a = block_pattern(torch, core.BCSR, *(INPUTS.get(name) or
                                              (name, 0, 0)), dev)
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
        what = f"{name}-pattern x{n} {'A and B' if b_too else 'A'}"
        t = fleet_times(torch, core, BK, bref, a, n, b_too,
                        f"{args.label} {what}", median, errors)
        if t is None:
            return 1
        print(json.dumps({
            "label": args.label, "fleet": what, "card": card,
            "reps": args.reps, "ms": {k: v[0] for k, v in t.items()},
            "stream_ms": {k: v[1] for k, v in t.items()},
            "host_ms": {k: v[2] for k, v in t.items()}}), flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
