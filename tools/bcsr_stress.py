#!/usr/bin/env python3
"""Repeat the BCSR block kernel on one card and report the calls that
come out wrong.

Runs ``kernel.numeric_call`` (single product) or
``kernel.batched_numeric_call`` (fleets of 1, 3 and 8 members of A's
tiles, B's shared: ``shared``, every index array shared, so that a block
row of a group of members is one work item; ``stacked``, every index
array stacked per member, a member's row an item) ``--calls`` times per
case and compares each call with the first call (bitwise, raw rows: the
kernel's row order is fixed) and with the plain version (block columns
and tiles bitwise after a per-row sort; dyadic values, so every summation
order is exact).  Cases: each probe mode (scalar, vector) on each tile
size -- 8x8 on ``chip_smoke.py``'s block inputs (phase 7: R-MAT ER s13
ef8 and G500 s10 ef8 patterns, seed 0), and 64x64 on the same R-MAT
presets at s6 ef4 -- for the single product and each fleet.  A race that one ``chip_smoke.py`` call can miss (a late
lane a barrier behind, a stage buffer read before its copies landed)
shows here as a share of wrong calls::

    python3 tools/bcsr_stress.py --calls 300

``--src`` names the tree's ``src`` directory (a parent unpacked with ``git
archive`` into a directory that ``.gitignore`` lists, as for
``tools/bcsr_cost.py``); ``--cases`` picks cases by name.  One summary
line per case, with the card's name and power limit; the exit code is 1
when any call was wrong.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

import _timing

ROOT = Path(__file__).resolve().parents[1]
#: tile -> (pattern scale, edge factor) per preset
SIZES = {8: {"ER": (13, 8), "G500": (10, 8)}, 64: {"ER": (6, 4),
                                                  "G500": (6, 4)}}
#: fleet sizes and layouts
MEMBERS = (1, 3, 8)
LAYOUTS = ("shared", "stacked")
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


def cases() -> list:
    kinds = ["single"] + [f"fleet{n}-{layout}" for n in MEMBERS
                          for layout in LAYOUTS]
    return [f"{mode}_{t}x{t}_{preset}_{kind}"
            for kind in kinds for t in (8, 64)
            for preset in ("ER", "G500") for mode in ("scalar", "vector")]


def block_pattern(torch, BCSR, preset, scale, ef, tile, dev):
    """The R-MAT pattern over the block grid as a BCSR of dense dyadic
    ``tile`` x ``tile`` tiles (duplicates collapsed)."""
    from repro_torch.data import rmat
    g = 1 << scale
    br, bc = rmat.rmat_edges(scale, ef, preset, seed=0)
    key = np.unique(br.astype(np.int64) * g + bc)
    br, bc = key // g, key % g
    indptr = np.zeros(g + 1, np.int64)
    np.cumsum(np.bincount(br, minlength=g), out=indptr[1:])
    blocks = np.random.default_rng(1).choice(
        DYADIC, (key.shape[0], tile, tile)).astype(np.float32)
    return BCSR.from_numpy(indptr, bc, blocks, key.shape[0],
                           (g * tile, g * tile), (tile, tile), device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--cases", default=",".join(cases()))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bcsr_stress: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core as core
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_bcsr import ref as bref
    card = _timing.card()
    dev = torch.device("cuda")
    failed = 0
    for case in args.cases.split(","):
        mode, tiles, preset, kind = case.split("_")
        tile = int(tiles.split("x")[0])
        vector = mode == "vector"
        a = block_pattern(torch, core.BCSR, preset, *SIZES[tile][preset],
                          tile, dev)
        plan = core.plan_bcsr(a, a, vector=vector, cache=False)
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
        head = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                plan.indptr_cb, a.indices)
        kw = dict(bcap_c=plan.bcap_c, table_size=plan.table_size,
                  vector=vector)
        if kind == "single":
            kargs = head + (a.blocks, a.indices, a.blocks)
            want = [bref.numeric_plain(*kargs, **kw)]

            def call():
                return [BK.numeric_call(*kargs, **kw, errors=errors)]
        else:
            n, layout = kind[5:].split("-")
            n = int(n)
            vals = torch.from_numpy(np.random.default_rng(2).choice(
                DYADIC, (n,) + tuple(a.blocks.shape)).astype(
                    np.float32)).to(dev)
            kargs = head + (vals, a.indices, a.blocks)
            if layout == "stacked":
                kargs = tuple(t if i == 6 else
                              torch.stack([t] * n).contiguous()
                              for i, t in enumerate(kargs))
            pc, pb = bref.batched_numeric_plain(*kargs, n_members=n, **kw)
            want = [(pc[e], pb[e]) for e in range(n)]

            def call(n=n, kargs=kargs):
                c, b = BK.batched_numeric_call(*kargs, n_members=n, **kw,
                                               errors=errors)
                return [(c[e], b[e]) for e in range(n)]
        first = call()
        bad_calls = 0
        for it in range(args.calls):
            got = first if it == 0 else call()
            torch.cuda.synchronize()
            bad = []
            for e, ((gc, gb), (fc, fb), (wc, wb)) in enumerate(
                    zip(got, first, want)):
                sc, sb = bref.sort_block_rows(plan.indptr_cb, gc, gb)
                if not (torch.equal(gc, fc) and torch.equal(gb, fb)):
                    bad.append({"member": e, "differs_from": "first call"})
                if not (torch.equal(sc, wc) and torch.equal(sb, wb)):
                    bad.append({"member": e, "differs_from": "plain"})
            if int(errors):
                bad.append({"errors": int(errors)})
                errors.zero_()
            if bad:
                bad_calls += 1
                print(json.dumps({"case": case, "call": it,
                                  "wrong": bad[:8]}), flush=True)
        failed += bad_calls
        print(json.dumps({"case": case, "card": card, "calls": args.calls,
                          "wrong_calls": bad_calls,
                          "nnzb_a": int(a.nnzb), "nnzb_c": plan.nnzb_c,
                          "table_size": plan.table_size}), flush=True)
        del a, plan, first, want
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
