#!/usr/bin/env python3
"""Race the measured recipe's lanes on one card.

For each input -- R-MAT ``ER18`` (scale 18) or ``G500s<scale>``, edge
factor 16, seed 0, as ``chip_smoke.py`` builds them, and the Table 2
proxies of ``repro_torch.data.matrices`` at ``--divisor`` (``--matrices``:
``all``, ``none``, a count of the first ones in Table 2's order, or
comma-separated names) -- squares A: plans ``A @ A`` under the heuristic
recipe, then times every lane the measured recipe would race
(``autotune.measure._candidates``) with the race's own timer
(``autotune.race_lanes``: median of 3 windows of back-to-back executes
between CUDA events, every lane once a round).  ``--max-heap-steps`` leaves out the heap lane
where its steps (the largest row flop; the plain loop syncs the host
once a step) pass the limit, and the row names it.  One JSON line per
input (``autotune.race_report``: n, nnz, flop, nnz(C), the compression
ratio, the heap lane's steps, the heuristic's choice and its lane's
microseconds, the winner and its, every lane's, the spread between lanes
that run one program), with the race's seconds on the host's clock; then
a summary line (the inputs on which Table 4's choice is within 5 % of
the winner), each with the card's name and power limit::

    python3 tools/autotune_race.py --inputs ER18,G500s12 --matrices all
    python3 tools/autotune_race.py --inputs none --divisor 16 \
        --max-heap-steps 2000
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

import _timing

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--inputs", default="ER18,G500s12")
    ap.add_argument("--divisor", type=int, default=256)
    ap.add_argument("--matrices", default="all")
    ap.add_argument("--max-heap-steps", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("autotune_race: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core as core
    from repro_torch import autotune
    from repro_torch.data import matrices, rmat
    from repro_torch.kernels import _build
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spgemm_hash import kernel as K
    from repro_torch.kernels.spgemm_pb import kernel as PK
    card = _timing.card()
    dev = torch.device("cuda")
    _build.compile_sources([K.SOURCE, PK.SOURCE, BK.SOURCE])
    out = open(args.out, "a") if args.out else None

    def emit(row: dict) -> None:
        line = json.dumps({**row, "card": card})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    def inputs():
        for name in filter(None, args.inputs.split(",")):
            if name == "none":
                continue
            preset, scale = ("ER", name[2:]) if name.startswith("ER") \
                else ("G500", name[5:])
            yield name, rmat.rmat_csr(int(scale), 16, preset, seed=0,
                                      device=dev)
        ps = [p.name for p in matrices.profiles()]
        if args.matrices == "all":
            pick = ps
        elif args.matrices == "none":
            pick = []
        elif args.matrices.isdigit():
            pick = ps[:int(args.matrices)]
        else:
            pick = args.matrices.split(",")
        for p in matrices.profiles():
            if p.name in pick:
                yield p.name, matrices.synth_proxy(p, divisor=args.divisor,
                                                   device=dev)

    rows = []
    for name, a in inputs():
        heur = core.plan_spgemm(a, a, cache=False)
        steps = int(heur.flop.max()) if heur.flop.numel() else 0
        lanes = autotune.measure._candidates(a, a, "plus_times", None)
        skipped = [lane[0] for lane in lanes if lane[0] == "heap" and
                   args.max_heap_steps is not None and
                   steps > args.max_heap_steps]
        lanes = [lane for lane in lanes if lane[0] not in skipped]
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            timings = autotune.race_lanes(a, a, lanes)
        race_s = time.perf_counter() - t0
        row = {"input": name, "divisor": args.divisor,
               **autotune.race_report(heur, timings), "race_s": race_s,
               "skipped": skipped,
               "failed": [str(w.message) for w in caught]}
        rows.append(row)
        emit(row)
        del heur, a
        core.clear_plan_cache()
        torch.cuda.empty_cache()
    near = [r["input"] for r in rows if r["heuristic_over_winner"] is not None
            and r["heuristic_over_winner"] <= 1.05]
    emit({"summary": "Table 4's choice within 5 % of the winner",
          "count": len(near), "of": len(rows), "inputs": near,
          "race_s": sum(r["race_s"] for r in rows)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
