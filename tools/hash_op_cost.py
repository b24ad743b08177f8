#!/usr/bin/env python3
"""Time the eager hash execute of one source tree on one card.

For each of ``chip_smoke.py``'s phase-4 inputs named in ``--inputs``
(``ER``, ``G500``: R-MAT s18 and s16, edge factor 16, seed 0, squared) and
each probe mode (``hash``, ``hash_vector``), prints the median CUDA-event
times (7 runs after 2 warm-ups) of:

* ``execute``: ``plan_spgemm(a, a, algorithm=mode).execute(a, a)``;
* ``kernel``: the numeric kernel through ``kernel.numeric_call`` with the
  caller's ``errors`` tensor (no read-back);
* ``kernel_readback``: the same wrapper reading its own ``errors`` back;
* ``kernel_op``: the same through the custom op
  ``repro_torch::spgemm_hash_numeric``, where the tree has it (the op's
  own cost is ``kernel_op - kernel_readback``).

With ``MoE`` in ``--inputs``, also phase 12's MoE dispatch fleet (128
experts, top-8, 16,384 tokens, d_model 2,048, density 0.05):
``plan_batch(pairs).execute(pairs)``, which runs the batched numeric
kernel through ``core.batch``'s direct call.

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/hash_op_cost.py --src build/parent/src --label parent
    python3 tools/hash_op_cost.py --src src --label change

One JSON line per input and mode, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import _timing

ROOT = Path(__file__).resolve().parents[1]
SCALES = {"ER": 18, "G500": 16}
EDGE_FACTOR, REPS, WARM = 16, 7, 2
#: chip_smoke.py's MoE dispatch fleet (phase 12)
MOE = dict(n_experts=128, top_k=8, tokens=16384, d_model=2048,
           density=0.05)


def time_ms(torch, fn) -> float:
    return _timing.median_ms(torch, fn, REPS, WARM)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (default: this one's)")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--inputs", default="ER,G500",
                    help="comma-separated: ER, G500, MoE")
    args = ap.parse_args()
    inputs = args.inputs.split(",")
    if not set(inputs) <= {"ER", "G500", "MoE"}:
        ap.error(f"unknown input in {args.inputs!r}")
    import torch
    if not torch.cuda.is_available():
        print("hash_op_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core as core
    from repro_torch.data import rmat
    from repro_torch.kernels.spgemm_hash import kernel as K
    from repro_torch.kernels.spgemm_hash import ops
    card = _timing.card()
    K.build()
    numeric_op = getattr(ops, "numeric_op", None)
    dev = torch.device("cuda")
    for preset in (x for x in inputs if x in SCALES):
        scale = SCALES[preset]
        a = rmat.rmat_csr(scale, EDGE_FACTOR, preset, seed=0, device=dev)
        for mode in ("hash", "hash_vector"):
            core.clear_plan_cache()
            plan = core.plan_spgemm(a, a, algorithm=mode)
            vector = mode == "hash_vector"
            kargs = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                     plan.indptr_c, a.indices, a.data.float(), a.indices,
                     a.data.float())
            kw = dict(cap_c=plan.cap_c, table_size=plan.table_size,
                      vector=vector)
            errors = torch.zeros(1, dtype=torch.int32, device=dev)
            t = {"execute": time_ms(torch, lambda: plan.execute(a, a)),
                 "kernel": time_ms(torch, lambda: K.numeric_call(
                     *kargs, **kw, errors=errors)),
                 "kernel_readback": time_ms(torch, lambda: K.numeric_call(
                     *kargs, **kw))}
            if numeric_op is not None:
                t["kernel_op"] = time_ms(torch, lambda: numeric_op(
                    *kargs, plan.cap_c, plan.table_size, vector))
            torch.cuda.synchronize()
            if int(errors):
                print(f"hash_op_cost: {int(errors)} kernel errors",
                      file=sys.stderr)
                return 1
            print(json.dumps({"tree": args.label, "src": args.src,
                              "card": card,
                              "input": f"{preset} s{scale} ef{EDGE_FACTOR}",
                              "mode": mode, "ms": t}), flush=True)
            del plan
        del a
        core.clear_plan_cache()
        torch.cuda.empty_cache()
    if "MoE" in inputs:
        from repro_torch.examples.moe_dispatch_batch import \
            build_dispatch_fleet
        pairs, _, _ = build_dispatch_fleet(0, **MOE, device=dev)
        plan = core.plan_batch(pairs)
        t = {"execute": time_ms(torch, lambda: plan.execute(pairs))}
        print(json.dumps({"tree": args.label, "src": args.src, "card": card,
                          "input": "MoE dispatch 128 experts top-8 "
                          "T=16384 d=2048", "mode": "plan_batch",
                          "ms": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
