#!/usr/bin/env python3
"""Time the SpMM kernel of one source tree on one card.

On ``chip_smoke.py``'s two SpMM inputs (phase 8: R-MAT ER s18 ef16, seed
0; phase 9's graph: R-MAT G500 s16 ef16, seed 1, symmetrized), with X
``(n, 64)`` float32 uniform in [0.5, 1.5) from seed 2, prints the median
single-call CUDA-event times (``--reps`` runs after 2 warm-ups) of:

* ``kernel``: the SpMM launch alone -- ``kernel.spmm_call`` with the row
  lists made beforehand, where the tree has a classifying kernel, else
  ``kernel.spmm_call``;
* ``kernel_classify``: ``kernel.spmm_call`` without the lists (the
  classifying kernel, then the SpMM launch), where the tree has one;
* ``spmm``: ``core.spmm(a, x)``, the front door (lists memoized on the CSR);
* ``torch_sparse_mm``: ``torch.sparse.mm`` on the same CSR (a yardstick,
  never on the path);
* on the graph, ``dense_bfs``: ``multi_source_bfs`` from 64 sources over 6
  hops (one SpMM a hop);

and the spread of the kernel's runs (min, max).  A single call's time
holds the wrapper's host work; ``stream_ms`` gives the card's time a call
for ``kernel`` and ``torch_sparse_mm`` (20 calls back to back inside one
CUDA event pair, divided by 20) and ``host_ms`` the host's time to issue
one.  Each result is checked bitwise against the tree's plain version
once.

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/spmm_cost.py --src build/parent/src --label parent
    python3 tools/spmm_cost.py --src src --label change

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
K = 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--inputs", default="ER,graph")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spmm_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.core as core
    from repro_torch.data import rmat
    from repro_torch.examples import graph_analytics as ga
    from repro_torch.kernels.spmm import kernel as SK
    from repro_torch.kernels.spmm import ref as sref
    card = _timing.card()
    dev = torch.device("cuda")

    def times(fn):
        return _timing.event_times(torch, fn, args.reps)

    for name in args.inputs.split(","):
        if name == "ER":
            a = rmat.rmat_csr(18, 16, "ER", seed=0, device=dev)
        else:
            g = rmat.rmat_csr(16, 16, "G500", seed=1, device=dev)
            a = rmat.symmetrize(g, cap=2 * g.cap, device=dev)
        n = a.n_cols
        x = torch.from_numpy(np.random.default_rng(2).uniform(
            0.5, 1.5, (n, K)).astype(np.float32)).to(dev)
        data = a.data.float()
        kargs = (a.indptr, a.indices, data, x, a.nnz)
        has_classes = hasattr(SK, "classify")
        if has_classes:
            cls = SK.classify(a.indptr, a.nnz, a.cap)
            kernel = lambda: SK.spmm_call(*kargs, classes=cls)  # noqa: E731
        else:
            kernel = lambda: SK.spmm_call(*kargs)  # noqa: E731
        y = kernel()
        if not torch.equal(y, sref.spmm_plain(*kargs)):
            print(f"spmm_cost: {args.label} {name}: kernel differs from "
                  f"its plain version", file=sys.stderr)
            return 1
        nnz = int(a.nnz)
        sp = torch.sparse_csr_tensor(a.indptr.long(), a.indices[:nnz].long(),
                                     data[:nnz], size=a.shape)
        k_times = times(kernel)
        ms = {"kernel": k_times[len(k_times) // 2]}
        if has_classes:
            t = times(lambda: SK.spmm_call(*kargs))
            ms["kernel_classify"] = t[len(t) // 2]
        t = times(lambda: core.spmm(a, x))
        ms["spmm"] = t[len(t) // 2]
        t = times(lambda: torch.sparse.mm(sp, x))
        ms["torch_sparse_mm"] = t[len(t) // 2]
        stream, host = {}, {}
        stream["kernel"], host["kernel"] = _timing.stream_ms(torch, kernel)
        stream["torch_sparse_mm"], host["torch_sparse_mm"] = \
            _timing.stream_ms(torch, lambda: torch.sparse.mm(sp, x))
        if name != "ER":
            sources = np.random.default_rng(0).choice(
                n, 64, replace=False).tolist()
            t = times(lambda: ga.multi_source_bfs(a, sources, 6))
            ms["dense_bfs"] = t[len(t) // 2]
        print(json.dumps({
            "label": args.label, "input": name, "card": card,
            "m": a.n_rows, "nnz": nnz, "k": K,
            "max_row_nnz": int((a.indptr[1:] - a.indptr[:-1]).max()),
            "reps": args.reps, "ms": ms, "stream_ms": stream,
            "host_ms": host,
            "kernel_spread_ms": [k_times[0], k_times[-1]]}), flush=True)
        del a, x, sp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
