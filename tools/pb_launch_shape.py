#!/usr/bin/env python3
"""Time the single-product PB kernels at three launch shapes on one card.

``scatter_call`` and ``merge_call`` (``repro_torch/kernels/spgemm_pb``)
launch ``min(n_buckets, MAX_BLOCKS)`` blocks, each walking about eight
buckets with a grid stride.  This script times, on the sorted PB plan of
``chip_smoke.py`` phase 6 (R-MAT ER s18 ef16, seed 0, ``A @ A``):

* ``shipped``: the wrappers as they are;
* ``per_bucket``: the same single-product kernels with one block per
  bucket (``MAX_BLOCKS`` raised to ``n_buckets`` for the call);
* ``batched_1``: the batched kernels at one member, every argument
  shared (member stride 0), which also launch one block per bucket.

Every variant's output must equal the shipped one bitwise (the bucket
body is the same code).  The variants run in the order shipped,
per_bucket, batched_1, batched_1, per_bucket, shipped, each timed as the
median of 15 CUDA-event runs, so that a drift in the card's clock shows.

Run from the repo root on a machine with a CUDA card::

    python3 tools/pb_launch_shape.py

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line of times in ms.  Exits 2 without a card.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import _timing

ROOT = Path(__file__).resolve().parents[1]
REPS = 15


def median_ms(torch, fn, reps: int = REPS) -> float:
    return _timing.median_ms(torch, fn, reps)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pb_launch_shape: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.data import rmat
    from repro_torch.kernels.spgemm_pb import kernel as K

    card = _timing.card()
    print(card, flush=True)
    a = rmat.rmat_csr(18, 16, "ER", seed=0, device=torch.device("cuda"))
    p = core.plan_pb(a, a)
    nb = p.n_buckets

    @contextlib.contextmanager
    def blocks(n):
        """The single-product wrappers launch at most ``n`` blocks."""
        saved, K.MAX_BLOCKS = K.MAX_BLOCKS, n
        try:
            yield
        finally:
            K.MAX_BLOCKS = saved

    def single(pp):
        return (lambda: K.scatter_call(p.bucket_nnz, p.src_a, p.src_b,
                                       a.data, a.data),
                lambda: K.merge_call(p.bucket_nnz, p.seg, pp, p.cap_c))

    def batched(pp):
        return (lambda: K.batched_scatter_call(
                    p.bucket_nnz, p.src_a, p.src_b, a.data, a.data,
                    n_members=1)[0],
                lambda: K.batched_merge_call(p.bucket_nnz, p.seg, pp,
                                             p.cap_c, n_members=1)[0])

    # name: (launch bound, scatter and merge callables given pp)
    variants = {"shipped": (K.MAX_BLOCKS, single),
                "per_bucket": (nb, single),
                "batched_1": (K.MAX_BLOCKS, batched)}
    want_pp = single(None)[0]()
    want_c = single(want_pp)[1]()
    for name, (limit, calls) in variants.items():
        with blocks(limit):
            pp = calls(None)[0]()
            c = calls(pp)[1]()
        if not (torch.equal(pp, want_pp) and torch.equal(c, want_c)):
            print(f"pb_launch_shape: {name} differs from the shipped "
                  f"launch", file=sys.stderr)
            return 1
    ms = {name: {"scatter": [], "merge": []} for name in variants}
    for name in ("shipped", "per_bucket", "batched_1", "batched_1",
                 "per_bucket", "shipped"):
        limit, calls = variants[name]
        scatter, merge = calls(want_pp)
        with blocks(limit):
            ms[name]["scatter"].append(median_ms(torch, scatter))
            ms[name]["merge"].append(median_ms(torch, merge))
    print(json.dumps({"pb_launch_shape": "ER s18 ef16 sorted plan",
                      "card": card, "n_buckets": nb,
                      "bucket_cap": p.bucket_cap,
                      "shipped_blocks": min(nb, K.MAX_BLOCKS),
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
