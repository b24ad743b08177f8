#!/usr/bin/env python3
"""Time the SSD chunk-scan kernels of one source tree on one card.

At mamba2-780m's SSD widths (48 heads of head dim 64, one group, state
128, chunks of 256; ``chip_smoke.py`` phase 19's inputs, bf16, B 1) for
each length in ``--lengths``, prints the median single-call CUDA-event
times (``--reps`` runs after 2 warm-ups) and the back-to-back times (20
calls inside one CUDA event pair, divided by 20: the card's time a call,
beside the host's time to issue one, ``_timing.stream_ms``) of:

* ``kernel``: ``kernel.ssd_fwd`` as the model calls it (the kernel the
  tree picks: the CUDA-core one in a tree without the tensor-core one);
* ``passes``: where the tree has the tensor-core kernel, its passes
  cumulatively, back to back: (a), (a)+(b), (a)+(b)+(c);
* ``plain``: ``ref.ssd_chunked`` (``--plain``).

and, with ``--sweep``, the tensor-core kernel back to back at other heads
a block of pass (a) and of pass (c).  Each kernel's output is checked
against the plain version once (one bf16 ulp plus phase 19's tolerance).

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/ssd_cost.py --src build/parent/src --label parent
    python3 tools/ssd_cost.py --src src --label change

One JSON line per length, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import _timing

ROOT = Path(__file__).resolve().parents[1]
HEADS, HEAD_DIM, STATE, CHUNK = 48, 64, 128, 256
SSD_REL = 1e-4
SWEEP = ((2, 8), (4, 4), (4, 6), (4, 8), (4, 12), (8, 8), (4, 16))


def inputs(torch, s, seed, dev):
    """Phase 19's draws: x ~ N(0, 1), dt = softplus(N(0, 1)), A spanning
    1..16 over the heads, log_a = -dt A, xd = x dt, B and C ~ N(0, 1)."""
    gen = torch.Generator(dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((1, s, HEADS),
                                                  generator=gen, device=dev))
    A = torch.linspace(1.0, 16.0, HEADS, device=dev)
    x = torch.randn((1, s, HEADS, HEAD_DIM), generator=gen, device=dev)
    Bm, Cm = (torch.randn((1, s, 1, STATE), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    return (x * dt[..., None]).to(torch.bfloat16), -dt * A, Bm, Cm


def bad_values(torch, y, yw, la, q) -> tuple:
    """(values of y past one bf16 ulp plus phase 19's tolerance of the
    plain output, max abs diff)."""
    b, s, nh = la.shape
    cum = float(-la.reshape(b, s // q, q, nh).sum(2).min())
    tol = (SSD_REL + 8 * torch.finfo(torch.float32).eps * cum) * \
        max(1.0, float(yw.float().abs().max()))
    _, e = yw.float().abs().frexp()
    d = (y.float() - yw.float()).abs()
    return int((d > (e.float() - 8).exp2() + tol).sum()), float(d.max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--lengths", default="4096,32768")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.ssd_chunk import kernel as K
    from repro_torch.kernels.ssd_chunk import ref
    card = _timing.card()
    dev = torch.device("cuda")
    has_tc = hasattr(K, "tc_passes")

    for s in (int(x) for x in args.lengths.split(",")):
        q = min(CHUNK, s)
        xd, la, Bm, Cm = inputs(torch, s, 400 + s, dev)

        def kernel():
            return K.ssd_fwd(xd, la, Bm, Cm, q)
        yw, _ = ref.ssd_chunked(xd, la, Bm, Cm, q)
        y, _ = kernel()
        torch.cuda.synchronize()
        bad, err = bad_values(torch, y, yw, la, q)
        if bad:
            print(f"ssd_cost: {args.label} S {s}: {bad} values past one "
                  f"bf16 ulp plus the tolerance (max abs diff {err})",
                  file=sys.stderr)
            return 1
        del yw, y
        ms = {"kernel": _timing.median_ms(torch, kernel, args.reps)}
        stream, host = {}, {}
        stream["kernel"], host["kernel"] = _timing.stream_ms(torch, kernel)
        if has_tc:
            for mask, name in ((1, "a"), (3, "ab"), (7, "abc")):
                stream[f"passes_{name}"], _ = _timing.stream_ms(
                    torch, lambda: K.tc_passes(xd, la, Bm, Cm, q, mask))
            if args.sweep:
                for heads in SWEEP:
                    stream[f"heads_{heads[0]}_{heads[1]}"], _ = \
                        _timing.stream_ms(torch, lambda: K.tc_passes(
                            xd, la, Bm, Cm, q, 7, heads))
        if args.plain:
            ms["plain"] = _timing.median_ms(
                torch, lambda: ref.ssd_chunked(xd, la, Bm, Cm, q), 3, 1)
        print(json.dumps({
            "label": args.label, "timing": f"ssd_chunk bf16 B 1 nh {HEADS} "
            f"hp {HEAD_DIM} g 1 n {STATE} S {s} Q {q}", "card": card,
            "variant": K.variant(xd, Bm, Cm) if has_tc else "fma",
            "reps": args.reps, "ms": ms, "stream_ms": stream,
            "host_ms": host, "max_abs_diff": err}), flush=True)
        del xd, la, Bm, Cm
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
