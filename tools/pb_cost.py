#!/usr/bin/env python3
"""Time the propagation-blocking (PB) kernels of one source tree on one
card, and repeat them to count wrong calls.

Cases (``--cases``, comma-separated), on ``chip_smoke.py``'s phase-6 plan
(R-MAT ER s18 ef16, seed 0, ``plan_pb(a, a)``, the recipe's sorted route):

* ``single``: ``scatter_call`` and ``merge_call`` (PERF.md rows 7 and
  8), and the sorted ``plan.execute``;
* ``fleets``: phase 14's value fleets -- 8 members of A's values (B's
  shared, dyadic), 4 members with A's and B's values batched, and 8
  members through ``plan_spgemm(sorted_output=True).execute`` -- through
  ``batched_scatter_call`` and ``batched_merge_call`` (rows 9 and 10) on
  the plan's shared index arrays, and ``torch.func.vmap`` of the
  execute (also its device time by kernel, from a ``torch.profiler``
  trace); where the tree has ``slot_major``, its copy of each stacked
  operand apart; the execute's consumer of the merge's output
  (``torch.where`` past nnz(C)) on the layout returned and on a
  member-major copy, and the copy;
* ``stacked``: the 8-member A fleet with the plan's index arrays stacked
  per member (the batched kernels' general path);
* ``rules``: the batched scatter on the first two fleets under each
  ``(inner, slot)`` choice of ``kernel.scatter_layout`` (members inside
  the block or a block a member; slot-major or member-major values), for
  a tree that has it, each checked bitwise against the plain version.

Each time is a median single-call CUDA-event time (``--reps`` runs after
2 warm-ups) and back to back (20 calls inside one CUDA event pair,
divided by 20: the card's time a call, ``_timing.stream_ms``), beside
the host's time to issue one.

``--stress N`` repeats each kernel call of ``single``, ``fleets`` and
``stacked`` ``N`` times on dyadic values and counts the wrong calls: a
call is wrong when its output is not bitwise the plain version's (on
dyadic values every product and sum is exact, so the plain merge's
atomics give the same bits).

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/pb_cost.py --src build/parent/src --label parent
    python3 tools/pb_cost.py --src src --label change

One JSON line per case, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

import _timing

ROOT = Path(__file__).resolve().parents[1]
CASES = ("single", "fleets", "stacked", "rules")
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


class Tree:
    """The modules of one source tree and phase 6's plan on its card."""

    def __init__(self, torch, src):
        sys.path.insert(0, str(Path(src).resolve()))
        import repro_torch.core as core
        from repro_torch.data import rmat
        from repro_torch.kernels.spgemm_pb import kernel as K
        from repro_torch.kernels.spgemm_pb import ref
        self.torch, self.core, self.K, self.ref = torch, core, K, ref
        self.dev = torch.device("cuda")
        self.a = rmat.rmat_csr(18, 16, "ER", seed=0, device=self.dev)
        self.plan = core.plan_spgemm(self.a, self.a, algorithm="auto",
                                     sorted_output=True)
        if self.plan.algorithm != "pb":
            raise SystemExit(f"pb_cost: the recipe chose "
                             f"{self.plan.algorithm}, not pb")
        self.p = self.plan.pb_plan

    def values(self, n, seed, dyadic):
        """``n`` members of new values on A's pattern, ``(n, cap)``, zero
        past nnz: dyadic, or uniform in [0.5, 1.5) (``chip_smoke.py``'s
        ``csr_fleet``)."""
        a = self.a
        rng = np.random.default_rng(seed)
        vals = DYADIC[rng.integers(0, 4, (n, a.cap))] if dyadic else \
            rng.uniform(0.5, 1.5, (n, a.cap)).astype(np.float32)
        live = self.torch.arange(a.cap, device=self.dev) < a.nnz
        return self.torch.from_numpy(vals).to(self.dev) * live


def times(torch, fn, reps):
    """``{"ms", "b2b", "host"}``: single-call median, back to back, the
    host's time to issue one."""
    b2b, host = _timing.stream_ms(torch, fn)
    return {"ms": _timing.median_ms(torch, fn, reps), "b2b": b2b,
            "host": host}


def wrong_calls(torch, calls, fn, want) -> int:
    """Calls of ``fn`` out of ``calls`` whose output is not bitwise
    ``want``."""
    wrong = 0
    for _ in range(calls):
        if not torch.equal(fn(), want):
            wrong += 1
    return wrong


def single_case(t, args):
    """Rows 7 and 8 and the sorted execute."""
    torch, K, ref, p, a = t.torch, t.K, t.ref, t.p, t.a
    pp = K.scatter_call(p.bucket_nnz, p.src_a, p.src_b, a.data, a.data)
    line = {
        "scatter": times(torch, lambda: K.scatter_call(
            p.bucket_nnz, p.src_a, p.src_b, a.data, a.data), args.reps),
        "merge": times(torch, lambda: K.merge_call(
            p.bucket_nnz, p.seg, pp, p.cap_c), args.reps),
        "execute": times(torch, lambda: t.plan.execute(a, a), args.reps)}
    if args.stress:
        x = t.values(1, 7, True)[0]
        pp = K.scatter_call(p.bucket_nnz, p.src_a, p.src_b, x, x)
        want_pp = ref.scatter_plain(p.bucket_nnz, p.src_a, p.src_b, x, x)
        want = ref.merge_plain(p.bucket_nnz, p.seg, want_pp, p.cap_c)
        line["stress"] = {
            "calls": args.stress,
            "wrong_scatter": wrong_calls(torch, args.stress, lambda: K.
                                         scatter_call(p.bucket_nnz, p.src_a,
                                                      p.src_b, x, x),
                                         want_pp),
            "wrong_merge": wrong_calls(torch, args.stress, lambda: K.
                                       merge_call(p.bucket_nnz, p.seg, pp,
                                                  p.cap_c), want)}
    return line


def fleets(t, dyadic):
    """Phase 14's fleets: ``[(name, execute, A's values, B's values)]``,
    B's shared (``a.data``, dyadic) unless batched."""
    shared_b = t.values(1, 3, True)[0]
    return [("ER s18 x8, A batched", t.p.execute, t.values(8, 80, dyadic),
             shared_b),
            ("ER s18 x4, A and B batched", t.p.execute,
             t.values(4, 90, dyadic), t.values(4, 100, dyadic)),
            ("ER s18 x8 via plan_spgemm, A batched", t.plan.execute,
             t.values(8, 110, dyadic), shared_b)]


def fleet_line(t, name, execute, xa, xb, idx, args):
    """The batched pair (and, on shared indices, the vmapped execute) on
    one fleet; ``idx``: the index arrays ``(bucket_nnz, src_a, src_b,
    seg)``, shared or stacked."""
    torch, K, p, a = t.torch, t.K, t.p, t.a
    n = xa.shape[0]
    bnz, sa, sb, seg = idx
    pp = K.batched_scatter_call(bnz, sa, sb, xa, xb, n_members=n)
    line = {"case": name, "members": n,
            "batched_scatter": times(torch, lambda: K.batched_scatter_call(
                bnz, sa, sb, xa, xb, n_members=n), args.reps),
            "batched_merge": times(torch, lambda: K.batched_merge_call(
                bnz, seg, pp, p.cap_c, n_members=n), args.reps)}
    if hasattr(K, "slot_major"):
        for side, x in (("a", xa), ("b", xb)):
            if x.dim() == 2:
                line[f"slot_major_{side}"] = times(
                    torch, lambda x=x: K.slot_major(x), args.reps)
    if bnz.dim() == 1:
        def one(x, y):
            return execute(dataclasses.replace(a, data=x),
                           dataclasses.replace(a, data=y)).data

        dims = (0, 0 if xb.dim() == 2 else None)

        def vmapped():
            return torch.func.vmap(one, in_dims=dims)(xa, xb)

        line["vmap_execute"] = times(torch, vmapped, args.reps)
        line["vmap_execute_device"] = device_ms_by_kernel(torch, vmapped)
        # the execute's consumer of the merge's output (spgemm_pb's mask
        # past nnz(C)) on the layout returned and on a member-major copy
        out = K.batched_merge_call(bnz, seg, pp, p.cap_c, n_members=n)
        rows = out.contiguous()
        valid = torch.arange(p.cap_c, device=t.dev) < p.nnz_c
        line["consumer"] = {
            "returned": times(torch, lambda: torch.where(valid, out, 0.0),
                              args.reps),
            "member_major": times(torch, lambda: torch.where(valid, rows,
                                                             0.0),
                                  args.reps),
            "contiguous_copy": times(torch, lambda: out.contiguous(),
                                     args.reps),
            "returned_strides": list(out.stride())}
    return line


def device_ms_by_kernel(torch, fn, top: int = 8) -> dict:
    """Device ms of one call of ``fn`` by kernel name (the ``top``
    largest) and in all, from a ``torch.profiler`` trace of one call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_time_total > 0 and e.device_type
                   == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    return {"total": sum(ms for _, ms in rows),
            "kernels": {k[:60]: ms for k, ms in rows[:top]}}


def stress_fleet(t, xa, xb, idx, calls):
    """Wrong calls of the batched pair on a dyadic fleet against the
    batched plain versions."""
    torch, K, ref, p = t.torch, t.K, t.ref, t.p
    n = xa.shape[0]
    bnz, sa, sb, seg = idx
    want_pp = ref.batched_scatter_plain(bnz, sa, sb, xa, xb, n)
    want = ref.batched_merge_plain(bnz, seg, want_pp, p.cap_c, n)
    return {"calls": calls,
            "wrong_scatter": wrong_calls(torch, calls, lambda: K.
                                         batched_scatter_call(
                                             bnz, sa, sb, xa, xb,
                                             n_members=n), want_pp),
            "wrong_merge": wrong_calls(torch, calls, lambda: K.
                                       batched_merge_call(
                                           bnz, seg, want_pp, p.cap_c,
                                           n_members=n).contiguous(), want)}


def rules_case(t, args):
    """The batched scatter under each ``scatter_layout`` choice."""
    torch, K, ref, p = t.torch, t.K, t.ref, t.p
    if not hasattr(K, "scatter_layout"):
        return {"skipped": "tree has no scatter_layout"}
    idx = (p.bucket_nnz, p.src_a, p.src_b)
    rule = K.scatter_layout
    out = []
    try:
        for name, _, xa, xb in fleets(t, False)[:2]:
            n = xa.shape[0]
            want = ref.batched_scatter_plain(*idx, xa, xb, n)
            line = {"case": name}
            for inner, slot in ((True, True), (True, False),
                                (False, False)):
                K.scatter_layout = lambda *_, c=(inner, slot): c
                got = K.batched_scatter_call(*idx, xa, xb, n_members=n)
                if not torch.equal(got, want):
                    raise SystemExit(f"pb_cost: {name} inner={inner} "
                                     f"slot={slot} differs from the plain "
                                     f"version")
                del got
                line[f"inner={inner},slot={slot}"] = times(
                    torch, lambda: K.batched_scatter_call(
                        *idx, xa, xb, n_members=n), args.reps)
            out.append(line)
    finally:
        K.scatter_layout = rule
    return {"fleets": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--stress", type=int, default=0)
    args = ap.parse_args()
    cases = args.cases.split(",")
    if any(c not in CASES for c in cases):
        ap.error(f"cases are {', '.join(CASES)}")
    import torch
    if not torch.cuda.is_available():
        print("pb_cost: no CUDA device", file=sys.stderr)
        return 2
    card = _timing.card()
    t = Tree(torch, args.src)
    p = t.p
    head = {"label": args.label, "card": card, "n_buckets": p.n_buckets,
            "bucket_w": p.bucket_w, "bucket_cap": p.bucket_cap,
            "flop": p.total_flop, "nnz_c": p.nnz_c}
    shared = (p.bucket_nnz, p.src_a, p.src_b, p.seg)
    for case in cases:
        if case == "single":
            lines = [{"case": "single ER s18 ef16 sorted",
                      **single_case(t, args)}]
        elif case == "rules":
            lines = [{"case": "scatter_layout choices", **rules_case(t, args)}]
        else:
            lines = []
            chosen = fleets(t, False) if case == "fleets" \
                else fleets(t, False)[:1]
            dyadic = fleets(t, True)
            for (name, execute, xa, xb), (_, _, da, db) in zip(chosen,
                                                               dyadic):
                n = xa.shape[0]
                idx = shared if case == "fleets" else \
                    [torch.stack([x] * n) for x in shared]
                line = fleet_line(t, name, execute, xa, xb, idx, args)
                if args.stress:
                    line["stress"] = stress_fleet(t, da, db, idx,
                                                  args.stress)
                line["indices"] = "shared" if case == "fleets" \
                    else "stacked"
                lines.append(line)
                del idx
                torch.cuda.empty_cache()
        for line in lines:
            print(json.dumps({**head, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
