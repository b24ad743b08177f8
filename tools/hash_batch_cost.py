#!/usr/bin/env python3
"""Time the hash kernels' batched grids (and the single-product numeric
kernel) of one source tree on one card, and repeat them to count wrong
calls.

Cases (``--cases``, comma-separated), on ``chip_smoke.py``'s inputs:

* ``squares``: ``plan_batch`` of two G500 s16 ef16 squares (seeds 0, 1);
* ``moe``: MoE dispatch at qwen3-moe-30b-a3b's routing widths (128
  experts, top-8, d_model 2,048, 16,384 tokens, feature density 0.05);
* ``fleet``: ``rmat_fleet(64, 10)``;
* ``vmap_g500``: the G500 s16 hash plan's values, 2 members of A's;
* ``vmap_er``: the ER s18 hash plan's values, 8 members of A's;
* ``single``: the single-product numeric kernel (rows 1 and 3: scalar and
  chunked probe) and symbolic kernel (row 2, scalar) on ER s18 and G500
  s16;
* ``symbolic``: the single-product symbolic kernel (row 2), scalar and
  chunked probe, on ER s18 and G500 s16 (the plan's schedule) and on the
  block patterns of ``chip_smoke.py``'s phase 7 (ER-pattern s13 ef8,
  G500-pattern s10 ef8: the BCSR inspection's schedule), with B's width
  where the tree takes it; on ER and G500 also the planless front door
  ``core.spgemm(a, a, cap, algorithm="hash")`` beside one
  ``torch.sparse.mm`` of the same product;
* ``patterns``: the ``symbolic`` case's block patterns alone, scalar probe
  (the BCSR inspection's symbolic call), with the spread of the single
  calls (lowest, median, highest of ``--reps``) and the card's busy time
  a call (every device operation of 5 calls in a ``torch.profiler``
  trace, divided by 5), to tell the card's work from the host's.

For each batched case: the batched numeric kernel over every hash class
of the plan (``plan_batch``) or over the members (vmap fleets), the
batched symbolic kernel (vmap fleets), and the front door
(``plan.execute``, the vmapped execute), each as a median single-call
CUDA-event time (``--reps`` runs after 2 warm-ups) and back to back (20
calls inside one CUDA event pair, divided by 20: the card's time a call,
``_timing.stream_ms``), beside the host's time to issue one.  The kernels
get the schedule's launch data precomputed, as the plans pass it, so a
back-to-back run holds no host synchronisation.  The single-product
wrappers read the bins back every call, so for ``single`` the numeric
kernels' device time a call is also taken from a ``torch.profiler``
trace of 5 calls (the classifying and class kernels' sums).

``--stress N`` repeats each batched kernel (and, for ``single``, the
numeric kernel; for ``symbolic``, the symbolic kernel in both probe modes)
``N`` times on dyadic values and counts the wrong calls: a call is wrong
when its ``errors`` counter is not zero or when any row's order-free
checksum (each entry's column and value bits mixed and summed per row;
symbolic: the row counts themselves, against ESC's or the plain
version's) differs from the plain version's.

``--src`` names the tree's ``src`` directory, so two trees (a parent and
its change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) can be timed in turns in one call on one card::

    python3 tools/hash_batch_cost.py --src build/parent/src --label parent
    python3 tools/hash_batch_cost.py --src src --label change

One JSON line per case, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import sys
from pathlib import Path

import numpy as np

import _timing

ROOT = Path(__file__).resolve().parents[1]
CASES = ("squares", "moe", "fleet", "vmap_g500", "vmap_er", "single",
         "symbolic", "patterns")
DYADIC = np.array([0.5, 1.0, 1.5, 2.0], np.float32)


class Tree:
    """The modules of one source tree and its batched calls' launch data:
    the class-ordered tree takes ``largest=`` (``fleet_table``), an older
    one ``launches=`` (``batched_launches``)."""

    def __init__(self, torch, src):
        sys.path.insert(0, str(Path(src).resolve()))
        import repro_torch.core as core
        from repro_torch.core import batch
        from repro_torch.data import rmat
        from repro_torch.kernels.spgemm_hash import kernel as K
        from repro_torch.kernels.spgemm_hash import ref
        self.torch, self.core, self.batch, self.rmat = torch, core, batch, rmat
        self.K, self.ref = K, ref
        self.by_classes = "largest" in inspect.signature(
            K.batched_numeric_call).parameters
        #: whether the symbolic wrappers take B's width (the bitmap class)
        self.has_width = "n_cols" in inspect.signature(
            K.symbolic_call).parameters
        self.dev = torch.device("cuda")

    def width(self, n_cols) -> dict:
        """The symbolic wrappers' B-width argument, where the tree has it."""
        return {"n_cols": n_cols} if self.has_width else {}

    def launch_kw(self, offsets, bin_tsize, n, table, n_rows, vector):
        """The batched calls' precomputed launch data for a schedule
        (stacked or shared)."""
        rows = offsets.tolist() if offsets.dim() == 2 \
            else [offsets.tolist()] * n
        sizes = bin_tsize.tolist() if bin_tsize.dim() == 2 \
            else [bin_tsize.tolist()] * n
        if self.by_classes:
            return {"largest": self.K.fleet_table(rows, sizes, table, n_rows,
                                                  vector)}
        return {"launches": self.K.batched_launches(rows, sizes, table,
                                                    n_rows, vector)}

    def dyadic(self, a, seed):
        rng = np.random.default_rng(seed)
        d = np.zeros(a.cap, np.float32)
        d[:int(a.nnz)] = rng.choice(DYADIC, int(a.nnz))
        return dataclasses.replace(a, data=self.torch.from_numpy(d).to(
            self.dev))

    def values(self, a, n, seed, dyadic):
        """``n`` members of new values on ``a``'s pattern, zero past nnz:
        dyadic, or uniform in [0.5, 1.5) (``chip_smoke.csr_fleet``)."""
        rng = np.random.default_rng(seed)
        vals = DYADIC[rng.integers(0, 4, (n, a.cap))] if dyadic else \
            rng.uniform(0.5, 1.5, (n, a.cap)).astype(np.float32)
        live = self.torch.arange(a.cap, device=self.dev) < a.nnz
        return self.torch.from_numpy(vals).to(self.dev) * live


def checksum(torch, indptr, cols, vals):
    """Each row's order-free checksum of its entries (column and value
    bits mixed, summed with int64 wraparound), ``(m,) int64``."""
    m = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(m, device=cols.device),
        (indptr[1:] - indptr[:-1]).long(), output_size=nnz)
    mix = cols[:nnz].long() * 0x9E3779B1 + \
        vals[:nnz].contiguous().view(torch.int32).long() * 0x85EBCA77
    mix = mix ^ (mix >> 29)
    return torch.zeros(m, dtype=torch.int64,
                       device=cols.device).index_add_(0, rows, mix)


def class_kernels(t, plan, pairs, dyadic_pairs=None):
    """The batched numeric kernel's calls over ``plan``'s hash classes, as
    the class executors make them: ``[(args, kw, members)]``."""
    out = []
    for cls in plan.classes:
        if cls.hash_sched is None:
            raise SystemExit(f"hash_batch_cost: a class of algorithm "
                             f"{cls.algorithm}, not the hash kernel")
        src = dyadic_pairs or pairs
        (M, Kc), (_, N) = cls.shape_a, cls.shape_b

        def side(k, rows, cols, cap, shared):
            ops = [src[i][k] for i in cls.members]
            if shared:
                return ops[0]
            return t.batch._stack_csr(ops, cols, True,
                                      t.batch._stack_index(ops, rows, cap))

        a = side(0, M, Kc, cls.cap_a, cls.a_shared)
        b = side(1, Kc, N, cls.cap_b, cls.b_shared)
        off, bts, ic = cls.hash_sched
        args = (off, bts, a.indptr, b.indptr, ic, a.indices,
                a.data.float(), b.indices, b.data.float())
        kw = dict(n_members=cls.n_members, cap_c=cls.cap_c,
                  table_size=cls.table_size,
                  **t.launch_kw(off, bts, cls.n_members, cls.table_size, M,
                                False))
        out.append((args, kw, [src[i] for i in cls.members]))
    return out


def device_ms(torch, fn, reps: int = 5) -> float:
    """Device ms a call of ``fn`` in the hash classifying and class
    kernels, from a ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "hash_class_kernel" in e.key or "classify_kernel" in e.key)
    return us / reps / 1e3


def busy_ms(torch, fn, reps: int = 5) -> float:
    """The card's busy ms a call of ``fn``: every device operation
    (kernels, copies, fills) of ``reps`` calls in a ``torch.profiler``
    trace, summed and divided by ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def pattern_case(t, label, a, sched, args) -> dict:
    """The single-product symbolic kernel, scalar probe, on a block
    pattern's inspection schedule: the single calls' lowest, median and
    highest CUDA-event times, back to back, the host's time to issue one
    and the card's busy time a call; counts against the plain version."""
    torch, K, ref = t.torch, t.K, t.ref
    off, bts, table = sched
    ops_args = (a.indptr, a.indptr, a.indices, a.data.float(), a.indices,
                a.data.float())
    errors = torch.zeros(1, dtype=torch.int32, device=t.dev)

    def call():
        return K.symbolic_call(off, bts, *ops_args, table_size=table,
                               vector=False, errors=errors,
                               **t.width(a.n_cols))

    times = _timing.event_times(torch, call, args.reps)
    stream, host = _timing.stream_ms(torch, call)
    want = ref.symbolic_plain(off, bts, *ops_args, table_size=table,
                              vector=False)
    return {"label": args.label, "case": label, "width": t.has_width,
            "ms": {"low": times[0], "median": times[len(times) // 2],
                   "high": times[-1]},
            "stream_ms": stream, "host_ms": host,
            "busy_ms": busy_ms(torch, call),
            "right": torch.equal(call(), want) and int(errors) == 0}


def time_all(t, fns: dict, reps: int) -> dict:
    torch = t.torch
    ms, stream, host = {}, {}, {}
    for name, fn in fns.items():
        ms[name] = _timing.median_ms(torch, fn, reps)
        stream[name], host[name] = _timing.stream_ms(torch, fn)
    return {"ms": ms, "stream_ms": stream, "host_ms": host}


def stress_numeric(t, calls, fn, want, ic_rows):
    """Wrong calls of ``fn`` (-> cols, vals, each ``(n, cap)``) among
    ``calls`` against the plain checksums ``want[e]``."""
    torch = t.torch
    errors = torch.zeros(1, dtype=torch.int32, device=t.dev)
    wrong = 0
    for _ in range(calls):
        errors.zero_()
        cols, vals = fn(errors)
        bad = int(errors) != 0
        for e, ic in enumerate(ic_rows):
            if bad:
                break
            bad = not torch.equal(checksum(torch, ic, cols[e], vals[e]),
                                  want[e])
        wrong += bad
        del cols, vals
    return wrong


def batch_case(t, label, pairs, args):
    """``plan_batch(pairs).execute`` and the batched numeric kernel over
    its classes: timings, then (``--stress``) the wrong calls of the
    kernel on dyadic values."""
    torch, core, K, ref = t.torch, t.core, t.K, t.ref
    core.clear_plan_cache()
    plan = core.plan_batch(pairs)
    kernels = class_kernels(t, plan, pairs)
    errors = torch.zeros(1, dtype=torch.int32, device=t.dev)

    def numeric():
        for a, kw, _ in kernels:
            K.batched_numeric_call(*a, **kw, vector=False, errors=errors)

    plan.execute(pairs)
    line = {"label": args.label, "case": label, "products": len(pairs),
            "classes": plan.n_classes,
            **time_all(t, {"execute": lambda: plan.execute(pairs),
                           "batched_numeric": numeric}, args.reps)}
    torch.cuda.synchronize()
    line["errors"] = int(errors)
    if args.stress:
        seen, dy = {}, []
        for a, b in pairs:
            for x in (a, b):
                if id(x) not in seen:
                    seen[id(x)] = t.dyadic(x, len(seen))
            dy.append((seen[id(a)], seen[id(b)]))
        wrong = 0
        for a, kw, members in class_kernels(t, plan, pairs, dy):
            kw = dict(kw)
            pc, pv = ref.batched_numeric_plain(
                *a, n_members=kw["n_members"], cap_c=kw["cap_c"],
                table_size=kw["table_size"], vector=False)
            ic = [a[4][e, :x.n_rows + 1] for e, (x, _) in enumerate(members)]
            want = [checksum(torch, i, pc[e], pv[e])
                    for e, i in enumerate(ic)]
            del pc, pv
            wrong += stress_numeric(
                t, args.stress, lambda err: K.batched_numeric_call(
                    *a, **kw, vector=False, errors=err), want, ic)
        line["stress"] = {"calls": args.stress, "wrong": wrong}
    del plan, kernels
    core.clear_plan_cache()
    return line


def vmap_case(t, label, a, n, args):
    """``torch.func.vmap`` of the hash plan's execute over ``n`` members
    of A's values (B the dyadic A, shared) and the batched kernels of both
    phases on the same arguments: timings, then (``--stress``) the wrong
    calls of each batched kernel on dyadic values."""
    torch, core, K, ref = t.torch, t.core, t.K, t.ref
    core.clear_plan_cache()
    plan = core.plan_spgemm(a, a, algorithm="hash")
    b = t.dyadic(a, 99)
    table, m, cap_c = plan.table_size, a.n_rows, plan.cap_c
    sched = (plan.offsets, plan.bin_tsize)
    lkw = t.launch_kw(plan.offsets, plan.bin_tsize, n, table, m, False)
    errors = torch.zeros(1, dtype=torch.int32, device=t.dev)

    def numeric(vals, err=errors):
        return K.batched_numeric_call(
            *sched, a.indptr, a.indptr, plan.indptr_c, a.indices, vals,
            a.indices, b.data, n_members=n, cap_c=cap_c, table_size=table,
            vector=False, errors=err, **lkw)

    def symbolic(vals, err=errors):
        return K.batched_symbolic_call(
            *sched, a.indptr, a.indptr, a.indices, vals, a.indices, b.data,
            n_members=n, table_size=table, vector=False, errors=err, **lkw,
            **t.width(a.n_cols))

    def vmapped(vals):
        return torch.func.vmap(lambda x: plan.execute(
            dataclasses.replace(a, data=x), b).data)(vals)

    vals = t.values(a, n, 7, False)
    line = {"label": args.label, "case": label, "members": n,
            **time_all(t, {
                "vmap_execute": lambda: vmapped(vals),
                "batched_numeric": lambda: numeric(vals),
                "batched_symbolic": lambda: symbolic(vals),
                "loop_numeric": lambda: [K.numeric_call(
                    *sched, a.indptr, a.indptr, plan.indptr_c, a.indices,
                    vals[e], a.indices, b.data, cap_c=cap_c,
                    table_size=table, vector=False, errors=errors)
                    for e in range(n)]}, args.reps)}
    torch.cuda.synchronize()
    line["errors"] = int(errors)
    if args.stress:
        dv = t.values(a, n, 8, True)
        sym_want = plan.row_nnz_c.expand(n, -1)
        pc, pv = ref.batched_numeric_plain(
            *sched, a.indptr, a.indptr, plan.indptr_c, a.indices, dv,
            a.indices, b.data, n_members=n, cap_c=cap_c, table_size=table,
            vector=False)
        want = [checksum(torch, plan.indptr_c, pc[e], pv[e])
                for e in range(n)]
        del pc, pv
        wrong = stress_numeric(t, args.stress, lambda err: numeric(dv, err),
                               want, [plan.indptr_c] * n)
        wrong_sym = 0
        err = torch.zeros(1, dtype=torch.int32, device=t.dev)
        for _ in range(args.stress):
            err.zero_()
            rows = symbolic(dv, err)
            wrong_sym += int(err) != 0 or not torch.equal(rows, sym_want)
        line["stress"] = {"calls": args.stress, "wrong_numeric": wrong,
                          "wrong_symbolic": wrong_sym}
    del plan
    core.clear_plan_cache()
    return line


def single_case(t, label, a, args):
    """The single-product numeric kernel, scalar and chunked probe (rows
    1 and 3), and the symbolic kernel (row 2), on the hash plan of
    ``a @ a``."""
    torch, core, K, ref = t.torch, t.core, t.K, t.ref
    core.clear_plan_cache()
    plan = core.plan_spgemm(a, a, algorithm="hash")
    d = t.dyadic(a, 5)
    errors = torch.zeros(1, dtype=torch.int32, device=t.dev)

    def call(vector, x=a, err=errors):
        return K.numeric_call(plan.offsets, plan.bin_tsize, x.indptr,
                              x.indptr, plan.indptr_c, x.indices,
                              x.data.float(), x.indices, x.data.float(),
                              cap_c=plan.cap_c, table_size=plan.table_size,
                              vector=vector, errors=err)

    def symbolic():
        return K.symbolic_call(plan.offsets, plan.bin_tsize, a.indptr,
                               a.indptr, a.indices, a.data.float(),
                               a.indices, a.data.float(),
                               table_size=plan.table_size, vector=False,
                               errors=errors, **t.width(a.n_cols))

    line = {"label": args.label, "case": label,
            **time_all(t, {"numeric": lambda: call(False),
                           "numeric_vector": lambda: call(True),
                           "symbolic": symbolic}, args.reps)}
    line["device_ms"] = {"numeric": device_ms(torch, lambda: call(False)),
                         "numeric_vector": device_ms(torch,
                                                     lambda: call(True))}
    torch.cuda.synchronize()
    line["errors"] = int(errors)
    if args.stress:
        pc, pv = ref.numeric_plain(
            plan.offsets, plan.bin_tsize, d.indptr, d.indptr, plan.indptr_c,
            d.indices, d.data, d.indices, d.data, cap_c=plan.cap_c,
            table_size=plan.table_size, vector=False)
        want = [checksum(torch, plan.indptr_c, pc, pv)]
        del pc, pv
        line["stress"] = {"calls": args.stress}
        for vector in (False, True):
            line["stress"]["wrong_vector" if vector else "wrong"] = \
                stress_numeric(t, args.stress, lambda err: [
                    x[None] for x in call(vector, d, err)], want,
                    [plan.indptr_c])
    del plan
    core.clear_plan_cache()
    return line


def symbolic_case(t, label, a, args, plan=None, sched=None, want=None):
    """The single-product symbolic kernel, scalar and chunked probe, on
    ``a @ a`` with B's width: on the hash plan's schedule (``want``: its
    ESC counts), or on ``sched = (offsets, bin_tsize, table_size)`` (a
    block pattern; ``want``: the plain version's counts).  With a plan,
    also the planless front door and ``torch.sparse.mm``.  Timings, then
    (``--stress``) the wrong calls of each probe mode."""
    torch, core, K, ref = t.torch, t.core, t.K, t.ref
    if plan is not None:
        sched = (plan.offsets, plan.bin_tsize, plan.table_size)
        want = plan.row_nnz_c
    off, bts, table = sched
    ops_args = (a.indptr, a.indptr, a.indices, a.data.float(), a.indices,
                a.data.float())
    if want is None:
        want = ref.symbolic_plain(off, bts, *ops_args, table_size=table,
                                  vector=False)
    errors = torch.zeros(1, dtype=torch.int32, device=t.dev)

    def call(vector, err=errors):
        return K.symbolic_call(off, bts, *ops_args, table_size=table,
                               vector=vector, errors=err, **t.width(a.n_cols))

    fns = {"symbolic": lambda: call(False),
           "symbolic_vector": lambda: call(True)}
    if plan is not None:
        nnz = int(a.nnz)
        sp = torch.sparse_csr_tensor(a.indptr.long(), a.indices[:nnz].long(),
                                     a.data[:nnz], size=a.shape)
        fns["planless"] = lambda: core.spgemm(a, a, plan.cap_c,
                                              algorithm="hash")
        fns["torch_sparse_mm"] = lambda: torch.sparse.mm(sp, sp)
    line = {"label": args.label, "case": label, "width": t.has_width,
            **time_all(t, fns, args.reps)}
    torch.cuda.synchronize()
    line["errors"] = int(errors)
    line["right"] = all(torch.equal(call(v), want) for v in (False, True))
    if args.stress:
        line["stress"] = {"calls": args.stress}
        err = torch.zeros(1, dtype=torch.int32, device=t.dev)
        for vector in (False, True):
            wrong = 0
            for _ in range(args.stress):
                err.zero_()
                rows = call(vector, err)
                wrong += int(err) != 0 or not torch.equal(rows, want)
            line["stress"]["wrong_vector" if vector else "wrong"] = wrong
    return line


def block_pattern(t, preset, scale, ef):
    """The block-occupancy pattern of ``chip_smoke.py``'s phase 7 input
    (R-MAT block edges, seed 0, over a 2^scale grid) as a CSR of ones, and
    the BCSR inspection's schedule on it (``bcsr_inspect``'s:
    ``hash_schedule`` of the pattern, 8 bins)."""
    from repro_torch.kernels.spgemm_hash import ops
    br, bc = t.rmat.rmat_edges(scale, ef, preset, seed=0)
    g = 1 << scale
    key = np.unique(br.astype(np.int64) * g + bc)
    p = t.core.CSR.from_numpy_coo(key // g, key % g,
                                  np.ones(key.shape[0], np.float32), (g, g),
                                  device=t.dev)
    return p, ops.hash_schedule(p, p, n_bins=8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--stress", type=int, default=0)
    args = ap.parse_args()
    cases = args.cases.split(",")
    if any(c not in CASES for c in cases):
        ap.error(f"cases are {', '.join(CASES)}")
    import torch
    if not torch.cuda.is_available():
        print("hash_batch_cost: no CUDA device", file=sys.stderr)
        return 2
    t = Tree(torch, args.src)
    card = _timing.card()
    rmat = t.rmat
    for case in cases:
        if case == "squares":
            sq = [rmat.rmat_csr(16, 16, "G500", seed=s, device=t.dev)
                  for s in (0, 1)]
            line = batch_case(t, "G500 s16 ef16 squares (seeds 0, 1)",
                              [(x, x) for x in sq], args)
            del sq
        elif case == "moe":
            from repro_torch.examples.moe_dispatch_batch import \
                build_dispatch_fleet
            pairs, _, _ = build_dispatch_fleet(
                0, n_experts=128, top_k=8, tokens=16384, d_model=2048,
                density=0.05, device=t.dev)
            line = batch_case(t, "MoE dispatch 128 experts top-8 T=16384 "
                              "d=2048", pairs, args)
            del pairs
        elif case == "fleet":
            pairs = [(rmat.rmat_csr(10, 1 + i % 3, "G500" if i % 2 else "ER",
                                    seed=i, device=t.dev),
                      rmat.rmat_csr(10, 1 + (i + 1) % 4, "ER", seed=100 + i,
                                    device=t.dev)) for i in range(64)]
            line = batch_case(t, "rmat_fleet(64, 10)", pairs, args)
            del pairs
        elif case == "vmap_g500":
            line = vmap_case(t, "vmap G500 s16 ef16 x2, A batched",
                             rmat.rmat_csr(16, 16, "G500", seed=0,
                                           device=t.dev), 2, args)
        elif case == "vmap_er":
            line = vmap_case(t, "vmap ER s18 ef16 x8, A batched",
                             rmat.rmat_csr(18, 16, "ER", seed=0,
                                           device=t.dev), 8, args)
        elif case == "single":
            for preset, scale in (("ER", 18), ("G500", 16)):
                line = single_case(t, f"single {preset} s{scale} ef16",
                                   rmat.rmat_csr(scale, 16, preset, seed=0,
                                                 device=t.dev), args)
                print(json.dumps({**line, "card": card}), flush=True)
            continue
        elif case == "patterns":
            for preset, scale in (("ER", 13), ("G500", 10)):
                p, sched = block_pattern(t, preset, scale, 8)
                line = pattern_case(t, f"{preset}-pattern s{scale} ef8", p,
                                    sched, args)
                print(json.dumps({**line, "card": card}), flush=True)
            continue
        else:
            for preset, scale in (("ER", 18), ("G500", 16)):
                a = rmat.rmat_csr(scale, 16, preset, seed=0, device=t.dev)
                t.core.clear_plan_cache()
                plan = t.core.plan_spgemm(a, a, algorithm="hash")
                line = symbolic_case(t, f"symbolic {preset} s{scale} ef16",
                                     a, args, plan=plan)
                print(json.dumps({**line, "card": card}), flush=True)
                del a, plan
                t.core.clear_plan_cache()
                torch.cuda.empty_cache()
            for preset, scale in (("ER", 13), ("G500", 10)):
                p, sched = block_pattern(t, preset, scale, 8)
                line = symbolic_case(
                    t, f"symbolic {preset}-pattern s{scale} ef8", p, args,
                    sched=sched)
                print(json.dumps({**line, "card": card}), flush=True)
            continue
        print(json.dumps({**line, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
