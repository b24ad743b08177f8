#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path -- the planned hash SpGEMM of the paper --
through the entry points a user calls, at the paper's own input sizes
(R-MAT, edge factor 16, squared: ER at scale 18 and G500 at scale 16,
seed 0), and holds every hand-written kernel against its plain PyTorch
version.  Phases; any failure exits non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from the checkout's sources;
  3. the hash-table saturation fixtures (load factor exactly 1.0, and one
     past fill) through the scalar and vector kernels, bitwise against
     the plain versions after a per-row sort;
  4. per input: ``plan_spgemm(a, a)`` under ``algorithm="auto"`` and
     ``plan.execute``; an explicit ``hash_vector`` plan; the planless
     ``spgemm(..., algorithm="hash")``; ``execute(sorted_output=True)``.
     The launch counters are zeroed just before each of these paths and
     read just after: each must have launched its kernels and never the
     plain versions.  Outputs: row pointers bitwise equal to the plan's, each
     row's columns bitwise equal to the plain version's, values bitwise
     on a dyadic-valued copy of A and within 1 ulp per accumulated
     product on the R-MAT values; the symbolic kernel's row counts equal
     the planner's ESC counts bitwise;
  5. median CUDA-event times of each kernel, its plain version and
     ``torch.sparse.mm`` (cuSPARSE; a yardstick only, never on the path),
     each beside its least possible time on the card;
  6. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Usage: ``python3 chip_smoke.py`` (one card, no arguments).  A quick first
check of a changed kernel at small sizes is
``PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: the paper's inputs (section 5.1): R-MAT scale per preset, edge factor 16
ER_SCALE, G500_SCALE, EDGE_FACTOR = 18, 16, 16
#: timed repetitions per call (median taken)
REPS = 7

#: dyadic values: exact float32 products and sums
DYADIC = (0.5, 1.0, 1.5, 2.0)

KERNEL_SOURCE = "src/repro_torch/kernels/spgemm_hash/csrc/spgemm_hash.cu"
REPLACES = {
    "numeric": "src/repro/kernels/spgemm_hash/kernel.py:266",
    "numeric_vector": "src/repro/kernels/spgemm_hash/kernel.py:87",
    "symbolic": "src/repro/kernels/spgemm_hash/kernel.py:235",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, card: str):
        import repro_torch.core as core
        from repro_torch.core.formats import CSR
        from repro_torch.data import rmat
        from repro_torch.kernels.spgemm_hash import kernel as K
        from repro_torch.kernels.spgemm_hash import ops, ref
        self.torch, self.core, self.CSR, self.rmat = torch, core, CSR, rmat
        self.K, self.ops, self.ref = K, ops, ref
        self.card = card
        self.dev = torch.device("cuda")
        self.rows = []          # the kernels line

    # ---- helpers ---------------------------------------------------------
    def counted(self, fn):
        """Run ``fn`` between a counter reset and a read."""
        self.ops.reset_kernel_calls()
        out = fn()
        self.torch.cuda.synchronize()
        return out, self.ops.kernel_call_counts()

    def time_ms(self, fn) -> float:
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(REPS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        times.sort()
        return times[len(times) // 2]

    def sorted_rows(self, cols, vals, indptr, shape):
        c = self.CSR(indptr, cols, vals,
                     self.torch.tensor(int(indptr[-1]), dtype=self.torch.int32,
                                       device=self.dev), shape, False)
        return c.sort_rows()

    def compare(self, what, cols, vals, indptr, shape, plain_cols,
                plain_vals, counts=None) -> float:
        """Kernel output (unsorted rows) against the plain version (sorted
        rows): columns bitwise; values bitwise when ``counts`` is None,
        else within ``counts`` ulp of the plain value.  Returns the
        largest absolute difference."""
        torch = self.torch
        s = self.sorted_rows(cols, vals, indptr, shape)
        nnz = int(indptr[-1])
        check(torch.equal(s.indices[:nnz], plain_cols[:nnz]),
              f"{what}: column sets differ from the plain version")
        check(bool((cols[nnz:] == 0).all()) and bool((vals[nnz:] == 0).all()),
              f"{what}: tail past nnz is not zero")
        kv, pv = s.data[:nnz].float(), plain_vals[:nnz]
        diff = (kv - pv).abs()
        err = float(diff.max()) if nnz else 0.0
        if counts is None:
            check(torch.equal(kv, pv), f"{what}: values not bitwise equal "
                  f"(max abs diff {err})")
        else:
            ulp = torch.nextafter(pv.abs(), torch.full_like(pv, float("inf"))) \
                - pv.abs()
            bad = diff > counts[:nnz].float() * ulp
            check(not bool(bad.any()), f"{what}: {int(bad.sum())} values "
                  f"past 1 ulp per product (max abs diff {err})")
        return err

    def operands(self, a):
        return (a.indptr, a.indptr, a.indices, a.data.float(), a.indices,
                a.data.float())

    # ---- phase 3 -----------------------------------------------------------
    def saturation(self):
        """Load factor 1.0 (forced table of d = CHUNK slots for d distinct
        columns) and one past fill (d = CHUNK + 1, natural sizing)."""
        torch, CSR, K, ref = self.torch, self.CSR, self.K, self.ref
        chunk = K.CHUNK
        for d, forced in ((chunk, True), (chunk + 1, False)):
            a = CSR.from_numpy_coo([0, 1, 1], [0, 0, 1],
                                   np.asarray([1.0, 1.0, 0.5], np.float32),
                                   (2, 2), device=self.dev)
            rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
            cols = np.concatenate([np.arange(d), np.arange(d)])
            vals = np.asarray(DYADIC, np.float32)[np.arange(2 * d) % 4]
            b = CSR.from_numpy_coo(rows, cols, vals, (2, d), device=self.dev)
            if forced:
                offsets = torch.tensor([0, 2], dtype=torch.int32,
                                       device=self.dev)
                bin_tsize = torch.tensor([d], dtype=torch.int32,
                                         device=self.dev)
                table_size = d
            else:
                offsets, bin_tsize, table_size = self.ops.hash_schedule(
                    a, b, n_bins=1)
                check(table_size == 2 * chunk, "one past fill must double "
                      f"the table, got {table_size}")
            ip_a, ip_b = a.indptr, b.indptr
            args = (ip_a, ip_b, a.indices, a.data, b.indices, b.data)
            row_p = ref.symbolic_plain(offsets, bin_tsize, *args,
                                       table_size=table_size, vector=False)
            indptr_c = self.core.formats.prefix_sum(row_p).to(torch.int32)
            pc, pv = ref.numeric_plain(offsets, bin_tsize, ip_a, ip_b,
                                       indptr_c, a.indices, a.data, b.indices,
                                       b.data, cap_c=2 * d,
                                       table_size=table_size, vector=False)
            for vector in (False, True):
                err = torch.zeros(1, dtype=torch.int32, device=self.dev)
                row_k = K.symbolic_call(offsets, bin_tsize, *args,
                                        table_size=table_size, vector=vector,
                                        errors=err)
                kc, kv = K.numeric_call(
                    offsets, bin_tsize, ip_a, ip_b, indptr_c, a.indices,
                    a.data, b.indices, b.data, cap_c=2 * d,
                    table_size=table_size, vector=vector, errors=err)
                torch.cuda.synchronize()
                what = f"saturation d={d} vector={vector}"
                check(torch.equal(row_k, row_p), f"{what}: symbolic counts")
                check(int(err) == 0, f"{what}: {int(err)} kernel errors")
                self.compare(what, kc, kv, indptr_c, (2, d), pc, pv)
        print("phase 3: saturation fixtures bitwise equal (load factor 1.0 "
              "and one past fill, scalar and vector)", flush=True)

    # ---- phase 4 and 5 -----------------------------------------------------
    def one_input(self, preset: str, scale: int):
        torch, core, K, ref = self.torch, self.core, self.K, self.ref
        label = f"{preset} s{scale} ef{EDGE_FACTOR}"
        t0 = time.perf_counter()
        a = self.rmat.rmat_csr(scale, EDGE_FACTOR, preset, seed=0,
                               device=self.dev)
        nnz_a = int(a.nnz)
        rng = np.random.default_rng(1)
        dy = np.zeros(a.cap, np.float32)
        dy[:nnz_a] = np.asarray(DYADIC, np.float32)[rng.integers(0, 4, nnz_a)]
        a_d = self.CSR(a.indptr, a.indices, torch.from_numpy(dy).to(self.dev),
                       a.nnz, a.shape, True)
        print(f"{label}: n={a.n_rows} nnz(A)={nnz_a} "
              f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)

        # the main path: plan under the recipe, execute
        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan = core.plan_spgemm(a, a, algorithm="auto", sorted_output=False)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        algo = plan.algorithm
        print(f"{label}: recipe chose {algo!r}; total flop {plan.total_flop}, "
              f"nnz(C) {plan.nnz_c}, table_size {plan.table_size}, "
              f"bin_tsize {plan.bin_tsize.tolist()}, offsets "
              f"{plan.offsets.tolist()} (planned in {plan_s:.2f} s)",
              flush=True)
        check(algo in ("hash", "hash_vector"),
              f"{label}: recipe chose {algo}, not the hash family")
        key = "numeric_vector" if algo == "hash_vector" else "numeric"
        # launches per kernel, per path (counters zeroed before each path)
        paths = {"numeric": {}, "numeric_vector": {}, "symbolic": {}}

        def expect(counts, want, path):
            what = f"{label} {path}"
            plain = counts.pop("plain")
            check(plain == 0, f"{what}: ran the plain version {plain} times")
            check(counts == {k: want.get(k, 0) for k in counts},
                  f"{what}: launches {counts}, want {want}")
            for k, v in want.items():
                paths[k][path] = v

        c, counts = self.counted(lambda: plan.execute(a, a))
        expect(counts, {key: 1}, "plan.execute")

        # the plain version on the same operands, and the per-entry
        # product counts for the ulp bound
        args = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                plan.indptr_c, a.indices, a.data, a.indices, a.data)
        kw = dict(cap_c=plan.cap_c, table_size=plan.table_size, vector=False)
        pc, pv = ref.numeric_plain(*args, **kw)
        counts_pp = ref.products_per_entry(a.indptr, a.indptr, plan.indptr_c,
                                           a.indices, a.indices, plan.cap_c)
        pc_d, pv_d = ref.numeric_plain(*args[:6], a_d.data, a.indices,
                                       a_d.data, **kw)
        check(torch.equal(c.indptr, plan.indptr_c), f"{label}: indptr")
        check(int(c.nnz) == plan.nnz_c, f"{label}: nnz")
        errs = {}
        errs[key] = self.compare(f"{label} {algo}", c.indices, c.data,
                                 c.indptr, c.shape, pc, pv, counts_pp)
        c_d, counts = self.counted(lambda: plan.execute(a_d, a_d))
        expect(counts, {key: 1}, "plan.execute dyadic")
        self.compare(f"{label} {algo} dyadic", c_d.indices, c_d.data,
                     c_d.indptr, c_d.shape, pc_d, pv_d)

        # the other probe mode, planned explicitly
        other = "hash" if algo == "hash_vector" else "hash_vector"
        okey = "numeric" if key == "numeric_vector" else "numeric_vector"
        plan_o = core.plan_spgemm(a, a, algorithm=other)
        for arr in ("offsets", "bin_tsize", "indptr_c"):
            check(torch.equal(getattr(plan_o, arr), getattr(plan, arr)),
                  f"{label}: {arr} differs between {algo} and {other} plans")
        c_o, counts = self.counted(lambda: plan_o.execute(a, a))
        expect(counts, {okey: 1}, f"plan({other}).execute")
        errs[okey] = self.compare(f"{label} {other}", c_o.indices, c_o.data,
                                  c_o.indptr, c_o.shape, pc, pv, counts_pp)
        c_o, counts = self.counted(lambda: plan_o.execute(a_d, a_d))
        expect(counts, {okey: 1}, f"plan({other}).execute dyadic")
        self.compare(f"{label} {other} dyadic", c_o.indices, c_o.data,
                     c_o.indptr, c_o.shape, pc_d, pv_d)

        # the planless front door: symbolic + numeric kernels
        c_p, counts = self.counted(lambda: core.spgemm(
            a, a, plan.cap_c, algorithm="hash"))
        expect(counts, {"symbolic": 1, "numeric": 1},
               "spgemm(algorithm=hash)")
        check(torch.equal(c_p.indptr, plan.indptr_c),
              f"{label}: planless indptr differs from the plan's")
        self.compare(f"{label} planless", c_p.indices, c_p.data, c_p.indptr,
                     c_p.shape, pc, pv, counts_pp)
        sym_err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        ops_args = self.operands(a)
        row_k = K.symbolic_call(plan.offsets, plan.bin_tsize, *ops_args,
                                table_size=plan.table_size, vector=False,
                                errors=sym_err)
        check(torch.equal(row_k, plan.row_nnz_c),
              f"{label}: symbolic kernel row_nnz != ESC row_nnz_c")
        errs["symbolic"] = float((row_k - plan.row_nnz_c).abs().max())
        row_kv = K.symbolic_call(plan.offsets, plan.bin_tsize, *ops_args,
                                 table_size=plan.table_size, vector=True,
                                 errors=sym_err)
        check(torch.equal(row_kv, plan.row_nnz_c),
              f"{label}: vector symbolic kernel row_nnz != ESC row_nnz_c")
        check(int(sym_err) == 0, f"{label}: symbolic kernel errors")
        num_err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        for vector in (False, True):
            K.numeric_call(*args, cap_c=plan.cap_c,
                           table_size=plan.table_size, vector=vector,
                           errors=num_err)
        torch.cuda.synchronize()
        check(int(num_err) == 0, f"{label}: {int(num_err)} rows whose flush "
              f"count disagrees with indptr_c, or full-table probes")

        # sorted on request: the finalize epilogue
        c_s, counts = self.counted(lambda: plan.execute(a, a,
                                                        sorted_output=True))
        expect(counts, {key: 1}, "plan.execute sorted")
        check(c_s.sorted_cols, f"{label}: sorted output not flagged sorted")
        check(torch.equal(c_s.indices, pc), f"{label}: sorted columns")
        self.compare(f"{label} sorted", c_s.indices, c_s.data, c_s.indptr,
                     c_s.shape, pc, pv, counts_pp)
        print(f"{label}: outputs match the plain versions; launches per "
              f"path {paths}", flush=True)

        # ---- timings (phase 5) ------------------------------------------
        m = a.n_rows
        nnz_c = plan.nnz_c
        flop = plan.total_flop
        bytes_num = (4 * (m + 1) + 8 * nnz_a) + 8 * nnz_a + 8 * nnz_c \
            + 4 * (m + 1)
        bytes_sym = (4 * (m + 1) + 4 * nnz_a) + 4 * nnz_a + 4 * m
        bound_num = max(bytes_num / HBM_BYTES_PER_S,
                        2 * flop / FP32_FLOP_PER_S) * 1e3
        bound_num_by = "bytes" if bytes_num / HBM_BYTES_PER_S >= \
            2 * flop / FP32_FLOP_PER_S else "operations"
        bound_sym = bytes_sym / HBM_BYTES_PER_S * 1e3
        # the kernels are timed with an errors tensor of the caller's, so
        # the wrapper's read-back of its own count is not in their times
        t = {}
        for vector, name in ((False, "numeric"), (True, "numeric_vector")):
            t[name] = self.time_ms(lambda: K.numeric_call(
                *args, cap_c=plan.cap_c, table_size=plan.table_size,
                vector=vector, errors=num_err))
        t["symbolic"] = self.time_ms(lambda: K.symbolic_call(
            plan.offsets, plan.bin_tsize, *ops_args,
            table_size=plan.table_size, vector=False, errors=sym_err))
        t["plain_numeric"] = self.time_ms(lambda: ref.numeric_plain(*args,
                                                                    **kw))
        t["plain_symbolic"] = self.time_ms(lambda: ref.symbolic_plain(
            plan.offsets, plan.bin_tsize, *ops_args,
            table_size=plan.table_size, vector=False))
        t["execute"] = self.time_ms(lambda: plan.execute(a, a))
        sp = torch.sparse_csr_tensor(a.indptr.long(),
                                     a.indices[:nnz_a].long(),
                                     a.data[:nnz_a], size=a.shape)
        t["torch_sparse_mm"] = self.time_ms(lambda: torch.sparse.mm(sp, sp))
        print(json.dumps({"timing": label, "card": self.card,
                          "n": m, "nnz_a": nnz_a, "flop": flop,
                          "nnz_c": nnz_c, "algorithm": algo,
                          "ms": t, "bound_ms": {"numeric": bound_num,
                                                "symbolic": bound_sym},
                          "plan_s": plan_s}), flush=True)
        # `launches`: the count on the first path that runs the kernel --
        # plan.execute for the recipe's probe mode, the explicit plan's
        # execute for the other, the planless spgemm for symbolic
        for name in ("numeric", "numeric_vector", "symbolic"):
            num = name != "symbolic"
            self.rows.append({
                "name": f"spgemm_hash_{name}[{label}]", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                "launches": next(iter(paths[name].values())),
                "launches_by_path": paths[name],
                "max_abs_err": errs[name],
                "ms": t[name],
                "plain_ms": t["plain_numeric" if num else "plain_symbolic"],
                "bound_ms": bound_num if num else bound_sym,
                "bound_by": bound_num_by if num else "bytes",
                "library_ms": t["torch_sparse_mm"] if num else None})
        del plan, plan_o, c, c_d, c_o, c_p, c_s, pc, pv, pc_d, pv_d
        core.clear_plan_cache()
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    card = card_line()                                           # phase 1
    print(card, flush=True)

    from repro_torch.kernels.spgemm_hash import kernel as K      # phase 2
    info = K.build()
    print(f"phase 2: built {info['path']} in {info['seconds']:.1f} s",
          flush=True)
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    smoke = Smoke(torch, card)
    smoke.saturation()                                           # phase 3
    smoke.one_input("ER", ER_SCALE)
    smoke.one_input("G500", G500_SCALE)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": smoke.rows}), flush=True)       # phase 6
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
