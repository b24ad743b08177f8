"""Layer 1: check frozen plans and count what their executes dispatch (port
of ``repro.verify.bounds``).

Two proof families per executor case:

**Schedule verification conditions** (:func:`check_plan_vcs`) are the
reference's exact checks on the plan's *frozen* arrays, by name and detail
string (but for ``i32-flop``, which holds the port's int64 bin targets to
the port's own guard, :func:`_i32_flop`) -- the hash bins partition the rows, every per-bin p2 table is
large enough for its rows' symbolic counts (so probes terminate and
flushes fit), the output indptr is monotone and lands exactly on ``nnz_c
<= cap_c``, the PB buckets cover the columns and write disjoint slots, and
the flop-scaled quantities ``schedule.guard_i32_flop`` admits stay under
``2**31 - 1`` recomputed in exact Python integers.  Plan tensors on any
device are read through ``.cpu().numpy()``.

**Census budgets** pin the no-reinspection / no-densify story: a planned
execute (a repeat one: memos and batch executors are built by a first
call outside the window) runs under :class:`repro_torch.verify.census.
Census`, and its counts must equal the budget of what the execute is
designed to stage.  The reference walks a jaxpr with an interval domain
(``repro/verify/intervals.py``) to prove every index within the plan's
capacities; an eager execute has no jaxpr, so that proof has no
counterpart here.  What it proved about indices into the capacities is
held by the VCs (``store-capacity``, ``flush-bound``, ``gather-bounds``,
``segment-bounds``) and by the kernels' own ``errors`` read-back.

The port's budgets, one execute (``kernel ops`` are the custom ops
``repro_torch::*`` and the :func:`census.kernel_scope` entries; the
reference's ``pallas_call``):

===========================  ===========================  ==============
execute                      kernel ops                   ``aten.sort``
===========================  ===========================  ==============
hash / hash_vector           ``spgemm_hash_numeric`` 1    0; sorted: 2
heap                         0                            0
esc                          0                            2
hash_jnp, general semirings  0                            3; sorted: 5
pb (plus_times)              scatter 1 + merge 1          0
pb (other semirings)         0                            0
bcsr (block plan)            ``spgemm_bcsr_numeric`` 1    0
batch hash class             ``spgemm_hash_batched`` 1    sorted: 2 a
                                                          member
batch other class            a member: as above           a member: as
                                                          above
chain / gram                 the stages' sum              the stages' sum
===========================  ===========================  ==============

In every case: ``unique``, ``nonzero``, ``argwhere`` and ``dot_general``
0, the symbolic op ``spgemm_hash_symbolic`` 0 and the inspection counters
(``spgemm_pb`` ``inspect``, ``spgemm_bcsr`` ``symbolic``) 0; on the card
also the plain versions' counters (``plain``, ``batched_plain``) 0.

Where the counts differ from the reference's (``bounds.py``
``_algo_budget``): a row sort is a lexsort, which the reference stages as
one multi-operand ``sort`` primitive and the port as one stable
``aten.sort`` per key (``formats.lexsort``): ``finalize``'s row sort is
two (column, row), ESC's expansion sort two, ``hash_jnp``'s three
(column, hash, row), and ``hash_jnp``'s output is unsorted, so a sorted
request pays the row sort on top.  BCSR stages no ``dot_general``: the
tile product is inside the kernel, where the reference's jaxpr shows its
MXU dot.  A chain adds each sorted hop's row sort (``ChainPlan.
sorted_hops``: the hop into a stage that names A's slots or needs a
sorted A), which the reference's chains do not have.

Fixtures are tiny and deterministic (the reference's seeds and shapes);
:func:`run_layer1` runs on the card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import BCSR, CSR, resolve_device
from repro_torch.core import schedule as sched
from repro_torch.kernels.spgemm_hash import kernel as HK

from . import census as C
from .report import VC, CaseReport

_I32_MAX = 2**31 - 1

#: the plan kinds that wait for the port's distributed planners
_DISTRIBUTED = ("dist_1d", "summa")
_DISTRIBUTED_NOTE = ("distributed and SUMMA plans come with the port's "
                     "distributed planners (ROADMAP Queue 1 item 7)")


def _np(x) -> np.ndarray:
    """A plan array on the host, whatever its device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# schedule verification conditions (concrete, exact)
# ---------------------------------------------------------------------------

def _vc(name: str, ok, detail: str = "") -> VC:
    return VC(name, bool(ok), detail)


def _check_hash_schedule(offsets, bin_tsize, indptr_c, *, n_rows: int,
                         n_cols: int, cap_c: int, table_size: int,
                         flop=None, exact_cover: bool = True,
                         label: str = "") -> List[VC]:
    """The four hash-executor VCs on one (offsets, bin_tsize, indptr_c)
    schedule.  ``flop`` (the frozen per-row symbolic flop) enables the
    exact probe-termination recompute; without it (stacked batch
    schedules don't carry flop) the structural form is checked.
    ``exact_cover=False`` admits padded schedules (batch classes round
    a member's ``m`` up to the class shape, so ``offsets[-1]`` is the
    member's true row count, <= the padded ``n_rows``)."""
    pre = f"{label}: " if label else ""
    offsets = _np(offsets)
    bin_tsize = _np(bin_tsize)
    indptr_c = _np(indptr_c)
    vcs: List[VC] = []

    # bins partition the rows
    cover_ok = (offsets[-1] == n_rows if exact_cover
                else offsets[-1] <= n_rows)
    part_ok = (offsets.ndim == 1 and offsets[0] == 0
               and cover_ok and np.all(np.diff(offsets) >= 0))
    vcs.append(_vc("offsets-partition", part_ok,
                   f"{pre}bins cover [0, {int(offsets[-1])}] within "
                   f"[0, {n_rows}) contiguously"))

    # p2 tables within [CHUNK, table_size]
    bt = bin_tsize.astype(np.int64)
    p2_ok = np.all((bt & (bt - 1)) == 0) and np.all(bt >= HK.CHUNK) \
        and np.all(bt <= table_size)
    vcs.append(_vc("table-p2-range", p2_ok,
                   f"{pre}per-bin tables p2 in [{HK.CHUNK}, {table_size}]"))

    # probes terminate: each bin's table exceeds its rows' worst row
    if flop is not None and part_ok:
        flop = _np(flop)[:n_rows].astype(np.int64)
        need = np.empty(len(bin_tsize), np.int64)
        for b in range(len(bin_tsize)):
            rows = flop[int(offsets[b]):int(offsets[b + 1])]
            worst = int(rows.max()) if rows.size else 0
            need[b] = sched.lowest_p2(min(worst, n_cols) + 1)
        term_ok = np.all(bt >= np.minimum(need, table_size))
        vcs.append(_vc("probe-termination", term_ok,
                       f"{pre}bin_tsize >= p2(min(max bin flop, n)+1)"))

    # output indptr is monotone and lands exactly on nnz_c <= cap_c
    nnz_c = int(indptr_c[-1])
    cap_ok = (indptr_c[0] == 0 and np.all(np.diff(indptr_c) >= 0)
              and nnz_c <= cap_c)
    vcs.append(_vc("store-capacity", cap_ok,
                   f"{pre}indptr_c monotone, nnz_c={nnz_c} <= cap_c={cap_c}"))

    # flushes fit: each row's exact count leaves a free probe slot
    row_nnz = np.diff(indptr_c.astype(np.int64))
    flush_ok = True
    if part_ok:
        for b in range(len(bin_tsize)):
            rows = row_nnz[int(offsets[b]):int(offsets[b + 1])]
            if rows.size and int(rows.max()) > int(bt[b]) - 1:
                flush_ok = False
    vcs.append(_vc("flush-bound", flush_ok,
                   f"{pre}row_nnz_c[i] <= bin_tsize[bin(i)] - 1"))
    return vcs


def _i32_flop(total: int, plan, what: str = "") -> VC:
    """i32 admissibility, recomputed in exact Python ints the way the
    port's ``schedule.guard_i32_flop`` admits it: the total flop (the
    int32 expansion positions) fits int32.  The reference also bounds
    ``total * (n_bins - 1)``, its int32 equal-flop bin targets without
    x64; the port's ``rows_to_bins`` computes them in int64, as the
    reference does under x64, so the product is reported, not bounded
    (G500 s16 ef16, 400,330,394 flop x 7, passes 2^31 - 1)."""
    scaled = total * max(plan.n_bins - 1, 1)
    return _vc("i32-flop", total == int(plan.total_flop)
               and total <= _I32_MAX,
               f"{what}total_flop={total} <= 2^31-1, x(n_bins-1)={scaled} "
               f"in int64")


def _check_spgemm_vcs(plan) -> List[VC]:
    vcs: List[VC] = []
    m, n = plan.shape_a[0], plan.shape_b[1]
    flop = _np(plan.flop).astype(np.int64)[:m]

    total = int(flop.sum())
    vcs.append(_i32_flop(total, plan))
    vcs.append(_vc("expansion-capacity", int(plan.flop_cap) >= total,
                   f"flop_cap={plan.flop_cap} >= total_flop={total}"))

    row_nnz = _np(plan.row_nnz_c).astype(np.int64)
    vcs.append(_vc("row-capacity",
                   int(plan.row_cap) >= (int(row_nnz.max()) if m else 0),
                   f"row_cap={plan.row_cap} >= max row_nnz_c"))
    vcs.append(_vc("nnz-consistent",
                   int(_np(plan.indptr_c)[-1]) == int(plan.nnz_c)
                   and int(plan.nnz_c) <= int(plan.cap_c),
                   f"nnz_c={plan.nnz_c} <= cap_c={plan.cap_c}"))

    if plan.offsets is not None and plan.bin_tsize is not None:
        vcs += _check_hash_schedule(
            plan.offsets, plan.bin_tsize, plan.indptr_c, n_rows=m,
            n_cols=n, cap_c=int(plan.cap_c), table_size=int(plan.table_size),
            flop=flop)
    return vcs


def _check_bcsr_vcs(plan) -> List[VC]:
    """Block-granularity VCs for one frozen :class:`BCSRPlan`: the hash
    schedule invariants hold verbatim over the *block* grid (block rows
    are the rows, block columns of B the hash keys), plus the block-shape
    compatibility and i32 admissibility the planner promised."""
    vcs: List[VC] = []
    gm = -(-plan.shape_a[0] // plan.block_a[0])
    gn_b = -(-plan.shape_b[1] // plan.block_b[1])
    flop = _np(plan.flop).astype(np.int64)[:gm]

    vcs.append(_vc("block-compatible",
                   plan.block_a[1] == plan.block_b[0],
                   f"A tile inner {plan.block_a[1]} == B tile outer "
                   f"{plan.block_b[0]}"))

    total = int(flop.sum())
    vcs.append(_i32_flop(total, plan, "block "))
    vcs.append(_vc("nnz-consistent",
                   int(_np(plan.indptr_cb)[-1]) == int(plan.nnzb_c)
                   and int(plan.nnzb_c) <= int(plan.bcap_c),
                   f"nnzb_c={plan.nnzb_c} <= bcap_c={plan.bcap_c}"))

    vcs += _check_hash_schedule(
        plan.offsets, plan.bin_tsize, plan.indptr_cb, n_rows=gm,
        n_cols=gn_b, cap_c=int(plan.bcap_c),
        table_size=int(plan.table_size), flop=flop)
    return vcs


def _check_pb_vcs(plan) -> List[VC]:
    """Propagation-blocking VCs for one frozen :class:`PBPlan`: the
    bucket layout covers the output columns, every bucket's packed
    products fit its static capacity, all frozen gather/segment indices
    are in-bounds, and -- the PB race-freedom invariant -- every live
    product's output column lands inside its own bucket's column range,
    so buckets write disjoint output slots and merge independently."""
    vcs: List[VC] = []
    n = plan.shape_b[1]
    nb, bw = int(plan.n_buckets), int(plan.bucket_w)
    bucket_nnz = _np(plan.bucket_nnz).astype(np.int64)
    src_a = _np(plan.src_a)
    src_b = _np(plan.src_b)
    seg = _np(plan.seg)
    indptr_c = _np(plan.indptr_c).astype(np.int64)
    cols_c = _np(plan.cols_c).astype(np.int64)

    vcs.append(_vc("bucket-cover",
                   bw >= 1 and (bw & (bw - 1)) == 0 and nb * bw >= n,
                   f"{nb} buckets x p2 width {bw} cover {n} columns"))

    total = int(bucket_nnz.sum())
    vcs.append(_vc("i32-flop", total == int(plan.total_flop)
                   and total <= _I32_MAX,
                   f"sum(bucket_nnz)={total} == total_flop, <= 2^31-1"))
    vcs.append(_vc("bucket-capacity",
                   int(bucket_nnz.max(initial=0)) <= int(plan.bucket_cap),
                   f"max bucket_nnz <= bucket_cap={plan.bucket_cap}"))

    lane = np.arange(src_a.shape[-1])
    live = lane[None, :] < bucket_nnz[:, None]
    src_ok = (np.all((src_a >= 0) & (src_a < plan.cap_a) | ~live)
              and np.all((src_b >= 0) & (src_b < plan.cap_b) | ~live))
    vcs.append(_vc("gather-bounds", src_ok,
                   f"live src_a < cap_a={plan.cap_a}, "
                   f"src_b < cap_b={plan.cap_b}"))
    seg_ok = np.all((seg >= 0) & (seg < max(int(plan.cap_c), 1)) | ~live)
    vcs.append(_vc("segment-bounds", seg_ok,
                   f"live seg < cap_c={plan.cap_c}"))

    # race freedom: a live product in bucket g merges into an output slot
    # whose column is in [g*bw, (g+1)*bw)
    g = np.arange(nb)[:, None]
    col_of = cols_c[np.clip(seg, 0, max(int(plan.cap_c) - 1, 0))]
    disjoint = np.all((col_of // bw == g) | ~live)
    vcs.append(_vc("bucket-disjoint", disjoint,
                   "every live product's output column lies in its own "
                   "bucket's range (buckets write disjoint slots)"))

    nnz_c = int(indptr_c[-1])
    vcs.append(_vc("store-capacity",
                   indptr_c[0] == 0 and np.all(np.diff(indptr_c) >= 0)
                   and nnz_c == int(plan.nnz_c)
                   and nnz_c <= int(plan.cap_c),
                   f"indptr_c monotone, nnz_c={nnz_c} <= "
                   f"cap_c={plan.cap_c}"))
    return vcs


def _check_stacked_hash_vcs(hash_sched, *, n_rows: int, n_cols: int,
                            cap_c: int, table_size: int,
                            label: str) -> List[VC]:
    """Structural hash VCs over a stacked ``(..., n_bins+1/n_bins/m+1)``
    schedule (batch classes)."""
    offsets, bin_tsize, indptr_c = (_np(x) for x in hash_sched)
    lead = offsets.shape[:-1]
    offsets = offsets.reshape(-1, offsets.shape[-1])
    bin_tsize = bin_tsize.reshape(-1, bin_tsize.shape[-1])
    indptr_c = indptr_c.reshape(-1, indptr_c.shape[-1])
    merged: Dict[str, VC] = {}
    for i in range(offsets.shape[0]):
        for vc in _check_hash_schedule(
                offsets[i], bin_tsize[i], indptr_c[i], n_rows=n_rows,
                n_cols=n_cols, cap_c=cap_c, table_size=table_size,
                exact_cover=False, label=f"{label}[{i}/{lead}]"):
            prev = merged.get(vc.name)
            if prev is None or (prev.ok and not vc.ok):
                merged[vc.name] = vc
    return list(merged.values())


def _prefixed(prefix: str, vcs: List[VC]) -> List[VC]:
    return [VC(f"{prefix}.{vc.name}", vc.ok, vc.detail) for vc in vcs]


def check_plan_vcs(plan) -> List[VC]:
    """Concrete verification conditions for any plan kind (dispatches on
    the plan's type; container plans recurse into their members, and a
    chain's or Gram plan's stage into its nested block or PB plan).  The
    port adds the batched powers (``stage<k>.`` of each stage's batch
    plan), which the reference does not check."""
    from repro_torch.core.batch import BatchedPlan
    from repro_torch.core.bcsr import BCSRPlan
    from repro_torch.core.chain import BatchedPowerPlan, ChainPlan, GramPlan
    from repro_torch.core.pb import PBPlan
    from repro_torch.core.plan import SpGEMMPlan

    if isinstance(plan, BCSRPlan):
        return _check_bcsr_vcs(plan)

    if isinstance(plan, PBPlan):
        return _check_pb_vcs(plan)

    if isinstance(plan, SpGEMMPlan):
        vcs = _check_spgemm_vcs(plan)
        if plan.bcsr_plan is not None:
            # bcsr-routed CSR plan: the nested block plan's VCs gate too
            vcs += _prefixed("bcsr", _check_bcsr_vcs(plan.bcsr_plan))
        if plan.pb_plan is not None:
            # pb-routed CSR plan: the nested PB plan's VCs gate too
            vcs += _prefixed("pb", _check_pb_vcs(plan.pb_plan))
        return vcs

    if isinstance(plan, ChainPlan):
        vcs: List[VC] = []
        for k, stage in enumerate(plan.stages):
            vcs += _prefixed(f"stage{k}", check_plan_vcs(stage))
        return vcs

    if isinstance(plan, GramPlan):
        return _prefixed("gram", check_plan_vcs(plan.product))

    if isinstance(plan, BatchedPowerPlan):
        vcs = []
        for k, stage in enumerate(plan.stages):
            vcs += _prefixed(f"stage{k}", check_plan_vcs(stage))
        return vcs

    if isinstance(plan, BatchedPlan):
        vcs = []
        for ci, cls in enumerate(plan.classes):
            members = [i for i in range(plan.n_products)
                       if plan.class_of[i] == ci]
            nnz_ok = all(plan.nnz_cs[i] <= cls.cap_c for i in members)
            vcs.append(_vc(f"class{ci}.member-capacity", nnz_ok,
                           f"every member nnz_c <= class cap_c={cls.cap_c}"))
            if cls.hash_sched is not None:
                vcs += _prefixed(f"class{ci}", _check_stacked_hash_vcs(
                    cls.hash_sched, n_rows=cls.shape_a[0],
                    n_cols=cls.shape_b[1], cap_c=int(cls.cap_c),
                    table_size=int(cls.table_size), label=f"class{ci}"))
        return vcs

    raise TypeError(f"no verification conditions for "
                    f"{type(plan).__name__}: {_DISTRIBUTED_NOTE}")


# ---------------------------------------------------------------------------
# seeded bad twins (the checker's own differential)
# ---------------------------------------------------------------------------

#: the perturbations :func:`perturb_plan` makes
PLAN_PERTURBATIONS = ("cap_c", "bin_tsize", "seg")


def perturb_plan(plan, which: str):
    """A structurally broken twin of a frozen plan, which
    :func:`check_plan_vcs` must reject while it keeps passing the
    untouched plan; the input is never mutated.

      * ``"cap_c"``: the output capacity one below the exact ``nnz_c``
        (``store-capacity`` / ``nnz-consistent``), of a CSR, block or PB
        plan;
      * ``"bin_tsize"``: every per-bin hash table halved -- under the
        kernel's CHUNK floor (``table-p2-range``) or too small for its
        bin's worst row (``probe-termination`` / ``flush-bound``);
      * ``"seg"``: a PB plan (or a CSR plan's nested one) whose first live
        product merges into another bucket's output slot
        (``bucket-disjoint``), or past ``cap_c`` when every slot is its
        own bucket's (``segment-bounds``).
    """
    from repro_torch.core.pb import PBPlan
    if which == "cap_c":
        if hasattr(plan, "bcap_c"):
            return dataclasses.replace(plan, bcap_c=max(plan.nnzb_c - 1, 0))
        return dataclasses.replace(plan, cap_c=max(int(plan.nnz_c) - 1, 0))
    if which == "bin_tsize":
        if getattr(plan, "bin_tsize", None) is None:
            raise ValueError("the bin_tsize perturbation needs a hash plan")
        return dataclasses.replace(
            plan, bin_tsize=torch.clamp(plan.bin_tsize // 2, min=1))
    if which == "seg":
        if not isinstance(plan, PBPlan):
            if getattr(plan, "pb_plan", None) is None:
                raise ValueError("the seg perturbation needs a PB plan")
            return dataclasses.replace(
                plan, pb_plan=perturb_plan(plan.pb_plan, "seg"))
        bucket_nnz = _np(plan.bucket_nnz)
        g = int(np.flatnonzero(bucket_nnz)[0])
        cols = _np(plan.cols_c)[:int(plan.nnz_c)].astype(np.int64)
        foreign = np.flatnonzero(cols // int(plan.bucket_w) != g)
        slot = int(foreign[0]) if foreign.size else int(plan.cap_c) + 1
        seg = plan.seg.clone()
        seg[g, 0] = slot
        return dataclasses.replace(plan, seg=seg)
    raise ValueError(f"unknown plan perturbation {which!r}")


# ---------------------------------------------------------------------------
# census budgets
# ---------------------------------------------------------------------------

_K = C.KERNEL_PREFIX
HASH_NUMERIC = _K + "spgemm_hash_numeric"
HASH_SYMBOLIC = _K + "spgemm_hash_symbolic"
HASH_BATCHED = _K + "spgemm_hash_batched"
PB_SCATTER = _K + "spgemm_pb_scatter"
PB_MERGE = _K + "spgemm_pb_merge"
BCSR_NUMERIC = _K + "spgemm_bcsr_numeric"

#: aten.sort per lexsort: one stable sort per key (formats.lexsort)
ROW_SORT = 2          # finalize / CSR.sort_rows: (column, row)
ESC_SORT = 2          # ESC's expansion: (column, row)
HASH_JNP_SORT = 3     # the sort-based hash twin: (column, hash, row)

#: what no execute stages: inspection (unique/nonzero/argwhere, the
#: symbolic kernel, the PB and BCSR inspection counters) or a densify
_FORBIDDEN = {"unique": 0, "nonzero": 0, "argwhere": 0, "dot_general": 0,
              HASH_SYMBOLIC: 0, "inspect": 0}
#: launch counters that count an inspection on either device
_INSPECT_COUNTERS = ("spgemm_pb.inspect", "spgemm_bcsr.symbolic")


def _budget(kernels: Dict[str, int], sort: int) -> Dict[str, int]:
    return {"pallas_call": sum(kernels.values()), **kernels, "sort": sort,
            **_FORBIDDEN}


def _add(total: Dict[str, int], more: Dict[str, int],
         times: int = 1) -> Dict[str, int]:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v * times
    return total


def _algo_budget(algorithm: str, general: bool,
                 sorted_output: bool) -> Dict[str, int]:
    """One ``SpGEMMPlan.execute`` (the module docstring's table)."""
    if algorithm in ("hash", "hash_vector") and not general:
        return _budget({HASH_NUMERIC: 1}, ROW_SORT if sorted_output else 0)
    if algorithm == "heap":
        return _budget({}, 0)
    if algorithm == "pb":
        return _budget({} if general else {PB_SCATTER: 1, PB_MERGE: 1}, 0)
    if algorithm == "bcsr":
        return _budget({BCSR_NUMERIC: 1}, ROW_SORT if sorted_output else 0)
    if algorithm in ("esc", "dense"):
        # the expansion's output comes sorted, so no epilogue sort (the
        # dense oracle gets ESC's budget: its dot_general fails it)
        return _budget({}, ESC_SORT)
    # hash_jnp, or a hash request with a general semiring or a mask:
    # the sort-based twin, unsorted out
    return _budget({}, HASH_JNP_SORT + (ROW_SORT if sorted_output else 0))


def _census_of(fn):
    """The census of a repeat call: ``fn`` runs once first (building memos
    and batch executors, loading kernels), then once under the census."""
    fn()
    with C.Census() as census:
        fn()
    return census


def _budget_check(expected: Dict[str, int], census: C.Census,
                  device: torch.device) -> Dict[str, Any]:
    expected = dict(expected)
    summary = census.summary()
    got = {k: int(summary.get(k, 0)) for k in expected}
    got["inspect"] = sum(census.launches.get(k, 0)
                         for k in _INSPECT_COUNTERS)
    if device.type == "cuda":
        expected["plain"] = 0
        got["plain"] = census.plain_runs()
    return {"expected": expected, "got": got, "ok": got == expected,
            "launches": dict(sorted(census.launches.items()))}


def _case(kind: str, name: str, algorithm: str, vcs: List[VC],
          census: C.Census, expected: Dict[str, int],
          device: torch.device) -> CaseReport:
    return CaseReport(
        kind=kind, name=name, algorithm=algorithm, vcs=vcs, site_counts={},
        census=census.summary(),
        budget=_budget_check(expected, census, device),
        violations=[], warnings=[])


def _general(plan) -> bool:
    return plan.semiring != "plus_times" or plan.mask is not None


# ---------------------------------------------------------------------------
# per-kind verifiers
# ---------------------------------------------------------------------------

def verify_spgemm(plan, a: CSR, b: CSR, name: str = "") -> CaseReport:
    """Check one frozen :class:`SpGEMMPlan` and the census of its
    execute."""
    vcs = check_plan_vcs(plan)
    census = _census_of(lambda: plan.execute(a, b))
    expected = _algo_budget(plan.algorithm, _general(plan),
                            plan.sorted_output)
    return _case("spgemm", name or f"spgemm/{plan.algorithm}",
                 plan.algorithm, vcs, census, expected, a.device)


def verify_bcsr(plan, a: BCSR, b: BCSR, name: str = "") -> CaseReport:
    """Check one frozen :class:`repro_torch.core.bcsr.BCSRPlan`: exactly
    one block numeric kernel (a second would be the block symbolic kernel
    re-inspecting), no ``sort`` (block rows come out hash-ordered by
    contract) and no ``dot_general`` (the tile product is the kernel's)."""
    vcs = check_plan_vcs(plan)
    census = _census_of(lambda: plan.execute(a, b))
    return _case("bcsr", name or "bcsr/planned", "bcsr", vcs, census,
                 _budget({BCSR_NUMERIC: 1}, 0), a.device)


def verify_pb(plan, a: CSR, b: CSR, name: str = "") -> CaseReport:
    """Check one frozen :class:`repro_torch.core.pb.PBPlan`: on the
    plus_times path the scatter and the merge kernel once each, no
    ``sort`` (the output order was frozen at plan time); a general-semiring
    plan runs its plain twin, still sort-free."""
    vcs = check_plan_vcs(plan)
    census = _census_of(lambda: plan.execute(a, b))
    return _case("pb", name or "pb/planned", "pb", vcs, census,
                 _algo_budget("pb", plan.semiring != "plus_times", True),
                 a.device)


def _batch_budget(plan) -> Dict[str, int]:
    expected = _budget({}, 0)
    general = plan.semiring != "plus_times"
    for cls in plan.classes:
        if cls.algorithm in ("hash", "hash_vector") and \
                cls.hash_sched is not None:
            # one batched kernel entry for the class; finalize's row sort
            # per member when sorted output is asked for
            _add(expected, {"pallas_call": 1, HASH_BATCHED: 1})
            if plan.sorted_output:
                _add(expected, {"sort": ROW_SORT}, cls.n_members)
            continue
        _add(expected, _algo_budget(cls.algorithm,
                                    general or cls.mask_parts is not None,
                                    plan.sorted_output), cls.n_members)
    return expected


def verify_batch(plan, pairs: Sequence[Tuple[CSR, CSR]],
                 name: str = "") -> CaseReport:
    """Check one :class:`BatchedPlan` and the census of its execute: a
    hash class with a frozen schedule is one batched kernel entry
    (``kernel_scope``), every other class its torch body per member."""
    vcs = check_plan_vcs(plan)
    census = _census_of(lambda: plan.execute(pairs))
    algos = ",".join(sorted({c.algorithm for c in plan.classes}))
    return _case("batch", name or f"batch/{algos}", algos, vcs, census,
                 _batch_budget(plan), pairs[0][0].device)


def _chain_budget(plan) -> Dict[str, int]:
    expected = _budget({}, 0)
    last = len(plan.stages) - 1
    for k, stage in enumerate(plan.stages):
        # a stage's sortedness: the plan's for the last one, the hop's
        # (sort_intermediates or the slot-order rule) before it
        so = plan.sorted_output if k == last else plan.sorted_hops[k]
        _add(expected, _algo_budget(stage.algorithm, _general(stage), so))
    return expected


def verify_chain(plan, mats: Sequence[CSR], name: str = "") -> CaseReport:
    """Check one :class:`ChainPlan` end to end across its stages: the
    stages' budgets summed, each sorted hop's row sort included."""
    vcs = check_plan_vcs(plan)
    census = _census_of(lambda: plan.execute(*mats))
    algos = ",".join(s.algorithm for s in plan.stages)
    return _case("chain", name or f"chain/{algos}", algos, vcs, census,
                 _chain_budget(plan), mats[0].device)


def verify_gram(plan, a: CSR, name: str = "") -> CaseReport:
    """Check one :class:`GramPlan`: the transpose's values re-gathered
    (gathers only), then its product's budget."""
    vcs = check_plan_vcs(plan)
    census = _census_of(lambda: plan.execute(a))
    product = plan.product
    expected = _algo_budget(product.algorithm, _general(product),
                            product.sorted_output)
    return _case("gram", name or f"gram/{product.algorithm}",
                 product.algorithm, vcs, census, expected, a.device)


# ---------------------------------------------------------------------------
# the --all fixture sweep
# ---------------------------------------------------------------------------

#: the kinds :func:`run_layer1` sweeps by default
KINDS = ("spgemm", "batch", "bcsr", "pb", "chain", "gram")


def _dyadic_dense(m: int, n: int, density: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.array([0.5, 1.0, 1.5, 2.0], np.float32),
                      size=(m, n))
    return np.where(rng.random((m, n)) < density, vals, 0.0
                    ).astype(np.float32)


def _block_dyadic(gm: int, gn: int, bm: int, bn: int, density: float,
                  seed: int) -> np.ndarray:
    """Block-clustered dyadic dense fixture: a ``gm x gn`` occupancy grid
    of fully dense ``bm x bn`` tiles with values from {0.5, 1, 1.5, 2}."""
    rng = np.random.default_rng(seed)
    occ = (rng.random((gm, gn)) < density).astype(np.float32)
    vals = rng.choice(np.array([0.5, 1.0, 1.5, 2.0], np.float32),
                      size=(gm * bm, gn * bn))
    return np.kron(occ, np.ones((bm, bn), np.float32)) * vals


def _csr_of(d: np.ndarray, device, cap: Optional[int] = None) -> CSR:
    r, c = np.nonzero(d)
    return CSR.from_numpy_coo(r, c, d[r, c], d.shape, cap=cap, device=device)


def _bcsr_of(d: np.ndarray, block, device) -> BCSR:
    return BCSR.from_dense(torch.from_numpy(d).to(device), block)


def run_layer1(kinds: Optional[Sequence[str]] = None,
               device=None) -> List[CaseReport]:
    """Check the standard fixture sweep over every plan kind: the
    reference's fixtures (same seeds and shapes), plus the port's ``hash``
    -> ``pb`` chain, whose hop is sorted, and a Gram plan.

    Runs on the card unless ``device="cpu"`` is asked for (raises when
    CUDA is wanted but absent).  Returns one :class:`CaseReport` per
    case; the CLI turns them into the gating JSON document.
    """
    from repro_torch.core import (plan_batch, plan_bcsr, plan_chain,
                                  plan_gram, plan_pb, plan_spgemm)

    kinds = tuple(kinds or KINDS)
    waiting = [k for k in kinds if k in _DISTRIBUTED]
    if waiting:
        raise NotImplementedError(f"layer-1 kinds {waiting}: "
                                  f"{_DISTRIBUTED_NOTE}")
    unknown = sorted(set(kinds) - set(KINDS))
    if unknown:
        raise ValueError(f"unknown layer-1 kinds {unknown}; "
                         f"choose from {KINDS}")
    dev = resolve_device(device)
    cases: List[CaseReport] = []

    a = _csr_of(_dyadic_dense(16, 12, 0.3, 0), dev)
    b = _csr_of(_dyadic_dense(12, 10, 0.35, 1), dev)

    if "spgemm" in kinds:
        for algo in ("hash", "hash_vector", "esc", "heap", "hash_jnp"):
            plan = plan_spgemm(a, b, algorithm=algo)
            cases.append(verify_spgemm(plan, a, b))
        plan = plan_spgemm(a, b, algorithm="hash", sorted_output=True)
        cases.append(verify_spgemm(plan, a, b, name="spgemm/hash sorted"))

    if "batch" in kinds:
        pairs = [(a, b),
                 (_csr_of(_dyadic_dense(8, 12, 0.4, 2), dev), b),
                 (_csr_of(_dyadic_dense(5, 6, 0.5, 3), dev),
                  _csr_of(_dyadic_dense(6, 7, 0.5, 4), dev))]
        cases.append(verify_batch(plan_batch(pairs), pairs))

    if "bcsr" in kinds:
        ba = _bcsr_of(_block_dyadic(4, 3, 4, 4, 0.6, 8), (4, 4), dev)
        bb2 = _bcsr_of(_block_dyadic(3, 4, 4, 8, 0.6, 9), (4, 8), dev)
        cases.append(verify_bcsr(plan_bcsr(ba, bb2), ba, bb2))
        # rectangular-tile variant at a different bin count
        ba2 = _bcsr_of(_block_dyadic(5, 4, 2, 4, 0.5, 10), (2, 4), dev)
        bb3 = _bcsr_of(_block_dyadic(4, 5, 4, 2, 0.5, 11), (4, 2), dev)
        cases.append(verify_bcsr(plan_bcsr(ba2, bb3, n_bins=3), ba2, bb3,
                                 name="bcsr/rect-tiles"))

    if "pb" in kinds:
        cases.append(verify_pb(plan_pb(a, b), a, b))
        # multi-bucket + masked variant: structural pruning at plan time,
        # so the masked product still runs the mask-free kernel pair
        md = (_dyadic_dense(16, 10, 0.5, 12) > 0).astype(np.float32)
        plan = plan_pb(a, b, mask=_csr_of(md, dev), n_buckets=4)
        cases.append(verify_pb(plan, a, b, name="pb/masked-4buckets"))

    if "chain" in kinds:
        c = _csr_of(_dyadic_dense(10, 7, 0.4, 7), dev)
        plan = plan_chain([a, b, c], algorithm="hash")
        cases.append(verify_chain(plan, [a, b, c]))
        plan = plan_chain([a, b, c], algorithm="esc")
        cases.append(verify_chain(plan, [a, b, c], name="chain/esc-all"))
        # the port's slot-order rule: the hop into pb is sorted
        plan = plan_chain([a, b, c], algorithm=("hash", "pb"))
        cases.append(verify_chain(plan, [a, b, c]))

    if "gram" in kinds:
        cases.append(verify_gram(plan_gram(a, algorithm="hash"), a))

    return cases
