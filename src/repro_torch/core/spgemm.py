"""SpGEMM: C = A @ B on sparse A, B (port of ``repro.core.spgemm``).

Algorithms, as Table 1 of the paper:

  algorithm      phases  accumulator                 sortedness (in/out)
  -----------    ------  --------------------------  -------------------
  ``dense``      1       dense (oracle only)         any / sorted
  ``esc``        2       sort + segmented reduce     any / sorted
  ``heap``       1       k-way tournament merge      sorted / sorted
  ``hash``       2       hash table (CUDA kernel)    any / select
  ``hash_vector``2       chunked probing (CUDA)      any / select
  ``pb``         2       column buckets (CUDA)       any / sorted
  ``bcsr``       2       block-column hash (CUDA)    any / sorted

Everything in this module is plain PyTorch, as the reference is plain jnp:
the hand-written kernels live in ``repro_torch.kernels.spgemm_hash``,
``repro_torch.kernels.spgemm_pb`` (planned by ``core.pb``),
``repro_torch.kernels.spgemm_bcsr`` (planned by ``core.bcsr``) and
``repro_torch.kernels.spmm`` (behind :func:`spmm`).
:func:`spgemm_hash_jnp` (the name kept from the reference) is the sort-based
hash-order fallback that owns the semiring and masked generalizations.

Shapes are static: capacities come from :func:`symbolic`, the dynamic
``nnz`` rides along as a scalar.
"""
from __future__ import annotations

from typing import Literal

import torch

from .formats import CSR, csr_sorted_keys, lexsort, prefix_sum, \
    sorted_keys_contain
from .semiring import PLUS_TIMES, Semiring, resolve_semiring, segment_reduce
from . import schedule as sched

Algorithm = Literal["auto", "dense", "esc", "heap", "hash", "hash_vector",
                    "hash_jnp", "bcsr", "pb"]

#: hash-order scrambling of the fallback (Fig. 8's multiply hash over a
#: fixed 2^20 table: output order == table-scan order).  The reference's
#: int32 constant -1640531527 is 2654435769 (0x9E3779B9) mod 2^32; the
#: int64 product's low 20 bits equal its wrapped int32 product's.
_HASH_CONST = 2654435769
_HASH_P = 1 << 20


# ----------------------------------------------------------------------------
# Mask plumbing: structural CSR masks probed with one binary search each.
# ----------------------------------------------------------------------------

def _check_mask(a: CSR, b: CSR, mask: CSR | None):
    """Masks live in output coordinates: shape must be (m, n) of C."""
    if mask is not None and mask.shape != (a.n_rows, b.n_cols):
        raise ValueError(f"mask shape {mask.shape} != output shape "
                         f"{(a.n_rows, b.n_cols)}")


def _canon_mask(mask: CSR | None) -> CSR | None:
    """An unsorted mask (e.g. a hash-family output) is sorted first."""
    if mask is not None and not mask.sorted_cols:
        return mask.sort_rows()
    return mask


def _mask_prune(rows, cols, valid, mask: CSR | None, complement: bool):
    """``valid &= (rows, cols) in mask`` (or not in, when complemented)."""
    if mask is None:
        return valid
    allowed = mask.contains(rows, cols)
    if complement:
        allowed = ~allowed
    return valid & allowed


# ----------------------------------------------------------------------------
# Symbolic phase (Fig. 7 "Symbolic"): flop bound + exact nnz(C).
# ----------------------------------------------------------------------------

def symbolic_flops(a: CSR, b: CSR) -> torch.Tensor:
    """Upper bound per-row nnz(C) = flop per row."""
    return sched.flops_per_row(a, b)


def symbolic(a: CSR, b: CSR, mask: CSR | None = None,
             complement_mask: bool = False, flop_cap: int | None = None):
    """Exact per-row nnz(C) and total flop, mask-aware.

    Returns ``(row_nnz_c, indptr_c, flop_per_row, total_flop)``: the ESC
    expansion with a count-distinct reduction over one int64 key
    ``row * n + col``.  ``flop_cap`` bounds the expansion as in the
    reference (products past it are dropped); the planner passes the exact
    total.
    """
    _check_mask(a, b, mask)
    mask = _canon_mask(mask)
    flop = symbolic_flops(a, b)
    if flop_cap is None:
        flop_cap = _default_flop_cap(a, b)
    m, n = a.n_rows, b.n_cols
    rows, cols, _, valid = _expand(a, b, flop_cap)
    valid = _mask_prune(rows, cols, valid, mask, complement_mask)
    key = torch.where(valid, rows.to(torch.int64), m) * n + cols
    del rows, cols
    key_s, _ = torch.sort(key)
    newseg = torch.ones_like(key_s, dtype=torch.bool)
    newseg[1:] = key_s[1:] != key_s[:-1]
    newseg &= key_s < m * n
    row_nnz = torch.bincount(key_s[newseg] // n, minlength=m)[:m] \
        .to(torch.int32)
    indptr_c = prefix_sum(row_nnz).to(torch.int32)
    return row_nnz, indptr_c, flop, flop.to(torch.int64).sum()


# ----------------------------------------------------------------------------
# Oracle
# ----------------------------------------------------------------------------

def spgemm_dense(a: CSR, b: CSR, cap_c: int,  # verify: allow(no-densify)
                 semiring: str | Semiring = "plus_times",
                 mask: CSR | None = None,
                 complement_mask: bool = False) -> CSR:
    """Reference oracle via the dense product -- tests only.  Like the
    reference it drops structurally present entries whose value is 0."""
    sr = resolve_semiring(semiring)
    _check_mask(a, b, mask)
    ad, bd = a.to_dense(), b.to_dense()
    ap, bp = ad != 0, bd != 0
    if sr.name == "plus_times":
        c = ad @ bd
    elif sr.name == "boolean":
        c = ((ap.float() @ bp.float()) > 0).to(a.dtype)
    elif sr.name == "plus_first":
        c = ad @ bp.to(ad.dtype)
    elif sr.name == "min_plus":
        pair = ap[:, :, None] & bp[None, :, :]
        s = torch.where(pair, ad[:, :, None] + bd[None, :, :],
                        torch.full((), float("inf"), dtype=ad.dtype,
                                   device=ad.device))
        c = torch.amin(s, dim=1) if s.shape[1] else \
            torch.full((ad.shape[0], bd.shape[1]), float("inf"),
                       dtype=ad.dtype, device=ad.device)
        c = torch.where(torch.isinf(c), torch.zeros_like(c), c).to(a.dtype)
    else:
        raise ValueError(f"dense oracle lacks semiring {sr.name!r}")
    if mask is not None:
        md = mask.to_dense() != 0
        keep = ~md if complement_mask else md
        c = torch.where(keep, c, torch.zeros_like(c))
    return CSR.from_dense(c, cap=cap_c)


# ----------------------------------------------------------------------------
# ESC: expand - sort - compress
# ----------------------------------------------------------------------------

def _default_flop_cap(a: CSR, b: CSR) -> int:
    # every A slot touches at most min(b.cap, n_cols) B entries
    return a.cap * max(1, min(b.cap, b.n_cols))


def _expand(a: CSR, b: CSR, flop_cap: int, sr: Semiring | None = None):
    """All intermediate products of ``A @ B`` in A-slot order (the
    paper's ``value`` of Fig. 1), at most ``flop_cap`` of them.

    Returns ``(rows, cols, vals, valid)``.  Unlike the reference, which
    pads to ``flop_cap`` with invalid lanes, the tensors hold exactly the
    live products; ``valid`` is all-true until a mask prunes it.
    """
    sr = PLUS_TIMES if sr is None else sr
    nnz_a = int(a.nnz)
    k = a.indices[:nnz_a].long()
    pnz = (b.indptr[k + 1] - b.indptr[k]).long()
    total = int(pnz.sum())
    sched.guard_i32_flop(pnz, "expand")
    j = torch.repeat_interleave(
        torch.arange(nnz_a, device=a.device), pnz, output_size=total)
    off = prefix_sum(pnz)
    if total > flop_cap:
        j = j[:flop_cap]
    t = torch.arange(j.shape[0], device=a.device) - off[j]
    b_slot = b.indptr.long()[k[j]] + t
    del t
    rows = a.row_ids()[j]
    cols = b.indices[b_slot]
    vals = sr.mul(a.data[j], b.data[b_slot])
    valid = torch.ones(j.shape[0], dtype=torch.bool, device=a.device)
    return rows, cols, vals, valid


def _esc_core(a: CSR, b: CSR, cap_c: int, flop_cap: int | None,
              sr: Semiring, mask: CSR | None, complement_mask: bool,
              hash_order: bool) -> CSR:
    """Shared expand/prune/sort/compress pipeline.

    ``hash_order=False``: plain ESC, output sorted by column.
    ``hash_order=True``: the hash-family fallback -- each row comes out in
    multiply-hash table-scan order over a fixed 2^20 table, deliberately
    unsorted (C8).  Masked-out candidates are pruned right after expand.
    """
    if flop_cap is None:
        flop_cap = _default_flop_cap(a, b)
    _check_mask(a, b, mask)
    mask = _canon_mask(mask)
    m, n = a.n_rows, b.n_cols
    dev = a.device
    rows, cols, vals, valid = _expand(a, b, flop_cap, sr)
    valid = _mask_prune(rows, cols, valid, mask, complement_mask)
    zero = torch.full((), sr.zero, dtype=a.dtype, device=dev)
    vals = torch.where(valid, vals.to(a.dtype), zero)
    sort_rows = torch.where(valid, rows.long(), m)
    if hash_order:
        h = (cols.long() * _HASH_CONST) & (_HASH_P - 1)
        order = lexsort((cols, h, sort_rows))
    else:
        order = lexsort((cols, sort_rows))
    rows_s, cols_s, vals_s, valid_s = (rows[order], cols[order], vals[order],
                                       valid[order])
    flags = valid_s.clone()
    flags[1:] &= (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])
    uid = torch.cumsum(flags.long(), 0) - 1
    nnz_c = int(flags.sum())
    seg = torch.where(valid_s, torch.clamp(uid, max=cap_c - 1), cap_c)
    data_c = segment_reduce(sr, vals_s, seg, cap_c + 1)[:cap_c]
    put = torch.where(flags & (uid < cap_c), uid, cap_c)
    cols_c = torch.zeros(cap_c + 1, dtype=torch.int32, device=dev)
    cols_c[put] = cols_s.to(torch.int32)
    cols_c = cols_c[:cap_c].clone()
    row_nnz = torch.bincount(rows_s[flags].long(), minlength=m)[:m]
    indptr_c = prefix_sum(row_nnz).to(torch.int32)
    nnz_c = min(nnz_c, cap_c)
    data_c[nnz_c:] = 0
    return CSR(indptr_c, cols_c, data_c.to(a.dtype),
               torch.tensor(nnz_c, dtype=torch.int32, device=dev), (m, n),
               sorted_cols=not hash_order)


def spgemm_esc(a: CSR, b: CSR, cap_c: int, flop_cap: int | None = None,
               semiring: str | Semiring = "plus_times",
               mask: CSR | None = None,
               complement_mask: bool = False) -> CSR:
    """Expand-sort-compress SpGEMM. Output is sorted (it is a sort)."""
    return _esc_core(a, b, cap_c, flop_cap, resolve_semiring(semiring), mask,
                     complement_mask, hash_order=False)


def spgemm_hash_jnp(a: CSR, b: CSR, cap_c: int, flop_cap: int | None = None,
                    semiring: str | Semiring = "plus_times",
                    mask: CSR | None = None,
                    complement_mask: bool = False) -> CSR:
    """Sort-based fallback of the hash family (semiring/mask generality;
    the name is the reference's).  Contract-equivalent to the kernel:
    two-phase exact capacity, mask pruned at probe time, rows in
    table-scan order, ``sorted_cols=False`` (C8)."""
    return _esc_core(a, b, cap_c, flop_cap, resolve_semiring(semiring), mask,
                     complement_mask, hash_order=True)


# ----------------------------------------------------------------------------
# Heap SpGEMM (section 4.2.3): one-phase k-way merge, sorted in/out.
# ----------------------------------------------------------------------------

def spgemm_heap(a: CSR, b: CSR, row_cap: int, k_width: int,
                cap_c: int | None = None,
                semiring: str | Semiring = "plus_times",
                mask: CSR | None = None,
                complement_mask: bool = False) -> CSR:
    """One-phase merge accumulator (argmin tournament == heap extract-min).

    Per output row: ``nnz(a_i*)`` cursors walk the sorted rows of B; each
    step extracts the minimum head column, accumulates into the current
    output slot and advances that cursor.  All rows step together; a row
    whose cursors are exhausted stops changing, as the reference's per-row
    ``while_loop`` stops.  ``k_width >= max nnz(a_i*)``; a row that exceeds
    ``row_cap`` keeps its first ``row_cap`` columns and drops the rest.
    """
    if not (a.sorted_cols and b.sorted_cols):
        raise AssertionError("heap path requires sorted inputs")
    sr = resolve_semiring(semiring)
    _check_mask(a, b, mask)
    mask = _canon_mask(mask)
    m, n = a.n_rows, b.n_cols
    dev = a.device
    inf_col = n + 1
    mkeys = None if mask is None else csr_sorted_keys(mask)

    k = torch.arange(k_width, device=dev)[None, :]
    a_start = a.indptr[:-1].long()[:, None] + k
    a_live = k < a.row_nnz().long()[:, None]
    a_slot = torch.clamp(a_start, 0, a.cap - 1)
    a_vals = torch.where(a_live, a.data[a_slot], torch.zeros((), dtype=a.dtype,
                                                             device=dev))
    b_row = torch.where(a_live, a.indices[a_slot].long(), 0)
    cur = torch.where(a_live, b.indptr.long()[b_row], 0)
    end = torch.where(a_live, b.indptr.long()[b_row + 1], 0)

    out_cols = torch.full((m, row_cap), -1, dtype=torch.int64, device=dev)
    out_vals = torch.zeros((m, row_cap), dtype=a.dtype, device=dev)
    out_n = torch.zeros(m, dtype=torch.int64, device=dev)
    r = torch.arange(m, device=dev)
    while True:
        live = cur < end
        active = live.any(dim=1)
        if not bool(active.any()):
            break
        heads = torch.where(
            live, b.indices.long()[torch.clamp(cur, 0, b.cap - 1)], inf_col)
        j = torch.argmin(heads, dim=1)                       # extract-min
        c = heads[r, j]
        v = sr.mul(a_vals[r, j], b.data[torch.clamp(cur[r, j], 0, b.cap - 1)])
        allowed = active
        if mkeys is not None:
            hit = sorted_keys_contain(mkeys, r * n + c)
            allowed = allowed & (~hit if complement_mask else hit)
        prev = out_cols[r, torch.clamp(out_n - 1, min=0)]
        same = (out_n > 0) & (prev == c)
        # a new column on a full row is dropped; repeats of the last kept
        # column still accumulate
        allowed = allowed & (same | (out_n < row_cap))
        slot = torch.where(same, out_n - 1, torch.clamp(out_n, max=row_cap - 1))
        old_c, old_v = out_cols[r, slot], out_vals[r, slot]
        out_cols[r, slot] = torch.where(allowed, c, old_c)
        out_vals[r, slot] = torch.where(
            allowed, torch.where(same, sr.add(old_v, v), v), old_v)
        out_n = torch.where(allowed & ~same,
                            torch.clamp(out_n + 1, max=row_cap), out_n)
        cur[r, j] += active.long()

    if cap_c is None:
        cap_c = m * row_cap
    indptr_c = prefix_sum(out_n).to(torch.int32)
    nnz_c = min(int(indptr_c[-1]), cap_c)
    lane = torch.arange(row_cap, device=dev)[None, :]
    dest = torch.where(lane < out_n[:, None],
                       indptr_c[:-1].long()[:, None] + lane, cap_c)
    dest = torch.clamp(dest, max=cap_c).reshape(-1)
    cols_c = torch.zeros(cap_c + 1, dtype=torch.int32, device=dev)
    data_c = torch.zeros(cap_c + 1, dtype=a.dtype, device=dev)
    cols_c[dest] = torch.clamp(out_cols, min=0).reshape(-1).to(torch.int32)
    data_c[dest] = out_vals.reshape(-1)
    cols_c[cap_c] = 0
    return CSR(indptr_c, cols_c[:cap_c].clone(), data_c[:cap_c].clone(),
               torch.tensor(nnz_c, dtype=torch.int32, device=dev), (m, n),
               sorted_cols=True)


# ----------------------------------------------------------------------------
# SpMM: CSR x dense (square x tall-skinny use case, section 5.5)
# ----------------------------------------------------------------------------

def spmm(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """C = A @ X with dense X of shape (n, k); returns (m, k) in X's dtype.

    On CUDA tensors this launches the hand-written kernel
    (``repro_torch.kernels.spmm``); on CPU tensors it runs that kernel's
    plain version (``kernels/spmm/ref.py``), not the reference's gather plus
    segment sum.  Both accumulate in float32 in each row's nonzero order
    and count padded slots as 0, as the reference does: values agree with
    the reference bitwise on dyadic inputs and within one ulp per
    accumulated product otherwise.  A bfloat16 or float16 X gives X's
    dtype, where the reference promotes to float32.
    """
    from repro_torch.kernels.spmm.ops import spmm_kernel
    return spmm_kernel(a, x)


# ----------------------------------------------------------------------------
# Sort-on-demand epilogue + public dispatcher
# ----------------------------------------------------------------------------

def finalize(c: CSR, sorted_output: bool) -> CSR:
    """Sort ``c``'s rows iff sorted output was asked for and the
    accumulator emitted select (unsorted) order -- the one place the Eq. 2
    sort term is paid (C8)."""
    if sorted_output and not c.sorted_cols:
        return c.sort_rows()
    return c


def spgemm(a: CSR, b: CSR, cap_c: int | None = None,
           algorithm: Algorithm = "auto",
           sorted_output: bool | None = None,
           semiring: str | Semiring = "plus_times",
           mask: CSR | None = None, complement_mask: bool = False,
           use_case: str | None = None, plan=None, **kw) -> CSR:
    """Front door. ``auto`` consults the recipe (``core.recipe``).

    The hash kernels are (+, x)-specialised, so generalised requests on the
    hash family run :func:`spgemm_hash_jnp` (same contract, unsorted
    output).  ``plan=`` takes a :class:`repro_torch.core.plan.SpGEMMPlan`
    and ignores every other argument except ``(a, b)``.
    """
    if plan is not None:
        return plan.execute(a, b)
    if cap_c is None:
        raise ValueError("spgemm needs cap_c unless plan= is given")
    sr = resolve_semiring(semiring)
    general = sr.name != "plus_times" or mask is not None
    mask = _canon_mask(mask)
    if algorithm == "auto":
        from .recipe import choose_algorithm
        if use_case is None:
            use_case = "masked" if mask is not None else "AxA"
        algorithm = choose_algorithm(
            a, b, sorted_output=bool(sorted_output), use_case=use_case,
            semiring=sr.name, mask=mask, complement_mask=complement_mask)
    if algorithm == "dense":
        out = spgemm_dense(a, b, cap_c, semiring=sr, mask=mask,
                           complement_mask=complement_mask)
    elif algorithm == "esc":
        out = spgemm_esc(a, b, cap_c, semiring=sr, mask=mask,
                         complement_mask=complement_mask, **kw)
    elif algorithm == "heap":
        row_cap = kw.pop("row_cap", min(cap_c, b.n_cols))
        k_width = kw.pop("k_width", a.cap)
        out = spgemm_heap(a, b, row_cap=row_cap, k_width=k_width,
                          cap_c=cap_c, semiring=sr, mask=mask,
                          complement_mask=complement_mask)
    elif algorithm == "hash_jnp" or (algorithm in ("hash", "hash_vector")
                                     and general):
        for name in ("n_bins", "table_size", "vector", "schedule",
                     "indptr_c"):
            kw.pop(name, None)
        out = spgemm_hash_jnp(a, b, cap_c, semiring=sr, mask=mask,
                              complement_mask=complement_mask, **kw)
    elif algorithm in ("hash", "hash_vector"):
        from repro_torch.kernels.spgemm_hash import ops as hash_ops
        out = hash_ops.spgemm_hash(a, b, cap_c,
                                   vector=(algorithm == "hash_vector"), **kw)
    elif algorithm == "pb":
        # propagation blocking: plans eagerly (the inspection needs the
        # structure); repeat products should hold the PBPlan instead
        from .pb import pad_output, plan_pb
        pbp = plan_pb(a, b, semiring=sr.name, mask=mask,
                      complement_mask=complement_mask,
                      n_buckets=kw.pop("n_buckets", None),
                      budget=kw.pop("budget", sched.PB_BUCKET_BUDGET),
                      cache=kw.pop("cache", True))
        if cap_c < pbp.nnz_c:
            raise ValueError(f"cap_c={cap_c} < exact nnz(C)={pbp.nnz_c}")
        out = pad_output(pbp.execute(a, b), cap_c)
    elif algorithm == "bcsr":
        if general:
            raise NotImplementedError(
                "the bcsr path is (+, x)-only and unmasked; pick "
                "esc/heap/hash")
        # block path: dense (bm, bn) tiles with a block-column hash
        # accumulator, CSR in and out.  The default bcap_c is the whole
        # block grid of C; large products should pass bcap_c= (or plan)
        from .formats import bcsr_to_csr, csr_to_bcsr
        from repro_torch.kernels.spgemm_bcsr import ops as bcsr_ops
        block = tuple(kw.pop("block", (8, 8)))
        bcap_c = kw.pop("bcap_c", (-(-a.n_rows // block[0])) *
                        (-(-b.n_cols // block[1])))
        ab = csr_to_bcsr(a, block)
        bb = csr_to_bcsr(b, (block[1], block[1]))
        cb = bcsr_ops.spgemm_bcsr(ab, bb, bcap_c, **kw)
        out = bcsr_to_csr(cb, cap=cap_c)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return finalize(out, bool(sorted_output))
