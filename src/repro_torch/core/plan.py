"""Inspector-executor SpGEMM planner (port of ``repro.core.plan``).

:func:`plan_spgemm` runs the whole inspection once -- flop counting,
equal-flop binning, per-bin hash-table sizing, the exact symbolic phase and
the recipe's algorithm choice -- and freezes it in a :class:`SpGEMMPlan`.
``plan.execute(a, b)`` then runs only the numeric work; on the hash path
that is one call of the hand-written numeric kernel, on the ``bcsr`` path
a re-blocking of the operands on their device, one call of the block
kernel and a flattening back to CSR.

Plans are cached under a structure key: a blake2b digest of each operand's
``(shape, cap, nnz, sorted_cols, indptr, indices)`` plus the request's
semantic fields.  Values do not enter the key, so a re-weighted graph with
the same adjacency hits the cached plan.  The cache is one LRU shared by
every plan kind (:data:`PLAN_KINDS`), of :data:`PLAN_CACHE_CAPACITY`
entries, each filed under its key and the device its plan was made on.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .formats import CSR, memo_on_versions
from .semiring import Semiring, resolve_semiring
from . import schedule as sched
from .spgemm import (_canon_mask, _check_mask, finalize, spgemm_dense,
                     spgemm_esc, spgemm_hash_jnp, spgemm_heap, symbolic)


def structure_key(a: CSR) -> bytes:
    """Digest of a CSR's structure (pattern and static layout), not its
    values; the bytes hashed are the reference's, so both packages key a
    structure alike.  Memoized on the instance until ``indptr``,
    ``indices`` or ``nnz`` is written in place."""
    def digest():
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((a.shape, a.cap, int(a.nnz), a.sorted_cols)).encode())
        h.update(a.indptr.cpu().numpy().astype(np.int32).tobytes())
        h.update(a.indices.cpu().numpy().astype(np.int32).tobytes())
        return h.digest()
    return memo_on_versions(a, "_structure_digest",
                            (a.indptr, a.indices, a.nnz), digest)


#: plan cache: key tuple -> plan, insertion-ordered, least recent first
_CACHE: dict = {}
_STATS = {"hits": 0, "misses": 0}
#: maximum cached plans; the least recently used is evicted first.
PLAN_CACHE_CAPACITY = 256

#: every plan-kind namespace a cache key may lead with (the reference's
#: list, so dashboards key on the same kinds).
PLAN_KINDS = ("spgemm", "dist_1d", "summa", "chain", "chain_1d", "gram",
              "batch", "batch_power", "bcsr", "pb")


def plan_cache_stats() -> dict:
    """``{'hits', 'misses', 'size', 'kinds'}``; every kind of
    :data:`PLAN_KINDS` is present, zero when it has no live entries."""
    kinds: dict = {kind: 0 for kind in PLAN_KINDS}
    for key in _CACHE:
        kind = key[0] if isinstance(key[0], str) else "spgemm"
        kinds[kind] = kinds.get(kind, 0) + 1
    return {**_STATS, "size": len(_CACHE), "kinds": kinds}


def clear_plan_cache() -> None:
    """Empty the shared LRU and reset the hit/miss counters."""
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0


def _slot(key: tuple, device) -> tuple:
    # a plan holds tensors on the device it was inspected on, so the LRU
    # files it under that device too; ``plan.key`` stays the reference's
    return key + (torch.device(device),)


def cache_lookup(key: tuple, device):
    """Consult the shared LRU for ``key`` planned on ``device`` (counts a
    hit or a miss); a hit becomes the most recent entry."""
    slot = _slot(key, device)
    hit = _CACHE.get(slot)
    if hit is not None:
        _STATS["hits"] += 1
        _CACHE[slot] = _CACHE.pop(slot)
        return hit
    _STATS["misses"] += 1
    return None


def cache_store(key: tuple, device, value) -> None:
    """Insert under ``key`` and ``device``, evicting the least recent past
    capacity.  Pop before insert, so a re-stored key becomes the newest
    entry as a lookup hit does."""
    slot = _slot(key, device)
    _CACHE.pop(slot, None)
    _CACHE[slot] = value
    while len(_CACHE) > PLAN_CACHE_CAPACITY:
        _CACHE.pop(next(iter(_CACHE)))


def _plan_key(a: CSR, b: CSR, mask: Optional[CSR], sr_name: str,
              complement_mask: bool, sorted_output: bool, algorithm: str,
              use_case: Optional[str], n_bins: int) -> tuple:
    return ("spgemm", structure_key(a), structure_key(b),
            None if mask is None else structure_key(mask),
            sr_name, complement_mask, sorted_output, algorithm, use_case,
            n_bins)


@dataclass(frozen=True)
class SpGEMMPlan:
    """Frozen product recipe for one (A-structure, B-structure) pair: the
    flop profile and bins (Fig. 6), per-bin table sizes and the static
    table allocation (Fig. 7 lines 9-12), the exact ``indptr_c`` and
    capacities from the symbolic phase, and the recipe's choice."""
    key: tuple = dataclasses.field(repr=False)
    algorithm: str
    semiring: str
    complement_mask: bool
    sorted_output: bool
    mask: Optional[CSR] = dataclasses.field(repr=False)
    shape_a: Tuple[int, int]
    shape_b: Tuple[int, int]
    cap_a: int
    cap_b: int
    nnz_a: int
    nnz_b: int
    n_bins: int
    flop: torch.Tensor = dataclasses.field(repr=False)       # per-row flop
    total_flop: int
    flop_cap: int            # exact expansion bound for esc/fallback paths
    offsets: torch.Tensor = dataclasses.field(repr=False)    # (n_bins + 1,)
    bin_tsize: torch.Tensor = dataclasses.field(repr=False)  # (n_bins,) p2
    table_size: int          # static table allocation (bin max, p2)
    row_nnz_c: torch.Tensor = dataclasses.field(repr=False)
    indptr_c: torch.Tensor = dataclasses.field(repr=False)
    nnz_c: int
    cap_c: int               # exact nnz(C) as a static capacity
    row_cap: int             # heap: max nnz(c_i*)
    k_width: int             # heap: max nnz(a_i*)
    #: where the choice came from: "explicit" or "heuristic"
    provenance: str = "explicit"
    #: ``algorithm == "bcsr"`` only: the tile shape the CSR operands are
    #: re-blocked into and the nested block plan
    #: (:class:`repro_torch.core.bcsr.BCSRPlan`) the execute runs
    block: Optional[Tuple[int, int]] = None
    bcsr_plan: object = dataclasses.field(default=None, repr=False)
    #: ``algorithm == "pb"`` only: the nested propagation-blocking plan
    #: (:class:`repro_torch.core.pb.PBPlan`) the execute runs
    pb_plan: object = dataclasses.field(default=None, repr=False)

    def check_structure(self, a: CSR, b: CSR, strict: bool = False) -> None:
        """Cheap (shapes/caps/nnz) or strict (re-hash) structure check."""
        if a.shape != self.shape_a or b.shape != self.shape_b:
            raise ValueError(f"plan is for {self.shape_a}x{self.shape_b}, "
                             f"got {a.shape}x{b.shape}")
        if a.cap != self.cap_a or b.cap != self.cap_b:
            raise ValueError(
                "operand capacities differ from the planned structure")
        if int(a.nnz) != self.nnz_a or int(b.nnz) != self.nnz_b:
            raise ValueError("operand nnz differs from the planned structure "
                             "(replan or clear_plan_cache)")
        if strict and (structure_key(a), structure_key(b)) != self.key[1:3]:
            raise ValueError(
                "operand structure differs from the planned structure")

    def execute(self, a: CSR, b: CSR,
                sorted_output: Optional[bool] = None) -> CSR:
        """Numeric phase only, with this plan's algorithm, semiring and
        mask.  ``sorted_output`` overrides the recorded sortedness for this
        call: sorting is a pure epilogue (:func:`finalize`)."""
        self.check_structure(a, b)
        sr = resolve_semiring(self.semiring)
        general = sr.name != "plus_times" or self.mask is not None
        algo = self.algorithm
        if algo == "dense":
            out = spgemm_dense(a, b, self.cap_c, semiring=sr, mask=self.mask,
                               complement_mask=self.complement_mask)
        elif algo == "esc":
            out = spgemm_esc(a, b, self.cap_c, flop_cap=self.flop_cap,
                             semiring=sr, mask=self.mask,
                             complement_mask=self.complement_mask)
        elif algo == "heap":
            out = spgemm_heap(a, b, row_cap=self.row_cap,
                              k_width=self.k_width, cap_c=self.cap_c,
                              semiring=sr, mask=self.mask,
                              complement_mask=self.complement_mask)
        elif algo in ("hash", "hash_vector", "hash_jnp"):
            if general or algo == "hash_jnp":
                out = spgemm_hash_jnp(a, b, self.cap_c,
                                      flop_cap=self.flop_cap, semiring=sr,
                                      mask=self.mask,
                                      complement_mask=self.complement_mask)
            else:
                from repro_torch.kernels.spgemm_hash import ops as hash_ops
                out = hash_ops.spgemm_hash(
                    a, b, self.cap_c, vector=(algo == "hash_vector"),
                    table_size=self.table_size,
                    schedule=(self.offsets, self.bin_tsize),
                    indptr_c=self.indptr_c)
        elif algo == "bcsr":
            # re-block sparsely on the device at the planned capacities
            # (never through a dense matrix), run the frozen block plan,
            # flatten back to CSR
            from .formats import bcsr_to_csr, csr_to_bcsr
            bp = self.bcsr_plan
            ab = csr_to_bcsr(a, bp.block_a, bcap=bp.bcap_a)
            bb = csr_to_bcsr(b, bp.block_b, bcap=bp.bcap_b)
            out = bcsr_to_csr(bp.execute(ab, bb), cap=self.cap_c)
        elif algo == "pb":
            from .pb import pad_output
            out = pad_output(self.pb_plan.execute(a, b), self.cap_c)
        else:
            raise ValueError(f"plan holds unknown algorithm {algo!r}")
        so = self.sorted_output if sorted_output is None else sorted_output
        return finalize(out, so)

    __call__ = execute


def inspect_spgemm(a: CSR, b: CSR, *, algorithm: str = "auto",
                   semiring: str | Semiring = "plus_times",
                   mask: Optional[CSR] = None, complement_mask: bool = False,
                   sorted_output: bool = False,
                   use_case: Optional[str] = None, n_bins: int = 8,
                   bucket_caps: bool = False, a_row_nnz=None) -> dict:
    """The structural half of :func:`plan_spgemm`: flop profile and bins,
    table sizes, the exact symbolic phase and the recipe's choice, as a
    dict of the plan's fields (``algorithm`` resolved).

    Every field is a function of the column *set* of each row, not of the
    order of A's entries in it, so a chain asks a stage's route here
    before it decides whether that stage's hop is sorted, and hands the
    result to :func:`plan_spgemm` (``inspection=``) for either order.
    """
    from repro_torch.kernels.spgemm_hash.kernel import CHUNK
    sr = resolve_semiring(semiring)
    _check_mask(a, b, mask)
    mask = _canon_mask(mask)
    n = b.n_cols

    # Fig. 6: flop profile + equal-flop bins
    flop, offsets, tsize = sched.make_schedule_eager(a, b, n_bins)
    max_row_flop = int(flop.max()) if flop.numel() else 0
    total_flop = int(flop.to(torch.int64).sum())

    # Fig. 7 lines 9-12: static allocation = global-max p2 bound; per-bin
    # effective sizes ride in the plan
    table_size = max(sched.lowest_p2(min(max_row_flop, n) + 1), CHUNK)
    bin_tsize = sched.bin_table_sizes(tsize, n, table_size, floor=CHUNK)

    # symbolic phase with the exact flop bound
    flop_cap = max(total_flop, 1)
    if bucket_caps:
        flop_cap = sched.lowest_p2(flop_cap)
    row_nnz_c, indptr_c, _, _ = symbolic(
        a, b, mask=mask, complement_mask=complement_mask, flop_cap=flop_cap)
    nnz_c = int(row_nnz_c.to(torch.int64).sum())
    cap_c = max(nnz_c, 1)
    row_cap = max(int(row_nnz_c.max()) if row_nnz_c.numel() else 0, 1)
    a_rows = a.row_nnz()
    k_width = max(int(a_rows.max()) if a_rows.numel() else 0, 1)
    if bucket_caps:
        cap_c = sched.lowest_p2(cap_c)
        row_cap = sched.lowest_p2(row_cap)

    if algorithm == "heap" and not (a.sorted_cols and b.sorted_cols):
        raise AssertionError("heap path requires sorted inputs")
    provenance = "explicit"
    if algorithm == "auto":
        uc = use_case if use_case is not None else \
            ("masked" if mask is not None else "AxA")
        from .recipe import recommend
        algorithm, _ = recommend(a, b, sorted_output=sorted_output,
                                 use_case=uc, semiring=sr.name, mask=mask,
                                 complement_mask=complement_mask,
                                 row_nnz_c=row_nnz_c, a_row_nnz=a_row_nnz)
        provenance = "heuristic"
        if algorithm == "heap" and not (a.sorted_cols and b.sorted_cols):
            # the inputs cannot feed heap; hash keeps the unsorted contract
            algorithm = "hash"
    return dict(algorithm=algorithm, provenance=provenance, mask=mask,
                flop=flop, total_flop=total_flop, flop_cap=flop_cap,
                offsets=offsets, bin_tsize=bin_tsize, table_size=table_size,
                row_nnz_c=row_nnz_c, indptr_c=indptr_c, nnz_c=nnz_c,
                cap_c=cap_c, row_cap=row_cap, k_width=k_width)


def plan_spgemm(a: CSR, b: CSR, *, algorithm: str = "auto",
                semiring: str | Semiring = "plus_times",
                mask: Optional[CSR] = None, complement_mask: bool = False,
                sorted_output: bool = False, use_case: Optional[str] = None,
                n_bins: int = 8, cache: bool = True,
                bucket_caps: bool = False, a_row_nnz=None,
                autotune: bool = False,
                block: Tuple[int, int] = (8, 8),
                inspection: Optional[dict] = None) -> SpGEMMPlan:
    """Run the whole inspection once and freeze it as a
    :class:`SpGEMMPlan` on the operands' device.

    With ``cache=True`` a structure-identical repeat request returns the
    cached plan.  ``bucket_caps=True`` rounds ``cap_c``, ``flop_cap`` and
    ``row_cap`` up to powers of two, so similar structures share shapes.
    ``a_row_nnz`` marks A as a chain intermediate (the recipe's A-side
    statistics come from it).  ``block`` is the tile shape the ``bcsr``
    route re-blocks the operands into (A tiles ``block``, B tiles
    ``(block[1], block[1])``); it matters only when the resolved algorithm
    is ``bcsr``, and the plan then nests a frozen
    :class:`repro_torch.core.bcsr.BCSRPlan`.  ``inspection`` is
    :func:`inspect_spgemm`'s result for the same request on operands with
    the same column sets (a chain's intermediate before its hop is
    sorted); the plan then skips that half.  ``autotune=True`` is not
    ported yet and raises.

    Caveat of the ``bcsr`` route, as in the reference: its execute
    flattens the block product with ``bcsr_to_csr``, which prunes every
    cell that computes to exactly 0.  With signed values whose products
    cancel, the output then holds fewer entries than ``nnz_c`` and
    ``indptr_c`` (and the hash route) count, and its structure depends on
    the values.  Rounding differs from the reference's kernel, so a cell
    that cancels only up to rounding can be 0 in one package and not in
    the other.
    """
    if autotune:
        raise NotImplementedError("autotune= is not ported yet")
    sr = resolve_semiring(semiring)
    arn_digest = None
    if a_row_nnz is not None:
        arn_digest = hashlib.blake2b(
            np.asarray(torch.as_tensor(a_row_nnz).cpu()).tobytes(),
            digest_size=8).digest()
    block = tuple(block)
    key = _plan_key(a, b, mask, sr.name, complement_mask, sorted_output,
                    algorithm, use_case, n_bins) + (bucket_caps, arn_digest,
                                                    block)
    if cache:
        hit = cache_lookup(key, a.device)
        if hit is not None:
            return hit

    ins = inspection if inspection is not None else inspect_spgemm(
        a, b, algorithm=algorithm, semiring=sr, mask=mask,
        complement_mask=complement_mask, sorted_output=sorted_output,
        use_case=use_case, n_bins=n_bins, bucket_caps=bucket_caps,
        a_row_nnz=a_row_nnz)
    algorithm, mask = ins["algorithm"], ins["mask"]
    bcsr_plan = None
    if algorithm == "bcsr":
        if sr.name != "plus_times" or mask is not None:
            raise NotImplementedError(
                "the bcsr block path supports plus_times unmasked "
                "products only; plan esc/heap/hash instead")
        # nest the block-granularity inspection under the shared LRU's
        # "bcsr" kind: re-block the operand patterns once, freeze both
        # levels together
        from .bcsr import plan_bcsr
        from .formats import csr_to_bcsr
        bcsr_plan = plan_bcsr(csr_to_bcsr(a, block),
                              csr_to_bcsr(b, (block[1], block[1])),
                              n_bins=n_bins, cache=cache)
    pb_plan = None
    if algorithm == "pb":
        # nest the propagation-blocking inspection under the shared LRU's
        # "pb" kind; it handles every semiring and prunes masks itself
        from .pb import plan_pb
        pb_plan = plan_pb(a, b, semiring=sr.name, mask=mask,
                          complement_mask=complement_mask, cache=cache)

    plan = SpGEMMPlan(
        key=key, semiring=sr.name, complement_mask=complement_mask,
        sorted_output=sorted_output, shape_a=a.shape, shape_b=b.shape,
        cap_a=a.cap, cap_b=b.cap, nnz_a=int(a.nnz), nnz_b=int(b.nnz),
        n_bins=n_bins, block=block if algorithm == "bcsr" else None,
        bcsr_plan=bcsr_plan, pb_plan=pb_plan, **ins)
    if cache:
        cache_store(key, a.device, plan)
    return plan
