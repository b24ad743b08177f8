"""Inspector-executor SpGEMM planner (port of ``repro.core.plan``).

:func:`plan_spgemm` runs the whole inspection once -- flop counting,
equal-flop binning, per-bin hash-table sizing, the exact symbolic phase and
the recipe's algorithm choice -- and freezes it in a :class:`SpGEMMPlan`.
``plan.execute(a, b)`` then runs only the numeric work; on the hash path
that is one call of the hand-written numeric kernel.

Plans are cached under a structure key: a blake2b digest of each operand's
``(shape, cap, nnz, sorted_cols, indptr, indices)`` plus the request's
semantic fields.  Values do not enter the key, so a re-weighted graph with
the same adjacency hits the cached plan.  The cache is one LRU shared by
every plan kind (:data:`PLAN_KINDS`), of :data:`PLAN_CACHE_CAPACITY`
entries.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .formats import CSR
from .semiring import Semiring, resolve_semiring
from . import schedule as sched
from .spgemm import (_canon_mask, _check_mask, finalize, spgemm_dense,
                     spgemm_esc, spgemm_hash_jnp, spgemm_heap, symbolic)


def structure_key(a: CSR) -> bytes:
    """Digest of a CSR's structure (pattern and static layout), not its
    values; the bytes hashed are the reference's, so both packages key a
    structure alike.  Memoized on the frozen instance."""
    cached = a.__dict__.get("_structure_digest")
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((a.shape, a.cap, int(a.nnz), a.sorted_cols)).encode())
    h.update(a.indptr.cpu().numpy().astype(np.int32).tobytes())
    h.update(a.indices.cpu().numpy().astype(np.int32).tobytes())
    digest = h.digest()
    object.__setattr__(a, "_structure_digest", digest)
    return digest


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


def cache_lookup(key: tuple):
    """Consult the shared LRU (counts a hit or a miss); a hit becomes the
    most recent entry."""
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        _CACHE[key] = _CACHE.pop(key)
        return hit
    _STATS["misses"] += 1
    return None


def cache_store(key: tuple, value) -> None:
    """Insert, evicting the least recent past capacity.  Pop before insert,
    so a re-stored key becomes the newest entry as a lookup hit does."""
    _CACHE.pop(key, None)
    _CACHE[key] = value
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
        else:
            raise ValueError(f"plan holds unknown algorithm {algo!r}")
        so = self.sorted_output if sorted_output is None else sorted_output
        return finalize(out, so)

    __call__ = execute


def plan_spgemm(a: CSR, b: CSR, *, algorithm: str = "auto",
                semiring: str | Semiring = "plus_times",
                mask: Optional[CSR] = None, complement_mask: bool = False,
                sorted_output: bool = False, use_case: Optional[str] = None,
                n_bins: int = 8, cache: bool = True,
                bucket_caps: bool = False, a_row_nnz=None,
                autotune: bool = False) -> SpGEMMPlan:
    """Run the whole inspection once and freeze it as a
    :class:`SpGEMMPlan` on the operands' device.

    With ``cache=True`` a structure-identical repeat request returns the
    cached plan.  ``bucket_caps=True`` rounds ``cap_c``, ``flop_cap`` and
    ``row_cap`` up to powers of two, so similar structures share shapes.
    ``a_row_nnz`` marks A as a chain intermediate (the recipe's A-side
    statistics come from it).  ``autotune=True`` and the ``bcsr``/``pb``
    algorithms are not ported yet and raise.
    """
    if autotune:
        raise NotImplementedError("autotune= is not ported yet")
    sr = resolve_semiring(semiring)
    arn_digest = None
    if a_row_nnz is not None:
        arn_digest = hashlib.blake2b(
            np.asarray(torch.as_tensor(a_row_nnz).cpu()).tobytes(),
            digest_size=8).digest()
    key = _plan_key(a, b, mask, sr.name, complement_mask, sorted_output,
                    algorithm, use_case, n_bins) + (bucket_caps, arn_digest)
    if cache:
        hit = cache_lookup(key)
        if hit is not None:
            return hit

    from repro_torch.kernels.spgemm_hash.kernel import CHUNK
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
    if algorithm in ("bcsr", "pb"):
        raise NotImplementedError(
            f"the {algorithm} plan is not ported yet (recipe chose it for "
            f"this input); plan esc/heap/hash instead")

    plan = SpGEMMPlan(
        key=key, algorithm=algorithm, semiring=sr.name,
        complement_mask=complement_mask, sorted_output=sorted_output,
        mask=mask, shape_a=a.shape, shape_b=b.shape, cap_a=a.cap,
        cap_b=b.cap, nnz_a=int(a.nnz), nnz_b=int(b.nnz), n_bins=n_bins,
        flop=flop, total_flop=total_flop, flop_cap=flop_cap,
        offsets=offsets, bin_tsize=bin_tsize, table_size=table_size,
        row_nnz_c=row_nnz_c, indptr_c=indptr_c, nnz_c=nnz_c, cap_c=cap_c,
        row_cap=row_cap, k_width=k_width, provenance=provenance)
    if cache:
        cache_store(key, plan)
    return plan
