"""Plan-composed SpGEMM chains (port of ``repro.core.chain``, its
single-device parts).

Real SpGEMM users run chains, not single products: A^2 and A^3 for
triangle counting and Markov-clustering expansion, the Gram product A^T.A,
and the Galerkin triple product R.A.P of multigrid and graph coarsening.

:func:`plan_chain` runs the inspection left to right once: stage ``k`` is
a full :func:`repro_torch.core.plan.plan_spgemm` whose A operand is the
intermediate that stage ``k-1`` materializes at plan time.  Every stage's
frozen capacities, schedules and recorded algorithm ride in one cached
:class:`ChainPlan`, under the same structure-keyed LRU as single products.
Stage ``k``'s recipe receives stage ``k-1``'s recorded ``row_nnz_c``
(``plan_spgemm(a_row_nnz=...)``), because an intermediate's compression
and skew differ from the operands that produced it.

``chain.execute(...)`` runs the numeric phases only and keeps
intermediates unsorted between stages, so the paper's C8 finding (hash
SpGEMM gains when rows need not be sorted) applies at every hop;
``finalize`` is the single sort site.

**Slot order on the card.**  A plan freezes what it reads of its operands'
*structure*, and the set of columns in each row of an intermediate is a
function of structure.  Their order is not: the hash kernel's inserts race
and its flush takes positions from an atomic cursor, so a row's column
order differs from call to call.  A stage whose plan names its A operand's
value *slots* (:data:`A_SLOT_ALGORITHMS`) would then read the wrong values
on execute.  So the hop into such a stage is sorted -- at plan time, where
the stage is planned on the sorted intermediate, and at every execute --
and the sorted intermediate is canonical: the same positions on every
call.  Every other hop stays unsorted.  :attr:`ChainPlan.sorted_hops`
records the choice.

On top of the chain plan ride :func:`galerkin` (R.A.P), :func:`gram`
(A^T.A through a transpose-aware :class:`GramPlan` that freezes the
transpose's gather permutation, so a repeat execute re-gathers values
only), :func:`plan_power` (A^k) and :func:`plan_batch_power` (A_i^k over a
fleet, one :func:`repro_torch.core.batch.plan_batch` per stage).  Every
stage dispatches through its plan's execute, so a stage whose recipe
picked the hash family launches the hash numeric kernel, a sorted
barely-compressing one the PB kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .formats import CSR, csr_transpose
from .plan import (SpGEMMPlan, cache_lookup, cache_store, inspect_spgemm,
                   plan_spgemm, structure_key)
from .semiring import Semiring, resolve_semiring
from .spgemm import finalize

#: Algorithms whose frozen plan names its A operand's value slots, so the
#: hop into them must be sorted: ``pb`` freezes ``src_a``, the slot of A
#: that each partial product reads (``core/pb.py``).  Every other route the
#: planner can record reads A's entries at execute time: the hash family,
#: ``esc``, ``heap``, ``dense`` and ``hash_jnp`` through A's row pointer
#: and columns, ``bcsr`` by re-blocking A's entries by (row, column),
#: which no entry order changes (``formats.csr_to_bcsr``).  No batch class
#: (``esc``, ``heap``, ``hash``, ``hash_vector``, ``hash_jnp``) names A's
#: slots either, so :func:`plan_batch_power`'s hops all stay unsorted.
A_SLOT_ALGORITHMS = frozenset({"pb"})


def _check_chain_shapes(mats: Sequence[CSR], mask: Optional[CSR]) -> None:
    if len(mats) < 2:
        raise ValueError("a chain needs at least two operands")
    for k in range(len(mats) - 1):
        if mats[k].n_cols != mats[k + 1].n_rows:
            raise ValueError(f"chain stage {k}: {mats[k].shape} @ "
                             f"{mats[k + 1].shape} shapes do not compose")
    if mask is not None:
        out_shape = (mats[0].n_rows, mats[-1].n_cols)
        if mask.shape != out_shape:
            raise ValueError(f"mask shape {mask.shape} != chain output "
                             f"shape {out_shape}")


# ----------------------------------------------------------------------------
# ChainPlan: composed single-product plans
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainPlan:
    """Frozen inspection of a whole product chain ``mats[0] @ ... @
    mats[-1]``.

    ``stages[k]`` is the :class:`SpGEMMPlan` of product ``k``; for ``k >=
    1`` its A operand is the intermediate materialized at plan time, whose
    row structure :meth:`execute` reproduces.  ``sorted_hops[k]`` says
    whether stage ``k``'s output is sorted before stage ``k + 1`` reads it
    (``sort_intermediates``, or the slot-order rule of the module
    docstring).  The final output's sortedness is the plan's
    ``sorted_output``, overridable per call.
    """
    key: tuple = dataclasses.field(repr=False)
    stages: Tuple[SpGEMMPlan, ...] = dataclasses.field(repr=False)
    semiring: str
    complement_mask: bool
    sorted_output: bool
    sort_intermediates: bool
    sorted_hops: Tuple[bool, ...]          # one per hop, len(stages) - 1
    shapes: Tuple[Tuple[int, int], ...]    # operand shapes, left to right
    caps: Tuple[int, ...]
    nnzs: Tuple[int, ...]
    nnz_c: int                             # exact nnz of the final output
    total_flop: int                        # summed over every stage

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def algorithms(self) -> Tuple[str, ...]:
        """Per-stage recorded algorithm choices (recipe-resolved)."""
        return tuple(p.algorithm for p in self.stages)

    def check_structure(self, mats: Sequence[CSR]) -> None:
        """Cheap shapes/caps/nnz check of every operand against the plan;
        raises ``ValueError``."""
        if len(mats) != len(self.shapes):
            raise ValueError(f"plan composes {len(self.shapes)} operands, "
                             f"got {len(mats)}")
        for k, op in enumerate(mats):
            if op.shape != self.shapes[k] or op.cap != self.caps[k]:
                raise ValueError(
                    f"chain operand {k}: planned {self.shapes[k]}/cap "
                    f"{self.caps[k]}, got {op.shape}/cap {op.cap}")
            if int(op.nnz) != self.nnzs[k]:
                raise ValueError(f"chain operand {k} nnz differs from the "
                                 f"planned structure (replan or "
                                 f"clear_plan_cache)")

    def execute(self, *mats: CSR,
                sorted_output: Optional[bool] = None) -> CSR:
        """Numeric phases only, end to end: no re-inspection.

        Takes the operands positionally or as one sequence.  Each hop
        keeps its planned sortedness (``sorted_hops``); only the final
        stage pays the sort epilogue, and only when ``sorted_output``
        (argument, else the plan's flag) asks for it.
        """
        if len(mats) == 1 and not isinstance(mats[0], CSR):
            mats = tuple(mats[0])
        self.check_structure(mats)
        so = self.sorted_output if sorted_output is None else sorted_output
        cur = mats[0]
        last = len(self.stages) - 1
        for k, stage in enumerate(self.stages):
            cur = stage.execute(cur, mats[k + 1],
                                sorted_output=so if k == last
                                else self.sorted_hops[k])
        return cur

    __call__ = execute


def plan_chain(mats: Sequence[CSR], *,
               algorithm: Union[str, Sequence[str]] = "auto",
               semiring: str | Semiring = "plus_times",
               mask: Optional[CSR] = None, complement_mask: bool = False,
               sorted_output: bool = False, sort_intermediates: bool = False,
               use_case: Optional[str] = None, n_bins: int = 8,
               cache: bool = True, bucket_caps: bool = False) -> ChainPlan:
    """Inspect a product chain left to right once; freeze a
    :class:`ChainPlan`.

    ``mats`` is the operand sequence (at least two); the chain computes
    ``mats[0] @ mats[1] @ ... @ mats[-1]`` left to right.  ``algorithm``
    is one name for every stage or one per stage; ``"auto"`` lets each
    stage's recipe decide, with the previous stage's ``row_nnz_c`` as its
    A-side statistics.  ``mask`` (coordinates of the final output) and
    ``sorted_output`` apply to the last stage only; intermediates are
    planned unsorted unless ``sort_intermediates`` (the measured-slower
    control) or the stage they feed names A's value slots
    (:data:`A_SLOT_ALGORITHMS`).  ``bucket_caps`` p2-rounds every stage's
    capacities.  Cached under a ``("chain", ...)`` key in the shared plan
    LRU; stage plans are cached on their own too.
    """
    mats = list(mats)
    _check_chain_shapes(mats, mask)
    sr = resolve_semiring(semiring)
    n_stages = len(mats) - 1
    algos = tuple(algorithm) if not isinstance(algorithm, str) \
        else (algorithm,) * n_stages
    if len(algos) != n_stages:
        raise ValueError(f"algorithm must be one name or {n_stages} "
                         f"per-stage names")
    key = ("chain", tuple(structure_key(m) for m in mats),
           None if mask is None else structure_key(mask), sr.name,
           complement_mask, sorted_output, sort_intermediates, algos,
           use_case, n_bins, bucket_caps)
    if cache:
        hit = cache_lookup(key, mats[0].device)
        if hit is not None:
            return hit

    stages: List[SpGEMMPlan] = []
    hops: List[bool] = []
    cur = mats[0]
    for k in range(n_stages):
        last = k == n_stages - 1
        kw = dict(algorithm=algos[k], semiring=sr.name,
                  mask=mask if last else None,
                  complement_mask=complement_mask if last else False,
                  sorted_output=sorted_output if last else sort_intermediates,
                  use_case=use_case, n_bins=n_bins, bucket_caps=bucket_caps,
                  a_row_nnz=stages[-1].row_nnz_c if stages else None)
        inspection = None
        if hops and not hops[-1]:
            # decide the hop once, from the stage's route: the pinned name,
            # or the recipe's choice on the intermediate's column sets; a
            # route that names A's slots is planned on, and at every
            # execute handed, the sorted intermediate
            algo = algos[k]
            if algo == "auto":
                inspection = inspect_spgemm(cur, mats[k + 1], **kw)
                algo = inspection["algorithm"]
            if algo in A_SLOT_ALGORITHMS:
                hops[-1] = True
                cur = finalize(cur, True)
        stages.append(plan_spgemm(cur, mats[k + 1], cache=cache,
                                  inspection=inspection, **kw))
        if not last:
            # materialize the intermediate: this is the inspection of
            # stage k+1's A operand (only its structure is consumed)
            cur = stages[-1].execute(cur, mats[k + 1],
                                     sorted_output=sort_intermediates)
            hops.append(sort_intermediates)

    plan = ChainPlan(
        key=key, stages=tuple(stages), semiring=sr.name,
        complement_mask=complement_mask, sorted_output=sorted_output,
        sort_intermediates=sort_intermediates, sorted_hops=tuple(hops),
        shapes=tuple(m.shape for m in mats),
        caps=tuple(m.cap for m in mats),
        nnzs=tuple(int(m.nnz) for m in mats),
        nnz_c=stages[-1].nnz_c,
        total_flop=sum(p.total_flop for p in stages))
    if cache:
        cache_store(key, mats[0].device, plan)
    return plan


# ----------------------------------------------------------------------------
# Chain-shaped workloads: Galerkin triple product, A^k powers
# ----------------------------------------------------------------------------

def plan_galerkin(r: CSR, a: CSR, p: CSR, **kw) -> ChainPlan:
    """Plan the Galerkin triple product ``R @ A @ P`` (multigrid, graph
    coarsening; R is typically P^T, :func:`csr_transpose`).  Keyword
    arguments are :func:`plan_chain`'s."""
    return plan_chain([r, a, p], **kw)


def galerkin(r: CSR, a: CSR, p: CSR, *, sorted_output: bool = False,
             **kw) -> CSR:
    """One-shot planned ``R @ A @ P``: plans (or takes the cached plan --
    a re-weighted A under a fixed hierarchy runs numeric-only) and
    executes."""
    plan = plan_galerkin(r, a, p, sorted_output=sorted_output, **kw)
    return plan.execute(r, a, p)


def plan_power(a: CSR, k: int, **kw) -> ChainPlan:
    """Plan ``A^k`` (k >= 2) as a left-to-right chain of k-1 products."""
    if k < 2:
        raise ValueError("plan_power needs k >= 2 (k == 1 is the identity "
                         "plan)")
    return plan_chain([a] * k, **kw)


# ----------------------------------------------------------------------------
# Batched powers: A_i^k over a fleet (core.batch x core.chain)
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchedPowerPlan:
    """Frozen ``[A_i^k for i in fleet]``: one
    :class:`repro_torch.core.batch.BatchedPlan` per chain stage,
    intermediates unsorted between stages (no batch class names A's
    slots).  Stage ``j`` multiplies the fleet's intermediates by the
    original operands, one classifying launch and one launch per table
    class per hash plan class."""
    key: tuple = dataclasses.field(repr=False)
    stages: Tuple = dataclasses.field(repr=False)    # BatchedPlans
    semiring: str
    sorted_output: bool
    n_products: int
    shapes: Tuple[Tuple[int, int], ...]
    nnz_cs: Tuple[int, ...]        # final stage, per product

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def n_classes(self) -> int:
        """Capacity classes (executors) across the whole plan."""
        return sum(p.n_classes for p in self.stages)

    def execute(self, mats: Sequence[CSR],
                sorted_output: Optional[bool] = None) -> list:
        """Numeric phases only, fleet x stages; returns per-product CSRs.
        Only the final stage pays the sort epilogue, and only when
        asked."""
        mats = list(mats)
        if len(mats) != self.n_products:
            raise ValueError(f"plan is for {self.n_products} products, got "
                             f"{len(mats)}")
        so = self.sorted_output if sorted_output is None else sorted_output
        cur = mats
        last = len(self.stages) - 1
        for j, stage in enumerate(self.stages):
            cur = stage.execute(list(zip(cur, mats)),
                                sorted_output=so if j == last else False)
        return cur

    __call__ = execute


def plan_batch_power(mats: Sequence[CSR], k: int, *,
                     algorithm: str = "auto",
                     semiring: str | Semiring = "plus_times",
                     sorted_output: bool = False,
                     cache: bool = True) -> BatchedPowerPlan:
    """Inspect ``[A_i^k for i in fleet]`` once; freeze the staged batch.

    Stage ``j`` pairs the stage ``j-1`` intermediates (materialized at plan
    time, as in :func:`plan_chain`) with the original operands; each stage
    is a :func:`repro_torch.core.batch.plan_batch` whose p2 capacity
    classes are shared through the plan LRU.  Cached under
    ``("batch_power", ...)``.
    """
    from .batch import plan_batch
    mats = list(mats)
    if not mats:
        raise ValueError("a batched power needs at least one operand")
    if k < 2:
        raise ValueError("plan_batch_power needs k >= 2")
    for m in mats:
        if m.n_rows != m.n_cols:
            raise ValueError(f"powers need square operands; got {m.shape}")
    sr = resolve_semiring(semiring)
    key = ("batch_power", tuple(structure_key(m) for m in mats), k,
           sr.name, sorted_output, algorithm)
    if cache:
        hit = cache_lookup(key, mats[0].device)
        if hit is not None:
            return hit

    stages = []
    cur = mats
    for j in range(k - 1):
        last = j == k - 2
        stage = plan_batch(list(zip(cur, mats)), algorithm=algorithm,
                           semiring=sr.name,
                           sorted_output=sorted_output if last else False,
                           cache=cache)
        stages.append(stage)
        if not last:
            cur = stage.execute(list(zip(cur, mats)))

    plan = BatchedPowerPlan(
        key=key, stages=tuple(stages), semiring=sr.name,
        sorted_output=sorted_output, n_products=len(mats),
        shapes=tuple(m.shape for m in mats), nnz_cs=stages[-1].nnz_cs)
    if cache:
        cache_store(key, mats[0].device, plan)
    return plan


# ----------------------------------------------------------------------------
# Gram product: A^T A via a transpose-aware plan
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class GramPlan:
    """Frozen ``A^T @ A``: the transpose's structure plus the product plan.

    The transpose's structure -- its row pointer, columns and the gather
    permutation ``t_perm`` with ``A^T.data == A.data[t_perm]`` -- is
    computed once, on the operand's device, and frozen with zeroed values,
    so :meth:`execute` rebuilds A^T with one gather and runs the planned
    product: a re-weighted A reuses everything.  A^T is sorted, so its
    slots are canonical for any product route.
    """
    key: tuple = dataclasses.field(repr=False)
    product: SpGEMMPlan = dataclasses.field(repr=False)
    t_struct: CSR = dataclasses.field(repr=False)     # data zeroed
    t_perm: torch.Tensor = dataclasses.field(repr=False)
    shape_a: Tuple[int, int]
    cap_a: int
    nnz_a: int

    @property
    def nnz_c(self) -> int:
        return self.product.nnz_c

    @property
    def algorithm(self) -> str:
        return self.product.algorithm

    def check_structure(self, a: CSR) -> None:
        if a.shape != self.shape_a or a.cap != self.cap_a:
            raise ValueError(f"plan is for {self.shape_a}/cap {self.cap_a}, "
                             f"got {a.shape}/cap {a.cap}")
        if int(a.nnz) != self.nnz_a:
            raise ValueError("operand nnz differs from the planned structure")

    def execute(self, a: CSR, sorted_output: Optional[bool] = None) -> CSR:
        """Numeric phase only: gather A's values through the frozen
        transpose permutation, then run the planned ``A^T @ A``."""
        self.check_structure(a)
        t = self.t_struct
        live = torch.arange(t.cap, device=t.device) < t.nnz
        vals = torch.where(live, a.data[self.t_perm],
                           torch.zeros((), dtype=a.dtype, device=a.device))
        return self.product.execute(dataclasses.replace(t, data=vals), a,
                                    sorted_output=sorted_output)

    __call__ = execute


def plan_gram(a: CSR, *, algorithm: str = "auto",
              semiring: str | Semiring = "plus_times",
              sorted_output: bool = False, n_bins: int = 8,
              cache: bool = True, bucket_caps: bool = False) -> GramPlan:
    """Inspect ``A^T @ A`` once -- transpose included -- and freeze it.
    Cached under a ``("gram", ...)`` key in the shared LRU."""
    sr = resolve_semiring(semiring)
    key = ("gram", structure_key(a), sr.name, sorted_output, algorithm,
           n_bins, bucket_caps)
    if cache:
        hit = cache_lookup(key, a.device)
        if hit is not None:
            return hit
    t, perm = csr_transpose(a, return_perm=True)
    product = plan_spgemm(t, a, algorithm=algorithm, semiring=sr.name,
                          sorted_output=sorted_output, n_bins=n_bins,
                          cache=cache, bucket_caps=bucket_caps)
    plan = GramPlan(
        key=key, product=product,
        t_struct=dataclasses.replace(t, data=torch.zeros_like(t.data)),
        t_perm=perm, shape_a=a.shape, cap_a=a.cap, nnz_a=int(a.nnz))
    if cache:
        cache_store(key, a.device, plan)
    return plan


def gram(a: CSR, *, sorted_output: bool = False, **kw) -> CSR:
    """One-shot planned ``A^T @ A`` (cached; a repeat call on the same
    structure -- a re-weighted design matrix -- runs numeric-only)."""
    return plan_gram(a, sorted_output=sorted_output, **kw).execute(a)
